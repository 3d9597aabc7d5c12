"""What holds the GNN's tensor-core GEMM (gsdx_torch/csrc/gnn_gemm.cu) back on
an NVIDIA GPU: its time under each of the design's knobs, at the products
of the fused forward of a 125-sample rope chunk, beside `torch.matmul` of
the same bf16 operands.

    python3 tools/gnn_gemm_ablation.py [--reps 30] [--variants NAME,NAME,...]

The knobs are the `constexpr` lines at the top of gnn_gemm.cu: the tile
width (128x128 against the shipped choice, 128x256 wherever N allows it),
the ring's shared memory (its depth), the epilogue (stores from the
registers against the shipped one, staged through shared memory and
stored by TMA), and a block a tile against the persistent grid. (Ping-pong
consumers, each on its own 64-row tiles, and a cluster of 2 blocks along M
multicasting the weight tile were measured and gained nothing, so the
kernel no longer has them: PERF.md keeps their times.) Each variant is the
committed source with some of those lines changed, built by nvcc (all at
once) into build/gnn_gemm_ablation/. "earlier layout" is as close to the
kernel's earlier, non-persistent design as the knobs come: 128x128 tiles,
3 stages, register stores, a block a tile (but one block an SM, where
that design fitted two).

Every variant must give bit-identical outputs: the K sum runs in ascending
K in 16-deep wgmma steps in all of them. Each time is the mean of --reps
calls queued back to back between two CUDA events, taken twice (variants
in the order listed, then reversed), and again without outputs (the
epilogue computes and stores nothing: the main loop alone). Prints the
card's name and power limit, then one JSON line per shape with each
variant's times and launch (grid, tile, stages).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from gsdx_torch.kernels import _build  # noqa: E402
from gsdx_torch.kernels._build import ptr  # noqa: E402
from gsdx_torch.kernels import gnn_forward as G  # noqa: E402

# Knob settings of each variant, over the committed source's.
VARIANTS = {
    "shipped": {},
    "128x128 tiles": {"FORCE_BN": "128"},
    "ring 96 KB": {"RING_BYTES": "96 * 1024"},
    "ring 144 KB": {"RING_BYTES": "144 * 1024"},
    "register stores": {"TMA_STORE": "false"},
    "a block a tile": {"PERSISTENT": "false"},
    "earlier layout": {"FORCE_BN": "128", "RING_BYTES": "96 * 1024", "TMA_STORE": "false",
                       "PERSISTENT": "false"},
}
assert not any("," in name for name in VARIANTS), "--variants splits names on commas"
# (name, M, N, epilogue) with K = 512, the epilogues the forward gives them
SHAPES = (("w2r, edge rows", 63000, 512, {"bias": True, "relu": True, "out": "bf16"}),
          ("w2p, node rows", 16000, 512, {"bias": True, "relu": True, "out": "bf16"}),
          ("wp1, a round", 16000, 512, {"res": 2, "relu": True, "out": "both"}),
          ("wt_rs, a round", 16000, 1024, {"out": "f32"}),
          ("wh3, the head", 16000, 8, {"bias": True, "out": "f32"}))
K = 512


def variant_source(knobs: dict) -> str:
    src = (_build.CSRC / "gnn_gemm.cu").read_text()
    for name, value in knobs.items():
        pat = re.compile(rf"^(constexpr \w+ {name} = )[^;]+;", re.M)
        if not pat.search(src):
            raise RuntimeError(f"gnn_gemm.cu no longer has the knob {name}")
        src = pat.sub(lambda m: f"{m.group(1)}{value};", src)
    return src


def mean_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variant names, in the order to run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gnn_gemm_ablation: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    names = [v for v in args.variants.split(",") if v]
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    sources = {name: variant_source(VARIANTS[name]) for name in names}
    out_dir = REPO / "build" / "gnn_gemm_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, (name, src) in enumerate(sources.items()):
        path = out_dir / f"gnn_gemm_{i}.cu"
        path.write_text(src)
        libs[name] = _build.CudaLibrary(f"gnn_gemm_ablation_{i}", str(path),
                                        G.GEMM_LIBRARY.functions, G.GEMM_LIBRARY.error_string)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    # launched straight, not through `G.gnn_gemm`, which refuses a call
    # without outputs
    gemms = {name: _build.Launcher(lib, "gsdx_gnn_gemm", f"variant {name!r}")
             for name, lib in libs.items()}

    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(0)
    order = list(libs) + list(reversed(list(libs)))
    for label, M, N, epi in SHAPES:
        x = torch.relu(torch.randn(M, K, device=dev, generator=g)).to(torch.bfloat16)
        rows = -(-N // G.GEMM_BN) * G.GEMM_BN
        w = (torch.randn(N, K, device=dev, generator=g) / K ** 0.5).to(torch.bfloat16)
        wt = torch.cat([w, w.new_zeros(rows - N, K)]).contiguous()
        bias = torch.randn(N, device=dev, generator=g) if epi.get("bias") else None
        res = [torch.randn(M, N, device=dev, generator=g) for _ in range(epi.get("res", 0))]
        r1, r2 = (res + [None, None])[:2]
        yf = torch.empty(M, N, device=dev) if epi["out"] in ("f32", "both") else None
        yb = (torch.empty(M, N, device=dev, dtype=torch.bfloat16)
              if epi["out"] in ("bf16", "both") else None)
        ref, row = None, {}
        for name in order:
            def run(store: bool = True, gemm=gemms[name]) -> None:
                gemm(dev.index, x.data_ptr(), wt.data_ptr(), M, N, K, ptr(bias), ptr(r1),
                     ptr(r2), ptr(yf) if store else None, ptr(yb) if store else None,
                     int(epi.get("relu", 0)))

            try:
                run()
                torch.cuda.synchronize()
            except Exception as e:
                raise RuntimeError(f"variant {name!r} failed at {label}") from e
            outs = [t.clone() for t in (yf, yb) if t is not None]
            if ref is None:
                ref = outs
            elif not all(torch.equal(a, b) for a, b in zip(outs, ref)):
                raise AssertionError(f"{name} differs from {order[0]} at {label}")
            entry = row.setdefault(name, {"ms": [], "ms_without_outputs": []})
            entry["launch"] = libs[name].record("gsdx_gnn_gemm_last_launch",
                                                G.GEMM_LAUNCH_FIELDS)
            entry["ms"].append(mean_ms(run, args.reps))
            entry["ms_without_outputs"].append(mean_ms(lambda: run(False), args.reps))
        w_kn = wt[:N].t()
        row["torch.matmul (bf16 out)"] = {"ms": [mean_ms(lambda: torch.matmul(x, w_kn),
                                                         args.reps)]}
        print(json.dumps({"shape": label, "M": M, "N": N, "K": K, "epilogue": epi,
                          "variants": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
