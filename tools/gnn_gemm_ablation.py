"""What bounds the GNN's tensor-core GEMM (gsdx_torch/csrc/gnn_gemm.cu) on an
NVIDIA GPU: its time against the depth of the load ring and the number of
blocks an SM holds, each with and without the epilogue's stores, at the
rope chunk's shapes, beside `torch.matmul` of the same bf16 operands.

    python3 tools/gnn_gemm_ablation.py

Each variant is the committed source with one constant changed, built by
nvcc into build/gnn_gemm_ablation/. All variants must give bit-identical
outputs. Every time is the mean of 30 CUDA-event timed calls, taken twice
in the order shipped, variants, variants reversed, shipped. Prints one JSON
line per shape, after the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from gsdx_torch.kernels import _build  # noqa: E402
from gsdx_torch.kernels import gnn_forward as G  # noqa: E402

# (stages, blocks an SM): the shipped ring, and one block an SM with deeper
# rings (two blocks of 4 or more stages do not fit in shared memory)
VARIANTS = {"3 stages x 2 blocks (shipped)": (3, 2), "4 stages x 1 block": (4, 1),
            "6 stages x 1 block": (6, 1)}
SHAPES = ((63000, 512), (16000, 512), (16000, 1024))  # (M, N), K = 512


def variant_source(stages: int, blocks: int) -> str:
    src = (_build.CSRC / "gnn_gemm.cu").read_text()
    out = src.replace("constexpr int STAGES = 3;", f"constexpr int STAGES = {stages};")
    out = out.replace("__launch_bounds__(THREADS, 2)", f"__launch_bounds__(THREADS, {blocks})")
    if (stages, blocks) != (3, 2) and out == src:
        raise RuntimeError("gnn_gemm.cu no longer has the constants this script varies")
    return out


def mean_ms(fn, reps: int = 30) -> float:
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("gnn_gemm_ablation: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    out_dir = REPO / "build" / "gnn_gemm_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, (name, (stages, blocks)) in enumerate(VARIANTS.items()):
        path = out_dir / f"gnn_gemm_{i}.cu"
        path.write_text(variant_source(stages, blocks))
        lib = _build.CudaLibrary(f"gnn_gemm_ablation_{i}", str(path),
                                 G.GEMM_LIBRARY.functions, G.GEMM_LIBRARY.error_string)
        libs[name] = lib.load()

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    order = list(libs) + list(reversed(list(libs)))
    for M, N in SHAPES:
        x = torch.relu(torch.randn(M, 512, device=dev, generator=g)).to(torch.bfloat16)
        wt = (torch.randn(N, 512, device=dev, generator=g) / 512 ** 0.5).to(torch.bfloat16)
        bias = torch.randn(N, device=dev, generator=g)
        y = torch.empty(M, N, device=dev, dtype=torch.bfloat16)
        ref, row = None, {}
        for name in order:
            lib = libs[name]

            def run(store: bool = True, lib=lib) -> None:
                # bias, ReLU and a bf16 output, as the edge layers take them;
                # without an output the epilogue computes and stores nothing
                err = lib.gsdx_gnn_gemm(x.data_ptr(), wt.data_ptr(), M, N, 512,
                                        bias.data_ptr(), None, None, None,
                                        y.data_ptr() if store else None, 1, stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")

            run()
            torch.cuda.synchronize()
            if ref is None:
                ref = y.clone()
            elif not torch.equal(y, ref):
                raise AssertionError(f"{name} differs from the shipped kernel")
            row.setdefault(name, {}).setdefault("ms", []).append(mean_ms(run))
            row[name].setdefault("ms_without_stores", []).append(
                mean_ms(lambda: run(False)))
        w_kn = wt.t()
        row["torch.matmul (bf16 out)"] = {"ms": [mean_ms(lambda: torch.matmul(x, w_kn))]}
        print(json.dumps({"M": M, "N": N, "K": 512, "variants": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
