"""What holds kernel #4 (gsdx_torch/csrc/probes.cu `hot_loop_kernel`) back on
an NVIDIA GPU: its device time under each of its design's knobs, both
variants (transcendentals and polynomial stand-ins), at the TPU probe's
shape (T 128, K 512, sub 64 and 128, `tools/transcendental_probe.py`
`probe_inputs`).

    python3 tools/hot_loop_ablation.py [--variants NAME,NAME,...]

The knobs are `constexpr` lines of probes.cu: PPT (pixels a lane, and so
the unit: 32 columns x PPT rows), STEP (splats a load step), BLOCKS_A_SM
(persistent blocks on each SM) and WARPS (a block). Each variant is the
committed source with some of those lines changed, built by nvcc (all at
once) into build/hot_loop_ablation/. Every variant must give the outputs
of the shipped one bit for bit: a pixel's arithmetic does not depend on
which warp runs it. Each time is the kernel's device time a call from
`torch.profiler`, taken in the order variants, variants reversed; the
least of the two is kept. Prints the card's name and power limit, each
variant's registers and spills, then one JSON line per (sub, variant of the
probe) with each knob variant's device ms and its SASS's pipe bound (a
diagnostic: the function's own bound is `transcendental_probe.py`
`function_bound_ms`, the same for every variant).
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

import chip_smoke as S  # noqa: E402
from gsdx_torch.kernels import _build  # noqa: E402
from gsdx_torch.kernels import probes  # noqa: E402
import transcendental_probe as tp  # noqa: E402

# knob settings of each variant, over the committed source's
VARIANTS = {
    "shipped": {},
    "4-splat steps": {"STEP": "4"},
    "4-splat steps, 3 blocks an SM": {"STEP": "4", "BLOCKS_A_SM": "3"},
    "1 block an SM": {"BLOCKS_A_SM": "1"},
    "2 pixels a lane": {"PPT": "2"},
    "8 warps a block, 1 block an SM": {"WARPS": "8", "BLOCKS_A_SM": "1"},
}


def variant_source(knobs: dict) -> str:
    src = (_build.CSRC / "probes.cu").read_text()
    for name, value in knobs.items():
        pattern = rf"constexpr int {name} = [^;]+;"
        if len(re.findall(pattern, src)) != 1:
            raise RuntimeError(f"probes.cu no longer has one `{pattern}`, which this script varies")
        src = re.sub(pattern, f"constexpr int {name} = {value};", src)
    return src


def launch(hot_loop: _build.Launcher, feats, counts, sub: int, transcend: bool):
    T, _, K = feats.shape
    accum = torch.empty((T, probes.N_ACCUM, probes.P), device=feats.device)
    logt = torch.empty((T, 1, probes.P), device=feats.device)
    scratch = torch.empty(1, dtype=torch.int32, device=feats.device)
    hot_loop(feats.device.index, feats.data_ptr(), counts.data_ptr(), accum.data_ptr(),
             logt.data_ptr(), scratch.data_ptr(), T, K, sub, int(transcend))
    return accum, logt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", help="comma-separated names (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hot_loop_ablation: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    names = args.variants.split(",") if args.variants else list(VARIANTS)
    if "shipped" not in names:
        names.insert(0, "shipped")
    out_dir = REPO / "build" / "hot_loop_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, name in enumerate(names):
        path = out_dir / f"probes_{i}.cu"
        path.write_text(variant_source(VARIANTS[name]))
        libs[name] = _build.CudaLibrary(f"hot_loop_ablation_{i}", str(path),
                                        probes.LIBRARY.functions, probes.LIBRARY.error_string)
    with ThreadPoolExecutor(len(libs)) as pool:
        logs = dict(zip(libs, pool.map(lambda lib: lib.build(), libs.values())))
    for name, log in logs.items():
        print(json.dumps({"variant": name, "ptxas": S.ptxas_report([log])}), flush=True)
    clk = S.card_info()["max_sm_mhz"]
    pipes = {name: S.hot_loop_pipes(lib.path()) for name, lib in libs.items()}
    hot = {name: _build.Launcher(lib, "gsdx_probe_hot_loop", f"hot loop variant {name!r}")
           for name, lib in libs.items()}
    for sub in probes.SUBS:
        feats, counts = tp.probe_inputs(sub)
        w = tp.work(counts, sub)
        for transcend in (True, False):
            key = f"{'transcend' if transcend else 'poly'}_{sub}"
            ref = launch(hot["shipped"], feats, counts, sub, transcend)
            row = {}
            for name in names + names[::-1]:
                got = launch(hot[name], feats, counts, sub, transcend)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"{name}: outputs differ from the shipped kernel's")
                ms = S.kernel_device_ms(
                    lambda name=name: launch(hot[name], feats, counts, sub, transcend),
                    rf"hot_loop_kernel<{'true' if transcend else 'false'}, {sub}>")
                r = row.setdefault(name, {"device_ms": ms, **tp.sass_bound_ms(
                    w["pairs"], pipes[name][key], clk)})
                r["device_ms"] = min(r["device_ms"], ms)
            print(json.dumps({"sub": sub, "transcend": transcend, "bound_ms": tp.function_bound_ms(
                w, transcend, clk)["bound_ms"], "variants": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
