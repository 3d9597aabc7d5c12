"""How much of the tile compositor's hot loop is its transcendentals, on an
NVIDIA GPU (counterpart of benchmarks/probe_transcendental.py).

    python3 tools/transcendental_probe.py

Kernel #4 (`gsdx_torch/kernels/probes.py` `composite_hot_loop`, source
`gsdx_torch/csrc/probes.cu`) walks the compositor's per-tile loop with its
three transcendentals (exp(power), log1p(-alpha), exp(log T)) and, as a
twin, with the probe's polynomial stand-ins in their place: same loads,
same loop, so the difference is what the transcendentals cost. The data
are the probe's: `np.random.default_rng(0)`, normal features (128, 16,
512), counts drawn from [sub, 512]; sub 64 and 128. Each variant's time is
the kernel's device time a call from `torch.profiler`, taken in the order
variants, variants reversed, for three rounds, the best of each kept.
Prints the card's name and power limit, then one JSON line per sub:
microseconds a granule (device time over the granules of all tiles) for
each variant, the transcendental share, and each variant's bounds on this
card: the function's (`function_bound_ms`: the operations a pair that the
probe's arithmetic needs, counted from its source, pipe by pipe, and the
bytes) and, as a diagnostic beside it, that of the compiled loop's own
SASS (`chip_smoke.py` `hot_loop_pipes`: its FP32, ALU and MUFU
instructions a pair over their lanes, and all over the issue slots); then
TRANSCENDENTAL PROBE OK.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as S  # noqa: E402
from gsdx_torch.kernels import probes  # noqa: E402

T, F, K = 128, 16, 512
SUBS = probes.SUBS
VARIANTS = (True, False)  # transcend
# What the function needs a processed (splat, pixel) pair, by pipe (FP32
# add/multiply/fma, ALU compare/select/min, MUFU), counted from the probe's
# arithmetic and not from any compiled code, so that the bound does not
# move with what a kernel or nvcc issues. FP32:
#   the falloff, rounded op by op as the plain version (so no fusing): dx,
#     (a dx) dx, + (c dy) dy, (b dx) dy, - : 7 a pair (-0.5 folded into a
#     and c, exact); dy and (c dy) dy, 3 a (splat, column), shared by the
#     tile's TILE_H rows;
#   alpha = op e and w = alpha e': 2; 4 channel FMAs; the log T step: 1;
#   transcendental variant: the power's scale to base 2 and 1 - alpha: 2;
#   stand-in variant: 1 + x + x^2 / 2 as two FMAs (Horner) for each exp,
#     -a - a^2 / 2 as an FMA and a multiply: 6.
# ALU: the clamp (min), the two cut compares and a select: 4.
# MUFU: exp(power), log(1 - alpha), exp(log T) in the transcendental variant.
FALLOFF_FP32 = 7 + 3 / probes.TILE_H
FUNCTION_A_PAIR = {
    True: {"fp32": FALLOFF_FP32 + 2 + 4 + 1 + 2, "alu": 4, "mufu": 3},
    False: {"fp32": FALLOFF_FP32 + 2 + 4 + 1 + 6, "alu": 4, "mufu": 0},
}


def probe_inputs(sub: int, device="cuda"):
    """The probe's data (benchmarks/probe_transcendental.py `build`)."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(T, F, K)).astype(np.float32)
    counts = rng.integers(sub, K + 1, size=(T,)).astype(np.int32)
    return torch.from_numpy(feats).to(device), torch.from_numpy(counts).to(device)


def dense_inputs(sub: int, device="cuda"):
    """`tests/test_torch_probes.py` `_dense_inputs` at T 128: splats that
    cover the probe's pixels, so that every output entry depends on the
    transcendentals (on the probe's data ~98% of the entries are 0)."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(T, F, K)).astype(np.float32)
    ca = rng.uniform(2e-6, 2e-5, size=(T, K))
    cc = rng.uniform(5e-3, 5e-2, size=(T, K))
    feats[:, 0] = rng.uniform(0, 2048, size=(T, K))
    feats[:, 1] = rng.uniform(0, 12.8, size=(T, K))
    feats[:, 2], feats[:, 4] = ca, cc
    feats[:, 3] = rng.uniform(-0.9, 0.9, size=(T, K)) * np.sqrt(ca * cc)
    feats[:, 5] = rng.uniform(0.05, 0.5, size=(T, K))
    counts = rng.integers(sub, K + 1, size=(T,)).astype(np.int32)
    return torch.from_numpy(feats).to(device), torch.from_numpy(counts).to(device)


def work(counts: torch.Tensor, sub: int) -> dict:
    """Granules, processed pairs, and the bytes the function needs at these
    counts: the 10 used rows of each processed column read once, the
    counts, the outputs written once."""
    granules = int(((counts.long() + sub - 1) // sub).sum())
    return {"granules": granules, "pairs": granules * sub * probes.P,
            "bytes": 4 * (10 * granules * sub + T + T * 5 * probes.P)}


def function_bound_ms(w: dict, transcend: bool, clk_mhz: float) -> dict:
    """The least time of the function on the card: the larger of its bytes
    over the memory rate and, on each pipe, its operations (`work`'s pairs
    times `FUNCTION_A_PAIR`) over the pipe's lanes at ``clk_mhz``."""
    pipe_ms = {k: w["pairs"] * n / (S.SMS * S.PIPE_LANES[k] * clk_mhz * 1e6) * 1e3
               for k, n in FUNCTION_A_PAIR[transcend].items()}
    pipe = max(pipe_ms, key=pipe_ms.get)
    bytes_ms = w["bytes"] / S.PEAK_BYTES_S * 1e3
    return {"bound_ms": max(bytes_ms, pipe_ms[pipe]),
            "bound_by": "bytes" if bytes_ms > pipe_ms[pipe] else "operations",
            "bound_pipe": pipe, "bound_bytes": w["bytes"],
            "function_a_pair": FUNCTION_A_PAIR[transcend]}


def sass_bound_ms(pairs: int, pipes: dict, clk_mhz: float) -> dict:
    """A diagnostic, not the function's bound: the least time of ``pairs``
    pairs at the loop's own SASS counts a pair (`chip_smoke.py`
    `hot_loop_pipes` row), each pipe's instructions over its lanes, and all
    over the issue slots. It rises with every instruction the code issues."""
    to_ms = pairs / (S.SMS * clk_mhz * 1e6) * 1e3
    return {"bound_ms_sass": to_ms * pipes["clk_a_pair"][pipes["bound_pipe"]],
            "bound_pipe_sass": pipes["bound_pipe"],
            "bound_ms_issue_sass": to_ms * pipes["clk_a_pair_issue"]}


def ab(sub: int, clk_mhz: float, rounds: int = 3) -> dict:
    """Both variants timed in turns on the probe's data at ``sub``, with each
    variant's function bound and, beside it, its SASS's pipe bounds."""
    feats, counts = probe_inputs(sub)
    best = {v: float("inf") for v in VARIANTS}
    for _ in range(rounds):
        for order in (VARIANTS, VARIANTS[::-1]):
            for v in order:
                ms = S.kernel_device_ms(
                    lambda v=v: probes.composite_hot_loop(feats, counts, sub, v),
                    rf"hot_loop_kernel<{'true' if v else 'false'}, {sub}>")
                best[v] = min(best[v], ms)
    w = work(counts, sub)
    pipes = S.hot_loop_pipes(probes.LIBRARY.path())
    out = {"sub": sub, "T": T, "K": K, "granules": w["granules"], "pairs": w["pairs"]}
    for v in VARIANTS:
        name = "transcend" if v else "poly"
        fb = function_bound_ms(w, v, clk_mhz)
        out.update({f"device_ms_{name}": best[v],
                    f"us_per_granule_{name}": best[v] * 1e3 / w["granules"],
                    **{f"{k}_{name}": x for k, x in fb.items()},
                    f"bound_over_device_{name}": fb["bound_ms"] / best[v],
                    **{f"{k}_{name}": x for k, x in sass_bound_ms(
                        w["pairs"], pipes[f"{name}_{sub}"], clk_mhz).items()},
                    f"sass_a_pair_{name}": pipes[f"{name}_{sub}"]})
    out["transcendental_share"] = 1.0 - best[False] / best[True]
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("transcendental_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    clk = S.card_info()["max_sm_mhz"]
    for sub in SUBS:
        r = ab(sub, clk)
        print(json.dumps(r), flush=True)
        print(f"sub={sub}: {r['us_per_granule_transcend']:.4f} us/granule with "
              f"transcendentals, {r['us_per_granule_poly']:.4f} without -> "
              f"{r['transcendental_share']:.0%} of granule time is exp/log", flush=True)
    print("TRANSCENDENTAL PROBE OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
