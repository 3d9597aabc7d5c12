"""How much of the tile compositor's hot loop is its transcendentals, on an
NVIDIA GPU (counterpart of benchmarks/probe_transcendental.py).

    python3 tools/transcendental_probe.py

Kernel #4 (`gsdx_torch/kernels/probes.py` `composite_hot_loop`, source
`gsdx_torch/csrc/probes.cu`) walks the compositor's per-tile loop with its
three transcendentals (exp(power), log1p(-alpha), exp(log T)) and, as a
twin, with the probe's polynomial stand-ins in their place (2 mul + 2 add
each): same loads, same loop, so the difference is what the
transcendentals cost. The data are the probe's: `np.random.default_rng(0)`,
normal features (128, 16, 512), counts drawn from [sub, 512]; sub 64 and
128. Each variant's time is the kernel's device time a call from
`torch.profiler`, taken in the order variants, variants reversed, for three
rounds, the best of each kept. Prints the card's name and power limit, then
one JSON line per sub: microseconds a granule (device time over the
granules of all tiles) for each variant, the transcendental share, and each
variant's bound on this card; then TRANSCENDENTAL PROBE OK.
"""

from __future__ import annotations

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
# Work a processed (splat, pixel) pair, counted from csrc/probes.cu: the
# falloff (11 flops), alpha and its cut (3), w (1), 4 channel FMAs (8) and
# the log T step (1); the transcendentals 3 MUFU.EX2 (the SASS holds 24 in
# the loop body of 4 splats x 2 pixels, `chip_smoke.py` `mufu_counts`),
# their stand-ins 4 flops each.
FLOPS_A_PAIR = 24
STANDIN_FLOPS = 3 * 4
MUFU_A_PAIR = 3


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


def work(counts: torch.Tensor, sub: int, transcend: bool) -> dict:
    """Granules, processed pairs, and the bytes and operations the function
    needs at these counts: the 10 used rows of each processed column read
    once, the counts, the outputs written once."""
    granules = int(((counts.long() + sub - 1) // sub).sum())
    pairs = granules * sub * probes.P
    return {"granules": granules, "pairs": pairs,
            "bytes": 4 * (10 * granules * sub + T + T * 5 * probes.P),
            "flops": pairs * (FLOPS_A_PAIR + (0 if transcend else STANDIN_FLOPS)),
            "mufu": pairs * MUFU_A_PAIR if transcend else 0}


def ab(sub: int, clk_mhz: float, rounds: int = 3) -> dict:
    """Both variants timed in turns on the probe's data at ``sub``."""
    feats, counts = probe_inputs(sub)
    best = {v: float("inf") for v in VARIANTS}
    for _ in range(rounds):
        for order in (VARIANTS, VARIANTS[::-1]):
            for v in order:
                ms = S.kernel_device_ms(
                    lambda v=v: probes.composite_hot_loop(feats, counts, sub, v),
                    rf"hot_loop_kernel<{'true' if v else 'false'}, {sub}>")
                best[v] = min(best[v], ms)
    out = {"sub": sub, "T": T, "K": K}
    for v in VARIANTS:
        name = "transcend" if v else "poly"
        w = work(counts, sub, v)
        b = S.bound_ms(w["bytes"], w["flops"], w["mufu"], clk_mhz)
        out.update({"granules": w["granules"], "pairs": w["pairs"],
                    f"device_ms_{name}": best[v],
                    f"us_per_granule_{name}": best[v] * 1e3 / w["granules"],
                    f"bound_ms_{name}": b[0], f"bound_by_{name}": b[1],
                    f"bound_bytes_{name}": w["bytes"], f"bound_flops_{name}": w["flops"],
                    f"bound_mufu_{name}": w["mufu"]})
    out["transcendental_share"] = 1.0 - best[False] / best[True]
    return out


def main() -> int:
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
