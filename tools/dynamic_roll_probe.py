"""A roll along axis 1 by a shift read on the device, on an NVIDIA GPU
(counterpart of benchmarks/probe_dynamic_roll.py).

    python3 tools/dynamic_roll_probe.py [--device cuda|cpu]

Kernel #5 (`gsdx_torch/kernels/probes.py` `dynamic_roll`, source
`gsdx_torch/csrc/probes.cu`) rolls an (8, 512) f32 block by a shift that
it reads from an int32 tensor on the device, the counterpart of the TPU's
scalar prefetch. For shifts 0, 3, 130 and 511 it prints whether the result
equals `np.roll`, then, on a card, one JSON line of `call_times` (the
host's work a call against `torch.roll`'s), then PROBE OK; exits 1 if any
shift differs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gsdx_torch.core.device import require_device  # noqa: E402
from gsdx_torch.kernels import probes  # noqa: E402

SHIFTS = (0, 3, 130, 511)


def run(device="cuda") -> bool:
    dev = require_device(device)
    x = np.arange(8 * 512, dtype=np.float32).reshape(8, 512)
    xt = torch.from_numpy(x).to(dev)
    ok = True
    for s in SHIFTS:
        out = probes.dynamic_roll(xt, torch.tensor([s], dtype=torch.int32, device=dev))
        match = bool(np.array_equal(out.cpu().numpy(), np.roll(x, s, axis=1)))
        print(f"shift={s}: match={match}", flush=True)
        ok &= match
    return ok


def call_times(rounds: int = 5, reps: int = 200) -> dict:
    """Kernel #5's call back to back on the card, the host's work a call
    (`chip_smoke.py` `cuda_ms_back_to_back`, ``reps`` calls between two CUDA
    events), for an (8, 512) block and shift 130: the wrapper allocating its
    output ("ms"), the wrapper into the caller's output ("ms_out") and
    `torch.roll` ("library_ms"), beside two pieces of the wrapper's (a
    launch of the empty kernel by the same ctypes path, and `empty_like`).
    Each round times them in turn, then in the reverse order; every time is
    kept ("rounds", ms), with the least of each, the ratios of the least
    to torch.roll's, and the passes in which each call was no slower than
    torch.roll's of the same pass."""
    import chip_smoke as S

    x = torch.randn(8, 512, device="cuda")
    s = torch.tensor([130], dtype=torch.int32, device="cuda")
    y = torch.empty_like(x)
    if not torch.equal(probes.dynamic_roll(x, s, out=y), torch.roll(x, 130, dims=1)):
        raise AssertionError("dynamic_roll into the caller's output differs from torch.roll")
    calls = {"ms": lambda: probes.dynamic_roll(x, s),
             "ms_out": lambda: probes.dynamic_roll(x, s, out=y),
             "library_ms": lambda: torch.roll(x, 130, dims=1),
             "empty_launch_call_ms": lambda: probes.empty_launch(0),
             "empty_like_ms": lambda: torch.empty_like(x)}
    times = {k: [] for k in calls}
    for _ in range(rounds):
        for k in list(calls) + list(calls)[::-1]:
            times[k].append(S.cuda_ms_back_to_back(calls[k], reps=reps))
    out = {k: min(v) for k, v in times.items()}
    lib = times["library_ms"]
    out.update(rounds=times,
               call_over_library=out["ms"] / out["library_ms"],
               call_out_over_library=out["ms_out"] / out["library_ms"],
               passes_not_slower={k: sum(a <= b for a, b in zip(times[k], lib))
                                  for k in ("ms", "ms_out")},
               passes=len(lib))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not run(args.device):
        return 1
    if torch.device(args.device).type == "cuda":
        print(json.dumps({"call_times": call_times()}), flush=True)
    print("PROBE OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
