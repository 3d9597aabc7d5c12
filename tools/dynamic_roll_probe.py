"""A roll along axis 1 by a shift read on the device, on an NVIDIA GPU
(counterpart of benchmarks/probe_dynamic_roll.py).

    python3 tools/dynamic_roll_probe.py [--device cuda|cpu]

Kernel #5 (`gsdx_torch/kernels/probes.py` `dynamic_roll`, source
`gsdx_torch/csrc/probes.cu`) rolls an (8, 512) f32 block by a shift that
it reads from an int32 tensor on the device, the counterpart of the TPU's
scalar prefetch. For shifts 0, 3, 130 and 511 it prints whether the result
equals `np.roll`, then PROBE OK; exits 1 if any differs.
"""

from __future__ import annotations

import argparse
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not run(args.device):
        return 1
    print("PROBE OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
