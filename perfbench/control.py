"""Readings that the limits of `correct` are set from: the program's check
numbers on many seeds, and the control's (the reference computed one
precision below the configuration's, put in the program's place) on a few.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 10

One process: each seed is a run of the cell through the harness
(`harness.run_cell`: set-up, a window of ``--seconds``, the state released,
the answers checked); a control seed's answers are also judged with the
control in the program's place, and a fault seed's with the driver's
planted ``--fault`` (training: ``half``, half of each batch left out). Prints one JSON line a reading. Not run by the
benchmark's own runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402


def readings(workload: str, seeds, control_seeds, seconds: float, require_card=True,
             overrides=None, fault_seeds=(), fault=None, bench=None):
    """Yield one dict a reading: {"seed", "side", "numbers", ...}. Each seed
    is one run of the cell through `harness.run_cell`, its answers judged by
    each side the seed is listed for."""
    import torch

    for seed in dict.fromkeys([*seeds, *control_seeds, *fault_seeds]):
        sides = ([("program", {})] if seed in seeds else []) + (
            [("control", {"control": True})] if seed in control_seeds else []) + (
            [(f"fault:{fault}", {"fault": fault})] if seed in fault_seeds else [])
        judged = {}

        def judge(cell):
            for side, how in sides:
                judged[side] = cell.check(**how)
            judged["diagnostics"] = getattr(cell, "diagnostics", None)
            return judged[sides[0][0]]

        args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=0,
                                  overrides=overrides)
        _, result = harness.run_cell(args, time.perf_counter(), bench=bench,
                                     require_card=require_card, judge=judge)
        for side, _ in sides:
            yield {"workload": workload, "seed": seed, "side": side,
                   "attempted": result["attempted"], "metrics": result["metrics"],
                   "numbers": {n: v for n, v, _ in judged[side]},
                   "diagnostics": judged["diagnostics"]}
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--fault", default=None, help="a fault the driver plants in the reference")
    p.add_argument("--fault-seeds", default="")
    a = p.parse_args()
    seeds = [int(s) for s in a.seeds.split(",") if s]
    control = [int(s) for s in a.control_seeds.split(",") if s]
    faults = [int(s) for s in a.fault_seeds.split(",") if s]
    for row in readings(a.workload, seeds, control, a.seconds, fault_seeds=faults,
                        fault=a.fault):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    harness.cache_environment()
    sys.exit(main())
