"""Tiny configurations of the benchmark's cells for the CPU tests, run
through the harness on the CPU with the look for a card skipped. Only for
the tests: the benchmark runs the published shapes."""

from __future__ import annotations

import copy
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402


def bench_with_staged() -> dict:
    """BENCHMARK.json with the cells, metrics and entries of staged.json."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    staged = harness.load_json(harness.PERFBENCH / "staged.json")
    return {**bench, **{k: bench[k] + staged[k]
                        for k in ("workloads", "end_to_end", "per_layer")}}


def tiny(workload: str) -> dict:
    """Overrides that shrink a cell to CPU size: narrow GNN, few samples,
    small images. Only for the tests: the benchmark runs the published
    shapes."""
    spec = harness.resolve(bench_with_staged(), workload)
    cfg = copy.deepcopy(spec["config"])
    mix = {}
    if spec["mix"]["driver"] == "mppi":
        for k in ("nf_particle", "nf_relation", "nf_effect"):
            cfg["model_config"][k] = 32
        cfg["mppi"].update(n_sample=16, n_update_iter=3, n_chunks=2, sort_chunks=2)
        mix = {"check_iterations": 1, "check_within": 3}
    elif spec["mix"]["driver"] == "train":
        for k in ("nf_particle", "nf_relation", "nf_effect"):
            cfg["model_config"][k] = 32
        cfg["train_config"]["batch_size"] = 4
        cfg["dataset_config"].update(max_nobj=20, max_nR=120)
        mix = {"episodes": 2, "frames": 12, "points": 60}
    elif spec["mix"]["driver"] == "track":
        cfg["tracking"].update(n_cams=2, width=256, height=96, iters_rest=8, bin_refresh=4,
                               capacity=512)
        cfg["tracking_scene"].update(points=300, focal_px=120.0)
        mix = {"iters_per_call": 4, "frames": 2}
    return {"config": cfg, "mix": mix}


def run_tiny(workload: str, seed: int = 2**31 + 11, seconds: float = 1.0, trace: int = 0,
             cell_hook=None):
    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=seconds, trace=trace,
                                 overrides=tiny(workload))
    return harness.run_cell(args, time.perf_counter(), bench=bench_with_staged(),
                            require_card=False, cell_hook=cell_hook)[1]
