"""`edges_ms.plan`: the radius graph's device milliseconds a MPPI iteration,
read from the traced window's ``edges_kernel`` intervals; nothing where the
trace holds no such kernel."""

from __future__ import annotations

import pytest
import torch
from tinycells import harness, run_tiny

from gsdx_torch.utils import profiling

GEMM = "void (anonymous namespace)::gnn_gemm_kernel<256, false>(CUtensorMap_st)"
EDGES = "void (anonymous namespace)::edges_kernel<5>((anonymous namespace)::Args)"


def test_reads_the_kernels_device_time_over_the_iterations():
    reader = harness.metric_reader("edges_ms.plan")
    kernels = [(GEMM, 0.0, 500.0), (EDGES, 600.0, 623.0), (EDGES, 900.0, 921.0),
               ("void at::native::radixSortKVInPlace<2, -1, 32, 32>", 1000.0, 1100.0)]
    assert reader.read({"kernels": kernels, "units": 2}) == pytest.approx(0.022)
    # a program that builds its graph otherwise (the parent) reads nothing
    assert reader.read({"kernels": [k for k in kernels if k[0] != EDGES], "units": 2}) is None
    assert reader.read({"kernels": kernels, "units": 0}) is None


@pytest.mark.parametrize("cell", ["rope.plan", "cloth.plan"])
def test_traced_tiny_plan_cell_spans_each_push_steps_edges(cell, monkeypatch):
    """On the CPU the trace holds no kernel, so the line leaves the metric
    out; the push step's ``graph.edges`` span is there, one a step."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    profiling.reset()
    try:
        res = run_tiny(cell, seconds=1.0, trace=1)
        assert "edges_ms.plan" not in res["metrics"], res["metrics"]
        done = [r for r in profiling.snapshot()["roots"]["plan.iteration"] if not r["cut"]]
        spans = done[-1]["spans"]
        assert spans["graph.edges"]["count"] == spans["rollout.step"]["count"] > 0
    finally:
        profiling.reset()
