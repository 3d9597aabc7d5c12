"""The readers of the port's spans: tiny cells traced on the CPU give the
host metrics and no device ones, and a window the profiler took again
counts once."""

from __future__ import annotations

import pytest
import torch
from tinycells import harness, run_tiny

from gsdx_torch.utils import profiling

PLAN_HOST = {"host_reads_per_iter.plan", "step_host_us.plan"}
DEVICE = {"fps_ms.train", "sample_ms.train", "train_step_ms.train"}


@pytest.fixture
def traced_on_the_cpu(monkeypatch):
    """The traced window synchronises the card around the profiler; on the
    CPU there is nothing to wait for."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("cell", ["rope.plan", "cloth.plan"])
def test_traced_tiny_plan_cell_reads_its_host_metrics(cell, traced_on_the_cpu):
    res = run_tiny(cell, seconds=2.0, trace=1)
    metrics = res["metrics"]
    assert PLAN_HOST <= set(metrics), metrics
    # the CPU's plain twin of the GNN checks no indices: one trip count a
    # chunk and look-ahead step (the tiny cells' two chunks of one step)
    assert metrics["host_reads_per_iter.plan"]["value"] == 2
    assert metrics["step_host_us.plan"]["value"] > 0
    assert not DEVICE & set(metrics)


def test_traced_tiny_train_cell_has_no_device_times(traced_on_the_cpu):
    res = run_tiny("cloth.train", seconds=1.0, trace=1)
    assert not DEVICE & set(res["metrics"]), res["metrics"]
    roots = profiling.snapshot()["roots"]
    assert roots["train.sample"] and roots["train.step"]
    assert "kernels.fps" in roots["train.sample"][-1]["spans"]


def _iteration(reads: int, cut: bool = False) -> None:
    class Closed(Exception):
        pass

    try:
        with profiling.span("plan.iteration"):
            with profiling.span("rollout.step"):
                for _ in range(reads):
                    profiling.host_read("trip_count", torch.tensor(3))
            if cut:
                raise Closed
    except Closed:
        pass


def test_readers_count_only_the_last_windows_roots():
    """Two traced windows in a row, as after the profiler's retry: five
    iterations of three reads and a cut one, then two of one read and a
    cut one; the window's record holds two units."""
    reader = harness.metric_reader("host_reads_per_iter.plan")
    profiling.reset()
    profiling.enable()
    try:
        for reads, n in ((3, 5), (1, 2)):
            for _ in range(n):
                _iteration(reads)
            _iteration(reads, cut=True)
        assert reader.read({"units": 2}) == 1
        assert reader.read({"units": 3}) == pytest.approx(5 / 3)
        assert harness.metric_reader("step_host_us.plan").read({"units": 2}) > 0
        assert reader.read({"units": 0}) is None
        assert reader.read({"units": 20}) is None  # fewer roots than units
    finally:
        profiling.disable()
        profiling.reset()
