"""`correct`: tiny cells run through the harness on the CPU come out correct,
and come out not correct with the timed path broken underneath (a step that
returns its state unchanged, half of the batch left out, an answer altered
where it is produced) or with the control (the reference one precision
below the configuration's) in the program's place."""

from __future__ import annotations

import importlib

import pytest
import torch
from tinycells import bench_with_staged, harness, run_tiny, tiny

from perfbench import control


def test_plan_cells_are_correct():
    for cell in ("rope.plan", "cloth.plan"):
        res = run_tiny(cell, seconds=3.0)
        assert res["correct"], res["checked"]
        assert res["attempted"] > 0
        assert {"mppi_iter_ms", "setup_s"} <= set(res["metrics"])


def _break_rollout(fault):
    def hook(cell):
        orig = cell.program_rollout

        def broken(state, acts, **kw):
            B = acts.shape[0]
            if fault == "half":
                out = orig(state, acts[:B // 2], **kw)
                seqs = out["state_seqs"]
                return {"state_seqs": torch.cat([seqs, seqs]), "action_seqs":
                        torch.cat([out["action_seqs"], out["action_seqs"]])}
            out = orig(state, acts, **kw)
            seqs = out["state_seqs"].clone()
            if fault == "unchanged":
                seqs[:] = state
            else:
                seqs[B // 3, 0, 0, 0] += 0.01
            return dict(out, state_seqs=seqs)

        cell.program_rollout = broken
    return hook


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_plan_check_catches_a_broken_rollout(fault):
    res = run_tiny("rope.plan", seconds=3.0, cell_hook=_break_rollout(fault))
    assert not res["correct"], res["checked"]


def _first_chunk(self, generator, state_cur, init_act_seq, n_chunks=10):
    return self.trajectory_optimization(generator, state_cur, init_act_seq)


@pytest.mark.parametrize("fault", ["update", "choice"])
def test_plan_check_catches_a_broken_planner(fault, monkeypatch):
    """The mean left where it was; the action of the first chunk returned
    in place of the best chunk's."""
    from gsdx_torch.plan import planner

    if fault == "update":
        monkeypatch.setattr(planner, "optimize_action_mppi", lambda acts, *a, **kw: acts[0])
    else:
        monkeypatch.setattr(planner.Planner, "plan_chunked", _first_chunk)
    res = run_tiny("rope.plan", seconds=3.0)
    assert not res["correct"], res["checked"]


def test_track_cell_is_correct():
    """rope.track waits in staged.json (PERF.md); its code stays tested."""
    res = run_tiny("rope.track", seconds=0.5)
    assert res["correct"], res["checked"]
    assert {"track_iters_per_s", "setup_s"} <= set(res["metrics"])


def _unchanged_step(self, grads, state, params, lrs):
    return params, state


def _half_l1(x, y):
    h = x.shape[-2] // 2
    return torch.where(x[..., :h, :] >= y[..., :h, :], x[..., :h, :] - y[..., :h, :],
                       y[..., :h, :] - x[..., :h, :]).mean()


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_track_check_catches_a_broken_fit(fault, monkeypatch):
    from gsdx_torch.track import losses, optimizer

    rasterize = importlib.import_module("gsdx_torch.render.rasterize")

    if fault == "unchanged":
        monkeypatch.setattr(optimizer.GroupAdam, "update", _unchanged_step)
    elif fault == "half":
        monkeypatch.setattr(losses, "l1_loss", _half_l1)
    else:
        orig = rasterize.composite_fwd

        def altered(*args, **kw):
            out = list(orig(*args, **kw))
            out[0] = out[0].clone()
            out[0][0] += 0.2  # the first tile's every channel
            return tuple(out)

        monkeypatch.setattr(rasterize, "composite_fwd", altered)
    res = run_tiny("rope.track", seconds=0.5)
    assert not res["correct"], res["checked"]


def test_train_cell_is_correct():
    res = run_tiny("cloth.train")
    assert res["correct"], res["checked"]
    assert {"train_samples_per_s", "setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_train_check_catches_a_broken_step(fault, monkeypatch):
    from gsdx_torch.dynamics import train
    from gsdx_torch.graph import dataset

    if fault == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half":
        monkeypatch.setattr(train, "mse_loss", lambda p, g: torch.mean(
            (p[:p.shape[0] // 2] - g[:g.shape[0] // 2]) ** 2))
    else:
        orig = dataset.build_batch

        def altered(*args, **kw):
            b = orig(*args, **kw)
            b.state_future[0, 0, 0, 0] += 0.01
            return b

        monkeypatch.setattr(dataset, "build_batch", altered)
    res = run_tiny("cloth.train")
    assert not res["correct"], res["checked"]


# the training cell's control is TF32, which only the card has; the card's
# test (test_perfbench_cuda.py) holds it
@pytest.mark.parametrize("workload", ["rope.plan", "cloth.plan", "rope.track"])
def test_the_control_fails_the_check(workload):
    """The control's numbers pass a limit: it can only be rejected."""
    bench = bench_with_staged()
    spec = harness.resolve(bench, workload)
    limits = spec["config"]["limits"][spec["mix"]["driver"]]
    rows = {r["side"]: r for r in control.readings(workload, [2**31 + 5], [2**31 + 5], 0.5,
                                                   require_card=False, bench=bench,
                                                   overrides=tiny(workload))}
    for side, passes in (("program", True), ("control", False)):
        numbers = rows[side]["numbers"]
        over = [n for n, v in numbers.items() if not v <= limits[n]]
        assert (not over) == passes, (side, numbers)
