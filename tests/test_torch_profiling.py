"""The port's span recorder (`gsdx_torch/utils/profiling.py`) on the CPU:
off it records nothing; on it nests spans under their roots, takes self and
waited time, marks a root an exception left, keeps the last roots of a
name, and turns on by itself under a `torch.profiler` session; and the
host reads of the planning and training paths are counted in their
spans."""

import json
import time

import pytest
import torch

from gsdx_torch.dynamics.model import ModelConfig, flax_params
from gsdx_torch.dynamics.train import TrainConfig, init_params, make_train_step
from gsdx_torch.graph.dataset import EpisodeStore, GraphDatasetConfig, GraphSampler
from gsdx_torch.kernels.gnn_forward import fused_gnn_forward, pack_gnn_params
from gsdx_torch.plan.dynamics_rollout import RolloutSpec, make_batched_rollout
from gsdx_torch.plan.planner import MPPIConfig, Planner
from gsdx_torch.utils import profiling
from gsdx_torch.utils.profiling import host_read, span, trace_to

MODEL = ModelConfig(nf_particle=32, nf_relation=32, nf_effect=32, n_his=3)


@pytest.fixture
def recorder():
    profiling.reset()
    profiling.enable()
    yield profiling
    profiling.disable()
    profiling.reset()


def _roots(name):
    return profiling.snapshot()["roots"].get(name, [])


def _reads(site):
    """The ``read.<site>`` spans the kept roots hold, and such roots."""
    name = f"read.{site}"
    roots = profiling.snapshot()["roots"]
    return len(roots.get(name, [])) + sum(r["spans"].get(name, {}).get("count", 0)
                                          for kept in roots.values() for r in kept)


def test_off_records_nothing_and_returns_the_shared_object():
    profiling.reset()
    assert span("a") is span("b", torch.device("cpu")) is profiling.OFF
    with span("a"):
        with span("b"):
            pass
    assert host_read("off", torch.tensor([1, 2])) == [1, 2]
    assert profiling.snapshot() == {"roots": {}}
    profiling.reset()


def test_spans_nest_under_their_root_with_self_and_waited_time(recorder):
    for _ in range(2):
        with span("root"):
            with span("a"):
                time.sleep(0.002)
            with span("b"):
                with span("a"):
                    time.sleep(0.001)
                host_read("site", torch.arange(3))
    first, second = _roots("root")
    assert second["id"] > first["id"] and not first["cut"]
    s = first["spans"]
    assert set(s) == {"a", "b", "read.site"}
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1
    assert s["a"]["host_ms"] >= 3.0 and s["b"]["host_ms"] >= 1.0
    # a host read's time counts as waited in every span around it
    assert s["read.site"]["wait_ms"] == pytest.approx(s["read.site"]["host_ms"])
    assert s["b"]["wait_ms"] == pytest.approx(s["read.site"]["host_ms"])
    assert first["wait_ms"] == pytest.approx(s["read.site"]["host_ms"])
    assert first["device_ms"] is None and s["a"]["device_ms"] is None  # no CUDA here


def test_self_time_is_host_time_less_the_child_spans(recorder):
    with span("root"):
        with span("child"):
            time.sleep(0.003)
        time.sleep(0.002)
    (r,) = _roots("root")
    child = r["spans"]["child"]
    assert child["self_ms"] == child["host_ms"] >= 3.0
    assert r["self_ms"] == pytest.approx(r["host_ms"] - child["host_ms"])
    assert r["self_ms"] >= 2.0


def test_a_root_left_by_an_exception_is_cut(recorder):
    with pytest.raises(KeyError):
        with span("window"):
            with span("inner"):
                raise KeyError
    with span("window"):
        pass
    cut, whole = _roots("window")
    assert cut["cut"] and cut["spans"]["inner"]["count"] == 1
    assert not whole["cut"]


def test_the_last_roots_of_a_name_are_kept(recorder):
    for _ in range(profiling.KEEP + 5):
        with span("many"):
            pass
    with span("other"):
        pass
    kept = _roots("many")
    assert len(kept) == profiling.KEEP
    ids = [r["id"] for r in kept]
    assert ids == sorted(ids) and ids[-1] - ids[0] == profiling.KEEP - 1
    assert len(_roots("other")) == 1


def test_on_by_itself_under_a_profiler_session():
    from torch.profiler import ProfilerActivity, profile

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("under.profiler"):
            with span("leaf"):
                torch.ones(8).sum()
    with span("after"):  # off again once the session ends
        pass
    events = {e.name: e for e in prof.events()}
    assert "under.profiler" in events and "leaf" in events
    # a host operator, not a user annotation (which the device's timeline
    # would mirror as an event a trace reader counts as a kernel)
    assert not events["leaf"].is_user_annotation
    roots = profiling.snapshot()["roots"]
    assert [r["spans"]["leaf"]["count"] for r in roots["under.profiler"]] == [1]
    assert "after" not in roots
    profiling.reset()


def test_trace_to_writes_the_spans_beside_the_operators(tmp_path):
    with trace_to(str(tmp_path / "trace")):
        with span("traced.span"):
            torch.ones(8).sum()
    text = (tmp_path / "trace" / "trace.json").read_text()
    names = {e.get("name") for e in json.loads(text)["traceEvents"]}
    assert "traced.span" in names and "aten::sum" in names
    profiling.reset()


def test_a_host_read_outside_any_span_is_a_root_of_its_own(recorder):
    assert host_read("alone", torch.tensor([[1.5], [2.5]])) == [[1.5], [2.5]]
    (r,) = _roots("read.alone")
    assert r["spans"] == {} and r["wait_ms"] == pytest.approx(r["host_ms"])
    assert _reads("alone") == 1


def test_disable_and_reset_end_the_record(recorder):
    with span("kept"):
        pass
    profiling.disable()
    assert span("dropped") is profiling.OFF
    with span("dropped"):
        pass
    assert set(profiling.snapshot()["roots"]) == {"kept"}
    profiling.reset()
    assert profiling.snapshot() == {"roots": {}}


def _acts(B, L, gen):
    lo = torch.tensor([-0.1, -0.1, -3.0, 2.0])
    hi = torch.tensor([0.1, 0.1, 3.0, 5.0])
    return lo + (hi - lo) * torch.rand(B, L, 4, generator=gen)


@pytest.mark.parametrize("sort_chunks,look_ahead", [(2, 2), (1, 3)])
def test_cpu_rollout_reads_one_trip_count_a_chunk_and_look_ahead_step(
        recorder, sort_chunks, look_ahead):
    gen = torch.Generator().manual_seed(0)
    model = init_params(MODEL, 0, "cpu")
    spec = RolloutSpec(max_nobj=12, max_nR=40, topk=3, max_repeat=5,
                       sort_chunks=sort_chunks, fused="twin")
    state = 0.05 * torch.randn(12, 3, generator=gen)
    before = _reads("trip_count")
    make_batched_rollout(model, spec)(state, _acts(8, look_ahead, gen))
    assert _reads("trip_count") - before == sort_chunks * look_ahead
    assert _reads("gnn_indices") == 0  # the plain twin checks no indices
    chunks = _roots("rollout.chunk")
    assert len(chunks) == sort_chunks
    for c in chunks:
        s = c["spans"]
        assert s["read.trip_count"]["count"] == look_ahead
        assert s["rollout.step"]["count"] == s["graph.edges"]["count"] == \
            s["rollout.advance"]["count"] >= look_ahead
        assert {"rollout.head", "rollout.pad", "rollout.gnn"} <= set(s)


def test_fused_gnn_forward_on_cpu_reads_the_indices_once_a_call(recorder):
    gen = torch.Generator().manual_seed(1)
    packed = pack_gnn_params(flax_params(init_params(MODEL, 1, "cpu"), as_numpy=False),
                             n_his=3, device=torch.device("cpu"))
    B, n_pad, E = 2, 128, 16
    attrs, action = torch.zeros(B, n_pad, 2), torch.zeros(B, n_pad, 3)
    attrs[:, :10, 0] = 1
    state_t = 0.05 * torch.randn(B, n_pad, 9, generator=gen)
    g = torch.zeros(B, n_pad, 1)
    recv = torch.randint(0, 11, (B, E), generator=gen, dtype=torch.int32).sort(1).values
    send = torch.randint(0, 11, (B, E), generator=gen, dtype=torch.int32)
    before = _reads("gnn_indices")
    for _ in range(3):
        fused_gnn_forward(packed, attrs, action, state_t, g, recv, send)
    assert _reads("gnn_indices") - before == 3
    (check,) = _roots("gnn.check")[-1:]
    assert check["spans"]["read.gnn_indices"]["count"] == 1


def test_kernel_route_rollout_reads_its_error_word_once_a_call(recorder, monkeypatch):
    """The kernels' route on CPU tensors, with the push step's forward
    wrapped by name as the MPPI benchmark's probe wraps it: every step's
    indices are checked into the call's error word, read once a call."""
    from gsdx_torch.kernels import gnn_forward as G
    from gsdx_torch.plan import dynamics_rollout as DR

    monkeypatch.setattr(DR, "fused_route", lambda *a, **kw: True)
    seen, forward = [], DR.fused_gnn_forward

    def probe(packed, attrs, action, state_t, g, recv, send, *a, **kw):
        out = forward(packed, attrs, action, state_t, g, recv, send, *a, **kw)
        kept = (attrs, action, state_t, g, recv, send, out)
        seen.append((kept, [t.clone() for t in kept]))
        return out

    monkeypatch.setattr(DR, "fused_gnn_forward", probe)
    gen = torch.Generator().manual_seed(4)
    roll = make_batched_rollout(init_params(MODEL, 4, "cpu"), RolloutSpec(
        max_nobj=12, max_nR=40, topk=3, max_repeat=5, sort_chunks=2))
    state = 0.05 * torch.randn(12, 3, generator=gen)
    before = dict(G.CHECKS)
    for calls in (1, 2):
        roll(state, _acts(8, 2, gen))
        assert _reads("gnn_errors") == calls
    assert _reads("gnn_indices") == 0
    steps = sum(c["spans"]["rollout.step"]["count"] for c in _roots("rollout.chunk"))
    assert steps >= 2 * 2 * 2 and len(seen) == steps
    assert {k: G.CHECKS[k] - before[k] for k in before} == {"host": 0, "device": steps}
    # what the probe kept is not written afterwards
    for kept, copies in seen:
        assert all(torch.equal(a, b) for a, b in zip(kept, copies))


def test_mppi_iteration_root_holds_its_layers(recorder):
    gen = torch.Generator().manual_seed(2)
    model = init_params(MODEL, 2, "cpu")
    roll = make_batched_rollout(model, RolloutSpec(max_nobj=12, max_nR=40, topk=3,
                                                   max_repeat=5, sort_chunks=2, fused="twin"))
    planner = Planner(MPPIConfig(n_sample=8, n_update_iter=2, push_length=0.01),
                      roll, lambda s, a, c: {"reward_seqs": -s[:, -1].abs().sum((1, 2))},
                      device="cpu")
    state = 0.05 * torch.randn(12, 3, generator=gen)
    res = planner.plan_chunked(gen, state, torch.tensor([[0.0, 0.0, 0.0, 3.0]]), n_chunks=2)
    assert res["act_seq"].shape == (1, 4)
    iters = _roots("plan.iteration")
    assert len(iters) == 4
    for r in iters:
        s = r["spans"]
        assert {"plan.sample", "plan.rollout", "plan.cost", "plan.update", "rollout.order",
                "rollout.chunk", "rollout.step", "graph.edges"} <= set(s)
        assert s["read.trip_count"]["count"] == 2  # two chunks of one look-ahead step
    # the best of the chunks: one read for all of them
    assert [r["spans"] for r in _roots("read.best_chunk")] == [{}]


def test_cpu_sample_and_train_step_give_their_roots(recorder):
    gen = torch.Generator().manual_seed(3)
    T, P = 10, 40
    pos = (0.1 * torch.rand(1, T, P, 3, generator=gen)).float()
    eef = torch.zeros(1, T, 1, 3)
    rows = torch.stack([torch.arange(T - 5) + j for j in range(6)], 1)
    pairs = torch.cat([torch.zeros(T - 5, 1, dtype=torch.long), rows], 1)
    cfg = GraphDatasetConfig(n_his=3, n_future=3, max_nobj=12, max_nR=48, topk=3,
                             fps_radius_range=(0.01, 0.03), adj_radius_range=(0.05, 0.09))
    sampler = GraphSampler(EpisodeStore(pos, eef, pairs), cfg, "train")
    model = init_params(MODEL, 3, "cpu")
    train_step, _, _ = make_train_step(model, TrainConfig(n_his=3, n_future=3))
    for _ in range(2):
        train_step(sampler.sample(gen, 4))
    samples, steps = _roots("train.sample"), _roots("train.step")
    assert len(samples) == len(steps) == 2
    s = samples[-1]["spans"]
    assert s["kernels.fps"]["count"] == 2 and s["graph.edges"]["count"] == 1
    assert samples[-1]["device_ms"] is None  # timed on the device on CUDA only
    assert set(steps[-1]["spans"]) == {"train.unroll", "train.backward", "train.adam"}
    assert _reads("train_loss") == 0  # a step reads nothing back
