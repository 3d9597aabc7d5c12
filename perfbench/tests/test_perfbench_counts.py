"""The yardstick's arithmetic: the GNN's operations and bytes, the trace's
busy time and breakdown, the seeded inputs."""

from __future__ import annotations

import math

import pytest
import torch
from tinycells import harness

from perfbench import flops, scenes, trace
from perfbench.drivers import mppi


def _model(nf: int, state_dim: int = 0, motion_dim: int = 0) -> dict:
    cfg = harness.load_json(harness.ROOT / "perfbench/configs/rope.json")
    m = mppi.model_dict(cfg)
    m.update(nf_particle=nf, nf_relation=nf, nf_effect=nf, state_dim=state_dim,
             motion_dim=motion_dim)
    return m


@pytest.mark.parametrize("state_dim,motion_dim", [(0, 0), (1, 3)])
def test_gnn_flops_match_the_modules_products(state_dim, motion_dim):
    """At a small width, the port's `DynamicsPredictor` forward under
    `FlopCounterMode` counts the products `flops.gnn_products` lists, plus
    its one-hot relation selections (which the least work does not need)."""
    from torch.utils.flop_counter import FlopCounterMode

    from gsdx_torch.dynamics.model import DynamicsPredictor, ModelConfig

    m = _model(16, state_dim, motion_dim)
    n_obj, n_rel, B = 6, 9, 1
    N = n_obj + 1
    net = DynamicsPredictor(ModelConfig(**{k: m[k] for k in ModelConfig._fields}))
    g = torch.Generator().manual_seed(0)
    recv = torch.randint(0, N, (B, n_rel), generator=g)
    send = torch.randint(0, N, (B, n_rel), generator=g)
    Rr = torch.nn.functional.one_hot(recv, N).float()
    Rs = torch.nn.functional.one_hot(send, N).float()
    state = torch.randn(B, m["n_his"], N, 3, generator=g)
    attrs = torch.zeros(B, N, 2)
    with FlopCounterMode(display=False) as counter:
        net(state, attrs, Rr, Rs, torch.ones(B, n_obj, 1), torch.zeros(B, N, 3))
    nf, d = m["nf_effect"], 3 * m["n_his"]
    one_hot = 2 * n_rel * N * (2 * 2 + 2 * 1 + 2 * d)  # attrs, group, positions
    one_hot += m["pstep"] * 2 * n_rel * N * nf * 3  # receivers, senders, aggregation
    products = sum(2 * r * i * o for r, i, o in flops.gnn_products(m, N, n_rel, n_obj))
    assert counter.get_total_flops() == products + one_hot
    adds = m["pstep"] * 3 * n_rel * nf
    assert flops.gnn_step_flops(m, N, n_rel, n_obj) == products + adds


def test_gnn_bytes_are_a_sample_steps_inputs_and_outputs():
    m = _model(512)
    got = flops.gnn_step_bytes(m, 101, 500, 100)
    assert got == 4 * 101 * (9 + 2 + 3) + 2 * 4 * 500 + 4 * 100 * 3


def test_published_rope_step_is_compute_bound_at_1_5_gflop():
    cfg = harness.load_json(harness.ROOT / "perfbench/configs/rope.json")
    m = mppi.model_dict(cfg)
    n = flops.gnn_step_flops(m, *flops.plan_shapes(cfg))
    assert 1.4e9 < n < 1.7e9
    assert flops.bound_s(n, flops.gnn_step_bytes(m, *flops.plan_shapes(cfg))) == n / 989e12


def test_busy_union_and_gaps():
    kernels = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 30.0), ("d", 31.0, 35.0)]
    busy, gaps = trace.busy_union(kernels)
    assert math.isclose(busy, 26e-6)
    assert gaps == [(12.0, 20.0), (30.0, 31.0)]


def test_breakdown_names_the_host_op_in_each_long_gap():
    kernels = [("k1", 0.0, 10.0), ("k2", 110.0, 120.0), ("k1", 121.0, 125.0)]
    host = [("aten::item", 5.0, 115.0), ("cudaLaunchKernel", 100.0, 109.0)]
    _, gaps = trace.busy_union(kernels)
    out = trace.breakdown(kernels, host, gaps)
    assert out["device_ops"][0][0] == "k1" and math.isclose(out["device_ops"][0][1], 14e-6)
    assert out["idle_gaps"][0][0] == "aten::item"
    assert any(name.startswith("gaps under") for name, _ in out["idle_gaps"])
    assert trace.missed_launches(kernels, {"k1": 2, "k2": 2}) == {"k2": (2, 1)}


@pytest.mark.parametrize("kind", ["rope", "cloth"])
def test_seeded_inputs_repeat_per_seed_and_differ_between_seeds(kind):
    cfg = harness.load_json(harness.ROOT / f"perfbench/configs/{kind}.json")
    m = mppi.model_dict(cfg)
    obj = cfg["object"]
    dev = torch.device("cpu")

    def draw(seed):
        w = scenes.gnn_weights(m, scenes.generator(seed, 1, dev), dev, 0.1)
        s = scenes.OBJECTS[kind](scenes.generator(seed, 2, dev), 2, 50, obj, dev)
        return w, s, scenes.target_pushes(scenes.generator(seed, 3, dev), s, obj)

    big = 2**31 + 123457
    a, b, c = draw(big), draw(big), draw(big + 1)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k])
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert not torch.equal(a[1], c[1])
    assert not torch.equal(a[0]["relation_propagator.kernel"],
                           c[0]["relation_propagator.kernel"])


def test_seeded_tracking_scene_repeats_per_seed():
    cfg = harness.load_json(harness.ROOT / "perfbench/configs/rope.json")
    sc = dict(cfg["tracking_scene"], points=64)
    dev = torch.device("cpu")
    one = scenes.tracking_cloud(scenes.generator(2**31 + 9, 11, dev), sc, dev)
    two = scenes.tracking_cloud(scenes.generator(2**31 + 9, 11, dev), sc, dev)
    other = scenes.tracking_cloud(scenes.generator(2**31 + 10, 11, dev), sc, dev)
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    assert not torch.equal(one[0], other[0])
