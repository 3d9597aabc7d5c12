"""GNS (`gsdx_torch.dynamics.gns`), its radius graph (`graph/radius.py`)
and its window sampler (`graph/dataset.py`) against the plain reference
the benchmark checks it with (`perfbench/reference/gns.py`), on the CPU,
at the published widths (latent 128, two hidden layers, a 16-wide
embedding of 9 types) with 2 blocks and a few hundred particles.

Tolerances: the port and the reference compute the same sums in another
order (the edge MLP's first layer node-side against one 384-wide product;
receiver sums by a CSR product against `index_add_`), so they agree to f32
rounding grown through the blocks, LayerNorm and the backward: ``RTOL`` of
each tensor's largest entry. The graphs and the noise are exact.
"""

from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch

from gsdx_torch.dynamics import gns
from gsdx_torch.dynamics.train import TrainConfig, make_train_step
from gsdx_torch.graph import radius
from gsdx_torch.graph.dataset import (EpisodeStore, WindowSampler, random_walk_noise,
                                      window_rows)
from gsdx_torch.io.config import load_config
from perfbench.reference import gns as ref

torch.set_num_threads(min(2, torch.get_num_threads()))

# f32 sums in another order, through two blocks, LayerNorm and the backward
RTOL = 2e-5
R = 0.1
CONFIG = gns.GNSConfig(message_passing_steps=2, connectivity_radius=R)


def cloud(g, B, P, side=0.4):
    return 0.3 + side * torch.rand(B, P, 3, generator=g)


def brute(pos, r):
    """Every (receiver, sender) of one (n, 3) cloud with d^2 <= R^2."""
    d = pos[:, None, :] - pos[None, :, :]
    sq = d * d
    keep = ((sq[..., 0] + sq[..., 1]) + sq[..., 2]) <= radius.f32_square(r)
    return {tuple(e) for e in keep.nonzero().tolist()}


def as_sets(recv, send):
    out = []
    for r, s in zip(recv, send):
        keep = r >= 0
        assert (s[keep] >= 0).all() and (s[~keep] == -1).all()
        pairs = list(zip(r[keep].tolist(), s[keep].tolist()))
        assert len(pairs) == len(set(pairs))  # no edge twice
        assert keep.sum() == 0 or keep[:int(keep.sum())].all()  # padding after the edges
        out.append(set(pairs))
    return out


def test_radius_graph_is_brute_force_with_padding_and_one_read(monkeypatch):
    """Two clouds of different density: different edge counts, the shorter
    padded with -1; self-edges kept; one host read a build."""
    reads = []
    orig = radius.host_read
    monkeypatch.setattr(radius, "host_read", lambda site, t: reads.append(site) or orig(site, t))
    g = torch.Generator().manual_seed(0)
    pos = torch.stack([cloud(g, 1, 400, 0.5)[0], cloud(g, 1, 400, 0.3)[0]])
    graph = radius.RadiusGraph(R, capacity=64)
    recv, send = graph(pos)
    assert recv.dtype == send.dtype == torch.int32 and recv.shape == send.shape
    got = as_sets(recv, send)
    for b in range(2):
        want = brute(pos[b], R)
        assert got[b] == want
        assert all((i, i) in want for i in range(400))
    counts = [len(s) for s in got]
    assert counts[0] != counts[1] and recv.shape[1] == max(counts)
    assert graph.edges == sum(counts) and graph.slots == 2 * max(counts)
    assert reads == ["gns_edges"]


def test_radius_graph_grows_its_capacity_and_keeps_its_edges():
    g = torch.Generator().manual_seed(1)
    pos = cloud(g, 1, 300, 0.25)
    small, roomy = radius.RadiusGraph(R, capacity=1), radius.RadiusGraph(R, capacity=256)
    a, b = small(pos), roomy(pos)
    assert small.capacity > 1
    assert as_sets(*a) == as_sets(*b) == [brute(pos[0], R)]


def test_radius_graph_edge_cases():
    """A pair at exactly R (d^2 == R^2 in f32) is an edge and one a step of
    the last bit farther is not; an isolated particle keeps its self-edge;
    particles on the cell list's faces see across them."""
    r32 = np.float32(R)
    far = np.nextafter(r32, np.float32(1))
    # x and 2x differ by x exactly: one pair R apart, one a last bit farther
    pts = [[r32, 0.5, 0.5], [2 * r32, 0.5, 0.5],
           [far, 0.2, 0.2], [2 * far, 0.2, 0.2],
           [0.9, 0.9, 0.9]]  # alone
    pos = torch.tensor(np.array(pts, np.float32))
    d = pos[1] - pos[0], pos[3] - pos[2]
    assert float((d[0] * d[0]).sum()) == radius.f32_square(R)
    assert float((d[1] * d[1]).sum()) > radius.f32_square(R)
    side = np.float32(R * radius._SLACK)
    face = [[side * i, side * j, side * k] for i in range(4) for j in range(3) for k in (0, 1)]
    pos = torch.cat([pos, torch.tensor(face, dtype=torch.float32) + 0.05])
    (got,) = as_sets(*radius.RadiusGraph(R)(pos[None]))
    assert got == brute(pos, R)
    assert (0, 1) in got and (1, 0) in got
    assert (2, 3) not in got and (3, 2) not in got
    assert {e for e in got if 4 in e} == {(4, 4)}


def test_random_walk_noise_per_step_std():
    """Velocity noise whose steps have std sigma / sqrt(5), summed into a
    walk whose last velocity has std sigma, integrated into positions with
    none on the first frame."""
    sigma = 6.7e-4
    noise = random_walk_noise(torch.Generator().manual_seed(2), (4, 6, 20000, 3), sigma, "cpu")
    assert (noise[:, 0] == 0).all()
    velocity = noise[:, 1:] - noise[:, :-1]
    steps = torch.cat([velocity[:, :1], velocity[:, 1:] - velocity[:, :-1]], 1)
    # 240,000 draws a step: the sample std is within 1% of the true one
    np.testing.assert_allclose(steps.std(dim=(0, 2, 3)).numpy(), sigma / 5 ** 0.5, rtol=0.01)
    np.testing.assert_allclose(float(velocity[:, -1].std()), sigma, rtol=0.01)


def test_window_sampler_draws_windows_and_replays_in_the_reference():
    g = torch.Generator().manual_seed(3)
    E, T, P = 2, 11, 50
    pos = torch.rand(E, T, P, 3, generator=g)
    rows = window_rows(E, T, 7, "cpu")
    assert rows.shape == (E * (T - 6), 8)
    assert (rows[:, 2:] - rows[:, 1:-1] == 1).all()
    types = torch.full((P,), 5)
    types[:10] = 3  # kinematic
    sampler = WindowSampler(EpisodeStore(pos, pos.new_zeros(E, T, 0, 3), rows), types, 6.7e-4)
    state = torch.Generator().manual_seed(4).get_state()
    batch = sampler.sample(torch.Generator().set_state(state), 3)
    d = ref.draws(torch.Generator().set_state(state), rows.shape[0], 3, 7, P, 6.7e-4, "cpu")
    window, noise = ref.batch(pos, rows, d, types != 3)
    assert torch.equal(batch.position, window) and torch.equal(batch.noise, noise)
    assert (batch.noise[:, :, :10] == 0).all() and (batch.noise[:, 1:, 10:] != 0).all()
    assert torch.equal(batch.particle_type, types.expand(3, P))
    for b, r in enumerate(rows[d["rows"]]):
        assert torch.equal(batch.position[b], pos[r[0], r[1:]])


def model_and_batch(seed=0, B=2, P=300, steps=2):
    """A GNS of ``CONFIG`` with nonzero biases and LayerNorm offsets (as
    trained), normalisation statistics, and a noisy batch of windows."""
    g = torch.Generator().manual_seed(seed)
    model = gns.GNS(CONFIG._replace(message_passing_steps=steps), generator=g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or ".norm." in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    walk = cloud(g, B, P)[:, None] + torch.cumsum(0.003 * torch.randn(B, 7, P, 3, generator=g), 1)
    model.set_statistics(gns.statistics(walk, CONFIG.noise_std))
    noise = random_walk_noise(g, (B, 6, P, 3), CONFIG.noise_std, "cpu")
    types = torch.randint(0, 9, (B, P), generator=g)
    return model, walk, noise, types


def reference_model(model):
    return model.cfg._asdict(), {k: v.detach() for k, v in model.state_dict().items()}


def close(got, want, rtol=RTOL):
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0,
                               atol=rtol * scale)


def test_forward_matches_the_reference():
    model, walk, noise, types = model_and_batch()
    inputs = walk[:, :-1] + noise
    cfg, weights = reference_model(model)
    want, (recv, send) = ref.forward(weights, cfg, inputs, types)
    got = model(inputs, types)
    close(got, want)
    # the port's graph is the reference's
    r, s = model.graph.last
    P = inputs.shape[2]
    keys = ref.edge_key(*[(x.long() + torch.arange(2)[:, None] * P)[r >= 0] for x in (r, s)], P)
    assert torch.equal(torch.sort(keys).values, torch.sort(ref.edge_key(recv, send, P)).values)


@pytest.mark.parametrize("steps", [2, 3])
def test_loss_and_every_gradient_match_the_reference(steps):
    model, walk, noise, types = model_and_batch(seed=steps, steps=steps)
    batch = type("Batch", (), {"position": walk, "noise": noise, "particle_type": types})
    loss, parts = gns.one_step_loss(model, batch)
    loss.backward()
    cfg, weights = reference_model(model)
    trained = [n for n, _ in model.named_parameters()]
    leaves = {k: weights[k].clone().requires_grad_(True) for k in trained}
    want, _ = ref.loss({**weights, **leaves}, cfg, walk, noise, types)
    # a mean of squared errors: the f32 rounding of its terms, averaged
    np.testing.assert_allclose(float(loss.detach()), float(want.detach()), rtol=1e-6)
    assert torch.equal(parts["mse"], loss)
    grads = torch.autograd.grad(want, list(leaves.values()))
    named = dict(model.named_parameters())
    for k, g in zip(trained, grads):
        assert named[k].grad is not None, k
        close(named[k].grad, g)


def test_initialisation_is_the_references():
    """The port's fresh GNS at the published widths has the reference's
    leaves and shapes (`ref.init_weights`, what the benchmark loads) and
    both draw from the same initialisers: linear weights a normal of std
    1/sqrt(fan_in) truncated at two deviations, zero biases, LayerNorm 1
    and 0, the embedding Glorot uniform. Draws differ, so moments are
    compared: each sample deviation within 6 of its own standard errors
    (about 1/sqrt(2n) of it for n draws; a uniform's 0.45/sqrt(n))."""
    cfg = gns.GNSConfig()
    port = {n: p.detach() for n, p in gns.GNS(
        cfg, generator=torch.Generator().manual_seed(0)).named_parameters()}
    want = ref.init_weights(cfg._asdict(), torch.Generator().manual_seed(1), "cpu")
    assert list(port) == list(want)
    for name, w in want.items():
        for x in (port[name], w):
            assert x.shape == w.shape, name
            if name == "type_embedding":
                b = math.sqrt(6.0 / sum(x.shape))
                assert float(x.abs().max()) <= b
                spread = 6 * 0.45 / math.sqrt(x.numel())
                assert abs(float(x.std()) / (b / math.sqrt(3)) - 1) < spread
            elif name.endswith("weight") and ".linears." in name:
                sigma = 1 / math.sqrt(x.shape[1])
                assert float(x.abs().max()) <= 2 * sigma * (1 + 1e-6), name
                # the std of a unit normal truncated at two deviations
                assert abs(float(x.std()) / (0.8796256610342398 * sigma) - 1) < 6 / math.sqrt(
                    2 * x.numel()), name
                assert abs(float(x.mean())) < 6 * sigma / math.sqrt(x.numel()), name
            else:  # biases and LayerNorm offsets 0, LayerNorm scales 1
                assert torch.equal(x, torch.full_like(x, float(name.endswith("norm.weight")))), name


def test_make_train_step_trains_gns_with_the_decayed_rate():
    model, walk, noise, types = model_and_batch(seed=5)
    batch = type("Batch", (), {"position": walk, "noise": noise, "particle_type": types})
    schedule = gns.learning_rate(model.cfg._replace(lr_decay_steps=3), 1e-4)
    step, eval_step, optimizer = make_train_step(model, TrainConfig(lr=1e-4), gns.one_step_loss,
                                                 schedule)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = [float(step(batch)[0]) for _ in range(3)]
    assert np.isfinite(losses).all()
    # three steps of a decay by a tenth every three: 1e-4 -> 1e-5 + 1e-6 x 0.9
    assert optimizer.param_groups[0]["lr"] == schedule(3) == pytest.approx(1.09e-5)
    assert all(not torch.equal(before[n], p) for n, p in model.named_parameters())
    with torch.no_grad():
        again = float(gns.one_step_loss(model, batch)[0])
    assert float(eval_step(batch)[0]) == again


def test_published_widths_from_the_yaml():
    train, model, data = load_config(os.path.join(os.path.dirname(__file__), "..", "configs",
                                                  "gns_water3d.yaml"))
    assert isinstance(model, gns.GNSConfig)
    assert (model.latent_size, model.hidden_layers, model.message_passing_steps) == (128, 2, 10)
    assert (model.n_his, model.particle_types, model.type_embedding) == (6, 9, 16)
    assert model.bounds == ((0.0, 1.0),) * 3 and model.noise_std == 6.7e-4
    assert (train.batch_size, train.lr, model.lr_final, model.lr_decay_steps) == (
        2, 1e-4, 1e-6, 5000000)
    net = gns.GNS(model)
    assert gns.node_input_dim(model) == 37
    assert len(net.blocks) == 10
    assert net.blocks[0].edge_mlp.linears[0].weight.shape == (128, 384)
    assert net.blocks[0].node_mlp.linears[0].weight.shape == (128, 256)
    assert 1.5e6 < sum(p.numel() for p in net.parameters()) < 1.7e6


def test_train_cli_trains_gns_from_its_yaml(tmp_path, monkeypatch):
    """`apps.train --config <gns yaml>` on the CPU: windows of the episodes'
    trajectories, checkpoints of the GNS weights and their Adam state."""
    from gsdx_torch.apps import train as app
    from gsdx_torch.io.checkpoint import load_checkpoint

    rng = np.random.default_rng(6)
    name = "episodes_water3d"
    for e in range(3):
        ep = f"episode_{e:02d}"
        out = tmp_path / "data" / "ckpts" / f"exp_{name}" / ep / name / ep
        out.mkdir(parents=True)
        xyz = 0.4 + 0.2 * rng.random((1, 60, 3)) + np.cumsum(
            rng.normal(scale=0.002, size=(9, 60, 3)), 0)
        np.save(out / "param_downsampled.npy", xyz.astype(np.float32))
    src = open(os.path.join(os.path.dirname(__file__), "..", "configs", "gns_water3d.yaml")).read()
    cfg = tmp_path / "gns.yaml"
    cfg.write_text(src.replace('"log/gns_water3d"', f'"{tmp_path / "log"}"')
                   .replace('"data/gns"', f'"{tmp_path / "data"}"')
                   .replace("n_epochs: 1000", "n_epochs: 1")
                   .replace("train: 100", "train: 2").replace("valid: 10", "valid: 1")
                   .replace("connectivity_radius: 0.035", "connectivity_radius: 0.1"))
    monkeypatch.chdir(tmp_path)
    app.main(["--config", str(cfg), "--device", "cpu"])
    ckpt = tmp_path / "log" / "checkpoints"
    params = load_checkpoint(str(ckpt / "latest.ckpt"))["params"]
    assert params["blocks"]["9"]["edge_mlp"]["linears"]["0"]["weight"].shape == (128, 384)
    assert params["vel_std"].shape == (3,)
    optim = load_checkpoint(str(ckpt / "latest_optim.ckpt"))["0"]
    assert int(optim["count"]) == 2
