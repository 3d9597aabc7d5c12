"""gsdx_torch.dynamics (utils, train) and the optimizer-state checkpoints
against gsdx on the CPU, at small widths.

The trainers draw their batches from different generators, so the port's
unroll is compared on batches gsdx's sampler built (injected). The JAX
side runs under `jax.jit`."""

import dataclasses
import os

import jax
import numpy as np
import optax
import pytest
import torch

from gsdx.dynamics import utils as jutils
from gsdx.dynamics.model import DynamicsPredictor as JModel
from gsdx.dynamics.model import ModelConfig as JModelConfig
from gsdx.dynamics.train import TrainConfig as JTrainConfig
from gsdx.dynamics.train import init_params as j_init_params
from gsdx.dynamics.train import unrolled_loss as j_unrolled_loss
from gsdx.graph import dataset as jds
from gsdx.io.checkpoint import load_checkpoint as j_load_checkpoint
from gsdx.io.checkpoint import save_checkpoint as j_save_checkpoint
from gsdx_torch.dynamics import utils as tutils
from gsdx_torch.dynamics.model import (FORWARDS, DynamicsPredictor, ModelConfig,
                                       flax_params, load_flax_params, params_from_flax,
                                       reset_forwards)
from gsdx_torch.dynamics.train import TrainConfig, init_params, make_train_step, train_dynamics
from gsdx_torch.dynamics.train import unrolled_loss
from gsdx_torch.graph import dataset as tds
from gsdx_torch.io import checkpoint as tckpt
from torch_batches import port_batch

torch.set_num_threads(min(2, torch.get_num_threads()))

MODEL = dict(nf_particle=48, nf_relation=48, nf_effect=48, n_his=3)
DATA = dict(n_his=3, n_future=3, max_nobj=16, max_nR=64, topk=4,
            fps_radius_range=(0.01, 0.03), adj_radius_range=(0.05, 0.09))


def gsdx_batches(n, seed=0, batch=4):
    """``n`` gsdx batches from a sampler over a drifting 0.2 m cloud pushed
    6 mm a frame, with their port copies (index lists from gsdx's one-hot
    rows)."""
    rng = np.random.default_rng(seed)
    T, P = 12, 48
    xyz = (rng.uniform(-0.1, 0.1, size=(1, P, 3))
           + np.cumsum(rng.normal(scale=0.003, size=(T, P, 3)), 0)).astype(np.float32)
    eef = np.zeros((T, 1, 3), np.float32)
    eef[:, 0, 0] = -0.12 + 0.006 * np.arange(T)
    rows = np.array([np.clip(np.arange(t - 2, t + 4), 0, T - 1) for t in range(T)])
    pairs = np.concatenate([np.zeros((T, 1), np.int64), rows], 1)
    sampler = jds.GraphSampler(jds.EpisodeStore.from_numpy([xyz], [eef], [pairs]),
                               jds.GraphDatasetConfig(**DATA), "train")
    out = []
    for k in jax.random.split(jax.random.PRNGKey(seed), n):
        jb = sampler.sample(k, batch)
        out.append((jb, port_batch(jb)))
    return out


def models(seed=0):
    """gsdx's init params and a port model holding the same weights."""
    jm = JModel(JModelConfig(**MODEL))
    params = j_init_params(jm, JTrainConfig(n_his=3), jds.GraphDatasetConfig(**DATA),
                           jax.random.PRNGKey(seed))
    tm = load_flax_params(DynamicsPredictor(ModelConfig(**MODEL)), jax.device_get(params))
    return jm, params, tm


def grads_as_torch(tree):
    return params_from_flax(jax.device_get(tree))


@pytest.mark.parametrize("rigid_weight", [0.0, 0.05])
def test_unrolled_loss_and_gradients_match(rigid_weight):
    """The loss within rtol 1e-5; every gradient leaf within 1e-5 of its
    largest entry in `jax.value_and_grad`. gsdx multiplies by its one-hot
    rows; the port takes the batch's index lists."""
    jm, params, tm = models()
    jcfg = JTrainConfig(n_his=3, n_future=3, length_weight=0.1, rigid_weight=rigid_weight)
    tcfg = TrainConfig(n_his=3, n_future=3, length_weight=0.1, rigid_weight=rigid_weight)
    vg = jax.jit(jax.value_and_grad(lambda p, b: j_unrolled_loss(jm, p, b, jcfg),
                                    has_aux=True))
    for jb, tb in gsdx_batches(2):
        (loss_j, parts_j), grads_j = vg(params, jb)
        tm.zero_grad()
        reset_forwards()
        loss_t, parts_t = unrolled_loss(tm, tb, tcfg)
        loss_t.backward()
        assert FORWARDS == {"indexed": tcfg.n_future, "one_hot": 0}
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        for k in ("mse", "length", "rigid"):
            np.testing.assert_allclose(float(parts_t[k]), float(parts_j[k]), rtol=1e-5,
                                       atol=1e-12)
        if rigid_weight:
            assert float(parts_t["rigid"]) > 0
        for name, g in grads_as_torch(grads_j).items():
            got = dict(tm.named_parameters())[name].grad
            scale = float(g.abs().max())
            np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=0,
                                       atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("fixed_scale", [True, False])
def test_umeyama_matches(rng, fixed_scale):
    B, N = 6, 30
    src = rng.normal(size=(B, N, 3)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, size=B)
    R = np.stack([[[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
                  for a in ang]).astype(np.float32)
    dst = (1.3 * np.einsum("bij,bnj->bni", R, src) + rng.normal(size=(B, 1, 3))
           + rng.normal(scale=0.01, size=(B, N, 3))).astype(np.float32)
    mask = rng.uniform(size=(B, N)) > 0.2
    out_t = tutils.umeyama(torch.from_numpy(src), torch.from_numpy(dst),
                           torch.from_numpy(mask), fixed_scale=fixed_scale)
    out_j = jax.jit(lambda s, d, m: jutils.umeyama(s, d, m, fixed_scale=fixed_scale))(
        src, dst, mask)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def adam_three_steps(rng):
    """Three steps of the port's optimizer (`make_train_step`'s Adam) and of
    optax's `adam` on the same gradients, tiny entries included."""
    _, params, tm = models()
    tx = optax.adam(1e-3)
    state = tx.init(params)
    _, _, opt = make_train_step(tm, TrainConfig(lr=1e-3))
    step_j = jax.jit(lambda p, s, g: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))
    for _ in range(3):
        grads = jax.tree.map(lambda x: (rng.normal(size=x.shape)
                                        * 10.0 ** rng.integers(-9, 0, size=x.shape)
                                        ).astype(np.float32), params)
        params, state = step_j(params, state, grads)
        for name, g in grads_as_torch(grads).items():
            dict(tm.named_parameters())[name].grad = g
        opt.step()
    return params, state, tm, opt


def test_adam_steps_match_optax(rng):
    """After three steps the parameters agree within 1e-6."""
    params, _, tm, _ = adam_three_steps(rng)
    for name, p in grads_as_torch(params).items():
        np.testing.assert_allclose(dict(tm.named_parameters())[name].detach().numpy(),
                                   p.numpy(), rtol=0, atol=1e-6, err_msg=name)


def test_checkpoints_and_optimizer_state_cross_both_ways(rng, tmp_path):
    """A port-written latest.ckpt and latest_optim.ckpt restore in gsdx's
    `load_checkpoint` (into optax's state), and gsdx-written ones in the
    port: after one more identical step both sides agree."""
    params, state, tm, opt = adam_three_steps(rng)
    # port -> gsdx
    tckpt.save_checkpoint(str(tmp_path / "t" / "latest.ckpt"), flax_params(tm))
    tckpt.save_checkpoint(str(tmp_path / "t" / "latest_optim.ckpt"),
                          tckpt.adam_state_tree(tm, opt))
    tx = optax.adam(1e-3)
    p_j = j_load_checkpoint(str(tmp_path / "t" / "latest.ckpt"), params)
    s_j = j_load_checkpoint(str(tmp_path / "t" / "latest_optim.ckpt"), tx.init(params))
    assert int(s_j[0].count) == 3
    for a, b in ((p_j, params), (s_j[0].mu, state[0].mu), (s_j[0].nu, state[0].nu)):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=1e-6)

    # gsdx -> port, then one more step on both sides
    j_save_checkpoint(str(tmp_path / "j" / "latest.ckpt"), params)
    j_save_checkpoint(str(tmp_path / "j" / "latest_optim.ckpt"), state)
    tm2 = DynamicsPredictor(ModelConfig(**MODEL))
    load_flax_params(tm2, tckpt.load_checkpoint(str(tmp_path / "j" / "latest.ckpt"),
                                                target=flax_params(tm2)))
    _, _, opt2 = make_train_step(tm2, TrainConfig(lr=1e-3))
    tree = tckpt.load_checkpoint(str(tmp_path / "j" / "latest_optim.ckpt"),
                                 target=tckpt.adam_state_tree(tm2, opt2))
    tckpt.load_adam_state(tm2, opt2, tree)
    grads = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), params)
    updates, _ = tx.update(grads, state, params)
    params = optax.apply_updates(params, updates)
    for name, g in grads_as_torch(grads).items():
        dict(tm2.named_parameters())[name].grad = g
    opt2.step()
    for name, p in grads_as_torch(params).items():
        np.testing.assert_allclose(dict(tm2.named_parameters())[name].detach().numpy(),
                                   p.numpy(), rtol=0, atol=1e-6, err_msg=name)


def port_store(seed=1, x0=0.0):
    """The port's `EpisodeStore` on the CPU: a drifting 0.2 m cloud and a
    pusher moving 6 mm a frame from ``x0``."""
    rng = np.random.default_rng(seed)
    T, P = 12, 48
    xyz = (rng.uniform(-0.1, 0.1, size=(1, P, 3))
           + np.cumsum(rng.normal(scale=0.003, size=(T, P, 3)), 0)).astype(np.float32)
    eef = np.zeros((T, 1, 3), np.float32)
    eef[:, 0, 0] = x0 + 0.006 * np.arange(T)
    rows = np.array([np.clip(np.arange(t - 2, t + 4), 0, T - 1) for t in range(T)])
    pairs = np.concatenate([np.zeros((T, 1), np.int64), rows], 1)
    return tds.EpisodeStore.from_numpy([xyz], [eef], [pairs], device="cpu")


def test_train_step_takes_the_index_form():
    """A train step on a `GraphSampler` batch runs n_future forwards on the
    batch's index lists and none on its one-hot rows, and its loss is the
    one-hot form's to f32 rounding."""
    sampler = tds.GraphSampler(port_store(x0=-0.12), tds.GraphDatasetConfig(**DATA), "train")
    batch = sampler.sample(torch.Generator().manual_seed(0), 4)
    assert (batch.recv >= 0).any() and (batch.recv < 0).any()
    cfg = TrainConfig(n_his=3, n_future=3, length_weight=0.1)
    model = init_params(ModelConfig(**MODEL), 0, "cpu")
    one_hot = dataclasses.replace(batch, recv=batch.Rr, send=batch.Rs)
    with torch.no_grad():
        want, _ = unrolled_loss(model, one_hot, cfg)
    train_step, _, _ = make_train_step(model, cfg)
    reset_forwards()
    loss, _ = train_step(batch)
    assert FORWARDS == {"indexed": cfg.n_future, "one_hot": 0}
    # the aggregation's sums in another order than the products': f32 rounding
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)


def test_train_dynamics_schedule_and_files(tmp_path):
    """The loop on the CPU: finite losses, the checkpoint schedule, and a
    latest.ckpt / latest_optim.ckpt pair that gsdx restores."""
    _, params, _ = models()
    store = port_store()
    dcfg = tds.GraphDatasetConfig(**DATA)
    cfg = TrainConfig(batch_size=2, n_epochs=11, n_iters_per_epoch_train=2,
                      n_iters_per_epoch_valid=1, n_his=3, n_future=3, log_interval=1,
                      out_dir=str(tmp_path / "log"))
    model, opt, hist = train_dynamics(tds.GraphSampler(store, dcfg, "train"),
                                      tds.GraphSampler(store, dcfg, "valid"),
                                      ModelConfig(**MODEL), cfg, progress=False)
    assert len(hist["train"]) == 11 and np.isfinite(hist["train"] + hist["valid"]).all()
    ckpts = sorted(os.listdir(tmp_path / "log" / "checkpoints"))
    assert ckpts == sorted([f"model_{e}.ckpt" for e in (*range(1, 10), 10)]
                           + ["latest.ckpt", "latest_optim.ckpt"])
    s_j = j_load_checkpoint(str(tmp_path / "log" / "checkpoints" / "latest_optim.ckpt"),
                            optax.adam(1e-3).init(params))
    assert int(s_j[0].count) == 22
    p_j = j_load_checkpoint(str(tmp_path / "log" / "checkpoints" / "latest.ckpt"), params)
    got = grads_as_torch(p_j)
    for name, p in model.named_parameters():
        assert torch.equal(got[name], p.detach()), name
    assert isinstance(init_params(ModelConfig(**MODEL), 0, "cpu"), DynamicsPredictor)
