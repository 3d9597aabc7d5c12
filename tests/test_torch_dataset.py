"""gsdx_torch.graph.dataset against gsdx.graph.dataset on the CPU.

gsdx draws each sample's randomness from a `jax.random` key. The test
replays those draws (in gsdx's split order) through the port's
deterministic `build_batch`, so every `GraphBatch` field is comparable:
the edges, masks and attributes integer for integer, the float fields
within 1e-6."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdx.graph import dataset as jds
from gsdx_torch.graph import dataset as tds

torch.set_num_threads(min(2, torch.get_num_threads()))

FIELDS = ("state", "action", "tool_future", "action_future", "state_future",
          "attrs", "p_instance", "obj_mask", "state_mask", "tool_mask", "Rr", "Rs")
EXACT = ("attrs", "p_instance", "obj_mask", "state_mask", "tool_mask", "Rr", "Rs")


def episodes(rng, lengths=(14, 11), n_points=60, n_cols=6):
    """Ragged episodes: a 0.2 m particle cloud drifting under a pusher that
    moves 6 mm a frame, and frame rows like `extract_pushes` gives."""
    parts, eefs, pairs = [], [], []
    for e, T in enumerate(lengths):
        base = rng.uniform(-0.1, 0.1, size=(n_points, 3)).astype(np.float32)
        walk = np.cumsum(rng.normal(scale=0.002, size=(T, n_points, 3)), 0)
        parts.append((base + walk).astype(np.float32))
        eef = np.zeros((T, 1, 3), np.float32)
        eef[:, 0, 0] = -0.12 + 0.006 * np.arange(T)
        eefs.append(eef)
        rows = np.array([np.clip(np.arange(t - 2, t - 2 + n_cols), 0, T - 1)
                         for t in range(T)], np.int64)
        pairs.append(np.concatenate([np.full((T, 1), e), rows], 1))
    return parts, eefs, pairs


def test_episode_store_from_numpy_equal(rng):
    parts, eefs, pairs = episodes(rng)
    parts[1] = parts[1][:, :45]  # fewer particles: zero padding
    ref = jds.EpisodeStore.from_numpy(parts, eefs, pairs)
    out = tds.EpisodeStore.from_numpy(parts, eefs, pairs, device="cpu")
    for f in ("particle_pos", "eef_pos", "pair_list"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)))


def replayed_draws(key, batch, n_pairs, n_points, cfg, noise):
    """gsdx's `GraphSampler.sample` draws for ``key``: the frame rows and,
    per sample, (start, radius, noise, theta, adjacency radius), in the
    order `_sample_one` takes them."""
    N = cfg.max_nobj + cfg.max_tool
    k_idx, k_batch = jax.random.split(key)
    rows = jax.random.randint(k_idx, (batch,), 0, n_pairs)

    def one(k):
        k_start, k_rad, k_noise, k_rot = jax.random.split(k, 4)
        return (jax.random.randint(k_start, (), 0, n_points),
                jax.random.uniform(k_rad, (), minval=cfg.fps_radius_range[0],
                                   maxval=cfg.fps_radius_range[1]),
                jax.random.uniform(k_noise, (cfg.n_his, N, 3), minval=-noise,
                                   maxval=noise),
                jax.random.uniform(k_rot, (), minval=-jnp.pi, maxval=jnp.pi),
                jax.random.uniform(k, (), minval=cfg.adj_radius_range[0],
                                   maxval=cfg.adj_radius_range[1]))

    draws = jax.jit(jax.vmap(one))(jax.random.split(k_batch, batch))
    t = [torch.from_numpy(np.array(d)) for d in draws]
    return np.asarray(rows), tds.SampleDraws(t[0].long(), *t[1:])


CASES = {
    "rope-like": dict(cfg=dict(n_his=3, n_future=3, max_nobj=20, max_nR=96, topk=5,
                               fps_radius_range=(0.01, 0.03), adj_radius_range=(0.05, 0.09)),
                      n_points=60, n_cols=6, phase="train"),
    "short rows": dict(cfg=dict(n_his=2, n_future=3, max_nobj=16, max_nR=64, topk=3,
                                fps_radius_range=(0.02, 0.02), adj_radius_range=(0.08, 0.08)),
                       n_points=40, n_cols=4, phase="train"),
    "few points, all edges": dict(cfg=dict(n_his=2, n_future=3, max_nobj=16, max_nR=96,
                                           topk=4, fps_radius_range=(0.0, 0.01),
                                           adj_radius_range=(0.06, 0.1), connect_all=True),
                                  n_points=12, n_cols=5, phase="valid"),
}


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_build_batch_equals_gsdx_with_draws_replayed(rng, case, seed):
    """The port's `build_batch` on gsdx's replayed draws against gsdx's sampler
    under vmap on the same key. "short rows" holds fewer frames a row than
    n_his + n_future (gsdx's indices clamp to the last), "few points" fewer
    particles than object slots."""
    spec = CASES[case]
    jcfg = jds.GraphDatasetConfig(**spec["cfg"])
    tcfg = tds.GraphDatasetConfig(**spec["cfg"])
    parts, eefs, pairs = episodes(rng, n_points=spec["n_points"], n_cols=spec["n_cols"])
    jstore = jds.EpisodeStore.from_numpy(parts, eefs, pairs)
    tstore = tds.EpisodeStore.from_numpy(parts, eefs, pairs, device="cpu")
    sampler = jds.GraphSampler(jstore, jcfg, spec["phase"])
    key = jax.random.PRNGKey(seed)
    ref = sampler.sample(key, 8)

    rows, draws = replayed_draws(key, 8, sampler.num_pairs, spec["n_points"], jcfg,
                                 sampler.noise)
    out = tds.build_batch(tstore, tstore.pair_list[torch.from_numpy(rows.copy())], draws, tcfg)
    assert out.obj_mask.any() and (out.Rr.sum((1, 2)) > 0).all()
    for f in FIELDS:
        got, want = getattr(out, f).numpy(), np.asarray(getattr(ref, f))
        assert got.shape == want.shape, f
        if f in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f)


def test_sampler_draws_and_batch(rng):
    """The port's own sampler: its draws lie in the configured ranges, a
    seeded generator repeats the batch, and the batch holds the masks'
    invariants."""
    cfg = tds.GraphDatasetConfig(n_his=3, n_future=3, max_nobj=20, max_nR=96,
                                 fps_radius_range=(0.01, 0.03), adj_radius_range=(0.05, 0.09))
    store = tds.EpisodeStore.from_numpy(*episodes(rng), device="cpu")
    draws = tds.draw_samples(torch.Generator().manual_seed(0), 64, 60, cfg, 0.003, "cpu")
    assert draws.start.min() >= 0 and draws.start.max() < 60
    assert 0.01 <= draws.radius.min() and draws.radius.max() < 0.03
    assert draws.noise.abs().max() <= 0.003 and draws.theta.abs().max() <= math.pi
    sampler = tds.GraphSampler(store, cfg, "train")
    a = sampler.sample(torch.Generator().manual_seed(3), 4)
    b = sampler.sample(torch.Generator().manual_seed(3), 4)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.state_mask[:, :20], a.obj_mask) and a.tool_mask[:, 20:].all()
    assert torch.equal(a.Rr.sum(2) > 0, a.Rs.sum(2) > 0)
    moved = a.to("cpu")
    assert isinstance(moved, tds.GraphBatch) and torch.equal(moved.Rr, a.Rr)
