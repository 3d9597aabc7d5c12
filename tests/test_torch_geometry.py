"""Perception geometry (`gsdx_torch/core/pointcloud.py` `depth2fgpcd`,
`segment_plane`) against gsdx's on the same inputs; the RANSAC draws of
gsdx's `jax.random.randint` are handed to the port as ``idx``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdx.core import pointcloud as jpc
from gsdx_torch.core import pointcloud as tpc


def test_depth2fgpcd_matches_gsdx(rng):
    depth = rng.uniform(0.5, 1.5, size=(24, 32)).astype(np.float32)
    depth[3:6, 4:9] = 0.0  # no reading
    mask = rng.uniform(size=(24, 32)) > 0.3
    k = np.array([[40.0, 0, 15.5], [0, 41.0, 12.0], [0, 0, 1]], np.float32)
    pj, vj = jpc.depth2fgpcd(jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(k))
    pt, vt = tpc.depth2fgpcd(torch.as_tensor(depth), torch.as_tensor(mask),
                             torch.as_tensor(k))
    # (x - cx) * z / fx in f32 on both sides, metres ~1: 1e-6
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("with_valid", [False, True])
def test_segment_plane_matches_gsdx_with_its_draws(rng, with_valid):
    n, n_iters = 600, 64
    table = np.concatenate([rng.uniform(-0.5, 0.5, size=(400, 2)),
                            rng.normal(0, 0.002, size=(400, 1))], 1)
    clutter = rng.uniform(-0.5, 0.5, size=(200, 3))
    pts = np.concatenate([table, clutter]).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1 if with_valid else None
    key = jax.random.PRNGKey(3)
    plane_j, inl_j = jpc.segment_plane(
        jnp.asarray(pts), 0.01, key, valid=None if valid is None else jnp.asarray(valid),
        n_iters=n_iters)
    idx = np.asarray(jax.random.randint(key, (n_iters, 3), 0, n))  # gsdx's draws
    plane_t, inl_t = tpc.segment_plane(
        torch.as_tensor(pts), 0.01, valid=None if valid is None else torch.as_tensor(valid),
        n_iters=n_iters, idx=torch.as_tensor(idx))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    # a cross product and a normalisation in f32: 1e-6
    np.testing.assert_allclose(plane_t.numpy(), np.asarray(plane_j), atol=1e-6)
    counted = np.ones(n, bool) if valid is None else valid
    assert abs(plane_t[2]) > 0.99 and inl_t.numpy()[:400][counted[:400]].mean() > 0.9


def test_segment_plane_draws_from_a_generator():
    pts = torch.rand(100, 3)
    pts[:80, 2] = 0.0
    a = tpc.segment_plane(pts, 1e-3, generator=torch.Generator().manual_seed(0))
    b = tpc.segment_plane(pts, 1e-3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[1][:80].all()
