"""The compositor kernels' culling rule, `alpha_cut_box`, against gsdx.

The CUDA kernels skip a splat for a warp when its alpha-cut box misses the
warp's pixel patch. That is exact only if every (splat, pixel) pair that
gsdx's compositor keeps (alpha > 0 in `_chunk_alpha`) lies inside the box.
These tests hold the rule's plain version to that on rendered scenes, on
edge cases and on random conics and opacities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gsdx.core.cameras import make_camera
from gsdx.kernels.composite import _chunk_alpha, _pixel_coords
from gsdx.render import binning as jbin
from gsdx.render.projection import project_gaussians
from gsdx_torch.kernels import composite as C

F32_CUT = np.float32(1.0 / 255.0)


def _kept_alpha(tf, counts, tiles_x, tile_h, tile_w=128):
    """gsdx's alpha (T, K, P) of every (column, pixel) pair, and the pixel
    coordinates (T, 1, P)."""
    T, _, K = tf.shape

    @jax.jit
    def one(chunk, count, t):
        px, py = _pixel_coords(t, tiles_x, tile_h, tile_w)
        smask = (jnp.arange(K) < count)[:, None]
        return _chunk_alpha(chunk, px, py, smask)[0], px, py

    alpha, px, py = jax.vmap(one)(jnp.asarray(tf), jnp.asarray(counts),
                                  jnp.arange(T))
    return np.asarray(alpha), np.asarray(px), np.asarray(py)


def _outside(tf, counts, tiles_x, tile_h):
    """(pairs gsdx keeps, those outside the port's box). A NaN box edge
    counts as inside: the kernels never cull on it."""
    alpha, px, py = _kept_alpha(tf, counts, tiles_x, tile_h)
    x0, x1, y0, y1 = (b.numpy()[:, :, None] for b in C.alpha_cut_box(torch.tensor(tf)))
    outside = (x1 < px) | (x0 > px) | (y1 < py) | (y0 > py)
    kept = alpha > 0
    return int(kept.sum()), int((kept & outside).sum())


def _scene_tiles(means, quats, scales, opac, h, w, f, tile_h, k):
    """(T, 16, K) tile features, counts, tiles_x and tile_h, projected and
    binned by gsdx."""
    cam = make_camera(np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32),
                      np.eye(4, dtype=np.float32), width=w, height=h)
    grid = jbin.TileGrid(h, w, tile_h, 128)
    n = means.shape[0]

    @jax.jit
    def build(means, quats, scales, opac):
        p = project_gaussians(means, quats, scales, cam)
        bins = jbin.bin_gaussians(p.mean2d, p.radius, p.depth, p.mask, grid, k, 32)
        feats = jnp.zeros((n, 16), jnp.float32)
        feats = feats.at[:, 0:2].set(p.mean2d).at[:, 2:5].set(p.conic)
        feats = feats.at[:, 5].set(opac[:, 0] * p.mask).at[:, 9].set(p.depth)
        return feats[bins.gauss_idx].transpose(0, 2, 1), bins.counts

    tf, counts = build(means, quats, scales, opac)
    return np.asarray(tf), np.asarray(counts), grid.tiles_x, tile_h


def _rasterize_scene(rng):
    """tests/test_rasterize.py's scene: 120 Gaussians, 40 x 64, f 60."""
    n = 120
    means = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    means[:, 2] += 3.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(0.02, 0.08, size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, size=(n, 1)).astype(np.float32)
    return _scene_tiles(means, quats, scales, opac, 40, 64, 60.0, 8, 256)


def _koverflow_scene(rng):
    """tests/test_koverflow.py's scene: 4096 Gaussians on 64 x 256, K 128."""
    n = 4096
    means = rng.normal(0, 0.12, size=(n, 3)).astype(np.float32)
    means[:, 2] = np.abs(means[:, 2]) * 0.8 + 2.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.full((n, 3), 0.02, np.float32)
    opac = rng.uniform(0.2, 0.9, size=(n, 1)).astype(np.float32)
    return _scene_tiles(means, quats, scales, opac, 64, 256, 100.0, 16, 128)


def _saturating_scene(rng):
    """Large opaque splats blanketing 24 x 160 (the early-stop scene of
    tests/test_pallas_composite.py)."""
    n = 120
    means = rng.uniform(-0.8, 0.8, size=(n, 3)).astype(np.float32)
    means[:, 2] += 3.0
    means[:, 0] = rng.uniform(-3.0, 3.0, size=n)
    means[:, 1] = rng.uniform(-0.5, 0.5, size=n)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.full((n, 3), 1.5, np.float32)
    opac = np.full((n, 1), 0.95, np.float32)
    return _scene_tiles(means, quats, scales, opac, 24, 160, 70.0, 8, 128)


@pytest.mark.parametrize("make", [_rasterize_scene, _koverflow_scene, _saturating_scene],
                         ids=["rasterize", "koverflow", "saturating"])
def test_every_kept_pair_lies_in_the_box(rng, make):
    tf, counts, tiles_x, tile_h = make(rng)
    kept, outside = _outside(tf, counts, tiles_x, tile_h)
    assert kept > 0
    assert outside == 0, f"{outside} of {kept} kept pairs lie outside the box"


def _one_splat_tile(splats):
    """One 8 x 128 tile of hand-made columns: (mx, my, a, b, c, op) each."""
    K = len(splats)
    tf = np.zeros((1, 16, K), np.float32)
    tf[0, :6] = np.asarray(splats, np.float32).T
    return tf, np.array([K], np.int32)


EDGE_SPLATS = {
    "opacity at the cut": (10.0, 3.0, 1.0, 0.0, 1.0, F32_CUT),
    "opacity just above the cut": (10.0, 3.0, 1.0, 0.0, 1.0,
                                   np.nextafter(F32_CUT, np.float32(1))),
    "opacity 1": (60.0, 4.0, 0.01, 0.002, 0.02, 1.0),
    "sub-pixel splat": (20.02, 5.0, 400.0, 0.0, 400.0, 0.9),
    "sub-pixel splat between pixels": (30.5, 2.5, 400.0, 0.0, 400.0, 0.9),
    "near-singular conic": (64.0, 4.0, 1.0, 0.9999, 1.0, 0.8),
    "splat across a patch edge": (15.5, 3.5, 0.5, 0.0, 0.5, 0.6),
}


@pytest.mark.parametrize("name", list(EDGE_SPLATS))
def test_edge_cases_keep_every_visible_pair(name):
    tf, counts = _one_splat_tile([EDGE_SPLATS[name]])
    kept, outside = _outside(tf, counts, 1, 8)
    if "between" not in name:
        assert kept > 0, "the case must have visible pairs"
    assert outside == 0


def test_opacity_below_the_cut_gives_an_empty_box():
    below = np.nextafter(F32_CUT, np.float32(0))
    tf, counts = _one_splat_tile([(10.0, 3.0, 1.0, 0.0, 1.0, below),
                                  (10.0, 3.0, 1.0, 0.0, 1.0, 0.0)])
    kept, _ = _outside(tf, counts, 1, 8)
    assert kept == 0
    x0, x1, y0, y1 = C.alpha_cut_box(torch.tensor(tf))
    assert torch.isinf(x0).all() and (x0 > x1).all() and (y0 > y1).all()


@pytest.mark.parametrize("conic", [(-1.0, 0.0, 1.0), (1.0, 2.0, 1.0), (0.0, 0.0, 1.0)],
                         ids=["a<0", "det<0", "a=0"])
def test_conic_not_positive_definite_is_never_culled(conic):
    tf, counts = _one_splat_tile([(10.0, 3.0, *conic, 0.9)])
    kept, outside = _outside(tf, counts, 1, 8)
    assert kept > 0 and outside == 0
    x0, x1, y0, y1 = C.alpha_cut_box(torch.tensor(tf))
    assert bool((x0 == -np.inf).all() and (x1 == np.inf).all()
                and (y0 == -np.inf).all() and (y1 == np.inf).all())


_finite = dict(allow_nan=False, allow_infinity=False, width=32)


@settings(max_examples=80, deadline=None)
@given(st.lists(st.tuples(
    st.floats(-40.0, 170.0, **_finite),           # mean x
    st.floats(-20.0, 28.0, **_finite),            # mean y
    st.floats(-9.0, 7.0, **_finite),              # log conic a
    st.floats(-9.0, 7.0, **_finite),              # log conic c
    st.floats(-1.0, 1.0, **_finite),              # b / sqrt(a c)
    st.one_of(st.floats(0.0, 1.0, **_finite),     # opacity
              st.sampled_from([float(F32_CUT), 1.0, 0.99]))),
    min_size=1, max_size=8))
def test_no_kept_pair_is_ever_outside_the_box(splats):
    cols = []
    for mx, my, la, lc, rho, op in splats:
        a, c = np.exp(la), np.exp(lc)
        cols.append((mx, my, a, rho * np.sqrt(a * c), c, op))
    tf, counts = _one_splat_tile(cols)
    _, outside = _outside(tf, counts, 1, 8)
    assert outside == 0
