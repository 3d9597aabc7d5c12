"""gsdx_torch.render and the compositor module against gsdx.

Projection (forward + autograd vs jax.grad), both binner forms (integer
equality), the plain compositor and its backward against the Pallas kernels
in interpret mode, and the whole rasterizer against gsdx's XLA path, the
golden render and the frozen-bin (presort) path. gsdx runs under jax.jit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdx.core.cameras import make_camera as j_make_camera
from gsdx.kernels.composite import (
    composite_tiles_pallas,
    composite_tiles_pallas_bwd,
)
from gsdx.render import binning as jbin
from gsdx.render.projection import project_gaussians as j_project
from gsdx.render.rasterize import RasterizeConfig as JCfg
from gsdx.render.rasterize import compute_bins as j_compute_bins
from gsdx.render.rasterize import rasterize as j_rasterize
from gsdx_torch.core.cameras import make_camera as t_make_camera
from gsdx_torch.kernels import composite as C
from gsdx_torch.render import binning as tbin
from gsdx_torch.render.projection import project_gaussians as t_project
from gsdx_torch.render.rasterize import RasterizeConfig as TCfg
from gsdx_torch.render.rasterize import compute_bins as t_compute_bins
from gsdx_torch.render.rasterize import rasterize as t_rasterize
from gsdx_torch.render.renderer import Renderer

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "raster_golden.npz")


def make_scene(rng, n, spread=0.5, scale=(0.02, 0.08), n_chan=3):
    """tests/test_rasterize.py's scene generator."""
    means = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    means[:, 2] += 3.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(*scale, size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, size=(n, 1)).astype(np.float32)
    colors = rng.uniform(0, 1, size=(n, n_chan)).astype(np.float32)
    return means, quats, scales, opac, colors


def cams(h, w, f=60.0, bg=(0.0, 0.0, 0.0)):
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    return (j_make_camera(k, w2c, width=w, height=h, bg=bg),
            t_make_camera(k, w2c, width=w, height=h, bg=bg))


def tt(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


# ---------------------------------------------------------------- projection


def test_projection_forward_and_grads_match(rng):
    means, quats, scales, _, _ = make_scene(rng, 50)
    means[:3, 2] = [0.1, -1.0, 0.19]  # behind / on the near-cull plane
    jc, tc = cams(40, 64)
    out_j = jax.jit(lambda *a: j_project(*a, jc))(means, quats, scales)
    out_t = t_project(*tt(means, quats, scales), tc)
    for f, tol in (("mean2d", 1e-4), ("conic", 1e-5), ("depth", 1e-6)):
        # f32 division chains; mean2d in pixels (~1e2)
        np.testing.assert_allclose(getattr(out_t, f).detach().numpy(),
                                   np.asarray(getattr(out_j, f)),
                                   rtol=1e-5, atol=tol, err_msg=f)
    np.testing.assert_array_equal(out_t.radius.detach().numpy(), np.asarray(out_j.radius))
    np.testing.assert_array_equal(out_t.mask.numpy(), np.asarray(out_j.mask))

    w = rng.normal(size=(50, 6)).astype(np.float32)

    def j_loss(m, q, s):
        p = j_project(m, q, s, jc)
        return jnp.sum(jnp.concatenate([p.mean2d, p.conic, p.depth[:, None]], 1)
                       * w * p.mask[:, None])

    g_j = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(means, quats, scales)
    args = tt(means, quats, scales, grad=True)
    p = t_project(*args, tc)
    loss = torch.sum(torch.cat([p.mean2d, p.conic, p.depth[:, None]], 1)
                     * torch.as_tensor(w) * p.mask[:, None])
    g_t = torch.autograd.grad(loss, args)
    for name, a, b in zip(("means", "quats", "scales"), g_t, g_j):
        b = np.asarray(b)
        scale = np.abs(b).max()
        # chain of ~30 f32 ops per element: 1e-5 of the largest gradient
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------- binning


def _projected(rng, n, h, w, spread=0.5, f=60.0):
    means, quats, scales, _, _ = make_scene(rng, n, spread=spread)
    jc, _ = cams(h, w, f=f)
    p = jax.jit(lambda *a: j_project(*a, jc))(means, quats, scales)
    return tuple(np.asarray(x) for x in (p.mean2d, p.radius, p.depth, p.mask))


@pytest.mark.parametrize("n,k", [(120, 256), (300, 64)])
def test_binner_equals_gsdx_sorted_bins(rng, n, k):
    """Depth-ordered lists == gsdx bin_gaussians, with and without K
    overflow (k=64 overflows: both keep the exact nearest K)."""
    m2d, rad, dep, mask = _projected(rng, n, 40, 300)
    grid = jbin.TileGrid(40, 300, 8, 128)
    jb = jax.jit(lambda *a: jbin.bin_gaussians(*a, grid, k, 16))(
        m2d, rad, dep, mask)
    tb = tbin.bin_gaussians(*tt(m2d, rad, dep, mask),
                            tbin.TileGrid(40, 300, 8, 128), k, 16)
    counts = np.asarray(jb.counts)
    np.testing.assert_array_equal(tb.counts.numpy(), counts)
    if k == 64:
        assert (counts == k).any(), "scene must overflow K"
    for t, c in enumerate(counts):
        np.testing.assert_array_equal(tb.gauss_idx[t, :c].numpy(),
                                      np.asarray(jb.gauss_idx)[t, :c])


def test_binner_original_order_equals_gsdx_unsorted_bins(rng):
    m2d, rad, dep, mask = _projected(rng, 150, 40, 300)
    grid = jbin.TileGrid(40, 300, 8, 128)
    jb = jax.jit(lambda *a: jbin.bin_gaussians_unsorted(*a, grid, 256, 16))(
        m2d, rad, dep, mask)
    tb = tbin.bin_gaussians(*tt(m2d, rad, dep, mask),
                            tbin.TileGrid(40, 300, 8, 128), 256, 16,
                            original_order=True)
    counts = np.asarray(jb.counts)
    assert counts.max() < 256  # no overflow: the lists must be identical
    np.testing.assert_array_equal(tb.counts.numpy(), counts)
    for t, c in enumerate(counts):
        np.testing.assert_array_equal(tb.gauss_idx[t, :c].numpy(),
                                      np.asarray(jb.gauss_idx)[t, :c])


# ---------------------------------------------------------------- compositor

TH, TW = 24, 160  # tests/test_pallas_composite.py: 3x2 grid of 8x128 tiles
GEO = dict(tiles_x=2, tile_h=8, tile_w=128)


def _tile_feats(rng, saturating: bool, original_order: bool):
    """(T, 16, K=128) tile features of a small scene, gsdx-binned."""
    n = 120 if saturating else 80
    means, quats, scales, opac, colors = make_scene(rng, n, spread=0.8)
    if saturating:  # tests/test_pallas_composite.py's early-stop scene
        means[:, 0] = rng.uniform(-3.0, 3.0, size=n)
        means[:, 1] = rng.uniform(-0.5, 0.5, size=n)
        scales[:] = 1.5
        opac[:] = 0.95
    jc, _ = cams(TH, TW, f=70.0)
    grid = jbin.TileGrid(TH, TW, 8, 128)
    binner = jbin.bin_gaussians_unsorted if original_order else jbin.bin_gaussians

    @jax.jit
    def build(means, quats, scales, opac, colors):
        p = j_project(means, quats, scales, jc)
        bins = binner(p.mean2d, p.radius, p.depth, p.mask, grid, 128, 16)
        feats = jnp.zeros((n, 16), jnp.float32)
        feats = feats.at[:, 0:2].set(p.mean2d).at[:, 2:5].set(p.conic)
        feats = feats.at[:, 5].set(opac[:, 0] * p.mask)
        feats = feats.at[:, 6:9].set(colors).at[:, 9].set(p.depth)
        return feats[bins.gauss_idx].transpose(0, 2, 1), bins.counts

    tf, counts = build(means, quats, scales, opac, colors)
    return np.asarray(tf), np.asarray(counts)


@pytest.mark.parametrize("saturating,presort,sub", [
    (False, False, 64), (False, True, 64), (True, False, 32), (True, True, 32)])
def test_plain_compositor_matches_pallas_kernels(rng, saturating, presort, sub):
    tf, counts = _tile_feats(rng, saturating, original_order=presort)
    kw = dict(GEO, n_accum=4, sub_chunk=sub, presort=presort)
    out_j = composite_tiles_pallas(jnp.asarray(tf), jnp.asarray(counts),
                                   chunk=128, interpret=True, **kw)
    out_t = C.composite_tiles_torch(*tt(tf, counts), **kw)
    nproc = np.asarray(out_j[2])
    np.testing.assert_array_equal(out_t[2].numpy(), nproc)
    if saturating:
        assert (nproc < np.ceil(counts / sub)).any(), "early stop never fired"
    # f32 sums of <= 128 terms in another order (sequential cumsum vs the
    # kernel's triangular-matmul prefix): 1e-5 absolute on values <= ~10.
    # Measured on the [False-False-64] scene: 2.4e-7 (accum) and 3.6e-7
    # (log T), the same at 1 to 8 torch threads, and 60 of 60 repeated
    # runs (alone and under -n 6 --dist loadfile) passed
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]),
                               rtol=1e-5, atol=1e-5)
    if presort:
        np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
        np.testing.assert_array_equal(out_t[4].numpy(), np.asarray(out_j[4]))

    # backward: the plain version's autograd vs the Pallas backward kernel
    g_acc = rng.normal(size=out_t[0].shape).astype(np.float32)
    g_lt = rng.normal(size=out_t[1].shape).astype(np.float32)
    feats_b = np.asarray(out_j[4]) if presort else tf
    rank = out_j[3] if presort else None
    want = np.asarray(composite_tiles_pallas_bwd(
        jnp.asarray(feats_b), jnp.asarray(counts), out_j[1], jnp.asarray(g_acc),
        jnp.asarray(g_lt), chunk=128, interpret=True, nproc=out_j[2], rank=rank,
        **kw))
    got = C.composite_bwd(*tt(feats_b, counts, nproc), out_t[1],
                          *tt(g_acc, g_lt),
                          None if rank is None else torch.as_tensor(np.asarray(rank)),
                          **{k: v for k, v in kw.items() if k != "presort"})
    # reverse-mode sums over 1024 pixels in another order: 1e-4 of each
    # feature row's largest entry (the conic rows grow with dx^2 and would
    # swamp the mean and opacity rows under one scale; all-zero pad rows
    # are held to 1e-4 absolute). Measured on [False-False-64]: 2.4e-7
    # of its row's largest entry, for the kernel port's plain backward and
    # for autograd alike
    scale = np.abs(want).max(axis=(0, 2), keepdims=True)
    scale = np.where(scale > 0, scale, 1.0)
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-4)
    # and autograd straight through the forward, on the input features
    # (with presort the Pallas gradient is already in input column order)
    f = torch.tensor(tf, requires_grad=True)
    acc, lt = C.composite_tiles_torch(f, torch.tensor(counts), **kw)[:2]
    (g_auto,) = torch.autograd.grad((acc, lt), f, tt(g_acc, g_lt))
    np.testing.assert_allclose(g_auto.numpy() / scale, want / scale, atol=1e-4)


# ---------------------------------------------------------------- rasterize

CFG_J = JCfg(tile_h=8, tile_w=128, max_per_tile=256, max_dup=32, backend="xla")
CFG_T = TCfg(tile_h=8, tile_w=128, max_per_tile=256, max_dup=32)


def _render_and_grads(rng, n, bg, use_bins=False):
    means, quats, scales, opac, colors = make_scene(rng, n)
    jc, tc = cams(40, 64, bg=bg)
    target = rng.uniform(0, 1, size=(3, 40, 64)).astype(np.float32)
    m2d = np.zeros((n, 2), np.float32)

    def j_fn(*a):
        bins = j_compute_bins(a[0], a[1], a[2], jc, CFG_J) if use_bins else None
        out = j_rasterize(*a[:5], jc, CFG_J, mean2d_offset=a[5], bins=bins)
        loss = (jnp.abs(out.im - target).mean() + 0.1 * jnp.abs(out.depth).mean()
                + 0.05 * out.final_t.mean())
        return loss, out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(
        j_fn, argnums=tuple(range(6)), has_aux=True))(
        means, quats, scales, opac, colors, m2d)
    args = tt(means, quats, scales, opac, colors, m2d, grad=True)
    bins = (t_compute_bins(*args[:3], tc, CFG_T) if use_bins else None)
    out_t = t_rasterize(*args[:5], tc, CFG_T, mean2d_offset=args[5], bins=bins)
    loss = (torch.abs(out_t.im - torch.as_tensor(target)).mean()
            + 0.1 * torch.abs(out_t.depth).mean() + 0.05 * out_t.final_t.mean())
    g_t = torch.autograd.grad(loss, args)
    return out_j, g_j, out_t, g_t


def _check_render(out_j, g_j, out_t, g_t):
    # the tolerances of tests/test_golden.py: f32 compositing sums
    np.testing.assert_allclose(out_t.im.detach().numpy(), np.asarray(out_j.im),
                               atol=1e-5)
    np.testing.assert_allclose(out_t.depth.detach().numpy(),
                               np.asarray(out_j.depth), atol=1e-4)
    np.testing.assert_allclose(out_t.final_t.detach().numpy(),
                               np.asarray(out_j.final_t), atol=1e-5)
    np.testing.assert_array_equal(out_t.radius.detach().numpy(), np.asarray(out_j.radius))
    names = ["means3d", "quats", "scales", "opacities", "colors", "mean2d"]
    for name, a, b in zip(names, g_t, g_j):
        b = np.asarray(b)
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=1e-5,
                                   err_msg=name)


def test_rasterize_matches_gsdx(rng):
    _check_render(*_render_and_grads(rng, 120, bg=(0.3, 0.1, 0.6)))


def test_rasterize_frozen_bins_presort_matches_gsdx(rng):
    """Caller-supplied compute_bins lists: original order, the compositor's
    presort path (forward kernel with rank + sorted copy, backward un-sort)."""
    _check_render(*_render_and_grads(rng, 90, bg=(0.2, 0.2, 0.2), use_bins=True))


def test_rasterize_matches_golden():
    """tests/goldens/raster_golden.npz, read as tests/test_golden.py reads it."""
    from test_rasterize import make_scene as golden_scene

    rng = np.random.default_rng(1234)
    means, quats, scales, opac, colors = golden_scene(rng, n=100)
    _, tc = cams(40, 64, bg=(0.25, 0.35, 0.45))
    args = tt(means, quats, scales, opac, colors, grad=True)
    out = t_rasterize(*args, tc, CFG_T)
    g = np.load(GOLDEN)
    np.testing.assert_allclose(out.im.detach().numpy(), g["im"], atol=1e-5)
    np.testing.assert_allclose(out.depth.detach().numpy(), g["depth"], atol=1e-4)
    np.testing.assert_allclose(out.final_t.detach().numpy(), g["final_t"],
                               atol=1e-5)
    np.testing.assert_array_equal(out.radius.detach().numpy(), g["radius"])
    loss = (out.im**2).mean() + (out.depth**2).mean()
    grads = torch.autograd.grad(loss, args)
    for name, got in zip(["g_means", "g_quats", "g_scales", "g_opac", "g_colors"],
                         grads):
        ref = g[name]
        scale = np.abs(ref).max() + 1e-12
        np.testing.assert_allclose(got.numpy() / scale, ref / scale, atol=1e-5,
                                   err_msg=name)


def test_renderer_facade_renders_on_cpu(rng):
    from gsdx.render.renderer import Renderer as JRenderer
    from gsdx_torch.render.rasterize import render as t_render

    means, quats, scales, opac, colors = make_scene(rng, 60)
    k = np.array([[60.0, 0, 32], [0, 60.0, 20], [0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    r = Renderer(width=64, height=40, cfg=CFG_T, device="cpu")
    data = {"means3D": means, "rotations": quats, "scales": scales,
            "opacities": opac, "colors_precomp": colors}
    im, depth = r.render(w2c, k, data)
    assert im.shape == (3, 40, 64) and depth.shape == (40, 64)
    # pixels no splat reaches show the grey background
    assert torch.isclose(im[:, 0, 0], torch.tensor(0.7)).all()
    assert torch.isfinite(im).all() and depth.max() > 2.0
    im_j, depth_j = jax.jit(lambda d: JRenderer(width=64, height=40, cfg=CFG_J)
                            .render(w2c, k, d))(data)
    # f32 compositing sums in another order, as in _check_render
    np.testing.assert_allclose(im.numpy(), np.asarray(im_j), atol=1e-5)
    np.testing.assert_allclose(depth.numpy(), np.asarray(depth_j), atol=1e-4)
    # the rendervar-dict entry is the same render
    out = t_render({key: torch.as_tensor(v) for key, v in data.items()},
                   r.setup_camera(k, w2c), CFG_T)
    np.testing.assert_array_equal(out.im.numpy(), im.numpy())
