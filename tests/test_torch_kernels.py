"""The CUDA compositor kernels against their plain PyTorch versions.

These need an NVIDIA GPU with nvcc; without one they skip. The file imports
no JAX, so on a machine with the card it runs on its own:

    python -m pytest --noconftest -o addopts="" tests/test_torch_kernels.py

`chip_smoke.py` makes the same comparison at the full 720p widths.
"""

import numpy as np
import pytest
import torch

from gsdx_torch.core.cameras import make_camera
from gsdx_torch.kernels import composite as C
from gsdx_torch.render.binning import TileGrid, bin_gaussians
from gsdx_torch.render.projection import project_gaussians
from gsdx_torch.render.rasterize import RasterizeConfig, rasterize

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _scene(seed, n, saturating=False, n_chan=3):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-0.8, 0.8, size=(n, 3)).astype(np.float32)
    means[:, 2] = means[:, 2] * 0.5 + 3.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(0.02, 0.10, size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, size=(n, 1)).astype(np.float32)
    if saturating:  # big opaque splats blanket tiles: early stop fires
        means[:, 0] = rng.uniform(-3.0, 3.0, size=n)
        scales[:] = 1.5
        opac[:] = 0.95
    colors = rng.uniform(0, 1, size=(n, n_chan)).astype(np.float32)
    return means, quats, scales, opac, colors


def _tiles(device, seed, n, tile_h, k, presort, saturating=False, n_chan=3):
    h, w = 64, 300
    means, quats, scales, opac, colors = (
        torch.as_tensor(x, device=device)
        for x in _scene(seed, n, saturating, n_chan))
    cam = make_camera(np.array([[90.0, 0, w / 2], [0, 90.0, h / 2], [0, 0, 1]],
                               np.float32), np.eye(4, dtype=np.float32),
                      width=w, height=h, device=device)
    grid = TileGrid(h, w, tile_h, 128)
    p = project_gaussians(means, quats, scales, cam)
    bins = bin_gaussians(p.mean2d, p.radius, p.depth, p.mask, grid, k, 16,
                         original_order=presort)
    feats = torch.cat([p.mean2d, p.conic, opac * p.mask[:, None], colors,
                       p.depth[:, None],
                       torch.zeros(n, 16 - 7 - n_chan, device=device)], 1)
    tf = feats[bins.gauss_idx].transpose(1, 2).contiguous()
    geo = dict(tiles_x=grid.tiles_x, tile_h=tile_h, tile_w=128,
               n_accum=n_chan + 1)
    return tf, bins.counts, geo


CASES = [  # (n, tile_h, K, sub, presort, saturating, n_chan)
    (300, 8, 128, 64, False, False, 3),
    (300, 16, 256, 128, True, False, 6),
    (400, 32, 256, 64, False, False, 6),
    (400, 32, 256, 64, True, False, 3),
    (150, 8, 128, 32, False, True, 3),
    (150, 16, 128, 32, True, True, 6),
    (400, 24, 256, 64, False, False, 3),
    (400, 24, 256, 128, True, True, 6),
    (3000, 16, 1024, 128, False, False, 6),
    (3000, 32, 1024, 128, True, False, 3),
]


@pytest.mark.parametrize("n,tile_h,k,sub,presort,saturating,n_chan", CASES)
def test_kernels_match_plain_versions(cuda, n, tile_h, k, sub, presort,
                                      saturating, n_chan):
    tf, counts, geo = _tiles(cuda, 0, n, tile_h, k, presort, saturating, n_chan)
    if k == 1024:
        assert int(counts.max()) > 896, "the scene must fill the last granule"
    _check_against_plain(tf, counts, geo, sub, presort, saturating)


def test_empty_tiles_between_full_ones(cuda):
    tf, counts, geo = _tiles(cuda, 0, 150, 16, 128, False, saturating=True)
    counts = counts.clone()
    counts[1::2] = 0
    assert (counts == 128).any() and (counts[0::2] > 0).all()
    for presort in (False, True):
        _check_against_plain(tf, counts, geo, 32, presort, saturating=True)


def _half_plane(x_edge, op, depth):
    """A column whose alpha is `op` (to 1e-4) on every pixel with x <=
    x_edge and zero right of it: conic (0, -1e-9, 0) and a mean far above
    the tile make power = 1e-9 dx dy, negative left of the edge and skipped
    (power > 0) right of it. Not positive definite, so never culled."""
    col = torch.zeros(16)
    col[0], col[1], col[3], col[5] = x_edge + 0.5, -1000.0, -1e-9, op
    col[6:9] = torch.tensor([0.2, 0.5, 0.8])
    col[9] = depth
    return col


def _stop_scene(tile_h, presort, seed=0):
    """One tile (K 256, sub 32) whose early stop needs the cluster's OR:
    granule 0 saturates every column <= 95, granule 1 those <= 111, granule
    2 all of them, so after granules 0 and 1 only blocks right of rank 0
    hold live pixels, and the tile stops after granule 2 (nproc 3). Every
    other column is an ordinary splat inside the tile, which would change
    the image if the walk went on. With ``presort`` the columns are
    shuffled and their depth puts them back in order."""
    rng = np.random.default_rng(seed)
    K = 256
    cols = []
    for k in range(K):
        g, s = divmod(k, 32)
        if g < 3 and s < 3:
            cols.append(_half_plane((95, 111, 127)[g], 0.99, float(k)))
            continue
        col = torch.zeros(16)
        col[0], col[1] = rng.uniform(0, 128), rng.uniform(0, tile_h)
        col[2] = col[4] = rng.uniform(0.02, 0.3)
        col[3] = rng.uniform(-0.01, 0.01)
        col[5] = rng.uniform(0.3, 0.9)
        col[6:9] = torch.as_tensor(rng.uniform(0, 1, 3))
        col[9] = float(k)
        cols.append(col)
    tf = torch.stack(cols, 1)[None]
    if presort:
        tf = tf[:, :, torch.as_tensor(rng.permutation(K))]
    geo = dict(tiles_x=1, tile_h=tile_h, tile_w=128, n_accum=4)
    return tf.contiguous(), torch.tensor([K], dtype=torch.int32), geo


@pytest.mark.parametrize("tile_h", [8, 16, 32])
@pytest.mark.parametrize("presort", [False, True])
def test_early_stop_needs_every_block_of_the_cluster(cuda, tile_h, presort):
    tf, counts, geo = _stop_scene(tile_h, presort)
    kw = dict(geo, sub_chunk=32, presort=presort)
    # the scene as designed, on the plain version: live pixels after
    # granules 1 and 2 lie only right of columns 95 and 111, and the tile
    # stops after granule 3
    with torch.no_grad():
        for g, edge in ((1, 95), (2, 111)):
            logt = C.composite_tiles_torch(tf, counts, nproc=torch.tensor([g]), **kw)[1]
            live = (logt[0, 0] >= C.LOG_T_STOP).reshape(tile_h, 128).any(0)
            assert live.any() and int(live.nonzero().min()) > edge
        assert int(C.composite_tiles_torch(tf, counts, **kw)[2][0]) == 3
    _check_against_plain(tf.to(cuda), counts.to(cuda), geo, 32, presort, saturating=True)
    assert C.last_launch()["cluster"] >= 2


def _edge_scene(tile_h, seed=0):
    """Two tiles of splats whose exact alpha-cut ellipse ends within 1e-3
    px of a warp patch's edge (columns 16 i, rows 4 j), from either side,
    so a box one pixel too tight would lose a visible pair."""
    rng = np.random.default_rng(seed)
    K = 128
    tf = torch.zeros(2, 16, K)
    for t in range(2):
        for k in range(K):
            op = rng.uniform(0.02, 1.0)
            a, c = rng.uniform(0.05, 2.0, 2)
            b = rng.uniform(-0.5, 0.5) * np.sqrt(a * c)
            det = a * c - b * b
            cut = 2 * np.log(255 * op)
            rx, ry = np.sqrt(cut * c / det), np.sqrt(cut * a / det)
            side = rng.choice([-1.0, 1.0])
            jitter = rng.uniform(-1e-3, 1e-3)
            if k % 2:  # ellipse edge on a column boundary
                mx = t * 128 + 16 * rng.integers(1, 8) - side * rx + jitter
                my = rng.uniform(0, tile_h)
            else:  # on a row boundary
                mx = t * 128 + rng.uniform(0, 128)
                my = 4 * rng.integers(1, tile_h // 4 + 1) - side * ry + jitter
            tf[t, :6, k] = torch.tensor([mx, my, a, b, c, op])
            tf[t, 6:9, k] = torch.as_tensor(rng.uniform(0, 1, 3))
            tf[t, 9, k] = rng.uniform(1, 5)
    geo = dict(tiles_x=2, tile_h=tile_h, tile_w=128, n_accum=4)
    return tf, torch.tensor([K, K], dtype=torch.int32), geo


@pytest.mark.parametrize("tile_h", [16, 24])
def test_box_edges_on_patch_edges(cuda, tile_h):
    tf, counts, geo = _edge_scene(tile_h)
    for presort in (False, True):
        _check_against_plain(tf.to(cuda), counts.to(cuda), geo, 64, presort, False)


def _check_against_plain(tf, counts, geo, sub, presort, saturating):
    """Both kernels against their plain versions; the backward twice,
    bit-equal."""
    kw = dict(geo, sub_chunk=sub, presort=presort)
    before = dict(C.LAUNCHES)
    out_k = C.composite_fwd(tf, counts, **kw)
    with torch.no_grad():
        out_p = C.composite_tiles_torch(tf, counts, **kw)
    torch.cuda.synchronize()
    variant = "fwd_presort" if presort else "fwd"
    assert C.LAUNCHES[variant] == before[variant] + 1
    torch.testing.assert_close(out_k[2], out_p[2], rtol=0, atol=0)  # nproc
    if saturating:
        assert (out_k[2].long() * sub < counts.long()).any(), "no early stop"
    # f32 sums of <= K terms in another order: 1e-5
    torch.testing.assert_close(out_k[0], out_p[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out_k[1], out_p[1], rtol=1e-5, atol=1e-5)
    if presort:
        torch.testing.assert_close(out_k[3], out_p[3], rtol=0, atol=0)
        torch.testing.assert_close(out_k[4], out_p[4], rtol=0, atol=0)

    g = torch.Generator(device=tf.device).manual_seed(1)
    g_acc = torch.randn(out_k[0].shape, device=tf.device, generator=g)
    g_lt = torch.randn(out_k[1].shape, device=tf.device, generator=g)
    feats_b = out_k[4] if presort else tf
    geo_b = dict(geo, sub_chunk=sub)
    args_b = (feats_b, counts, out_k[2], out_k[1], g_acc, g_lt, out_k[3])
    grad_k = C.composite_bwd(*args_b, **geo_b)
    grad_p = C.composite_bwd_torch(feats_b, counts, out_k[2], g_acc, g_lt,
                                   out_k[3], **geo_b)
    # reverse sums over the tile's pixels in another order: 1e-4 of each
    # feature row's largest entry (one scale for all rows would let the
    # conic rows, which grow with dx^2, swamp the mean and opacity rows)
    scale = grad_p.abs().amax(dim=(0, 2), keepdim=True)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    torch.testing.assert_close(grad_k / scale, grad_p / scale, rtol=0, atol=1e-4)
    # no atomics: the same sums in the same order on every run
    assert torch.equal(C.composite_bwd(*args_b, **geo_b), grad_k)


def test_rasterize_on_the_card_matches_cpu(cuda):
    arrays = _scene(3, 500, n_chan=6)
    k = np.array([[300.0, 0, 160], [0, 300.0, 90], [0, 0, 1]], np.float32)
    results = []
    for dev in ("cpu", cuda):
        args = [torch.tensor(a, device=dev, requires_grad=True) for a in arrays]
        cam = make_camera(k, np.eye(4, dtype=np.float32), width=320, height=180,
                          bg=(0.2, 0.3, 0.4), device=dev)
        out = rasterize(*args, cam, RasterizeConfig())
        loss = out.im.square().mean() + 0.1 * out.depth.mean()
        results.append((out.im.detach().cpu(),
                        [g.cpu() for g in torch.autograd.grad(loss, args)]))
    (im_c, g_c), (im_g, g_g) = results
    torch.testing.assert_close(im_g, im_c, rtol=1e-5, atol=1e-5)
    for a, b in zip(g_g, g_c):
        scale = b.abs().max()
        torch.testing.assert_close(a / scale, b / scale, rtol=0, atol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    tf, counts, geo = _tiles(cuda, 0, 100, 8, 128, False)
    with pytest.raises(ValueError, match="n_accum"):
        C.composite_fwd(tf, counts, **dict(geo, n_accum=5), sub_chunk=64)
    with pytest.raises(ValueError, match="int32"):
        C.composite_fwd(tf, counts.long(), **geo, sub_chunk=64)


def test_a_refused_launch_leaves_no_error_behind(cuda):
    # a backward asking for more shared memory than the card has is refused
    # with an error code; the launches after it must not report that error
    tf, counts, geo = _tiles(cuda, 0, 100, 8, 128, False)
    T, P = tf.shape[0], geo["tile_h"] * geo["tile_w"]
    K = sub = 4096
    feats = torch.zeros(T, 16, K, device=cuda)
    pix = torch.zeros(T, geo["n_accum"], P, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    err = C.LIBRARY.load().gsdx_composite_bwd(
        feats.data_ptr(), counts.data_ptr(), None, counts.data_ptr(), pix.data_ptr(),
        pix.data_ptr(), pix.data_ptr(), None, feats.data_ptr(), T, K,
        geo["tiles_x"], geo["tile_h"], geo["tile_w"], geo["n_accum"], sub, 0, stream)
    assert err != 0
    out = C.composite_fwd(tf, counts, **geo, sub_chunk=64)
    torch.cuda.synchronize()
    assert torch.isfinite(out[0]).all()
    assert float(torch.ones(1, device=cuda).add(1)) == 2.0


@pytest.mark.parametrize("presort", [False, True])
def test_a_shard_with_its_tile_ids_equals_the_unsharded_rows(cuda, presort):
    """Kernels #1 and #2 on one shard's rows, with their global tile ids,
    give the whole launch's rows bit for bit: a block does the same work
    whatever its row."""
    tf, counts, geo = _tiles(cuda, 0, 400, 16, 256, presort)
    T = tf.shape[0]
    tiles_y = -(-64 // geo["tile_h"])
    assert T == geo["tiles_x"] * tiles_y
    kw = dict(geo, sub_chunk=64, presort=presort)
    full = C.composite_fwd(tf, counts, **kw)
    g = torch.Generator(device=cuda).manual_seed(2)
    g_acc = torch.randn(full[0].shape, device=cuda, generator=g)
    g_lt = torch.randn(full[1].shape, device=cuda, generator=g)
    geo_b = dict(geo, sub_chunk=64)
    grad = C.composite_bwd(full[4] if presort else tf, counts, full[2], full[1], g_acc,
                           g_lt, full[3], **geo_b)
    rows = slice(T // 3, T)  # the last two of three shards
    ids = torch.arange(T, dtype=torch.int32, device=cuda)[rows].contiguous()
    before = dict(C.LAUNCHES)
    part = C.composite_fwd(tf[rows].contiguous(), counts[rows].contiguous(), **kw,
                           tile_ids=ids, tiles_y=tiles_y)
    variant = "fwd_presort" if presort else "fwd"
    assert C.LAUNCHES[variant] == before[variant] + 1
    for a, b in zip(part, full):
        if a is not None:
            assert torch.equal(a, b[rows])
    feats_b = part[4] if presort else tf[rows].contiguous()
    grad_s = C.composite_bwd(feats_b, counts[rows].contiguous(), part[2], part[1],
                             g_acc[rows].contiguous(), g_lt[rows].contiguous(), part[3],
                             **geo_b, tile_ids=ids, tiles_y=tiles_y)
    assert torch.equal(grad_s, grad[rows])
    # and the identity, given as ids, is the launch without them
    same = C.composite_fwd(tf, counts, **kw, tile_ids=torch.arange(
        T, dtype=torch.int32, device=cuda), tiles_y=tiles_y)
    assert torch.equal(same[0], full[0]) and torch.equal(same[1], full[1])


def test_tile_ids_outside_the_grid_are_refused_before_any_launch(cuda):
    tf, counts, geo = _tiles(cuda, 0, 100, 8, 128, False)
    T = tf.shape[0]
    tiles_y = 64 // 8
    before = dict(C.LAUNCHES)
    for ids in (torch.full((T,), T, dtype=torch.int32, device=cuda),
                torch.full((T,), -1, dtype=torch.int32, device=cuda)):
        with pytest.raises(ValueError, match="tile_ids must lie"):
            C.composite_fwd(tf, counts, **geo, sub_chunk=64, tile_ids=ids, tiles_y=tiles_y)
        with pytest.raises(ValueError, match="tile_ids must lie"):
            C.composite_bwd(tf, counts, counts, torch.zeros(T, 1, 1024, device=cuda),
                            torch.zeros(T, geo["n_accum"], 1024, device=cuda),
                            torch.zeros(T, 1, 1024, device=cuda), **geo, sub_chunk=64,
                            tile_ids=ids, tiles_y=tiles_y)
    ok = torch.zeros(T, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="tiles_y"):
        C.composite_fwd(tf, counts, **geo, sub_chunk=64, tile_ids=ok)
    with pytest.raises(ValueError, match="int32"):
        C.composite_fwd(tf, counts, **geo, sub_chunk=64, tile_ids=ok.long(), tiles_y=tiles_y)
    with pytest.raises(ValueError, match="int32"):
        C.composite_fwd(tf, counts, **geo, sub_chunk=64, tile_ids=ok.cpu(), tiles_y=tiles_y)
    assert C.LAUNCHES == before
