"""The 1/255 alpha cut where one rounding decides it, on the CPU.

    python -m pytest tests/test_torch_cut.py

`tools/cut_stress.py` builds tile inputs whose targeted (splat, pixel)
pairs put alpha within a few ulps of the cut; `chip_smoke.py` holds the
compositor kernels (#1, #1p, #2, #2p) to their plain version on them. Here:
the inputs are sharp (an FMA-contracted falloff flips some of the targets),
the plain version keeps exactly the pairs of the op-by-op f32 falloff that
the kernels now compute, and the segment identity that a split of a tile's
list would need holds for exp(log T) but not for the probe's polynomial
stand-in (why kernel #4 splits its work by pixels).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from gsdx_torch.kernels import probes
from gsdx_torch.kernels.composite import composite_tiles_torch

REPO = Path(__file__).resolve().parents[1]


def _load_cut_stress():
    spec = importlib.util.spec_from_file_location("cut_stress", REPO / "tools" / "cut_stress.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_cut_stress()


def _target_pairs(feats, geo, targets):
    """Each target's features and pixel-centre coordinates, f32."""
    t, col, pix = targets["tile"], targets["column"], targets["pixel"]
    tiles_x, tile_h, tile_w = geo["tiles_x"], geo["tile_h"], geo["tile_w"]
    px = ((t % tiles_x) * tile_w + pix % tile_w).astype(np.float32)
    py = ((t // tiles_x) * tile_h + pix // tile_w).astype(np.float32)
    rows = [feats[t, i, col] for i in range(6)]
    return rows, px, py


@pytest.mark.parametrize("presort", [False, True])
def test_cut_stress_inputs_are_sharp(presort):
    """Every target's op-by-op alpha lies within CUT_ULPS ulps of 1/255, and
    the FMA-contracted falloff flips at least 1% of them across the cut."""
    feats, counts, geo, targets = CS.cut_stress_inputs(0, 7, presort)
    assert geo["sub_chunk"] == (128 if presort else 64)
    assert int((counts > 0).sum()) == CS.BUSY_TILES
    assert len(targets["tile"]) == int(counts.sum()) >= 5000
    (mx, my, ca, cb, cc, op), px, py = _target_pairs(feats, geo, targets)
    dx, dy = (px - mx).astype(np.float32), (py - my).astype(np.float32)
    cut = CS.ALPHA_MIN

    def kept(power):
        alpha = np.minimum(np.float32(0.99), (op * np.exp(power)).astype(np.float32))
        return (power <= 0) & (alpha >= cut), alpha

    keep, alpha = kept(CS.falloff(ca, cb, cc, dx, dy))
    ulps = np.abs(alpha.view(np.int32).astype(np.int64) - np.int64(cut.view(np.int32)))
    assert ulps.max() <= CS.CUT_ULPS + 1  # np.exp may round the other way by an ulp
    assert 0.2 < keep.mean() < 0.8  # on both sides of the cut
    keep_fma, _ = kept(CS.falloff_contracted(ca, cb, cc, dx, dy))
    assert (keep != keep_fma).mean() >= 0.01


@pytest.mark.parametrize("presort", [False, True])
def test_plain_keeps_the_op_by_op_pairs(presort):
    """`composite_tiles_torch`'s final log T on two busy tiles equals a numpy
    f32 evaluation that rounds every operation of the falloff on its own
    (the order the kernels take), to 1e-6 relative. The exp is torch's on
    the same (tiles, K, P) array, so that only the falloff's order and the
    cut rule are compared; a flipped target moves a log T by 0.0039."""
    feats, counts, geo, _ = CS.cut_stress_inputs(1, 7, presort)
    busy = np.nonzero(counts)[0][:2]
    f, c = feats[busy], counts[busy]
    tiles_y = -(-{True: 480, False: 720}[presort] // geo["tile_h"])
    _, logt, nproc = composite_tiles_torch(
        torch.from_numpy(f), torch.from_numpy(c), **geo, presort=presort,
        tile_ids=torch.from_numpy(busy.astype(np.int32)), tiles_y=tiles_y)[:3]

    tile_h, tile_w, sub = geo["tile_h"], geo["tile_w"], geo["sub_chunk"]
    if presort:  # front to back by depth, ties by slot; past the count last
        key = np.where(np.arange(CS.K)[None] < c[:, None], f[:, 5 + geo["n_accum"]], 1e30)
        f = np.take_along_axis(f, np.argsort(key, axis=1, kind="stable")[:, None], axis=2)
    kb = -(-int(c.max()) // sub) * sub
    p = np.arange(tile_h * tile_w)
    px = ((busy % geo["tiles_x"])[:, None] * tile_w + p % tile_w).astype(np.float32)
    py = ((busy // geo["tiles_x"])[:, None] * tile_h + p // tile_w).astype(np.float32)
    mx, my, ca, cb, cc, op = (f[:, i, :kb, None] for i in range(6))
    dx = (px[:, None] - mx).astype(np.float32)
    dy = (py[:, None] - my).astype(np.float32)
    power = CS.falloff(ca, cb, cc, dx, dy)
    e = torch.exp(torch.from_numpy(power)).numpy()
    alpha = np.minimum(np.float32(0.99), (op * e).astype(np.float32))
    ceff = np.minimum(c, nproc.numpy() * sub)
    live = np.arange(kb)[None, :, None] < ceff[:, None, None]
    alpha = np.where((power <= 0) & (alpha >= CS.ALPHA_MIN) & live, alpha, np.float32(0))
    want = np.log1p(-alpha.astype(np.float64)).sum(axis=1)
    np.testing.assert_allclose(logt[:, 0].numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("transcend", [True, False])
def test_segment_combine(transcend):
    """A tile's list cut in two at a granule: with exp(log T) the halves
    combine as (acc_A + e^{lt_A} acc_B, lt_A + lt_B) into the whole, to 1e-6
    relative; with the probe's polynomial stand-in of exp they do not, so
    kernel #4 cannot split a tile's list, only its pixels."""
    rng = np.random.default_rng(3)
    T, K, sub = 2, 512, 64
    feats = rng.normal(size=(T, 16, K)).astype(np.float32)
    feats[:, 0] = rng.uniform(0, 2048, size=(T, K))
    feats[:, 1] = rng.uniform(0, 12.8, size=(T, K))
    feats[:, 2] = rng.uniform(2e-6, 2e-5, size=(T, K))
    feats[:, 4] = rng.uniform(5e-3, 5e-2, size=(T, K))
    feats[:, 3] = rng.uniform(-0.9, 0.9, size=(T, K)) * np.sqrt(feats[:, 2] * feats[:, 4])
    feats[:, 5] = rng.uniform(0.05, 0.5, size=(T, K))
    counts = np.array([K, 300], np.int32)
    h = 3 * sub  # the cut
    ft = torch.from_numpy(feats)
    whole = probes.composite_hot_loop_plain(ft, torch.from_numpy(counts), sub, transcend)
    acc_a, lt_a = probes.composite_hot_loop_plain(
        ft[:, :, :h].contiguous(), torch.from_numpy(np.minimum(counts, h)), sub, transcend)
    acc_b, lt_b = probes.composite_hot_loop_plain(
        ft[:, :, h:].contiguous(), torch.from_numpy(counts - h), sub, transcend)
    acc = acc_a.double() + torch.exp(lt_a.double()) * acc_b.double()
    lt = lt_a.double() + lt_b.double()
    err = max(float((acc - whole[0].double()).abs().max() / whole[0].abs().max()),
              float((lt - whole[1].double()).abs().max() / whole[1].abs().max()))
    if transcend:
        assert err < 1e-6
    else:
        assert err > 1e-2
