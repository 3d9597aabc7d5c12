"""The K-overflow divergence between the port and gsdx, measured.

Where a tile's list overflows K, the port's one binner keeps the exact
nearest K (`gsdx_torch/render/binning.py`), and gsdx's original-order
binner (`bin_gaussians_unsorted`, what `compute_bins` and the "nosort"
path use) keeps an approximately nearest K through 256 depth buckets. This
renders tests/test_koverflow.py's overflow-heavy scene (4096 Gaussians
concentrated on a few 64x256 tiles at K = 128) through both packages'
`compute_bins` path and bounds the difference; ROADMAP.md records it.
"""

import jax.numpy as jnp
import numpy as np
import torch

from gsdx.core.cameras import make_camera as j_make_camera
from gsdx.render.rasterize import RasterizeConfig as JCfg
from gsdx.render.rasterize import compute_bins as j_compute_bins
from gsdx.render.rasterize import rasterize as j_rasterize
from gsdx_torch.core.cameras import make_camera as t_make_camera
from gsdx_torch.render.rasterize import RasterizeConfig as TCfg
from gsdx_torch.render.rasterize import compute_bins as t_compute_bins
from gsdx_torch.render.rasterize import rasterize as t_rasterize


def test_overflowing_scene_difference_is_bounded(rng):
    H, W, n, K = 64, 256, 4096, 128
    k = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    eye = np.eye(4, dtype=np.float32)
    bg = (0.1, 0.2, 0.3)
    means = rng.normal(0, 0.12, size=(n, 3)).astype(np.float32)
    means[:, 2] = np.abs(means[:, 2]) * 0.8 + 2.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.full((n, 3), 0.02, np.float32)
    opac = rng.uniform(0.2, 0.9, size=(n, 1)).astype(np.float32)
    colors = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)

    j_cam = j_make_camera(k, eye, width=W, height=H, bg=bg)
    j_cfg = JCfg(max_per_tile=K, backend="xla")
    j_args = tuple(jnp.asarray(x) for x in (means, quats, scales, opac, colors))
    j_bins = j_compute_bins(*j_args[:3], j_cam, j_cfg)
    im_j = np.asarray(j_rasterize(*j_args, j_cam, j_cfg, bins=j_bins).im)

    t_cam = t_make_camera(k, eye, width=W, height=H, bg=bg)
    t_cfg = TCfg(max_per_tile=K)
    t_args = [torch.as_tensor(x) for x in (means, quats, scales, opac, colors)]
    with torch.no_grad():
        t_bins = t_compute_bins(*t_args[:3], t_cam, t_cfg)
        im_t = t_rasterize(*t_args, t_cam, t_cfg, bins=t_bins).im.numpy()

    counts_j = np.asarray(j_bins.counts)
    np.testing.assert_array_equal(t_bins.counts.numpy(), counts_j)
    overflow = counts_j == K
    assert overflow.sum() >= 4, "the scene must overflow K on several tiles"

    diff = np.abs(im_t - im_j)
    psnr = 10 * np.log10(1.0 / max(float(np.mean(diff ** 2)), 1e-20))
    # Measured on this scene: all 4 tiles (32x128) overflow; mean |diff|
    # 5.3e-4, max 0.34, PSNR 43.7 dB. The covers the two binners keep differ
    # only behind more than a hundred others: held to the bound gsdx sets
    # its own bucket approximation against its exact binning
    # (tests/test_koverflow.py: mean 2e-3, PSNR 40 dB).
    assert float(diff.mean()) < 2e-3, diff.mean()
    assert psnr > 40.0, psnr
    assert float(diff.max()) > 1e-3  # the two binners do differ here

    # the port's exact nearest K is gsdx's exact depth-ordered binning
    im_sort = np.asarray(j_rasterize(*j_args, j_cam, j_cfg._replace(binning="sort")).im)
    np.testing.assert_allclose(im_t, im_sort, rtol=0, atol=1e-5)
