"""Dynamic-GS tracking losses (counterpart of `gsdx/track/losses.py`).

Losses run on fixed-capacity tensors with liveness/foreground masks; masked
means divide by the mask population.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from gsdx_torch.core.cameras import Camera
from gsdx_torch.core.gaussians import GaussianParams, TrackingVariables
from gsdx_torch.core.transforms import quat_multiply, quat_normalize, quat_to_rotmat
from gsdx_torch.render.rasterize import RasterizeConfig, rasterize
from gsdx_torch.render.renderer import params_to_rendervar


class LossWeights(NamedTuple):
    im: float = 50.0
    seg: float = 200.0
    rigid: float = 200.0
    bg: float = 200.0
    iso: float = 1000.0
    rot: float = 4.0
    floor: float = 2.0
    soft_col_cons: float = 0.01  # weighs a term that is always 0


def _abs(x):
    """|x| with JAX's derivative, 1 at x == 0 (torch.abs's is 0 there).
    Losses meet exact zeros where a render and its target agree, as on a
    masked target's black background."""
    return torch.where(x >= 0, x, -x)


def l1_loss(x, y):
    return _abs(x - y).mean()


def _masked_mean(x, mask, eps=1e-8):
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=eps)


def weighted_l2_v1(x, y, w, mask):
    """sqrt((x-y)^2 * w + 1e-20), masked mean."""
    return _masked_mean(torch.sqrt((x - y) ** 2 * w + 1e-20), mask)


def weighted_l2_v2(x, y, w, mask):
    """sqrt(sum_last((x-y)^2) * w + 1e-20), masked mean."""
    return _masked_mean(torch.sqrt(torch.sum((x - y) ** 2, dim=-1) * w + 1e-20),
                        mask)


_WINDOW_1D = np.exp(-((np.arange(11) - 5) ** 2) / (2 * 1.5**2)).astype(np.float32)
_WINDOW_1D /= _WINDOW_1D.sum()


def _blur_once(x: torch.Tensor) -> torch.Tensor:
    """Depthwise separable 11-tap Gaussian (sigma 1.5) over (N, H, W), zero
    padding SAME, in full f32: cuDNN's TF32 is switched off for the call
    whatever the global flag says."""
    n = x.shape[0]
    w = torch.as_tensor(_WINDOW_1D, device=x.device)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv2d(x[None], w.view(1, 1, 11, 1).expand(n, 1, 11, 1),
                     padding=(5, 0), groups=n)
        y = F.conv2d(y, w.view(1, 1, 1, 11).expand(n, 1, 1, 11),
                     padding=(0, 5), groups=n)
    return y[0]


class _Blur(torch.autograd.Function):
    """The blur is self-adjoint (symmetric window, zero padding), so its
    backward is the same f32 blur — also run with TF32 off, which a plain
    conv2d backward would not guarantee."""

    @staticmethod
    def forward(ctx, x):
        return _blur_once(x)

    @staticmethod
    def backward(ctx, g):
        return _blur_once(g.contiguous())


def _filter2d(img: torch.Tensor) -> torch.Tensor:
    return _Blur.apply(img.contiguous())


def calc_ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """11x11 Gaussian-window SSIM (sigma 1.5) of two (C, H, W) images; the
    five blurs run as one depthwise pass."""
    c = img1.shape[0]
    blur = _filter2d(torch.cat([img1, img2, img1 * img1, img2 * img2,
                                img1 * img2]))
    mu1, mu2, e11, e22, e12 = blur.split(c)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


def calc_psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img1 - img2) ** 2)
    return 20 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


@dataclasses.dataclass
class LossAux:
    radius: torch.Tensor  # (N,)
    seen: torch.Tensor  # (N,) bool
    psnr: torch.Tensor  # scalar, colour render vs target
    losses: dict  # name -> scalar


def tracking_loss(
    params: GaussianParams,
    mean2d_dummy: torch.Tensor,
    camera: Camera,
    target_im: torch.Tensor,
    target_seg: torch.Tensor,
    variables: TrackingVariables,
    weights: LossWeights,
    is_initial_timestep: bool,
    raster_cfg: RasterizeConfig,
    bins=None,
):
    """Total tracking loss for one camera view; returns (loss, LossAux).

    rgb and seg render as 6 channels in one rasterizer pass, so the
    densification gradient includes the seg term. mean2d_dummy: (N, 2)
    zeros whose gradient feeds the densification statistics; ``bins``
    reuses `compute_bins` lists.
    """
    losses = {}
    rv = params_to_rendervar(params)
    cid = camera.cam_id
    out = rasterize(rv["means3D"], rv["rotations"], rv["scales"], rv["opacities"],
                    torch.cat([rv["colors_precomp"], params.seg_colors], 1),
                    camera, raster_cfg, live=params.live,
                    mean2d_offset=mean2d_dummy, bins=bins)
    im = torch.exp(params.cam_m[cid])[:, None, None] * out.im[:3] + (
        params.cam_c[cid][:, None, None])
    seg_im = out.im[3:6]
    losses["im"] = 0.8 * l1_loss(im, target_im) + 0.2 * (
        1.0 - calc_ssim(im, target_im))
    losses["seg"] = 0.8 * l1_loss(seg_im, target_seg) + 0.2 * (
        1.0 - calc_ssim(seg_im, target_seg))

    if not is_initial_timestep:
        losses.update(rigidity_losses(params, variables))
    weight_map = {"im": weights.im, "seg": weights.seg, "rigid": weights.rigid,
                  "iso": weights.iso, "rot": weights.rot,
                  "floor": weights.floor, "bg": weights.bg}
    loss = sum(weight_map[k] * v for k, v in losses.items())
    aux = LossAux(radius=out.radius, seen=out.radius > 0,
                  psnr=calc_psnr(im, target_im), losses=losses)
    return loss, aux


def rigidity_losses(params: GaussianParams, v: TrackingVariables) -> dict:
    """rigid / rot / iso / floor / bg losses over the fixed-shape KNN
    tables; foreground = seg channel 0 > 0.5 and live."""
    is_fg = (params.seg_colors[:, 0] > 0.5) & (params.live > 0)
    is_bg = (params.seg_colors[:, 0] <= 0.5) & (params.live > 0)
    fg_f = is_fg.float()
    pts = params.means3d
    rot = quat_normalize(params.unnorm_rotations)
    rel_rot = quat_multiply(rot, v.prev_inv_rot)
    R = quat_to_rotmat(rel_rot)  # (N, 3, 3)
    nbr_idx = v.neighbor_indices
    curr_offset = pts[nbr_idx] - pts[:, None]  # (N, K, 3)
    # offsets rotated into the previous frame: R^T @ offset
    curr_offset_prev = torch.einsum("nij,nki->nkj", R, curr_offset)
    nbr_mask = v.neighbor_valid * fg_f[:, None]

    losses = {}
    losses["rigid"] = weighted_l2_v2(curr_offset_prev, v.prev_offset,
                                     v.neighbor_weight, nbr_mask)
    losses["rot"] = weighted_l2_v2(rel_rot[nbr_idx], rel_rot[:, None],
                                   v.neighbor_weight, nbr_mask)
    curr_mag = torch.sqrt(torch.sum(curr_offset**2, dim=-1) + 1e-20)
    losses["iso"] = weighted_l2_v1(curr_mag, v.neighbor_dist, v.neighbor_weight,
                                   nbr_mask)
    losses["floor"] = _masked_mean(torch.clamp(pts[:, 1], min=0.0), fg_f)
    bg_f = is_bg.float()
    losses["bg"] = _masked_mean(torch.sum(_abs(pts - v.init_bg_pts), -1),
                                bg_f) + _masked_mean(
        torch.sum(_abs(rot - v.init_bg_rot), -1), bg_f)
    return losses
