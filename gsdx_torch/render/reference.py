"""Dense reference renderer — slow, exact, differentiable; a test oracle
(counterpart of `gsdx/render/reference.py`).

Composites every Gaussian against every pixel with strict front-to-back
sequential semantics, those of the CUDA reference rasterizer
(`diff-gaussian-rasterization-w-depth`): depth sort, alpha = min(0.99,
opacity * exp(power)), skip power > 0 and alpha < 1/255, and stop a pixel
once its transmittance would drop below 1e-4. O(N * H * W) memory and work:
for tiny scenes in tests and in `chip_smoke.py`. Plain PyTorch, so autograd
gives reference gradients for `render/rasterize.py`.
"""

from __future__ import annotations

import torch

from gsdx_torch.core.cameras import Camera
from gsdx_torch.render.projection import project_gaussians

ALPHA_MIN = 1.0 / 255.0
T_STOP = 1e-4
ALPHA_MAX = 0.99


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    cum = torch.cumsum(x, 0)
    return cum, torch.cat([torch.zeros_like(cum[:1]), cum[:-1]], 0)


def render_reference(
    means3d: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    camera: Camera,
    live: torch.Tensor | None = None,
    mean2d_offset: torch.Tensor | None = None,
    strict_t_stop: bool = True,
):
    """Render (im (3, H, W), radius (N,), depth (H, W), final_T (H, W)).

    ``mean2d_offset`` is an (N, 2) zeros tensor whose gradient is the
    screen-space positional gradient (the reference's ``means2D`` dummy).

    ``strict_t_stop``: emulate the CUDA early termination (contributions are
    cut once transmittance crosses 1e-4). The tile compositor stops per
    tile at granule boundaries instead; set False to compare with it at
    tight tolerances.
    """
    proj = project_gaussians(means3d, quats, scales, camera, live=live)
    mean2d = proj.mean2d
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset

    H, W = camera.height, camera.width
    N = means3d.shape[0]
    dev = means3d.device

    inf = torch.tensor(float("inf"), device=dev)
    order = torch.argsort(torch.where(proj.mask, proj.depth, inf), stable=True)
    mean2d_s = mean2d[order]
    conic_s = proj.conic[order]
    depth_s = proj.depth[order]
    mask_s = proj.mask[order]
    op_s = opacities.reshape(N)[order]
    col_s = colors[order]

    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")  # (H, W)
    dx = px[None] - mean2d_s[:, 0][:, None, None]  # (N, H, W)
    dy = py[None] - mean2d_s[:, 1][:, None, None]
    a, b, c = (conic_s[:, i][:, None, None] for i in range(3))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.minimum(torch.tensor(ALPHA_MAX, device=dev),
                          op_s[:, None, None] * torch.exp(power))
    zero = torch.zeros((), device=dev)
    alpha = torch.where((power > 0) | (alpha < ALPHA_MIN), zero, alpha)
    alpha = alpha * mask_s[:, None, None]

    # transmittance before each Gaussian: exclusive product of (1 - alpha)
    cum, log_t_before = _exclusive_cumsum(torch.log1p(-alpha))
    t_before = torch.exp(log_t_before)

    if strict_t_stop:
        # CUDA semantics: the Gaussian that would push T below 1e-4 and all
        # later ones are dropped; T freezes at its value before the cut
        cut = t_before * (1.0 - alpha) < T_STOP
        ever_cut = torch.cumsum(cut.to(torch.int32), 0) > 0
        alpha = torch.where(ever_cut, zero, alpha)
        cum, log_t_before = _exclusive_cumsum(torch.log1p(-alpha))
        t_before = torch.exp(log_t_before)

    w = alpha * t_before  # (N, H, W)
    rgb = torch.einsum("nhw,nc->chw", w, col_s)
    depth = torch.einsum("nhw,n->hw", w, depth_s)
    final_t = torch.exp(cum[-1])
    im = rgb + final_t[None] * camera.bg[:, None, None]
    return im, proj.radius, depth, final_t
