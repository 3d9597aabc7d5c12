"""EWA projection of 3D Gaussians to screen space (counterpart of
`gsdx/render/projection.py`; differentiated by autograd).

  * camera transform  p_cam = w2c @ p_world, depth = z
  * 3D covariance     Sigma = R S S^T R^T (`compute_cov3d`)
  * EWA 2D covariance cov2d = J W R S S^T R^T W^T J^T + 0.3 I, with the
    Jacobian's x/z, y/z clamped to 1.3x the field of view
  * conic = inverse(cov2d), radius = ceil(3 sqrt(lambda_max))
  * pixel centre      (fx x/z + cx - 0.5, fy y/z + cy - 0.5)
  * near culling at z <= 0.2
"""

from __future__ import annotations

import dataclasses

import torch

from gsdx_torch.core.cameras import Camera
from gsdx_torch.core.transforms import quat_normalize, quat_to_rotmat

# The reference rasterizer culls against a fixed 0.2 view-space z.
NEAR_CULL_Z = 0.2


@dataclasses.dataclass
class ProjectedGaussians:
    """mean2d (N, 2) pixels; conic (N, 3) (a, b, c) with power =
    -0.5 (a dx^2 + c dy^2) - b dx dy; depth (N,) view z; radius (N,) pixel
    extent, 0 when culled; mask (N,) bool visible."""

    mean2d: torch.Tensor
    conic: torch.Tensor
    depth: torch.Tensor
    radius: torch.Tensor
    mask: torch.Tensor


def compute_cov3d(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) world covariance R S S^T R^T from quats (normalized here)
    and scales, on their device. `project_gaussians` writes the same product
    out per component."""
    M = quat_to_rotmat(quats) * scales[:, None, :]  # R @ diag(s)
    return M @ M.transpose(-1, -2)


def project_gaussians(
    means3d: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    camera: Camera,
    live: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """Project N world-space Gaussians into screen space for one camera."""
    W = camera.w2c[:3, :3]
    t = camera.w2c[:3, 3]
    mxw, myw, mzw = means3d.unbind(-1)
    tx = mxw * W[0, 0] + myw * W[0, 1] + mzw * W[0, 2] + t[0]
    ty = mxw * W[1, 0] + myw * W[1, 1] + mzw * W[1, 2] + t[1]
    tz = mxw * W[2, 0] + myw * W[2, 1] + mzw * W[2, 2] + t[2]

    in_front = tz > NEAR_CULL_Z
    # finite tz for culled entries so no NaN reaches the gradients
    tz_safe = torch.where(in_front, tz, torch.ones_like(tz))

    lim_x = 1.3 * camera.tan_fovx
    lim_y = 1.3 * camera.tan_fovy
    txz = torch.clamp(tx / tz_safe, -lim_x, lim_x)
    tyz = torch.clamp(ty / tz_safe, -lim_y, lim_y)

    # cov2d = U U^T + 0.3 I with V = J W and U = V R(q) diag(s), written out
    # per component. J rows: [fx/tz, 0, -fx*txz/tz], [0, fy/tz, -fy*tyz/tz].
    fx, fy = camera.fx, camera.fy
    inv_tz = 1.0 / tz_safe
    a0 = fx * inv_tz
    b0 = -fx * txz * inv_tz
    a1 = fy * inv_tz
    b1 = -fy * tyz * inv_tz
    v00 = a0 * W[0, 0] + b0 * W[2, 0]
    v01 = a0 * W[0, 1] + b0 * W[2, 1]
    v02 = a0 * W[0, 2] + b0 * W[2, 2]
    v10 = a1 * W[1, 0] + b1 * W[2, 0]
    v11 = a1 * W[1, 1] + b1 * W[2, 1]
    v12 = a1 * W[1, 2] + b1 * W[2, 2]

    qr, qx, qy, qz = quat_normalize(quats).unbind(-1)
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qr * qz)
    r02 = 2 * (qx * qz + qr * qy)
    r10 = 2 * (qx * qy + qr * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qr * qx)
    r20 = 2 * (qx * qz - qr * qy)
    r21 = 2 * (qy * qz + qr * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)

    s0, s1, s2 = scales.unbind(-1)
    u00 = (v00 * r00 + v01 * r10 + v02 * r20) * s0
    u01 = (v00 * r01 + v01 * r11 + v02 * r21) * s1
    u02 = (v00 * r02 + v01 * r12 + v02 * r22) * s2
    u10 = (v10 * r00 + v11 * r10 + v12 * r20) * s0
    u11 = (v10 * r01 + v11 * r11 + v12 * r21) * s1
    u12 = (v10 * r02 + v11 * r12 + v12 * r22) * s2

    # low-pass dilation: every splat covers at least ~1 pixel
    c00 = u00 * u00 + u01 * u01 + u02 * u02 + 0.3
    c11 = u10 * u10 + u11 * u11 + u12 * u12 + 0.3
    c01 = u00 * u10 + u01 * u11 + u02 * u12

    det = c00 * c11 - c01 * c01
    invertible = det != 0.0
    det_safe = torch.where(invertible, det, torch.ones_like(det))
    conic = torch.stack([c11 / det_safe, -c01 / det_safe, c00 / det_safe], -1)

    mid = 0.5 * (c00 + c11)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))

    pix_x = fx * tx / tz_safe + camera.cx - 0.5
    pix_y = fy * ty / tz_safe + camera.cy - 0.5
    mean2d = torch.stack([pix_x, pix_y], dim=-1)

    mask = in_front & invertible & (radius > 0)
    if live is not None:
        mask = mask & (live > 0)
    radius = torch.where(mask, radius, torch.zeros_like(radius))
    return ProjectedGaussians(mean2d=mean2d, conic=conic, depth=tz,
                              radius=radius, mask=mask)
