"""Point-cloud geometry on the device (counterpart of
`gsdx/core/pointcloud.py`): voxel downsampling and statistical / radius
outlier removal, fixed shape with masks instead of compaction; depth
unprojection (`depth2fgpcd`) and a RANSAC plane fit (`segment_plane`).
"""

from __future__ import annotations

import numpy as np
import torch

from gsdx_torch.kernels.knn import knn

_GRID = 2048  # voxel grid span per axis


def voxel_downsample(points: torch.Tensor, voxel_size: float, max_points: int,
                     valid: torch.Tensor | None = None):
    """Average the points of each voxel (Open3D's `voxel_down_sample`).

    Returns (points (max_points, 3), mask (max_points,)), voxels in
    increasing voxel-id order; voxels beyond max_points are dropped. gsdx
    sorts on a pair of int32 keys (x * GRID + y, z) because GRID^3 does not
    fit int32; here the pair is one int64 key under a stable sort, the
    same order. Each voxel's sum is taken in float64, so the mean does not
    depend on the order of the card's atomic adds (an f32 sum of a dense
    voxel of a 720p view parts by ~1e-6 m between two orders).
    """
    n = points.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    valid = valid.bool()
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=points.device)
    origin = torch.where(valid[:, None], points, torch.full_like(points, 1e9)).min(0).values
    ij = torch.floor((points - origin) / vs).to(torch.int64).clamp(0, _GRID - 1)
    big = torch.iinfo(torch.int32).max
    key = torch.where(valid, (ij[:, 0] * _GRID + ij[:, 1]) * (1 << 31) + ij[:, 2],
                      torch.full_like(ij[:, 0], big * (1 << 31) + big))
    order = torch.sort(key, stable=True).indices
    key_s, pts_s, valid_s = key[order], points[order], valid[order]
    new_vox = torch.ones_like(valid_s)
    new_vox[1:] = key_s[1:] != key_s[:-1]
    new_vox &= valid_s
    seg = torch.cumsum(new_vox.to(torch.int64), 0) - 1  # voxel rank
    seg = torch.where(valid_s & (seg < max_points), seg,
                      torch.full_like(seg, max_points))  # spare row
    sums = torch.zeros((max_points + 1, 3), dtype=torch.float64, device=points.device)
    sums.index_add_(0, seg, pts_s.double() * valid_s[:, None])
    cnts = torch.zeros(max_points + 1, dtype=torch.float64, device=points.device)
    cnts.index_add_(0, seg, valid_s.double())
    sums, cnts = sums[:max_points], cnts[:max_points]
    return (sums / torch.clamp(cnts[:, None], min=1.0)).to(points.dtype), cnts > 0


def statistical_outlier_mask(points: torch.Tensor, nb_neighbors: int,
                             std_ratio: float, valid: torch.Tensor | None = None):
    """Inlier mask (Open3D's `remove_statistical_outlier`): keep points
    whose mean k-NN distance is at most mean + std_ratio * std."""
    n = points.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    valid = valid.bool()
    sq, _ = knn(points, nb_neighbors, valid=valid)
    mean_d = torch.mean(torch.sqrt(torch.clamp(sq, min=0.0)), 1)
    vf = valid.to(points.dtype)
    denom = torch.clamp(vf.sum(), min=1.0)
    mu = torch.sum(mean_d * vf) / denom
    var = torch.sum((mean_d - mu) ** 2 * vf) / denom
    thresh = mu + torch.tensor(std_ratio, dtype=points.dtype,
                               device=points.device) * torch.sqrt(var)
    return (mean_d <= thresh) & valid


def radius_outlier_mask(points: torch.Tensor, nb_points: int, radius: float,
                        valid: torch.Tensor | None = None):
    """Open3D's `remove_radius_outlier`: keep points with at least
    ``nb_points`` neighbours within ``radius``."""
    sq, _ = knn(points, nb_points, valid=valid)
    r2 = torch.tensor(radius, dtype=torch.float32, device=points.device) ** 2
    keep = torch.sum(sq <= r2, 1) >= nb_points
    return keep & valid.bool() if valid is not None else keep


def iterative_statistical_outliers(points, nb_neighbors: int = 50,
                                   std_start: float = 2.0, std_step: float = 0.5,
                                   max_iters: int = 10) -> np.ndarray:
    """Escalating outlier removal until nothing changes. Returns the inlier
    indices into ``points`` (host loop, device steps)."""
    pts = torch.as_tensor(points)
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    for it in range(max_iters):
        new_valid = statistical_outlier_mask(pts, nb_neighbors,
                                             std_start + it * std_step, valid=valid)
        if bool(torch.equal(new_valid, valid)):
            break
        valid = new_valid
    return np.nonzero(valid.cpu().numpy())[0]


def depth2fgpcd(depth: torch.Tensor, mask: torch.Tensor, k: torch.Tensor):
    """Unproject a masked depth map to camera-frame points
    (`src/real_world/utils/pcd_utils.py` depth2fgpcd). Returns (H*W, 3)
    points with a validity mask (fixed shape)."""
    H, W = depth.shape
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    ys, xs = torch.meshgrid(torch.arange(H, device=depth.device),
                            torch.arange(W, device=depth.device), indexing="ij")
    z = depth
    x = (xs - cx) * z / fx
    y = (ys - cy) * z / fy
    pts = torch.stack([x, y, z], -1).reshape(-1, 3)
    valid = (mask.bool() & (depth > 0)).reshape(-1)
    return pts, valid


def segment_plane(points: torch.Tensor, dist_thresh: float,
                  generator: torch.Generator | None = None,
                  valid: torch.Tensor | None = None, n_iters: int = 256,
                  idx: torch.Tensor | None = None):
    """RANSAC plane fit (Open3D's `segment_plane`): returns (plane (4,),
    inlier mask). ``n_iters`` candidate triplets, drawn uniformly from the
    points with ``generator`` (or given as ``idx`` (n_iters, 3)), are
    scored in one batch; the first with the most inliers wins."""
    n = points.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    if idx is None:
        idx = torch.randint(0, n, (n_iters, 3), generator=generator,
                            device=generator.device if generator is not None else "cpu")
    idx = idx.to(points.device).long()
    p0, p1, p2 = (points[idx[:, i]] for i in range(3))
    normal = torch.linalg.cross(p1 - p0, p2 - p0)
    normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-9)
    d = -torch.sum(normal * p0, -1)  # (n_iters,)
    dist = torch.abs(points @ normal.T + d[None, :])  # (n, n_iters)
    inl = (dist <= dist_thresh) & valid.bool()[:, None]
    best = int(torch.argmax(inl.sum(0)))  # first of the largest, as jnp.argmax
    plane = torch.cat([normal[best], d[best][None]])
    return plane, inl[:, best]
