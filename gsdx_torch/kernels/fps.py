"""Farthest-point sampling on the device (counterpart of
`gsdx/kernels/fps.py`, which is plain JAX there too).

A loop of n_samples masked distance updates with no host sync. Indices
equal gsdx's exactly: both `jnp.argmax` and `torch.argmax` return the FIRST
maximum, so duplicated points resolve to the same index, and the distances
are summed over the coordinates in the same order and rounding (`_sq_dist`).

`fps_rad_idx` is the radius-stopping variant: greedy FPS that stops once
every point lies within ``radius`` of a sample. It runs a fixed
``max_samples`` trips and returns a keep mask.
"""

from __future__ import annotations

import torch

_INF = 1e10


def _sq_dist(points, centroid):
    """Squared distances accumulated over the coordinates in order (any
    width; the planner's action grid is 4-D), each step one fused
    multiply-add rounded to f32, as XLA's CPU backend computes
    ``jnp.sum((p - c) ** 2, -1)``. f64 holds the f32 product exactly, so
    rounding the f64 sum to f32 gives the FMA's result (bar a rare double
    rounding). The exact rounding matters on grids, where many distances
    tie."""
    d = (points - centroid).double()
    out = torch.zeros(points.shape[0], dtype=points.dtype, device=points.device)
    for c in range(d.shape[1]):
        out = (out.double() + d[:, c] * d[:, c]).to(points.dtype)
    return out


def farthest_point_sampling(points: torch.Tensor, n_samples: int,
                            start_idx: int = 0,
                            valid: torch.Tensor | None = None) -> torch.Tensor:
    """Indices (n_samples,) int64 of greedy farthest points among ``points``
    (N, D); the first is ``start_idx``. With fewer valid points than
    n_samples indices repeat."""
    n = points.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    inf = torch.full((n,), _INF, device=points.device)
    dist = torch.where(valid, inf, -inf)
    idxs = torch.zeros(n_samples, dtype=torch.int64, device=points.device)
    farthest = torch.tensor(start_idx, dtype=torch.int64, device=points.device)
    for i in range(n_samples):
        idxs[i] = farthest
        d = torch.where(valid, _sq_dist(points, points[farthest]), -inf)
        dist = torch.minimum(dist, d)
        farthest = torch.argmax(dist)  # first maximum, as jnp.argmax
    return idxs


def fps_rad_idx(points: torch.Tensor, radius: float, max_samples: int,
                start_idx: int = 0, valid: torch.Tensor | None = None):
    """Radius-stopping FPS: (indices (max_samples,) int64, keep (max_samples,)
    bool). keep marks the samples taken before the farthest remaining point
    came within ``radius``."""
    n = points.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    inf = torch.full((n,), _INF, device=points.device)
    dist = torch.where(valid, inf, -inf)
    r2 = torch.tensor(radius, dtype=torch.float32, device=points.device) ** 2
    idxs = torch.zeros(max_samples, dtype=torch.int64, device=points.device)
    keep = torch.zeros(max_samples, dtype=torch.bool, device=points.device)
    farthest = torch.tensor(start_idx, dtype=torch.int64, device=points.device)
    active = torch.tensor(True, device=points.device)
    for i in range(max_samples):
        idxs[i] = farthest
        keep[i] = active
        d = torch.where(valid, _sq_dist(points, points[farthest]), -inf)
        dist = torch.minimum(dist, d)
        farthest = torch.argmax(dist)
        active = active & (torch.max(dist) > r2)
    return idxs, keep
