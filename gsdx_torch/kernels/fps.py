"""Farthest-point sampling on the device (counterpart of
`gsdx/kernels/fps.py`, which is plain JAX there too).

A loop of n_samples masked distance updates with no host sync, over a
batch of point sets at once: (B, P, D) points with a start index per row.
Indices equal gsdx's exactly: both `jnp.argmax` and `torch.argmax` return
the FIRST maximum, so duplicated points resolve to the same index, and the
distances are summed over the coordinates in the same order and rounding
(`_sq_dist`).

`fps_rad_idx` is the radius-stopping variant: greedy FPS that stops once
every point lies within ``radius`` of a sample. It runs a fixed
``max_samples`` trips and returns a keep mask.
"""

from __future__ import annotations

import torch

_INF = 1e10


def _sq_dist(points, centroid):
    """Squared distances (..., P) of ``points`` (..., P, D) from
    ``centroid`` (..., 1, D), accumulated over the coordinates in order
    (any width; the planner's action grid is 4-D), each step one fused
    multiply-add rounded to f32, as XLA's CPU backend computes
    ``jnp.sum((p - c) ** 2, -1)``. f64 holds the f32 product exactly, so
    rounding the f64 sum to f32 gives the FMA's result (bar a rare double
    rounding). The exact rounding matters on grids, where many distances
    tie."""
    d = (points - centroid).double()
    out = torch.zeros(points.shape[:-1], dtype=points.dtype, device=points.device)
    for c in range(d.shape[-1]):
        out = (out.double() + d[..., c] * d[..., c]).to(points.dtype)
    return out


def _start(start_idx, B: int, device) -> torch.Tensor:
    return torch.as_tensor(start_idx, dtype=torch.int64, device=device).expand(B).clone()


def _init_dist(valid, shape, device):
    if valid is None:
        return torch.full(shape, _INF, device=device)
    return torch.where(valid.bool(), _INF, -_INF).to(torch.float32).expand(shape).clone()


def _step(points, dist, farthest, valid):
    """One greedy step: fold the distances from the points at ``farthest``
    (B,) into ``dist`` (B, P); returns (dist, next farthest (B,))."""
    rows = torch.arange(points.shape[0], device=points.device)
    d = _sq_dist(points, points[rows, farthest][:, None])
    if valid is not None:
        d = torch.where(valid.bool(), d, -_INF)
    dist = torch.minimum(dist, d)
    return dist, torch.argmax(dist, dim=1)  # first maximum, as jnp.argmax


def farthest_point_sampling_batch(points: torch.Tensor, n_samples: int,
                                  start_idx: torch.Tensor | int = 0,
                                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Indices (B, n_samples) int64 of greedy farthest points of each row
    of ``points`` (B, P, D); row b starts at ``start_idx[b]`` (a (B,)
    tensor or one int for all). ``valid`` (P,) or (B, P) masks points out.
    With fewer valid points than n_samples indices repeat."""
    B, P, _ = points.shape
    dist = _init_dist(valid, (B, P), points.device)
    idxs = torch.zeros((B, n_samples), dtype=torch.int64, device=points.device)
    farthest = _start(start_idx, B, points.device)
    for i in range(n_samples):
        idxs[:, i] = farthest
        dist, farthest = _step(points, dist, farthest, valid)
    return idxs


def fps_rad_idx_batch(points: torch.Tensor, radius, max_samples: int,
                      start_idx: torch.Tensor | int = 0,
                      valid: torch.Tensor | None = None):
    """Radius-stopping FPS of each row of ``points`` (B, P, D): (indices
    (B, max_samples) int64, keep (B, max_samples) bool). keep marks the
    samples taken before the farthest remaining point came within
    ``radius`` (a float or a (B,) tensor)."""
    B, P, _ = points.shape
    dist = _init_dist(valid, (B, P), points.device)
    r = torch.as_tensor(radius, dtype=torch.float32, device=points.device)
    r2 = (r * r).expand(B)
    idxs = torch.zeros((B, max_samples), dtype=torch.int64, device=points.device)
    keep = torch.zeros((B, max_samples), dtype=torch.bool, device=points.device)
    farthest = _start(start_idx, B, points.device)
    active = torch.ones(B, dtype=torch.bool, device=points.device)
    for i in range(max_samples):
        idxs[:, i] = farthest
        keep[:, i] = active
        dist, farthest = _step(points, dist, farthest, valid)
        active = active & (torch.max(dist, dim=1).values > r2)
    return idxs, keep


def farthest_point_sampling(points: torch.Tensor, n_samples: int,
                            start_idx: int = 0,
                            valid: torch.Tensor | None = None) -> torch.Tensor:
    """Indices (n_samples,) int64 of greedy farthest points among ``points``
    (N, D); the first is ``start_idx``. With fewer valid points than
    n_samples indices repeat."""
    return farthest_point_sampling_batch(points[None], n_samples, start_idx,
                                         valid)[0]


def fps_rad_idx(points: torch.Tensor, radius: float, max_samples: int,
                start_idx: int = 0, valid: torch.Tensor | None = None):
    """Radius-stopping FPS of one point set (N, D): (indices (max_samples,)
    int64, keep (max_samples,) bool)."""
    idxs, keep = fps_rad_idx_batch(points[None], radius, max_samples, start_idx,
                                   valid)
    return idxs[0], keep[0]
