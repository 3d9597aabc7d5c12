"""Set-distance losses (counterpart of `gsdx/dynamics/losses.py`): Chamfer,
Hausdorff, Sinkhorn EMD on the device and exact Hungarian EMD on the host."""

from __future__ import annotations

import math

import numpy as np
import torch


def _pairwise_dist(x, y):
    """(B, N, D), (B, M, D) -> (B, N, M) euclidean, as gsdx computes it."""
    d2 = (torch.sum(x * x, -1)[:, :, None]
          - 2 * torch.einsum("bnd,bmd->bnm", x, y)
          + torch.sum(y * y, -1)[:, None, :])
    return torch.sqrt(torch.clamp(d2, min=1e-12))


def chamfer_distance(pred, target):
    """Mean of the row minima plus mean of the column minima."""
    d = _pairwise_dist(pred, target)
    return torch.mean(d.min(2).values) + torch.mean(d.min(1).values)


def hausdorff_distance(pred, target):
    d = _pairwise_dist(pred, target)
    return torch.max(d.min(2).values) + torch.max(d.min(1).values)


def emd_distance(pred, target, n_iters: int = 50, eps: float = 0.01):
    """Entropy-regularized optimal transport (Sinkhorn in log space)."""
    d = _pairwise_dist(pred, target)  # (B, N, M)
    B, N, M = d.shape
    log_k = -d / eps
    log_u = d.new_zeros((B, N))
    log_v = d.new_zeros((B, M))
    log_a, log_b = -math.log(N), -math.log(M)
    for _ in range(n_iters):
        log_u = log_a - torch.logsumexp(log_k + log_v[:, None, :], dim=2)
        log_v = log_b - torch.logsumexp(log_k + log_u[:, :, None], dim=1)
    pi = torch.exp(log_u[:, :, None] + log_k + log_v[:, None, :])
    return torch.sum(pi * d) / B


def emd_distance_exact(pred, target):
    """Exact Hungarian EMD on the host (scipy), non-differentiable."""
    from scipy.optimize import linear_sum_assignment

    pred = np.asarray(pred.detach().cpu() if torch.is_tensor(pred) else pred)
    target = np.asarray(target.detach().cpu() if torch.is_tensor(target) else target)
    total = 0.0
    for i in range(pred.shape[0]):
        d = np.linalg.norm(pred[i][:, None] - target[i][None], axis=-1)
        ri, ci = linear_sum_assignment(d)
        total += np.linalg.norm(pred[i][ri] - target[i][ci], axis=-1).mean()
    return total / pred.shape[0]
