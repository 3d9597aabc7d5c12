"""Dynamics training utilities (counterpart of `gsdx/dynamics/utils.py`):
batched masked Umeyama alignment and the auxiliary losses of GNN training.
"""

from __future__ import annotations

import torch

from gsdx_torch.dynamics.model import relations


def umeyama(src, dst, mask, fixed_scale: bool = True):
    """Batched masked rigid alignment of ``src`` onto ``dst`` (B, N, 3),
    ``mask`` (B, N) bool. Returns (scale (B,), R (B, 3, 3), t (B, 3)) with
    dst ~= scale * src @ R^T + t; R = U diag(1, 1, sign det(U V^T)) V^T
    from the SVD of the masked cross-covariance."""
    m = mask.to(src.dtype)[..., None]
    n = torch.clamp(torch.sum(m, 1), min=1e-6)  # (B, 1)
    mu_src = torch.sum(src * m, 1) / n
    mu_dst = torch.sum(dst * m, 1) / n
    sc = (src - mu_src[:, None]) * m
    dc = (dst - mu_dst[:, None]) * m
    cov = torch.einsum("bni,bnj->bij", dc, sc) / n[..., None]
    U, S, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U @ Vt)
    D = torch.eye(3, dtype=src.dtype, device=src.device).repeat(src.shape[0], 1, 1)
    D[:, 2, 2] = torch.sign(det)
    R = U @ D @ Vt
    if fixed_scale:
        scale = torch.ones(src.shape[0], dtype=src.dtype, device=src.device)
    else:
        var = torch.sum(sc * sc, (1, 2)) / n[:, 0]
        scale = torch.sum(S * torch.diagonal(D, dim1=1, dim2=2), 1) / var
    t = mu_dst - scale[:, None] * torch.einsum("bij,bj->bi", R, mu_src)
    return scale, R, t


def mse_loss(pred, gt):
    """MSE over the padded arrays, padded particles included (gsdx and the
    reference trainer do not mask them)."""
    return torch.mean((pred - gt) ** 2)


def length_loss(pred, state, Rr, Rs):
    """Edge-length preservation against the OLDEST history frame
    (``state[:, 0]``, detached), over the object columns of Rr / Rs: one-hot
    rows (B, n_rel, N), node indices (B, n_rel), or `relations` of either
    over the n_p object columns. An empty slot (-1) or a tool end (index
    n_p or more) reads a zero row; the mean is over every slot."""
    n_p = pred.shape[1]
    pos = state[:, 0, :n_p].detach()
    recv, send = relations(Rr, n_p), relations(Rs, n_p)
    pos_diff = recv.select(pos) - send.select(pos)
    pred_diff = recv.select(pred) - send.select(pred)
    pos_len = torch.sqrt(torch.sum(pos_diff ** 2, -1) + 1e-12)
    pred_len = torch.sqrt(torch.sum(pred_diff ** 2, -1) + 1e-12)
    return torch.mean((pred_len - pos_len) ** 2)


def rigid_loss(pred, state, obj_mask, mask_count=None):
    """Masked squared distance of ``pred`` from the best rigid fit of the
    oldest history frame onto it; the fit is detached. The sum is divided
    by 3 x ``mask_count``, by default ``obj_mask``'s own count of masked
    particles (data-parallel ranks pass the mean count over the ranks, so
    that the mean of their losses is the whole batch's)."""
    orig = state[:, 0, : pred.shape[1]]
    with torch.no_grad():
        _, R, t = umeyama(orig, pred, obj_mask, fixed_scale=True)
        pred_ume = torch.einsum("bni,bji->bnj", orig, R) + t[:, None]
    m = obj_mask.to(pred.dtype)[..., None]
    count = torch.sum(m) if mask_count is None else mask_count
    return torch.sum((pred - pred_ume) ** 2 * m) / torch.clamp(count * 3, min=1e-6)
