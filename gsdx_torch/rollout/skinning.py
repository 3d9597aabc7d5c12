"""Gaussian skinning: sparse bone motions interpolated to every splat
(counterpart of `gsdx/rollout/skinning.py`).

Per bone i, F_i = sum_j rel_ij (new_j - new_i)(old_j - old_i)^T over its
neighbours, and its rotation is the det-corrected Kabsch fit of F_i (one
batched 3x3 SVD for all bones); a bone without neighbours keeps the
identity. Each particle moves by the inverse-distance blend of every
bone's rigid transform, and its quaternion turns by the blend of the
bones' rotations.

For rank >= 2, R = U diag(1, 1, sign det) V^T is unique, so any SVD gives
the same R. For a rank-1 F (a bone with one neighbour, or neighbours on a
line) it is not, and the CPU's LAPACK and the card's cuSOLVER may return
different rotations.
"""

from __future__ import annotations

import torch

from gsdx_torch.core.transforms import quat_multiply, quat_normalize, rotmat_to_quat


def relations_to_matrix(Rr: torch.Tensor, Rs: torch.Tensor, n: int) -> torch.Tensor:
    """(max_nR, N) one-hot receiver / sender rows -> (n, n) f32 adjacency of
    the first n nodes."""
    valid = torch.sum(Rr, 1) > 0
    contrib = torch.einsum("er,es->rs", Rr * valid[:, None], Rs)
    return (contrib[:n, :n] > 0).to(torch.float32)


def bone_covariance(bones, motions, relations, bone_mask=None):
    """(F (n_bones, 3, 3), neighbour count (n_bones,)): each bone's
    F_i = sum_j rel_ij (new_j - new_i)(old_j - old_i)^T over its unmasked
    neighbours."""
    rel = relations
    if bone_mask is not None:
        m = bone_mask.to(torch.float32)
        rel = rel * m[:, None] * m[None, :]
    old_off = bones[None, :, :] - bones[:, None, :]  # (i, j, 3): neighbour - self
    new_pts = bones + motions
    new_off = new_pts[None, :, :] - new_pts[:, None, :]
    return torch.einsum("ij,ija,ijb->iab", rel, new_off, old_off), torch.sum(rel, 1)


def bone_rotations(bones, motions, relations, bone_mask=None):
    """(n_bones, 3, 3) rigid rotation of each bone from its neighbours'
    offsets before and after ``motions``."""
    F, n_adj = bone_covariance(bones, motions, relations, bone_mask)
    U, _, Vt = torch.linalg.svd(F)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = U @ D @ Vt
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand_as(R)
    return torch.where((n_adj > 0)[:, None, None], R, eye)


def interpolate_motions(bones, motions, relations, xyz, quat=None, bone_mask=None,
                        weights=None):
    """Skin particles ``xyz`` (n_particles, 3), and quaternions ``quat``
    (n_particles, 4) if given, to bones (n_bones, 3) moving by ``motions``.
    ``bone_mask`` (n_bones,) drops bones; ``weights`` (n_particles, n_bones)
    defaults to normalised inverse distances (clamped at 1e-4). Returns
    (xyz_new, quat_new or None, weights)."""
    R = bone_rotations(bones, motions, relations, bone_mask)

    if weights is None:
        d = torch.clamp(torch.linalg.norm(xyz[:, None, :] - bones[None, :, :], dim=-1),
                        min=1e-4)
        w = 1.0 / d
        if bone_mask is not None:
            w = w * bone_mask.to(w.dtype)[None, :]
        weights = w / torch.clamp(torch.sum(w, 1, keepdim=True), min=1e-12)

    rel_pos = xyz[:, None, :] - bones[None, :, :]  # (np, nb, 3)
    moved = torch.einsum("pbj,bij->pbi", rel_pos, R) + motions[None] + bones[None]
    xyz_new = torch.einsum("pbi,pb->pi", moved, weights)

    quat_new = None
    if quat is not None:
        base_quats = quat_normalize(rotmat_to_quat(R))
        q = quat_normalize(torch.einsum("bq,pb->pq", base_quats, weights))
        quat_new = quat_multiply(q, quat)
    return xyz_new, quat_new, weights
