"""MPPI reward (counterpart of `gsdx/plan/cost.py`).

reward = -chamfer(final state, target)
         - 5 * mean collision penalty (pusher spawning inside the object)
         - 5 * mean out-of-workspace penalty.
"""

from __future__ import annotations

import torch

from gsdx_torch.dynamics.losses import _pairwise_dist

PUSHER_SIZE = 0.01


def _chamfer(x, y):
    """Batched chamfer (B, N, 3) vs (B, M, 3) -> (B,)."""
    d = _pairwise_dist(x, y)
    return torch.mean(d.min(2).values, 1) + torch.mean(d.min(1).values, 1)


def box_loss(state, target_box):
    """Mean distance of the particles outside an x-y box. state (B, N, 3),
    target_box (2, 2) [[xmin, xmax], [ymin, ymax]] -> (B,)."""
    xmin, xmax = target_box[0, 0], target_box[0, 1]
    ymin, ymax = target_box[1, 0], target_box[1, 1]
    x = state[:, :, 0]
    y = state[:, :, 2]  # the reference indexes z-up layouts with [:, :, 2]
    x_diff = torch.clamp(xmin - x, min=0.0) + torch.clamp(x - xmax, min=0.0)
    y_diff = torch.clamp(ymin - y, min=0.0) + torch.clamp(y - ymax, min=0.0)
    return torch.mean(torch.sqrt(x_diff ** 2 + y_diff ** 2), 1)


def running_cost(state, action, state_cur, target_state, bounding_box):
    """state (B, L, n_obj, 3) predicted states, action (B, L, 4) decoded
    [x0, y0, x1, y1], state_cur (n_obj, 3), target_state (n_target, 3),
    bounding_box (3, 2) workspace. Returns {"reward_seqs": (B,)}."""
    B, L = state.shape[:2]
    state_flat = state.reshape(B * L, state.shape[2], 3)
    target = target_state[None].expand(B * L, -1, -1)
    cham = _chamfer(state_flat, target).reshape(B, L)

    start_2d = action[:, :, :2]
    state_2d = torch.cat([state_cur[None, None, :, :2].expand(B, 1, -1, -1),
                          state[:, :-1, :, :2]], 1)  # (B, L, n_obj, 2)
    d = torch.linalg.norm(start_2d[:, :, None] - state_2d, dim=-1).min(-1).values
    d = torch.clamp(d - PUSHER_SIZE, min=0.0)
    collision = torch.exp(-d * 100.0)

    bbox = bounding_box[:2]
    xmin = state[..., 0].min(2).values
    xmax = state[..., 0].max(2).values
    ymin = state[..., 1].min(2).values
    ymax = state[..., 1].max(2).values
    box_pen = torch.stack([
        torch.clamp(xmin - bbox[0, 0], min=0.0),
        torch.clamp(bbox[0, 1] - xmax, min=0.0),
        torch.clamp(ymin - bbox[1, 0], min=0.0),
        torch.clamp(bbox[1, 1] - ymax, min=0.0)], -1)
    box_pen = torch.exp(-box_pen * 100.0).max(-1).values  # (B, L)

    reward = (-cham[:, -1] - 5.0 * torch.mean(collision, 1)
              - 5.0 * torch.mean(box_pen, 1))
    return {"reward_seqs": reward}
