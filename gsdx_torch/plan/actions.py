"""Push-action space: sampling, clipping, MPPI aggregation, decoding
(counterpart of `gsdx/plan/actions.py`).

An action is (x, y, theta, length): a pusher start point, a push direction
and a push length in units of `push_length` (0.01 m) that the dynamics
applies as repeated unit pushes. Random draws come from a
`torch.Generator`, or are injected (``draws``) so that a test can replay
the JAX package's own draws.
"""

from __future__ import annotations

import math

import torch


def angle_normalize(x):
    """Wrap to [-pi, pi): floor-mod as jnp's ``%`` computes it (an exact
    fmod, then the divisor added where the signs differ)."""
    period = 2 * math.pi
    r = torch.fmod(x + math.pi, period)
    r = torch.where((r != 0) & (r < 0), r + period, r)
    return r - math.pi


def clip_actions(action, lower, upper):
    """Normalize theta, then clamp to the limits."""
    action = torch.cat([action[..., :2], angle_normalize(action[..., 2:3]),
                        action[..., 3:]], -1)
    return torch.clamp(action, lower, upper)


def sample_action_seq(generator: torch.Generator | None, act_seq, lower, upper,
                      n_sample: int, iter_index: int = 0,
                      noise_level: float = 0.3, push_length: float = 0.01,
                      draws: torch.Tensor | None = None):
    """Sample n_sample action sequences around ``act_seq`` (n_look, 4).

    Iteration 0 resamples uniformly over the action box; later iterations
    keep sample 0 as the incumbent and perturb the push start and end
    points with scaled Gaussian noise, re-deriving (theta, length).
    ``draws`` replaces the generator: at iteration 0 the (n_sample, n_look,
    4) uniform block, after it the (n_look, n_sample, 4) standard normals.
    """
    n_look = act_seq.shape[0]
    dev = act_seq.device
    if iter_index == 0:
        u = draws if draws is not None else torch.rand(
            (n_sample, n_look, 4), generator=generator, device=dev)
        return u.to(dev) * (upper - lower) + lower

    xs, ys = act_seq[:, 0], act_seq[:, 1]
    thetas, lengths = act_seq[:, 2], act_seq[:, 3]
    x_ends = xs - lengths * push_length * torch.cos(thetas)
    y_ends = ys - lengths * push_length * torch.sin(thetas)
    cols = []
    for i in range(n_look):
        beta = 0.1 * (10.0 ** i)
        z = draws[i] if draws is not None else torch.randn(
            (n_sample, 4), generator=generator, device=dev)
        noise = beta * noise_level * z.to(dev)
        xs_i = xs[i] + noise[:, 0]
        ys_i = ys[i] + noise[:, 1]
        x_ends_i = x_ends[i] + noise[:, 2]
        y_ends_i = y_ends[i] + noise[:, 3]
        thetas_i = torch.arctan2(ys_i - y_ends_i, xs_i - x_ends_i)
        lengths_i = torch.sqrt((x_ends_i - xs_i) ** 2 + (y_ends_i - ys_i) ** 2) / push_length
        cand = clip_actions(torch.stack([xs_i, ys_i, thetas_i, lengths_i], -1),
                            lower, upper)
        # sample 0 keeps the incumbent
        cols.append(torch.cat([act_seq[i][None], cand[1:]], 0))
    return torch.stack(cols, 1)


def sample_action_seq_fps(lower, upper, n_sample: int, n_look_ahead: int = 1,
                          grid_size: float = 0.02, device="cuda"):
    """Grid + farthest-point action coverage: enumerate a regular grid over
    the action box and FPS-select n_sample maximally spread actions
    (n_sample, n_look_ahead, 4) on ``device``, where the grid's FPS runs."""
    import numpy as np

    from gsdx_torch.core.device import require_device
    from gsdx_torch.kernels.fps import farthest_point_sampling

    device = require_device(device)
    # the grid in the limits' own precision (a tuple stays float64), as gsdx
    lower_np = lower.cpu().numpy() if torch.is_tensor(lower) else np.asarray(lower)
    upper_np = upper.cpu().numpy() if torch.is_tensor(upper) else np.asarray(upper)
    axes = [np.arange(lower_np[i], upper_np[i], grid_size)
            for i in range(len(lower_np))]
    grid = np.stack(np.meshgrid(*axes), axis=-1).reshape(-1, len(lower_np))
    grid_t = torch.as_tensor(grid.astype(np.float32), device=device)
    idx = farthest_point_sampling(grid_t, n_sample, start_idx=0)
    return grid_t[idx][:, None].repeat(1, n_look_ahead, 1)


def optimize_action_mppi(act_seqs, reward_seqs, lower, upper,
                         reward_weight: float = 100.0,
                         push_length: float = 0.01):
    """Softmax-weighted aggregation of the push start and end points."""
    w = torch.softmax(reward_seqs * reward_weight, dim=0)[:, None]
    xs, ys = act_seqs[:, :, 0], act_seqs[:, :, 1]
    thetas, lengths = act_seqs[:, :, 2], act_seqs[:, :, 3]
    x_ends = xs - lengths * push_length * torch.cos(thetas)
    y_ends = ys - lengths * push_length * torch.sin(thetas)
    x = torch.sum(w * xs, 0)
    y = torch.sum(w * ys, 0)
    x_end = torch.sum(w * x_ends, 0)
    y_end = torch.sum(w * y_ends, 0)
    theta = torch.arctan2(y - y_end, x - x_end)
    length = torch.sqrt((x_end - x) ** 2 + (y_end - y) ** 2) / push_length
    return clip_actions(torch.stack([x, y, theta, length], -1), lower, upper)


def decode_action(action, push_length: float = 0.01):
    """(B, L, 4) -> ((B, L, 4) [x0, y0, x1, y1], (B, L) int32 repeats)."""
    x0, y0 = action[:, :, 0], action[:, :, 1]
    theta = action[:, :, 2]
    repeats = action[:, :, 3].to(torch.int32)  # truncation, as astype
    x1 = x0 - push_length * torch.cos(theta)
    y1 = y0 - push_length * torch.sin(theta)
    return torch.stack([x0, y0, x1, y1], -1), repeats
