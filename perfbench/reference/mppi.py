"""Plain reference of the MPPI planner around the rollout: the action
sampler (a uniform draw over the action box at a chunk's first iteration,
Gaussian noise on the push's start and end points after it, the incumbent
kept as sample 0), the softmax-weighted update of the mean, and the best
action kept over the iterations of a chunk and over the chunks of an action,
as gs-dynamics' planner defines them.

The draws are replayed from a saved state of the planner's generator, so the
reference draws the same numbers the planner drew. ``dtype`` float64 is the
reference; bfloat16 is the control (the nearest precision below the float32
the configuration states for everything outside the GNN).
"""

from __future__ import annotations

import math

import torch


def _generator(state, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def _wrap(theta):
    return torch.remainder(theta + math.pi, 2 * math.pi) - math.pi


def _ends(acts, push_length: float):
    x, y, theta, length = acts.unbind(-1)
    return x - length * push_length * torch.cos(theta), y - length * push_length * torch.sin(theta)


def _clip(x, y, x_end, y_end, lower, upper, push_length: float):
    theta = torch.atan2(y - y_end, x - x_end)
    length = torch.sqrt((x_end - x) ** 2 + (y_end - y) ** 2) / push_length
    acts = torch.stack([x, y, _wrap(theta), length], -1)
    return torch.minimum(torch.maximum(acts, lower), upper)


def sample(gen_state, mean, iter_index: int, n_sample: int, lower, upper, mp: dict,
           dtype=torch.float64):
    """The samples of one iteration around ``mean`` (1, 4): (n_sample, 1, 4)."""
    dev = mean.device
    g = _generator(gen_state, dev)
    lo, hi = lower.to(dtype), upper.to(dtype)
    if iter_index == 0:
        u = torch.rand((n_sample, 1, 4), generator=g, device=dev)
        return (u.to(dtype) * (hi - lo) + lo).float()
    z = torch.randn((n_sample, 4), generator=g, device=dev).to(dtype)
    m = mean[0].to(dtype)
    x_end, y_end = _ends(m, mp["push_length"])
    noise = 0.1 * mp["noise_level"] * z
    cand = _clip(m[0] + noise[:, 0], m[1] + noise[:, 1], x_end + noise[:, 2],
                 y_end + noise[:, 3], lo, hi, mp["push_length"])
    cand[0] = m  # sample 0 keeps the incumbent
    return cand[:, None].float()


def update(act_seqs, rewards, lower, upper, mp: dict, dtype=torch.float64):
    """The next mean (1, 4) from an iteration's samples and rewards."""
    w = torch.softmax(rewards.to(dtype) * mp["reward_weight"], 0)[:, None]
    a = act_seqs.to(dtype)
    x_end, y_end = _ends(a, mp["push_length"])
    mean = _clip((w * a[..., 0]).sum(0), (w * a[..., 1]).sum(0), (w * x_end).sum(0),
                 (w * y_end).sum(0), lower.to(dtype), upper.to(dtype), mp["push_length"])
    return mean.float()


def action_gap(a, b, lower, upper) -> float:
    """Widest gap of two action batches, each component over its range; the
    push's direction compared round the circle."""
    d = (a.double() - b.double()).abs()
    d[..., 2] = torch.minimum(d[..., 2], 2 * math.pi - d[..., 2])
    return float((d / (upper - lower).double()).max()) if d.numel() else 0.0


def choice(act_seqs: list, rewards: list, init_act, n_update_iter: int):
    """The action planned from an action's iterations in order: each chunk
    keeps its best sample (a strictly larger reward replaces it), the action
    is the chunk whose best is largest, the first on a tie. Returns
    (act (1, 4), best reward)."""
    best = []
    for c0 in range(0, len(rewards), n_update_iter):
        act, r_best = init_act, -math.inf
        for acts, r in zip(act_seqs[c0:c0 + n_update_iter], rewards[c0:c0 + n_update_iter]):
            i = int(torch.argmax(r))
            if float(r[i]) > r_best:
                act, r_best = acts[i], float(r[i])
        best.append((act, r_best))
    return max(best, key=lambda ab: ab[1])
