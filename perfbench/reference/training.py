"""Plain reference of GNN dynamics training (gs-dynamics' `train.py`): the
graph batch of a recorded push (farthest-point sampling of the last history
frame, radius-limited FPS, history / future / tool tensors, uniform state
noise, a random z rotation, the radius graph), the n_future-step unroll fed
back through the network, the loss (mean squared error plus the weighted
edge-length loss against the oldest history frame) and one Adam step
(betas 0.9 / 0.999, eps 1e-8 outside the square root). Imports nothing of
the port.

Random draws are replayed from the state of the generator the program's
sampler drew from, by the same calls in the same order. Distances in FPS
round as gsdx's XLA code computes them: each coordinate's square added by
one fused multiply-add (rounded once to f32), so picks agree where
distances tie to the last bit.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import gnn


def fma_square(t, acc):
    """``t * t + acc`` of f32 tensors rounded once, as a fused multiply-add:
    the f64 sum rounded to odd (by its exact two-sum error), then to f32."""
    p = t.double() * t.double()
    a = acc.double()
    s = a + p
    bb = s - a
    err = (a - (s - bb)) + (p - bb)
    even = (s.view(torch.int64) & 1) == 0
    towards = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, towards), s)
    return s.to(t.dtype)


def sq_dist(points, centre):
    d = points - centre
    out = torch.zeros(points.shape[:-1], dtype=points.dtype, device=points.device)
    for c in range(d.shape[-1]):
        out = fma_square(d[..., c], out)
    return out


def fps(points, n: int, start, radius=None):
    """Greedy farthest points of (B, P, 3) from ``start`` (B,); with
    ``radius`` (B,) also whether each pick came while the largest remaining
    distance still exceeded the radius. Returns (idx (B, n), keep (B, n))."""
    B, P, _ = points.shape
    rows = torch.arange(B, device=points.device)
    dist = torch.full((B, P), float("inf"), device=points.device)
    idx = torch.zeros(B, n, dtype=torch.long, device=points.device)
    keep = torch.zeros(B, n, dtype=torch.bool, device=points.device)
    far = start.long().clone()
    active = torch.ones(B, dtype=torch.bool, device=points.device)
    r2 = None if radius is None else radius * radius
    for i in range(n):
        idx[:, i], keep[:, i] = far, active
        dist = torch.minimum(dist, sq_dist(points, points[rows, far][:, None]))
        far = torch.argmax(dist, 1)
        if r2 is not None:
            active = active & (dist.max(1).values > r2)
    return idx, keep


def draws(gen: torch.Generator, n_pairs: int, n_points: int, B: int, data: dict, noise: float,
          device):
    """The sampler's draws, by the same calls in the same order: frame
    rows, FPS start, FPS radius, state noise, rotation angle, adjacency
    radius."""
    N = data["max_nobj"] + data["max_tool"]

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    rows = torch.randint(0, n_pairs, (B,), generator=gen, device=device)
    start = torch.randint(0, n_points, (B,), generator=gen, device=device)
    return {"rows": rows, "start": start, "radius": uniform((B,), *data["fps_radius_range"]),
            "noise": uniform((B, data["n_his"], N, 3), -noise, noise),
            "theta": uniform((B,), -math.pi, math.pi),
            "adj": uniform((B,), *data["adj_radius_range"])}


def _rotate(x, theta):
    """x (B, ..., 3) @ R_z(theta), the three products summed in order."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                     torch.stack([z, z, o], -1)], -2)
    R = R.reshape(R.shape[:1] + (1,) * (x.ndim - 2) + (3, 3))
    return (x[..., 0:1] * R[..., 0, :] + x[..., 1:2] * R[..., 1, :]) + x[..., 2:3] * R[..., 2, :]


def batch(positions, tool, pair_list, d: dict, data: dict):
    """The graph batch of the frame rows and draws ``d``."""
    n_his, n_fut = data["n_his"], data["n_future"]
    n_obj, n_tool_slots = data["max_nobj"], data["max_tool"]
    N = n_obj + n_tool_slots
    rows_pl = pair_list[d["rows"]]
    B, dev = rows_pl.shape[0], positions.device
    r = torch.arange(B, device=dev)
    cols = torch.arange(n_his + n_fut, device=dev).clamp(max=rows_pl.shape[1] - 2)
    frames = rows_pl[:, 1:][:, cols]
    obj = positions[rows_pl[:, 0, None], frames]  # (B, F, P, 3)
    tl = tool[rows_pl[:, 0, None], frames]
    P, nt = obj.shape[2], tl.shape[2]
    anchor = obj[:, n_his - 1]
    n1 = min(n_obj, P)
    first, _ = fps(anchor, n1, d["start"])
    down = anchor[r[:, None], first]
    second, mask = fps(down, n1, torch.zeros(B, dtype=torch.long, device=dev), d["radius"])
    pick = torch.gather(first, 1, second)
    if n1 < n_obj:
        pick = torch.cat([pick, pick.new_zeros(B, n_obj - n1)], 1)
        mask = torch.cat([mask, mask.new_zeros(B, n_obj - n1)], 1)
    taken = obj[r[:, None, None], torch.arange(n_his + n_fut, device=dev)[None, :, None],
                pick[:, None, :]] * mask[:, None, :, None].float()
    ts = slice(n_obj, n_obj + nt)
    hist = obj.new_zeros(B, n_his, N, 3)
    hist[:, :, :n_obj] = taken[:, :n_his]
    hist[:, :, ts] = tl[:, :n_his]
    action = obj.new_zeros(B, N, 3)
    action[:, ts] = tl[:, n_his] - tl[:, n_his - 1]
    tool_future = obj.new_zeros(B, n_fut - 1, N, 3)
    action_future = obj.new_zeros(B, n_fut - 1, N, 3)
    tool_future[:, :, ts] = tl[:, n_his:n_his + n_fut - 1]
    action_future[:, :, ts] = tl[:, n_his + 1:n_his + n_fut] - tl[:, n_his:n_his + n_fut - 1]
    ones = torch.ones(B, n_tool_slots, dtype=torch.bool, device=dev)
    state_mask = torch.cat([mask, ones], 1)
    attrs = obj.new_zeros(B, N, 2)
    attrs[:, :n_obj, 0] = mask.float()
    attrs[:, n_obj:, 1] = 1.0
    hist = _rotate(hist + d["noise"], d["theta"])
    out = {"state": hist, "action": _rotate(action, d["theta"]),
           "tool_future": _rotate(tool_future, d["theta"]),
           "action_future": _rotate(action_future, d["theta"]),
           "state_future": _rotate(taken[:, n_his:], d["theta"]), "attrs": attrs,
           "group": torch.cat([mask.float(), obj.new_zeros(B, n_tool_slots)], 1),
           "obj_mask": mask}
    out["recv"], out["send"] = gnn.edges(hist[:, -1], n_obj, d["adj"], data["topk"],
                                         data["max_nR"], data["connect_all"], state_mask)
    return out


def unrolled_loss(weights, model: dict, b: dict, train: dict, precision: str = "f32"):
    """Sum over the n_future unrolled steps of mse_weight x MSE (padded
    particles included) + length_weight x the edge-length loss against the
    oldest history frame (detached), every relation slot counted, tool
    endpoints as zero vectors."""
    state, action = b["state"], b["action"]
    n_p = b["state_future"].shape[2]
    total = 0.0
    for fi in range(train["n_future"]):
        pred = gnn.forward(weights, model, state, b["attrs"], b["group"], action, b["recv"],
                           b["send"], n_p, precision)
        mse = ((pred - b["state_future"][:, fi]) ** 2).mean()
        total = total + train["mse_loss"] * mse + train["length_loss"] * _length(
            pred, state[:, 0, :n_p].detach(), b["recv"], b["send"])
        if fi < train["n_future"] - 1:
            nxt = torch.cat([pred, b["tool_future"][:, fi, n_p:]], 1)
            state = torch.cat([state[:, 1:], nxt[:, None]], 1)
            action = b["action_future"][:, fi]
    return total


def _length(pred, pos, recv, send):
    n_p = pred.shape[1]

    def ends(x, idx):
        ok = ((idx >= 0) & (idx < n_p))[..., None]
        return torch.where(ok, torch.gather(x, 1, idx.clamp(0, n_p - 1)[..., None].expand(
            -1, -1, 3)), torch.zeros((), device=x.device))

    def length(x):
        diff = ends(x, recv) - ends(x, send)
        return torch.sqrt((diff ** 2).sum(-1) + 1e-12)

    return ((length(pred) - length(pos)) ** 2).mean()


def adam(params: dict, grads: dict, state: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step as torch.optim.Adam takes it (bias corrections, eps
    outside the square root). Returns (params, state)."""
    step = state.get("step", 0) + 1
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    new_p, m, v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m[k] = state["m"][k] * b1 + g * (1 - b1) if "m" in state else g * (1 - b1)
        v[k] = (state["v"][k] * b2 + g * g * (1 - b2)) if "v" in state else g * g * (1 - b2)
        denom = v[k].sqrt() / math.sqrt(bc2) + eps
        new_p[k] = p - (lr / bc1) * m[k] / denom
    return new_p, {"m": m, "v": v, "step": step}
