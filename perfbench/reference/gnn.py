"""Plain reference of the planning path: the interaction network of
gs-dynamics (`DynamicsPredictor`, its published equations), the radius graph,
the push decoding, the unit-push rollout and the MPPI reward, in plain
PyTorch over index gathers.

Published form: the relation propagator is a Linear over the concatenation
(relation encoding, receiver effect, sender effect) followed by ReLU; the
particle propagator a Linear over (particle encoding, aggregated effect) with
the effect as residual, then ReLU; three-layer MLP encoders with ReLU after
every layer; the motion head lin-relu-lin-relu-lin; positions move by the
clamped motion. Weights are in the port's state-dict layout (``*.weight``
(out, in), propagator ``kernel`` (in, out)), made by the benchmark.

``precision``: "f32" computes every product in float32 with TF32 off (the
reference); "fp8" rounds both operands of every product to float8 e4m3 with
a per-tensor scale, then multiplies in float32 (the control: the nearest
precision below the bf16 operands the planning configuration states).
"""

from __future__ import annotations

import torch

BIG = 1e10
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def matmul(x, w, precision: str):
    """x (..., in) @ w (in, out)."""
    if precision == "fp8":
        return _fp8(x) @ _fp8(w)
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def linear(x, weights, name: str, precision: str):
    return matmul(x, weights[f"{name}.weight"].T, precision) + weights[f"{name}.bias"]


def mlp(x, weights, name: str, precision: str, relu_last: bool):
    for i in range(3):
        x = linear(x, weights, f"{name}.dense.{i}", precision)
        if i < 2 or relu_last:
            x = torch.relu(x)
    return x


def particle_inputs(model: dict, states, attrs, action):
    """(B, n_his, N, 3) histories -> (B, N, particle input) features."""
    B, n_his, N, _ = states.shape
    parts = [attrs]
    hist = states.transpose(1, 2)  # (B, N, n_his, 3)
    if model["state_dim"] == 3:
        parts.append(hist.reshape(B, N, n_his * 3))
    elif model["state_dim"] == 1:
        parts.append(hist[..., 2])
    if model["motion_dim"] > 0:
        parts.append((hist[:, :, 1:] - hist[:, :, :-1]).reshape(B, N, (n_his - 1) * 3))
    parts.append(action)
    return torch.cat(parts, -1)


def forward(weights: dict, model: dict, states, attrs, group, action, recv, send,
            n_p: int, precision: str = "f32"):
    """One GNN step. states (B, n_his, N, 3); attrs (B, N, 2); group (B, N)
    instance weights (1 object, 0 tool); action (B, N, 3); recv, send (B, E)
    long with -1 on empty slots. Returns predicted positions (B, n_p, 3)."""
    B, n_his, N, _ = states.shape
    nf = model["nf_effect"]
    hist = states.transpose(1, 2).reshape(B, N, n_his * 3)
    valid = recv >= 0
    b_idx = torch.arange(B, device=states.device)[:, None].expand_as(recv)[valid]
    r, s = recv[valid], send[valid]

    rel_in = torch.cat([attrs[b_idx, r], attrs[b_idx, s],
                        (group[b_idx, r] - group[b_idx, s]).abs()[:, None],
                        hist[b_idx, r] - hist[b_idx, s]], -1)  # (M, 14)
    p_enc = mlp(particle_inputs(model, states, attrs, action), weights,
                "particle_encoder", precision, relu_last=True)  # (B, N, nf)
    r_enc = mlp(rel_in, weights, "relation_encoder", precision, relu_last=True)
    k_r, b_r = weights["relation_propagator.kernel"], weights["relation_propagator.bias"]
    k_p, b_p = weights["particle_propagator.kernel"], weights["particle_propagator.bias"]
    effect = p_enc
    for _ in range(model["pstep"]):
        rel = torch.relu(matmul(torch.cat([r_enc, effect[b_idx, r], effect[b_idx, s]], -1),
                                k_r, precision) + b_r)  # (M, nf)
        agg = torch.zeros(B * N, nf, device=states.device).index_add_(0, b_idx * N + r, rel)
        effect = torch.relu(matmul(torch.cat([p_enc, agg.view(B, N, nf)], -1), k_p,
                                   precision) + b_p + effect)
    motion = mlp(effect[:, :n_p], weights, "non_rigid_predictor", precision, relu_last=False)
    clamp = model["motion_clamp"]
    return states[:, -1, :n_p] + torch.clamp(motion, -clamp, clamp)


def edges(states, n_obj: int, adj_thresh, topk: int, max_nR: int, connect_all: bool,
          mask=None):
    """Radius graph of (B, N, 3) positions, the last N - n_obj rows tools:
    pairs closer than ``adj_thresh`` (a float or one a graph); among objects
    only each receiver's topk nearest (itself included, the lower index
    first on ties); no pair with a particle outside ``mask`` (B, N); no
    tool-tool pairs; with connect_all every object-tool pair;
    receiver-major, the first max_nR kept. Returns (recv, send) (B, max_nR)
    long, -1 empty."""
    B, N, _ = states.shape
    d = states[:, :, None, :] - states[:, None, :, :]
    sq = d * d
    dis = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    tool = torch.zeros(N, dtype=torch.bool, device=states.device)
    tool[n_obj:] = True
    if mask is None:
        mask = torch.ones(B, N, dtype=torch.bool, device=states.device)
    both = mask[:, :, None] & mask[:, None, :]
    tool12 = tool[:, None] & tool[None, :]
    dis = torch.where(both & ~tool12, dis, torch.full_like(dis, BIG))
    thresh = torch.as_tensor(adj_thresh, dtype=states.dtype, device=states.device)
    thresh = thresh.reshape(-1, 1, 1) if thresh.ndim else thresh
    adj = dis < thresh * thresh
    k = min(topk, n_obj)
    nearest = torch.sort(dis[:, :n_obj, :n_obj], dim=2, stable=True).indices[:, :, :k]
    keep = torch.zeros(B, n_obj, n_obj, dtype=torch.bool, device=states.device)
    keep.scatter_(2, nearest, True)
    adj[:, :n_obj, :n_obj] &= keep
    if connect_all:
        adj |= (tool[:, None] & ~tool[None, :]) | (~tool[:, None] & tool[None, :])
        adj &= both & ~tool12
    flat = adj.reshape(B, N * N)
    pos = torch.cumsum(flat.long(), 1) - 1  # row-major rank of each pair
    keep = flat & (pos < max_nR)
    b_idx, cell = torch.nonzero(keep, as_tuple=True)
    recv = torch.full((B, max_nR), -1, dtype=torch.long, device=states.device)
    send = torch.full_like(recv, -1)
    slot = pos[b_idx, cell]
    recv[b_idx, slot] = cell // N
    send[b_idx, slot] = cell % N
    return recv, send


def decode(actions, push_length: float):
    """(B, 4) [x, y, theta, length] -> ((B, 4) [x0, y0, x1, y1], (B,) repeats)."""
    x0, y0, theta = actions[:, 0], actions[:, 1], actions[:, 2]
    repeats = actions[:, 3].to(torch.int32)
    return torch.stack([x0, y0, x0 - push_length * torch.cos(theta),
                        y0 - push_length * torch.sin(theta)], -1), repeats


@torch.no_grad()
def rollout(weights: dict, model: dict, graph: dict, state, actions,
            precision: str = "f32"):
    """Final positions after each sample's unit pushes. state (B, n_obj, 3)
    the state each sample starts from; actions (B, 4) one look-ahead step.
    The pusher spawns at (x0, y0) at the object's lowest z and moves by
    (x1 - x0, y1 - y0, 0) a unit push; the graph is rebuilt every unit push
    from the newest positions; a sample's result is its state after its own
    repeat count. Returns (B, n_obj, 3)."""
    B, n_obj, _ = state.shape
    n_his = model["n_his"]
    N = n_obj + 1
    dev = state.device
    dec, repeats = decode(actions, graph["push_length"])
    attrs = torch.zeros(B, N, 2, device=dev)
    attrs[:, :n_obj, 0] = 1.0
    attrs[:, n_obj:, 1] = 1.0
    group = torch.zeros(B, N, device=dev)
    group[:, :n_obj] = 1.0
    z = state[:, :, 2].min(1).values
    eef = torch.stack([dec[:, 0], dec[:, 1], z], -1)[:, None]
    delta = torch.stack([dec[:, 2] - dec[:, 0], dec[:, 3] - dec[:, 1],
                         torch.zeros_like(z)], -1)[:, None]  # (B, 1, 3)
    frame = torch.cat([state, eef], 1)
    states = frame[:, None].expand(B, n_his, N, 3)
    action = torch.cat([torch.zeros(B, n_obj, 3, device=dev), delta], 1)
    out = torch.zeros(B, n_obj, 3, device=dev)
    for step in range(1, int(repeats.max()) + 1):
        recv, send = edges(states[:, -1], n_obj, graph["adj_thresh"], graph["topk"],
                           graph["max_nR"], graph["connect_all"])
        pred = forward(weights, model, states, attrs, group, action, recv, send,
                       n_obj, precision)
        out = torch.where((repeats == step)[:, None, None], pred, out)
        tool = states[:, -1, n_obj:] + delta
        tool = torch.cat([tool[:, :, :2], pred[:, :, 2].min(1).values[:, None, None]], 2)
        states = torch.cat([states[:, 1:], torch.cat([pred, tool], 1)[:, None]], 1)
    return out


def reward(final, dec, state_cur, target, bbox, dtype=torch.float32):
    """gs-dynamics' MPPI reward of one look-ahead step: minus the chamfer
    distance of the final positions (B, n, 3) to the target (m, 3), minus 5
    x the collision penalty of the pusher spawning inside the object, minus
    5 x the out-of-workspace penalty of the final extent. Computed in
    ``dtype``."""
    final, dec, state_cur, target, bbox = (x.to(dtype) for x in (final, dec, state_cur,
                                                                  target, bbox))

    def dist(x, y):
        return torch.sqrt(((x[:, :, None] - y[:, None]) ** 2).sum(-1).clamp(min=1e-12))

    d = dist(final, target[None].expand(final.shape[0], -1, -1))
    cham = d.min(2).values.mean(1) + d.min(1).values.mean(1)
    start = dec[:, None, :2]
    gap = torch.linalg.norm(start - state_cur[..., :2], dim=-1).min(1).values
    collision = torch.exp(-torch.clamp(gap - 0.01, min=0.0) * 100.0)
    xmin, xmax = final[..., 0].min(1).values, final[..., 0].max(1).values
    ymin, ymax = final[..., 1].min(1).values, final[..., 1].max(1).values
    pen = torch.stack([torch.clamp(xmin - bbox[0, 0], min=0.0),
                       torch.clamp(bbox[0, 1] - xmax, min=0.0),
                       torch.clamp(ymin - bbox[1, 0], min=0.0),
                       torch.clamp(bbox[1, 1] - ymax, min=0.0)], -1)
    box = torch.exp(-pen * 100.0).max(-1).values
    return (-cham - 5.0 * collision - 5.0 * box).float()
