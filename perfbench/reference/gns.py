"""Plain reference of GNS training (Sanchez-Gonzalez et al., Learning to
Simulate Complex Physics with Graph Networks, ICML 2020, arXiv:2002.09405;
code deepmind-research/learning_to_simulate: `train.py`,
`learned_simulator.py`, `graph_network.py`, `noise_utils.py`,
`connectivity_utils.py`), in plain f32 torch. The caller turns TF32 off
(`torch.backends.cuda.matmul.allow_tf32`, `torch.backends.cudnn.allow_tf32`);
``precision="tf32"`` instead rounds every product's two operands to TF32
(10 mantissa bits, to nearest even), as the card's TF32 tensor cores take
them: the control one precision below the configuration's. Imports nothing
of the port.

A step, as published: windows of n_his + 1 frames drawn uniformly, the
random-walk noise on the n_his input frames, the radius graph of the
newest noisy positions (one graph of the batch's particles, each sample's
indices offset by its particle count, as graph_nets batches graphs), the
encoder, ``message_passing_steps`` interaction blocks with their own
weights (each edge from [edge, receiver, sender], the node from [sum of the
block's new incoming edges, node], summed by `index_add_`, both with a
residual), the decoder, the normalised target acceleration, the squared
error summed over dimensions and averaged over non-kinematic particles, and
one Adam step.

Departures from the published code:
  * the graph: every pair with d^2 <= R^2 in f32 (d^2 = (dx^2 + dy^2) +
    dz^2, R^2 the f32 square of the f32 radius), found by blocked dense
    distances, where `connectivity_utils` asks a KD-tree for d <= R in f64:
    the same pairs but those within rounding of R;
  * Adam with optax's `adam` settings (eps outside the square root of the
    bias-corrected second moment), where TF1's `AdamOptimizer` adds eps to
    the uncorrected root;
  * the weights come in the port's state-dict names (a flat dict:
    ``node_encoder.linears.0.weight``, ``blocks.3.edge_mlp.norm.bias``, ...,
    and the statistics ``vel_mean``, ``vel_std``, ``acc_mean``, ``acc_std``,
    ``bounds``), each an (out, in) weight of `x @ w.T + b`;
  * `init_weights` draws Sonnet's and TensorFlow's initialisers from a
    torch generator: the same distributions, not TensorFlow's numbers.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.training import adam

_BLOCK = 2048  # receivers a block of dense distances


def tf32(x):
    """``x`` f32 with its mantissa rounded to 10 bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``x @ w.T`` with both operands rounded to TF32, and so the backward's
    two products."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return tf32(x) @ tf32(w).T

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = tf32(g)
        return g @ tf32(w), g.T @ tf32(x)


def linear(x, w, b, precision: str):
    if precision == "tf32":
        return _TF32Product.apply(x, w) + b
    return x @ w.T + b


def mlp(weights: dict, name: str, x, layers: int, norm: bool, precision: str):
    """Sonnet's MLP: ``layers`` + 1 linear layers, ReLU between them, a
    LayerNorm (eps 1e-5) on the output where ``norm``."""
    for i in range(layers + 1):
        x = linear(x, weights[f"{name}.linears.{i}.weight"], weights[f"{name}.linears.{i}.bias"],
                   precision)
        if i < layers:
            x = torch.relu(x)
    if norm:
        x = torch.nn.functional.layer_norm(x, x.shape[-1:], weights[f"{name}.norm.weight"],
                                           weights[f"{name}.norm.bias"], 1e-5)
    return x


def shapes(model: dict) -> dict:
    """{name: (out, in)} of every trained weight and {name: (out,)} of every
    bias and LayerNorm vector, in the port's state-dict names and order;
    the type embedding (types, width)."""
    L, H, d = model["latent_size"], model["hidden_layers"], model["dim"]
    node_in = (model["n_his"] - 1) * d + 2 * d + (
        model["type_embedding"] if model["particle_types"] > 1 else 0)
    out = {"type_embedding": (model["particle_types"], model["type_embedding"])}

    def mlp(name, fan_in, width, norm):
        sizes = [fan_in] + [L] * H + [width]
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            out[f"{name}.linears.{i}.weight"] = (b, a)
            out[f"{name}.linears.{i}.bias"] = (b,)
        if norm:
            out[f"{name}.norm.weight"] = out[f"{name}.norm.bias"] = (width,)

    mlp("node_encoder", node_in, L, True)
    mlp("edge_encoder", d + 1, L, True)
    for k in range(model["message_passing_steps"]):
        mlp(f"blocks.{k}.edge_mlp", 3 * L, L, True)
        mlp(f"blocks.{k}.node_mlp", 2 * L, L, True)
    mlp("decoder", L, d, False)
    return out


def init_weights(model: dict, gen: torch.Generator, device) -> dict:
    """A fresh start, drawn from ``gen``: every linear weight Sonnet's
    truncated normal (std 1/sqrt(fan_in), a draw beyond two deviations
    drawn again, as TensorFlow's `truncated_normal` does), zero biases,
    LayerNorm scale 1 and offset 0, and the type embedding TensorFlow's
    default, Glorot uniform over (-b, b), b = sqrt(6 / (types + width))."""
    sizes = shapes(model)
    weights = {k: s for k, s in sizes.items() if k.endswith(".weight") and ".linears." in k}
    x = torch.randn(sum(math.prod(s) for s in weights.values()), generator=gen, device=device)
    far = x.abs() > 2.0
    while bool(far.any()):
        x[far] = torch.randn(int(far.sum()), generator=gen, device=device)
        far = x.abs() > 2.0
    out, at = {}, 0
    for name, shape in sizes.items():
        if name in weights:
            n = math.prod(shape)
            out[name] = (x[at:at + n] / math.sqrt(shape[1])).view(shape)
            at += n
        elif name == "type_embedding":
            b = math.sqrt(6.0 / sum(shape))
            out[name] = (2 * torch.rand(shape, generator=gen, device=device) - 1) * b
        elif name.endswith("norm.weight"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def f32_r2(radius: float):
    r = torch.tensor(radius, dtype=torch.float32)
    return float(r * r)


def radius_edges(pos, radius: float):
    """(receivers, senders) int64 of every pair of (n, 3) ``pos`` with d^2 <=
    R^2, self-edges included, by blocks of dense distances, receiver-major."""
    r2 = f32_r2(radius)
    recv, send = [], []
    for lo in range(0, pos.shape[0], _BLOCK):
        d = pos[None, :, :] - pos[lo:lo + _BLOCK, None, :]
        sq = d * d
        r, s = torch.nonzero(((sq[..., 0] + sq[..., 1]) + sq[..., 2]) <= r2, as_tuple=True)
        recv.append(r + lo)
        send.append(s)
    return torch.cat(recv), torch.cat(send)


def draws(gen: torch.Generator, n_rows: int, batch: int, frames: int, particles: int,
          noise_std: float, device):
    """The window sampler's draws, by the same calls in the same order: the
    frame rows, then the velocity noise N(0, noise_std^2 / (frames - 2)) a
    step of the frames - 1 inputs' frames - 2 velocities."""
    rows = torch.randint(0, n_rows, (batch,), generator=gen, device=device)
    F = frames - 1
    steps = torch.randn((batch, F - 1, particles, 3), generator=gen, device=device) * (
        noise_std / (F - 1) ** 0.5)
    return {"rows": rows, "steps": steps}


def batch(positions, frame_rows, d: dict, moving):
    """(window (B, W, P, 3), noise of its inputs (B, W - 1, P, 3)):
    `noise_utils`' random walk, velocities summed over time, then
    positions, none on the first frame and none on kinematic particles
    (``moving`` (P,) bool)."""
    rows = frame_rows[d["rows"]]
    window = positions[rows[:, :1], rows[:, 1:]]
    velocity = torch.cumsum(d["steps"], 1)
    noise = torch.cat([torch.zeros_like(velocity[:, :1]), torch.cumsum(velocity, 1)], 1)
    return window, noise * moving[None, None, :, None]


def forward(weights: dict, model: dict, inputs, types, precision: str = "f32"):
    """Normalised accelerations (B, P, 3) of the noisy input frames
    ``inputs`` (B, n_his, P, 3), particle types (B, P); and the graph
    (receivers, senders) of the batch's particles, flat."""
    B, _, P, d = inputs.shape
    R, L = model["connectivity_radius"], model["hidden_layers"]
    last = inputs[:, -1]
    recv, send = [], []
    for b in range(B):
        r, s = radius_edges(last[b], R)
        recv.append(r + b * P)
        send.append(s + b * P)
    recv, send = torch.cat(recv), torch.cat(send)

    velocity = (inputs[:, 1:] - inputs[:, :-1] - weights["vel_mean"]) / weights["vel_std"]
    bounds = weights["bounds"]
    to_bounds = torch.cat([last - bounds[:, 0], bounds[:, 1] - last], -1)
    parts = [velocity.permute(0, 2, 1, 3).reshape(B, P, -1),
             torch.clamp(to_bounds / R, -1.0, 1.0)]
    if model["particle_types"] > 1:
        parts.append(weights["type_embedding"][types])
    x = torch.cat(parts, -1).reshape(B * P, -1)
    flat = last.reshape(B * P, d)
    disp = (flat[send] - flat[recv]) / R
    dist = torch.sqrt((disp * disp).sum(-1, keepdim=True))
    nodes = mlp(weights, "node_encoder", x, L, True, precision)
    edges = mlp(weights, "edge_encoder", torch.cat([disp, dist], -1), L, True, precision)
    for k in range(model["message_passing_steps"]):
        new_edges = mlp(weights, f"blocks.{k}.edge_mlp",
                        torch.cat([edges, nodes[recv], nodes[send]], -1), L, True, precision)
        received = torch.zeros_like(nodes).index_add_(0, recv, new_edges)
        new_nodes = mlp(weights, f"blocks.{k}.node_mlp", torch.cat([received, nodes], -1), L,
                        True, precision)
        nodes, edges = nodes + new_nodes, edges + new_edges
    out = mlp(weights, "decoder", nodes, L, False, precision)
    return out.reshape(B, P, d), (recv, send)


def loss(weights: dict, model: dict, window, noise, types, precision: str = "f32",
         samples: int | None = None):
    """(loss, graph): `train.py`'s one-step loss of a batch; ``samples``
    plants a fault: the error of the batch's first so many samples alone."""
    inputs = window[:, :-1] + noise
    predicted, graph = forward(weights, model, inputs, types, precision)
    previous = inputs[:, -1]
    acceleration = ((window[:, -1] + noise[:, -1]) - previous) - (previous - inputs[:, -2])
    target = (acceleration - weights["acc_mean"]) / weights["acc_std"]
    moving = types != model["kinematic_type"]
    if samples is not None:
        moving = moving & (torch.arange(types.shape[0], device=types.device) < samples)[:, None]
    error = torch.where(moving[..., None], (predicted - target) ** 2, 0.0)
    return error.sum() / moving.sum(), graph


def learning_rate(model: dict, train: dict, step: int) -> float:
    """The rate of Adam's step ``step`` (0 the first): `train.py`'s
    exponential decay from lr to lr_final, a tenth every lr_decay_steps."""
    if step == 0:
        return train["lr"]
    return ((train["lr"] - model["lr_final"]) * 0.1 ** (step / model["lr_decay_steps"])
            + model["lr_final"])


def train_steps(weights: dict, model: dict, train: dict, batches, precision: str = "f32",
                samples: int | None = None):
    """Adam steps from ``weights`` on ``batches`` of (window, noise, types):
    (losses, gradients (a dict a step), weights after, graphs). Only the
    tensors that require a gradient are trained: the statistics stay.
    ``samples`` as `loss`."""
    params = {k: v.detach().clone() for k, v in weights.items()}
    trained = [k for k in params if not k.startswith(("vel_", "acc_", "bounds"))]
    opt, losses, gradients, graphs = {}, [], [], []
    for i, (window, noise, types) in enumerate(batches):
        leaves = {k: params[k].detach().requires_grad_(True) for k in trained}
        value, graph = loss({**params, **leaves}, model, window, noise, types, precision,
                            samples)
        grads = dict(zip(trained, torch.autograd.grad(value, list(leaves.values()))))
        losses.append(float(value.detach()))
        graphs.append(graph)
        gradients.append(grads)
        with torch.no_grad():
            new, opt = adam({k: params[k] for k in trained}, grads, opt,
                            learning_rate(model, train, i))
        params.update(new)
        del value, leaves
    return losses, gradients, params, graphs


def statistics(positions, noise_std: float) -> dict:
    """`learned_simulator`'s normalisation statistics of (..., T, P, 3)
    trajectories: velocity and acceleration means and deviations over every
    frame and particle (f64), each deviation sqrt(std^2 + noise_std^2)."""
    x = positions.double()
    vel = x[..., 1:, :, :] - x[..., :-1, :, :]
    acc = vel[..., 1:, :, :] - vel[..., :-1, :, :]
    out = {}
    for name, v in (("vel", vel), ("acc", acc)):
        flat = v.reshape(-1, 3)
        out[f"{name}_mean"] = flat.mean(0).float()
        out[f"{name}_std"] = torch.sqrt(flat.var(0, unbiased=False) + noise_std ** 2).float()
    return out


def edge_key(recv, send, particles: int):
    """One int64 key a directed edge of a batch's flat graph."""
    return recv.long() * particles + send.long()

