"""GNS, the Graph Network-based Simulator: Sanchez-Gonzalez et al., Learning
to Simulate Complex Physics with Graph Networks, ICML 2020
(arXiv:2002.09405); code deepmind-research/learning_to_simulate
(`learned_simulator.py`, `graph_network.py`, `train.py`).

A particle's next acceleration from its last ``n_his`` positions:

  * graph: the exact radius graph of the newest positions, self-edges
    included, no cap on degree (`graph/radius.py`);
  * node input: the n_his - 1 velocities, normalised and flattened
    time-major; the distances to the box's lower and upper bounds over the
    connectivity radius R, clipped to [-1, 1]; a learned type embedding
    (used where there is more than one type). Edge input: (x_s - x_r) / R
    and its norm;
  * encoder: a node and an edge MLP; processor: ``message_passing_steps``
    interaction blocks with their own weights, each rewriting every edge
    from [edge, receiver, sender], then every node from [sum of the block's
    new incoming edges, node], each with a residual (graph_nets'
    `InteractionNetwork` with a sum reducer, then `EncodeProcessDecode`'s
    residuals); decoder: an MLP to the normalised acceleration.

Every MLP is Sonnet's: ``hidden_layers`` layers of ``latent_size`` and a
last one, ReLU between layers, LayerNorm (eps 1e-5) on the output except the
decoder's; Sonnet's initialisation (weights truncated-normal at two
deviations with std 1/sqrt(fan_in), zero biases), and TensorFlow's default
for the embedding (Glorot uniform).

The edge MLP's first layer runs node-side: its receiver and sender columns
multiply the node latents before they are gathered (the same sum; the
gather of a product is the product of a gather), so the edge rows take one
128-wide product where the concatenation took a 384-wide one. Endpoints
are gathered and edges summed by receiver through `model.relations`' index
form (`_Indexed`: gathers and a CSR segment sum, each the other's
backward).

`one_step_loss` is `train.py`'s objective on a `graph.dataset.WindowBatch`:
the random-walk noise on the inputs, the target acceleration from the noisy
inputs and the next position moved by the last noise, the squared error
summed over dimensions and averaged over non-kinematic particles.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from gsdx_torch.dynamics.model import relations
from gsdx_torch.graph.radius import RadiusGraph
from gsdx_torch.utils.profiling import span


class GNSConfig(NamedTuple):
    """The model_config block of a GNS configuration (``network: gns``)."""

    latent_size: int = 128
    hidden_layers: int = 2
    message_passing_steps: int = 10
    n_his: int = 6  # input positions: n_his - 1 velocities
    dim: int = 3
    particle_types: int = 9
    type_embedding: int = 16
    kinematic_type: int = 3
    connectivity_radius: float = 0.035
    bounds: tuple = ((0.0, 1.0), (0.0, 1.0), (0.0, 1.0))
    noise_std: float = 6.7e-4
    lr_final: float = 1e-6  # Adam's rate decays from the train config's lr to this
    lr_decay_steps: int = 5_000_000  # by a tenth of the way every so many steps


def node_input_dim(cfg: GNSConfig) -> int:
    d = (cfg.n_his - 1) * cfg.dim + 2 * cfg.dim
    return d + (cfg.type_embedding if cfg.particle_types > 1 else 0)


def _linear(fan_in: int, out: int, generator=None) -> nn.Linear:
    """Sonnet's Linear: weights truncated-normal at two deviations with std
    1/sqrt(fan_in), zero biases."""
    lin = nn.Linear(fan_in, out)
    std = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        nn.init.zeros_(lin.bias)
    return lin


class MLP(nn.Module):
    """``hidden_layers`` Linear layers of ``hidden`` and one of ``out``,
    ReLU between them, a LayerNorm on the output where ``norm``."""

    def __init__(self, fan_in: int, hidden: int, hidden_layers: int, out: int, norm: bool,
                 generator=None):
        super().__init__()
        sizes = [fan_in] + [hidden] * hidden_layers + [out]
        self.linears = nn.ModuleList([_linear(a, b, generator)
                                      for a, b in zip(sizes[:-1], sizes[1:])])
        self.norm = nn.LayerNorm(out, eps=1e-5) if norm else None

    def forward(self, x):
        return self.rest(self.linears[0](x))

    def rest(self, h):
        """The MLP after its first layer, on that layer's output ``h``."""
        for lin in self.linears[1:]:
            h = lin(torch.relu(h))
        return h if self.norm is None else self.norm(h)


class InteractionBlock(nn.Module):
    """One message-passing block: edges from [edge, receiver, sender], then
    nodes from [sum of the new incoming edges, node], both residual."""

    def __init__(self, latent: int, hidden_layers: int, generator=None):
        super().__init__()
        self.edge_mlp = MLP(3 * latent, latent, hidden_layers, latent, True, generator)
        self.node_mlp = MLP(2 * latent, latent, hidden_layers, latent, True, generator)

    def forward(self, nodes, edges, recv, send):
        """nodes (B, n, L), edges (B, E, L), ``recv`` / ``send`` relations
        over n -> (nodes, edges) updated."""
        L = nodes.shape[-1]
        first = self.edge_mlp.linears[0]
        w = first.weight  # (L, 3L): the edge's, the receiver's and the sender's columns
        h = (torch.nn.functional.linear(edges, w[:, :L], first.bias)
             + recv.select(nodes @ w[:, L:2 * L].T)) + send.select(nodes @ w[:, 2 * L:].T)
        new_edges = self.edge_mlp.rest(h)
        new_nodes = self.node_mlp(torch.cat([recv.aggregate(new_edges), nodes], -1))
        return nodes + new_nodes, edges + new_edges


class GNS(nn.Module):
    def __init__(self, cfg: GNSConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        L, H = cfg.latent_size, cfg.hidden_layers
        bound = math.sqrt(6.0 / (cfg.particle_types + cfg.type_embedding))
        self.type_embedding = nn.Parameter(
            torch.rand(cfg.particle_types, cfg.type_embedding, generator=generator) * 2 * bound
            - bound)
        self.node_encoder = MLP(node_input_dim(cfg), L, H, L, True, generator)
        self.edge_encoder = MLP(cfg.dim + 1, L, H, L, True, generator)
        self.blocks = nn.ModuleList([InteractionBlock(L, H, generator)
                                     for _ in range(cfg.message_passing_steps)])
        self.decoder = MLP(L, L, H, cfg.dim, False, generator)
        for name in ("vel_mean", "acc_mean"):
            self.register_buffer(name, torch.zeros(cfg.dim))
        for name in ("vel_std", "acc_std"):
            self.register_buffer(name, torch.ones(cfg.dim))
        self.register_buffer("bounds", torch.tensor(cfg.bounds, dtype=torch.float32))
        self.graph = RadiusGraph(cfg.connectivity_radius)

    def set_statistics(self, stats: dict) -> "GNS":
        """The normalisation statistics (`statistics`), in place."""
        for name, value in stats.items():
            getattr(self, name).copy_(torch.as_tensor(value, dtype=torch.float32))
        return self

    def encode(self, positions, particle_types, recv, send):
        cfg, R = self.cfg, self.cfg.connectivity_radius
        B, _, n, d = positions.shape
        last = positions[:, -1]
        velocity = (positions[:, 1:] - positions[:, :-1] - self.vel_mean) / self.vel_std
        parts = [velocity.transpose(1, 2).reshape(B, n, -1),
                 torch.clamp(torch.cat([last - self.bounds[:, 0], self.bounds[:, 1] - last], -1)
                             / R, -1.0, 1.0)]
        if cfg.particle_types > 1:
            parts.append(self.type_embedding[particle_types])
        disp = (send.select(last) - recv.select(last)) / R
        edges = torch.cat([disp, torch.linalg.vector_norm(disp, dim=-1, keepdim=True)], -1)
        return self.node_encoder(torch.cat(parts, -1)), self.edge_encoder(edges)

    def forward(self, positions, particle_types):
        """positions (B, n_his, n, dim) f32, the input frames (noisy in
        training); particle_types (B, n) int64 -> the normalised
        acceleration (B, n, dim). Spans: ``gns.graph`` and ``gns.process``
        timed on the device, ``gns.encode``, a ``gns.block`` a block,
        ``gns.decode``."""
        dev = positions.device
        n = positions.shape[2]
        with span("gns.graph", dev):
            recv_idx, send_idx = self.graph(positions[:, -1])
            recv, send = relations(recv_idx, n), relations(send_idx, n)
        with span("gns.encode"):
            nodes, edges = self.encode(positions, particle_types, recv, send)
        with span("gns.process", dev):
            for block in self.blocks:
                with span("gns.block"):
                    nodes, edges = block(nodes, edges, recv, send)
        with span("gns.decode"):
            return self.decoder(nodes)

    def normalised_acceleration(self, next_position, positions):
        """learned_simulator's `_inverse_decoder_postprocessor`: the
        acceleration that takes ``positions``' last frame to
        ``next_position``, normalised."""
        previous = positions[:, -1]
        acceleration = (next_position - previous) - (previous - positions[:, -2])
        return (acceleration - self.acc_mean) / self.acc_std


def one_step_loss(model: GNS, batch, cfg=None):
    """(loss, {"mse": loss}) of a `WindowBatch`: the noisy inputs' predicted
    normalised acceleration against the target's, squared, summed over
    dimensions, averaged over non-kinematic particles. ``cfg`` (the train
    config) is not read: `make_train_step` passes it to every loss."""
    inputs = batch.position[:, :-1] + batch.noise
    predicted = model(inputs, batch.particle_type)
    target = model.normalised_acceleration(batch.position[:, -1] + batch.noise[:, -1], inputs)
    moving = batch.particle_type != model.cfg.kinematic_type
    error = torch.where(moving[..., None], (predicted - target) ** 2, 0.0)
    loss = error.sum() / moving.sum()
    return loss, {"mse": loss}


def learning_rate(cfg: GNSConfig, lr: float):
    """`train.py`'s rate after k steps, a `make_train_step` schedule:
    (lr - lr_final) x 0.1^(k / lr_decay_steps) + lr_final."""
    return lambda k: (lr - cfg.lr_final) * 0.1 ** (k / cfg.lr_decay_steps) + cfg.lr_final


def statistics(positions, noise_std: float) -> dict:
    """Velocity and acceleration means and deviations of trajectories
    (..., T, P, dim), over every frame and particle, each deviation combined
    with the noise as learned_simulator does: sqrt(std^2 + noise_std^2)."""
    x = positions.double()
    vel = x[..., 1:, :, :] - x[..., :-1, :, :]
    acc = vel[..., 1:, :, :] - vel[..., :-1, :, :]
    out = {}
    for name, v in (("vel", vel), ("acc", acc)):
        flat = v.reshape(-1, v.shape[-1])
        out[f"{name}_mean"] = flat.mean(0).float()
        out[f"{name}_std"] = torch.sqrt(flat.var(0, unbiased=False) + noise_std ** 2).float()
    return out


def state_tree(sd: dict) -> dict:
    """Tensors keyed by the module's state-dict names (its weights, or
    per-weight optimizer moments) as nested dicts {"params": ...} split at
    the dots, what `io.checkpoint.save_checkpoint` writes."""
    out: dict = {}
    for name, value in sd.items():
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value.detach()
    return {"params": out}
