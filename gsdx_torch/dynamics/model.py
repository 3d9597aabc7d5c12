"""Graph neural dynamics model (counterpart of `gsdx/dynamics/model.py`).

An interaction network over particles: dense one-hot relation matrices
Rr, Rs (B, n_rel, N) select receivers and senders by batched products, and
the message passing is the hoisted, node-side form of gsdx's
`DynamicsPredictor` (`model.py:173-190`): the loop-invariant encoder
projections leave the pstep loop, and the 512x512 projections of the effect
run on the N node rows before the one-hot selections.

Weights carry over from the JAX package's flax param tree with
`params_from_flax` (a flax `Dense.kernel` is (in, out) and becomes the
transposed `nn.Linear.weight`); the two propagators keep their
row-partitioned (sum of segment sizes, out) kernel, so `seg(i, x)` stays a
slice. `flax_params` goes the other way.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn


class ModelConfig(NamedTuple):
    """Mirrors the reference model_config yaml block."""

    nf_particle: int = 512
    nf_relation: int = 512
    nf_effect: int = 512
    attr_dim: int = 2
    state_dim: int = 0  # 0, 1 (z-only) or 3
    action_dim: int = 3
    pstep: int = 3
    rel_attr_dim: int = 2
    rel_group_dim: int = 1
    rel_distance_dim: int = 3
    motion_dim: int = 0  # 0 or 3 (cloth/sloth use 3)
    n_his: int = 3
    motion_clamp: float = 100.0


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """flax's lecun_normal: truncated normal at +-2 std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class _Dense(nn.Linear):
    """nn.Linear with flax's Dense init (lecun_normal kernel, zero bias)."""

    def __init__(self, fan_in: int, out: int, generator=None):
        super().__init__(fan_in, out)
        _lecun_normal_(self.weight, fan_in, generator)
        nn.init.zeros_(self.bias)


class Encoder(nn.Module):
    """3-layer MLP with ReLU after every layer."""

    def __init__(self, fan_in: int, hidden: int, out: int, generator=None):
        super().__init__()
        self.dense = nn.ModuleList([_Dense(fan_in, hidden, generator),
                                    _Dense(hidden, hidden, generator),
                                    _Dense(hidden, out, generator)])

    def forward(self, x):
        for d in self.dense:
            x = torch.relu(d(x))
        return x


class ParticlePredictor(nn.Module):
    """lin-relu-lin-relu-lin motion head."""

    def __init__(self, hidden: int, out: int, generator=None):
        super().__init__()
        self.dense = nn.ModuleList([_Dense(hidden, hidden, generator),
                                    _Dense(hidden, hidden, generator),
                                    _Dense(hidden, out, generator)])

    def forward(self, x):
        x = torch.relu(self.dense[0](x))
        x = torch.relu(self.dense[1](x))
        return self.dense[2](x)


class Propagator(nn.Module):
    """Linear + ReLU over a concatenation of segments, with a
    row-partitioned (sum(sizes), out) kernel so that each segment can be
    applied on its own (`seg`)."""

    def __init__(self, sizes: tuple, out: int, generator=None):
        super().__init__()
        self.sizes = tuple(sizes)
        self.kernel = nn.Parameter(torch.empty(sum(self.sizes), out))
        _lecun_normal_(self.kernel, sum(self.sizes), generator)
        self.bias = nn.Parameter(torch.zeros(out))

    def seg(self, i: int, x):
        """x @ (segment-i rows of the kernel), no bias."""
        lo = sum(self.sizes[:i])
        return x @ self.kernel[lo:lo + self.sizes[i]]


def particle_input_dim(cfg: ModelConfig) -> int:
    d = cfg.attr_dim
    if cfg.state_dim == 3:
        d += 3 * cfg.n_his
    elif cfg.state_dim == 1:
        d += cfg.n_his
    if cfg.motion_dim > 0:
        d += 3 * (cfg.n_his - 1)
    return d + max(cfg.action_dim, 0)


def relation_input_dim(cfg: ModelConfig) -> int:
    d = 2 * cfg.attr_dim if cfg.rel_attr_dim > 0 else 0
    d += 1 if cfg.rel_group_dim > 0 else 0
    return d + (3 * cfg.n_his if cfg.rel_distance_dim > 0 else 0)


class DynamicsPredictor(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        nf = cfg.nf_effect
        self.particle_encoder = Encoder(particle_input_dim(cfg), cfg.nf_particle,
                                        nf, generator)
        self.relation_encoder = Encoder(relation_input_dim(cfg), cfg.nf_relation,
                                        nf, generator)
        self.relation_propagator = Propagator((nf, nf, nf), nf, generator)
        self.particle_propagator = Propagator((nf, nf), nf, generator)
        self.non_rigid_predictor = ParticlePredictor(nf, 3, generator)

    def forward(self, state, attrs, Rr, Rs, p_instance, action=None):
        """Predict next particle positions.

        state (B, n_his, N, 3) position history (object + tool slots),
        attrs (B, N, attr_dim), Rr/Rs (B, n_rel, N) one-hot receiver/sender
        rows, p_instance (B, n_p, n_instance), action (B, N, action_dim).
        Returns (pred_pos (B, n_p, 3), pred_motion (B, n_p, 3)).
        """
        cfg = self.cfg
        B, n_his, N, sd = state.shape
        n_p, n_instance = p_instance.shape[1], p_instance.shape[2]
        Rr_t = Rr.transpose(1, 2)
        # (B, N, n_his * 3), history-major
        state_t = state.transpose(1, 2).reshape(B, N, n_his * sd)

        p_inputs = attrs
        if cfg.state_dim == 3:
            p_inputs = torch.cat([p_inputs, state_t], 2)
        elif cfg.state_dim == 1:
            state_z = state_t.reshape(B, N, n_his, sd)[..., 2]
            p_inputs = torch.cat([attrs, state_z], 2)
        if cfg.motion_dim > 0:
            s = state_t.reshape(B, N, n_his, sd)
            motion = (s[:, :, 1:] - s[:, :, :-1]).reshape(B, N, (n_his - 1) * 3)
            p_inputs = torch.cat([p_inputs, motion], 2)
        if cfg.action_dim > 0:
            p_inputs = torch.cat([p_inputs, action], 2)

        rel_parts = []
        if cfg.rel_attr_dim > 0:
            rel_parts += [Rr @ attrs, Rs @ attrs]
        if cfg.rel_group_dim > 0:
            g = torch.cat([p_instance, p_instance.new_zeros((B, N - n_p, n_instance))], 1)
            rel_parts.append(torch.sum(torch.abs(Rr @ g - Rs @ g), 2, keepdim=True))
        if cfg.rel_distance_dim > 0:
            rel_parts.append(Rr @ state_t - Rs @ state_t)
        rel_inputs = torch.cat(rel_parts, 2)

        particle_encode = self.particle_encoder(p_inputs)
        relation_encode = self.relation_encoder(rel_inputs)
        rp, pp = self.relation_propagator, self.particle_propagator
        rel_pre = rp.seg(0, relation_encode) + rp.bias
        node_pre = pp.seg(0, particle_encode) + pp.bias
        effect = particle_encode
        for _ in range(cfg.pstep):
            eff_wr = rp.seg(1, effect)  # (B, N, nf)
            eff_ws = rp.seg(2, effect)
            effect_rel = torch.relu(rel_pre + Rr @ eff_wr + Rs @ eff_ws)
            agg = Rr_t @ effect_rel
            effect = torch.relu(node_pre + pp.seg(1, agg) + effect)

        pred_motion = self.non_rigid_predictor(effect[:, :n_p])
        pred_pos = state[:, -1, :n_p] + torch.clamp(
            pred_motion, -cfg.motion_clamp, cfg.motion_clamp)
        return pred_pos, pred_motion


_MLPS = ("particle_encoder", "relation_encoder", "non_rigid_predictor")
_PROPS = ("relation_propagator", "particle_propagator")


def params_from_flax(tree) -> dict:
    """A flax-layout param tree (nested dicts of numpy arrays or tensors,
    with or without the top "params" level) as a `DynamicsPredictor`
    state dict."""
    p = tree["params"] if "params" in tree else tree

    def t(x):
        if torch.is_tensor(x):
            return x.detach().to(torch.float32)
        return torch.from_numpy(np.array(x, dtype=np.float32))

    state = {}
    for mod in _MLPS:
        for i in range(3):
            d = p[mod][f"Dense_{i}"]
            state[f"{mod}.dense.{i}.weight"] = t(d["kernel"]).T.contiguous()
            state[f"{mod}.dense.{i}.bias"] = t(d["bias"])
    for mod in _PROPS:
        state[f"{mod}.kernel"] = t(p[mod]["kernel"])
        state[f"{mod}.bias"] = t(p[mod]["bias"])
    return state


def flax_params(model: DynamicsPredictor, as_numpy: bool = True) -> dict:
    """The module's weights as a flax-layout tree {"params": ...}, numpy
    arrays by default (what `io.checkpoint.save_checkpoint` writes), or
    detached tensors on the module's device."""
    return flax_tree(model.state_dict(), as_numpy)


def flax_tree(sd: dict, as_numpy: bool = True) -> dict:
    """Tensors keyed by the module's state-dict names (its weights, or
    per-weight optimizer moments) as a flax-layout tree {"params": ...}."""

    def out(x):
        x = x.detach()
        return x.cpu().numpy().copy() if as_numpy else x

    p = {}
    for mod in _MLPS:
        p[mod] = {f"Dense_{i}": {"kernel": out(sd[f"{mod}.dense.{i}.weight"].T),
                                 "bias": out(sd[f"{mod}.dense.{i}.bias"])}
                  for i in range(3)}
    for mod in _PROPS:
        p[mod] = {"kernel": out(sd[f"{mod}.kernel"]), "bias": out(sd[f"{mod}.bias"])}
    return {"params": p}


def load_flax_params(model: DynamicsPredictor, tree) -> DynamicsPredictor:
    """Copy a flax-layout param tree into ``model`` (shapes must match)."""
    model.load_state_dict(params_from_flax(tree))
    return model
