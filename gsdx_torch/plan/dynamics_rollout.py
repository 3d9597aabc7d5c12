"""Batched GNN rollout for MPPI (counterpart of
`gsdx/plan/dynamics_rollout.py`).

Evaluates a batch of push candidates: each action decodes into a pusher
start plus up to `max_repeat` unit pushes; the radius graph is rebuilt at
every unit push; each sample's prediction freezes at its own repeat count.
gsdx's dynamic-bound `fori_loop` becomes a Python loop to the chunk's
largest repeat count (one host read a chunk).

Repeat-sorted chunks (`sort_chunks`): samples are sorted by repeat count
(descending, a stable sort, as `jnp.argsort` is: repeat counts tie
constantly) and run in equal chunks whose push loop stops at the chunk's
own maximum; outputs go back to the original order. Every per-sample
computation is independent, so this is an exact permutation up to the
summation order of batched products.

The GNN of a push step is, by `RolloutSpec.fused`:
  * "auto": the fused CUDA kernels (`kernels/gnn_forward.py`) when the
    tensors are on CUDA, else the `DynamicsPredictor` module. On CUDA a
    model the kernels do not take raises: it never runs the module in their
    place;
  * "twin": `gnn_forward_plain`, the kernels' plain version (any device);
  * "off": the `DynamicsPredictor` module.
``needs_grad=True`` (the GD planner) always takes the module: the kernels
have no backward.

The push loop's host work lies in spans (`utils/profiling.py`):
``rollout.order`` (decode, pack, sort), a ``rollout.chunk`` a chunk holding
``rollout.head``, the trip count's host read and a ``rollout.step`` a push
(``graph.edges``, ``rollout.pad``, ``rollout.gnn``, ``rollout.advance``),
then ``rollout.gather``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsdx_torch.dynamics.model import DynamicsPredictor, flax_params
from gsdx_torch.graph.edges import construct_edge_indices_batch, construct_edges_batch
from gsdx_torch.kernels.gnn_forward import (fused_gnn_forward, gnn_forward_plain,
                                            pack_gnn_params)
from gsdx_torch.plan.actions import decode_action
from gsdx_torch.utils.profiling import host_read, span


class RolloutSpec(NamedTuple):
    n_his: int = 3
    max_nobj: int = 100
    max_nR: int = 500
    topk: int = 5
    adj_thresh: float = 0.08
    push_length: float = 0.01
    max_repeat: int = 20  # bound on the action length (upper limit of its 4th entry)
    connect_all: bool = False
    # run samples in this many repeat-sorted chunks (1 disables)
    sort_chunks: int = 8
    fused: str = "auto"  # "auto" | "twin" | "off", see the module docstring


def _fused_refusal(cfg, max_nobj: int) -> str | None:
    """The fields of a model the fused forward does not take, or None. It
    takes rope (state 0, motion 0) and cloth/dog/sloth (z-state 1, motion
    3), up to 256 node slots."""
    checks = [("(state_dim, motion_dim)", (cfg.state_dim, cfg.motion_dim),
               (cfg.state_dim, cfg.motion_dim) in ((0, 0), (1, 3))),
              ("attr_dim", cfg.attr_dim, cfg.attr_dim == 2),
              ("rel_group_dim", cfg.rel_group_dim, cfg.rel_group_dim == 1),
              ("rel_attr_dim", cfg.rel_attr_dim, cfg.rel_attr_dim == 2),
              ("rel_distance_dim", cfg.rel_distance_dim, cfg.rel_distance_dim == 3),
              ("action_dim", cfg.action_dim, cfg.action_dim == 3),
              ("(nf_particle, nf_relation, nf_effect)",
               (cfg.nf_particle, cfg.nf_relation, cfg.nf_effect),
               cfg.nf_particle == cfg.nf_relation == cfg.nf_effect),
              ("max_nobj", max_nobj, max_nobj + 1 <= 256)]
    bad = [f"{name} = {value}" for name, value, ok in checks if not ok]
    return ", ".join(bad) or None


def fused_route(spec: RolloutSpec, cfg, device: torch.device, needs_grad: bool) -> bool:
    """Whether a push step runs the fused forward (the kernels, or their
    plain version for "twin") rather than the `DynamicsPredictor` module.
    Raises where the fused forward is asked for, or is "auto" on CUDA, and
    cannot take the model."""
    if needs_grad or spec.fused == "off":
        return False
    if spec.fused == "auto" and device.type != "cuda":
        return False
    refusal = _fused_refusal(cfg, spec.max_nobj)
    if refusal:
        raise ValueError(f"RolloutSpec.fused={spec.fused!r} on {device.type}: the fused "
                         f"GNN forward does not take {refusal}; fused='off' runs "
                         "the module")
    return True


def make_batched_rollout(model: DynamicsPredictor, spec: RolloutSpec):
    """Returns ``rollout(state (n_obj, 3), act_seqs (B, L, 4), *,
    needs_grad=False) -> {"state_seqs": (B, L, n_obj, 3), "action_seqs":
    decoded (B, L, 4)}`` through ``model``'s weights, on the device of
    ``state``."""
    if spec.fused not in ("auto", "twin", "off"):
        raise ValueError(f"RolloutSpec.fused must be auto/twin/off, got {spec.fused!r}")
    cfg = model.cfg
    packs = {}

    def packed_for(device: torch.device):
        """The weights packed for the fused forward: once for each device and
        weight version (an in-place update bumps a parameter's version)."""
        key = (device, tuple((p.data_ptr(), p._version) for p in model.parameters()))
        if key not in packs:
            packs.clear()
            packs[key] = pack_gnn_params(flax_params(model, as_numpy=False),
                                         n_his=spec.n_his, device=device)
        return packs[key]

    def roll_block(state, decoded, repeats, packed, needs_grad):
        """Per-sample independent rollout of one (Bc, L, 4) action block."""
        with span("rollout.chunk"):
            with span("rollout.head"):
                Bc, L = decoded.shape[:2]
                n_obj = state.shape[0]
                N = n_obj + 1  # a single tool particle
                dev = state.device
                state_mask = torch.ones((Bc, N), dtype=torch.bool, device=dev)
                tool_mask = torch.zeros((Bc, N), dtype=torch.bool, device=dev)
                tool_mask[:, n_obj:] = True
                edge_kw = dict(n_obj=n_obj, topk=spec.topk, max_nR=spec.max_nR,
                               connect_all=spec.connect_all)
                if packed is None:
                    attrs = torch.zeros((Bc, N, 2), device=dev)
                    attrs[:, :n_obj, 0] = 1.0
                    attrs[:, n_obj:, 1] = 1.0
                    p_instance = torch.ones((Bc, n_obj, 1), device=dev)
                else:
                    e_pad = -(-spec.max_nR // 8) * 8
                    n_pad = 128 if N <= 128 else 256
                    attrs_pad = torch.zeros((Bc, n_pad, 2), device=dev)
                    attrs_pad[:, :n_obj, 0] = 1.0
                    attrs_pad[:, n_obj:N, 1] = 1.0
                    g_pad = torch.zeros((Bc, n_pad, 1), device=dev)
                    g_pad[:, :n_obj, 0] = 1.0
                    gnn = gnn_forward_plain if spec.fused == "twin" else fused_gnn_forward
                obj_kp = state[None, None].expand(Bc, spec.n_his, n_obj, 3)

            def step(states):
                if packed is None:
                    Rr, Rs = construct_edges_batch(states[:, -1], spec.adj_thresh,
                                                   state_mask, tool_mask, **edge_kw)
                    pred, _ = model(states, attrs, Rr, Rs, p_instance, action)
                    return pred
                recv, send = construct_edge_indices_batch(
                    states[:, -1], spec.adj_thresh, state_mask, tool_mask, out_width=e_pad,
                    **edge_kw)
                with span("rollout.pad"):
                    st_pad = torch.zeros((Bc, n_pad, spec.n_his * 3), device=dev)
                    st_pad[:, :N] = states.transpose(1, 2).reshape(Bc, N, spec.n_his * 3)
                with span("rollout.gnn"):
                    motion = gnn(packed, attrs_pad, action_pad, st_pad, g_pad, recv, send,
                                 pstep=cfg.pstep)[:, :n_obj, :3]
                    return states[:, -1, :n_obj] + torch.clamp(
                        motion, -cfg.motion_clamp, cfg.motion_clamp)

            preds = []
            for li in range(L):
                with span("rollout.head"):
                    if li > 0:
                        obj_kp = preds[li - 1][:, None].expand(Bc, spec.n_his, n_obj, 3)
                    # the pusher spawns at the action's (x, y), at the object's
                    # lowest z
                    z = obj_kp[:, -1, :, 2].min(1).values
                    eef = torch.stack([decoded[:, li, 0], decoded[:, li, 1], z], -1)[:, None]
                    delta = torch.stack([decoded[:, li, 2] - decoded[:, li, 0],
                                         decoded[:, li, 3] - decoded[:, li, 1],
                                         torch.zeros_like(z)], -1)[:, None]  # (Bc, 1, 3)
                    states = torch.cat([obj_kp, eef[:, None].expand(Bc, spec.n_his, 1, 3)], 2)
                    action = torch.cat([delta.new_zeros((Bc, n_obj, 3)), delta], 1)
                    if packed is not None:
                        action_pad = torch.zeros((Bc, n_pad, 3), device=dev)
                        action_pad[:, n_obj:N] = delta
                    pred_li = torch.zeros((Bc, n_obj, 3), device=dev)
                    repeats_li = repeats[:, li]
                if needs_grad:
                    # a fixed trip count: iterations past a sample's own repeat
                    # never match its freeze mask, so the result is the same
                    upper = spec.max_repeat + 1
                else:
                    upper = min(host_read("trip_count", repeats_li.max()), spec.max_repeat) + 1
                for ai in range(1, upper):
                    with span("rollout.step"):
                        pred = step(states)
                        with span("rollout.advance"):
                            # freeze each sample's output at its own repeat count
                            freeze = (repeats_li == ai)[:, None, None]
                            pred_li = torch.where(freeze, pred, pred_li)
                            z_cur = pred[:, :, 2].min(1).values
                            eef_cur = states[:, -1, n_obj:] + action[:, n_obj:]
                            eef_cur = torch.cat([eef_cur[:, :, :2], z_cur[:, None, None]], 2)
                            states_cur = torch.cat([pred, eef_cur], 1)
                            states = torch.cat([states[:, 1:], states_cur[:, None]], 1)
                preds.append(pred_li)
            return torch.stack(preds, 1)

    def rollout(state, act_seqs, *, needs_grad: bool = False):
        with span("rollout.order"):
            B = act_seqs.shape[0]
            decoded, repeats = decode_action(act_seqs, spec.push_length)
            packed = None
            if fused_route(spec, cfg, state.device, needs_grad):
                packed = packed_for(state.device)
            nc = spec.sort_chunks
            sort = nc > 1 and B % nc == 0 and B >= 2 * nc
            if sort:
                # total repeats over the look-ahead decide a sample's cost
                order = torch.argsort(-repeats.sum(1), stable=True)
                inv = torch.argsort(order)
                dec_s, rep_s = decoded[order], repeats[order]
                chunk = B // nc
        if not sort:
            pred_seq = roll_block(state, decoded, repeats, packed, needs_grad)
            return {"state_seqs": pred_seq, "action_seqs": decoded}
        preds = [roll_block(state, dec_s[c * chunk:(c + 1) * chunk],
                            rep_s[c * chunk:(c + 1) * chunk], packed, needs_grad)
                 for c in range(nc)]
        with span("rollout.gather"):
            pred_seq = torch.cat(preds, 0)[inv]
        return {"state_seqs": pred_seq, "action_seqs": decoded}

    return rollout
