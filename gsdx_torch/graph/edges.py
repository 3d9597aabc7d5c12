"""Radius-graph edge construction (counterpart of `gsdx/graph/edges.py`).

Semantics kept from gsdx, integer for integer:
  * squared-distance threshold adj_thresh^2;
  * no edges of invalid particles, no tool-tool edges;
  * the top-k nearest constraint among object-object pairs only (the
    object block is states[:n_obj]), ties to the lower index as
    `jax.lax.top_k` breaks them (zero-padded states tie constantly);
  * connect_all adds every object<->tool edge;
  * self-edges kept;
  * edges packed row-major (receiver-major, as torch `nonzero` orders
    them) into a fixed budget of max_nR slots, first max_nR kept, so each
    receiver's slots form one consecutive range; -1 on empty slots.

The packing is a cumulative sum over the flattened adjacency and a scatter
into a (B, max_nR) buffer: no `nonzero`, no host sync.
"""

from __future__ import annotations

import torch

from gsdx_torch.utils.profiling import span

_BIG = 1e10


def _adjacency(states, adj_thresh, mask, tool_mask, n_obj: int, topk: int,
               connect_all: bool):
    """(B, N, 3) states -> (B, N, N) bool adjacency, receiver rows."""
    B, N, _ = states.shape
    diff = states[:, :, None, :] - states[:, None, :, :]
    sq = diff * diff
    dis = (sq[..., 0] + sq[..., 1]) + sq[..., 2]  # gsdx's sum over xyz
    big = torch.full_like(dis, _BIG)
    mask12 = mask[:, :, None] & mask[:, None, :]
    dis = torch.where(mask12, dis, big)
    tool12 = tool_mask[:, :, None] & tool_mask[:, None, :]
    dis = torch.where(tool12, big, dis)
    # one radius stays a host scalar: a copy to the device would synchronise
    thresh = torch.as_tensor(adj_thresh, dtype=states.dtype)
    thresh = thresh.to(states.device).reshape(-1)[:, None, None] if thresh.ndim else thresh
    adj = dis < thresh * thresh

    k = min(topk, n_obj)
    dis_obj = dis[:, :n_obj, :n_obj]
    # k smallest, the lower index first among equal distances
    nearest = torch.sort(dis_obj, dim=2, stable=True).indices[:, :, :k]
    topk_mask = torch.zeros_like(adj[:, :n_obj, :n_obj])
    topk_mask.scatter_(2, nearest, True)
    adj = adj.clone()
    adj[:, :n_obj, :n_obj] &= topk_mask

    if connect_all:
        obj_tool_1 = tool_mask[:, :, None] & mask[:, None, :]  # tool receiver
        obj_tool_2 = tool_mask[:, None, :] & mask[:, :, None]  # tool sender
        adj = (adj | obj_tool_1 | obj_tool_2) & ~tool12 & mask12
    return adj


def _pack(adj, max_nR: int):
    """Row-major set bits of (B, N, N) ``adj`` into (B, max_nR) receiver and
    sender indices (int32, -1 on empty slots)."""
    B, N, _ = adj.shape
    flat = adj.reshape(B, N * N)
    pos = torch.cumsum(flat.to(torch.int64), dim=1) - 1
    keep = flat & (pos < max_nR)
    slot = torch.where(keep, pos, torch.full_like(pos, max_nR))  # spare slot
    cell = torch.arange(N * N, device=adj.device).expand(B, -1)
    recv = torch.full((B, max_nR + 1), -1, dtype=torch.int64, device=adj.device)
    send = torch.full_like(recv, -1)
    recv.scatter_(1, slot, torch.where(keep, cell // N, -1))
    send.scatter_(1, slot, torch.where(keep, cell % N, -1))
    return recv[:, :max_nR].to(torch.int32), send[:, :max_nR].to(torch.int32)


def _one_hot(idx, N: int):
    valid = (idx >= 0)[..., None]
    oh = torch.nn.functional.one_hot(idx.clamp(min=0).long(), N).to(torch.float32)
    return torch.where(valid, oh, torch.zeros_like(oh))


def construct_edge_indices_batch(states, adj_thresh, mask, tool_mask, n_obj: int,
                                 topk: int = 10, max_nR: int = 500,
                                 connect_all: bool = False):
    """(recv_idx, send_idx) int32 (B, max_nR), -1 on unused slots.
    ``adj_thresh`` is a scalar or (B,). A span ``graph.edges``."""
    with span("graph.edges"):
        adj = _adjacency(states, adj_thresh, mask.bool(), tool_mask.bool(), n_obj,
                         topk, connect_all)
        return _pack(adj, max_nR)


def construct_edges_batch(states, adj_thresh, mask, tool_mask, n_obj: int,
                          topk: int = 10, max_nR: int = 500,
                          connect_all: bool = False):
    """(Rr, Rs) f32 one-hot rows (B, max_nR, N); unused slots are zero rows."""
    recv, send = construct_edge_indices_batch(states, adj_thresh, mask, tool_mask,
                                              n_obj, topk, max_nR, connect_all)
    N = states.shape[1]
    return _one_hot(recv, N), _one_hot(send, N)


def construct_edge_indices(states, adj_thresh, mask, tool_mask, n_obj: int,
                           topk: int = 10, max_nR: int = 500,
                           connect_all: bool = False):
    """Single-graph form of `construct_edge_indices_batch`: (max_nR,) each."""
    recv, send = construct_edge_indices_batch(
        states[None], adj_thresh, mask[None], tool_mask[None], n_obj, topk,
        max_nR, connect_all)
    return recv[0], send[0]


def construct_edges(states, adj_thresh, mask, tool_mask, n_obj: int,
                    topk: int = 10, max_nR: int = 500, connect_all: bool = False):
    """Single-graph form of `construct_edges_batch`: (max_nR, N) each."""
    Rr, Rs = construct_edges_batch(states[None], adj_thresh, mask[None],
                                   tool_mask[None], n_obj, topk, max_nR,
                                   connect_all)
    return Rr[0], Rs[0]
