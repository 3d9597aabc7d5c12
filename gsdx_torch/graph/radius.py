"""Exact radius graphs of particle clouds on the device, by a cell list.

GNS (`dynamics/gns.py`) connects every pair of particles no farther apart
than its connectivity radius R, self-edges included, with no cap on a
particle's degree: at Water-3D's scale (13,824 particles, ~28 neighbours)
~390k edges a graph. A pair (r, s) is an edge when d^2 <= R^2 in f32, with
d^2 = (dx^2 + dy^2) + dz^2, each square rounded, and R^2 the f32 product of
the f32 radius: the rule `perfbench/reference/gns.py` applies to every pair.

The cloud is sorted by cell of side a little over R (keys sample-major,
then x, y, z), so that a pair within R lies in neighbouring cells, and the
three z-neighbours of a cell are one range of the sorted keys: a particle's
candidates are nine ranges, found by binary search. Each range is read
through ``capacity`` slots; the one host read of a build brings back the
longest range and each sample's edge count. A range longer than the
capacity grows it and builds again (once, on the first clouds). Edges are
packed receiver-major, in the sorted order, into (B, E_max) int32 receivers
and senders with -1 on the slots past a sample's count: the index form of
`dynamics/model.py`'s `relations`.
"""

from __future__ import annotations

import numpy as np
import torch

from gsdx_torch.utils.profiling import host_read

_GRID = 1 << 10  # cells an axis before a far particle is clamped to the last
_SLACK = 1.0 + 2.0 ** -8  # cell side over R: rounding never puts a pair two cells apart


def f32_square(radius: float) -> float:
    """R^2 as the f32 product of the f32 radius."""
    r = np.float32(radius)
    return float(r * r)


class RadiusGraph:
    """``graph(pos)``: the radius graph of each of B clouds (B, n, 3) f32,
    as (recv, send) int32 (B, E_max), -1 on empty slots. Keeps the host's
    counts of its last build: ``edges`` (real, all samples), ``slots``
    (B x E_max) and ``last`` (recv, send)."""

    def __init__(self, radius: float, capacity: int = 8):
        self.radius, self.r2 = float(radius), f32_square(radius)
        self.capacity = int(capacity)
        self.edges = self.slots = 0
        self.last = None

    def _candidates(self, pos):
        B, n, _ = pos.shape
        dev, G = pos.device, _GRID
        lo = pos.amin(1, keepdim=True)
        cell = torch.floor((pos - lo) / (self.radius * _SLACK)).long().clamp_(0, G - 1)
        sample = torch.arange(B, device=dev)[:, None].expand(B, n)
        key = ((sample * G + cell[..., 0]) * G + cell[..., 1]) * G + cell[..., 2]
        skey, order = torch.sort(key.reshape(-1), stable=True)
        spos = pos.reshape(-1, 3)[order]
        c = cell.reshape(-1, 3)[order]
        step = torch.arange(-1, 2, device=dev)
        nx = (c[:, 0:1] + step)[:, :, None].expand(-1, 3, 3)  # (B n, 3, 3)
        ny = (c[:, 1:2] + step)[:, None, :].expand(-1, 3, 3)
        column = ((skey // (G * G * G))[:, None, None] * G + nx) * G + ny
        lo_key = (column * G + (c[:, 2:3, None] - 1).clamp(min=0)).reshape(-1, 9)
        hi_key = (column * G + (c[:, 2:3, None] + 1).clamp(max=G - 1)).reshape(-1, 9)
        start = torch.searchsorted(skey, lo_key)
        count = torch.searchsorted(skey, hi_key, right=True) - start
        inside = ((nx >= 0) & (nx < G) & (ny >= 0) & (ny < G)).reshape(-1, 9)
        count = torch.where(inside, count, 0)
        return spos, order, start, count

    def __call__(self, pos):
        B, n, _ = pos.shape
        spos, order, start, count = self._candidates(pos)
        while True:
            cap = self.capacity
            slot = torch.arange(cap, device=pos.device)
            ok = slot < count[..., None]  # (B n, 9, cap)
            j = torch.where(ok, start[..., None] + slot, 0)
            d = spos[j] - spos[:, None, None, :]
            sq = d * d
            edge = ok & (((sq[..., 0] + sq[..., 1]) + sq[..., 2]) <= self.r2)
            edge = edge.reshape(B, -1)
            counts = edge.sum(1, dtype=torch.int32)
            longest, *per_sample = host_read(
                "gns_edges", torch.cat([count.max().reshape(1).int(), counts]))
            if longest <= cap:
                break
            self.capacity = 8 * -(-int(1.25 * longest) // 8)
        width = max(per_sample)
        # one scan over the whole batch (a row's own scan runs a block a
        # row), less the edges of the samples before each
        at = torch.cumsum(edge.reshape(-1), 0, dtype=torch.int32).view(B, -1)
        at = at - (at[:, -1:] - counts[:, None]) - 1
        at = torch.where(edge, at, width).long()  # a spare slot takes the rest
        recv_i = order % n  # a sorted point's index in its cloud
        recv = recv_i[:, None, None].expand(-1, 9, cap).reshape(B, -1)
        send = recv_i[j].reshape(B, -1)
        out_r = torch.full((B, width + 1), -1, dtype=torch.int32, device=pos.device)
        out_s = torch.full_like(out_r, -1)
        out_r.scatter_(1, at, torch.where(edge, recv, -1).to(torch.int32))
        out_s.scatter_(1, at, torch.where(edge, send, -1).to(torch.int32))
        self.edges, self.slots = sum(per_sample), B * width
        self.last = (out_r[:, :width], out_s[:, :width])
        return self.last
