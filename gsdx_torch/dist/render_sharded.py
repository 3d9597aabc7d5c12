"""Tile-sharded compositing and camera-sharded tracking (counterpart of
`gsdx/dist/render_sharded.py`).

Rendering scales by tile ownership: the tile features are replicated, each
rank composites its contiguous slice of the tiles through kernels #1 and #2
with its global tile ids, and the outputs are gathered on every rank. The
backward runs kernel #2 on the rank's rows and one all-reduce gives every
rank the whole feature gradient, as gsdx's shard_map transpose gives a
replicated input.

Tracking scales by camera ownership: each rank sums the tracking loss over
its cameras, and the loss, the camera count and the gradients are
all-reduced into the mean over every camera, as gsdx's psum does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gsdx_torch.core.gaussians import GaussianParams
from gsdx_torch.dist.mesh import Mesh, gather_rows, shard_rows
from gsdx_torch.kernels.composite import ACCUM_DIM
from gsdx_torch.render.binning import TileGrid
from gsdx_torch.render.rasterize import RasterizeConfig, _Composite
from gsdx_torch.track.losses import LossWeights, tracking_loss
from gsdx_torch.track.trainer import GRAD_FIELDS


class _SumGradOverRanks(torch.autograd.Function):
    """Identity forward; the backward all-reduces (sums) the gradient, each
    rank having filled only the rows it owns."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows, gathered. Backward: the rows of the
    (replicated) gradient that this rank owns."""

    @staticmethod
    def forward(ctx, local, mesh, axis):
        ctx.rows = shard_rows(local.shape[0] * mesh.shape[axis], mesh, axis)
        return gather_rows(local, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None, None


def sharded_composite(tile_feats: torch.Tensor, counts: torch.Tensor, grid: TileGrid,
                      cfg: RasterizeConfig, mesh: Mesh, axis: str = "data",
                      n_accum: int = ACCUM_DIM):
    """The compositor over the mesh: (accum (T, n_accum, P), logt (T, 1, P))
    on every rank, from the same (T, 16, K) features and (T,) counts on
    every rank, tile t of the features covering tile t of ``grid``.

    T is padded to a multiple of the axis size (padded rows have count 0
    and are cut after the gather). ``cfg`` gives the granule (``sub_chunk``,
    0 for 128), the early stop and, with ``binning="nosort"``, the
    compositor's own depth sort. Differentiable in ``tile_feats``.
    """
    n = mesh.shape[axis]
    T = tile_feats.shape[0]
    if T > grid.num_tiles:
        raise ValueError(f"{T} tile rows for a grid of {grid.num_tiles} tiles")
    T_pad = -(-T // n) * n
    feats, cts = tile_feats, counts.to(torch.int32)
    if T_pad > T:
        feats = torch.cat([feats, feats.new_zeros(T_pad - T, *feats.shape[1:])])
        cts = torch.cat([cts, cts.new_zeros(T_pad - T)])
    # padded rows take tile 0's id: every id lies in the grid
    ids = torch.arange(T_pad, dtype=torch.int32, device=feats.device)
    ids = torch.where(ids < T, ids, torch.zeros_like(ids))
    rows = shard_rows(T_pad, mesh, axis)
    feats = _SumGradOverRanks.apply(feats, mesh.axis_groups[axis])
    geo = dict(tiles_x=grid.tiles_x, tiles_y=grid.tiles_y, tile_h=grid.tile_h,
               tile_w=grid.tile_w, n_accum=n_accum, sub_chunk=cfg.sub_chunk or 128)
    accum, logt = _Composite.apply(feats[rows].contiguous(), cts[rows].contiguous(), geo,
                                   cfg.binning == "nosort", cfg.early_stop,
                                   ids[rows].contiguous())
    accum = _GatherRows.apply(accum, mesh, axis)
    logt = _GatherRows.apply(logt, mesh, axis)
    return accum[:T], logt[:T]


def make_sharded_tracking_step(cfg: RasterizeConfig, mesh: Mesh, weights: LossWeights,
                               is_initial: bool, axis: str = "data"):
    """Camera-sharded tracking loss and gradient.

    Returns ``loss_and_grad(params, m2d, cams, ims, segs, variables)`` ->
    (loss, (grads, g_m2d)): the mean `tracking_loss` over every camera of
    the stack ``cams`` (targets ``ims``, ``segs`` (C, 3, H, W)), and its
    gradient in ``params`` (a `GaussianParams` of gradients, ``live``
    None) and in ``m2d``, the same on every rank. Each rank renders its
    contiguous cameras; C must divide over the axis.
    """
    group = mesh.axis_groups[axis]

    def loss_and_grad(params: GaussianParams, m2d, cams, ims, segs, variables):
        rows = shard_rows(ims.shape[0], mesh, axis)
        leaves = {f: getattr(params, f).detach().requires_grad_(True) for f in GRAD_FIELDS}
        p = dataclasses.replace(params, **leaves)
        m = m2d.detach().requires_grad_(True)
        total = m.new_zeros(())
        for c in range(rows.start, rows.stop):
            loss, _ = tracking_loss(p, m, cams[c], ims[c], segs[c], variables, weights,
                                    is_initial_timestep=is_initial, raster_cfg=cfg)
            total = total + loss
        wrt = [*leaves.values(), m]
        grads = torch.autograd.grad(total, wrt, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, wrt)]
        flat = torch.cat([total.detach().reshape(1),
                          total.new_full((1,), float(rows.stop - rows.start)),
                          *[g.reshape(-1) for g in grads]])
        dist.all_reduce(flat, group=group)
        loss, count = flat[0] / flat[1], flat[1]
        out, i = [], 2
        for x in wrt:
            out.append((flat[i:i + x.numel()] / count).view_as(x))
            i += x.numel()
        g_params = GaussianParams(**dict(zip(GRAD_FIELDS, out[:-1])), live=None)
        return loss, (g_params, out[-1])

    return loss_and_grad
