"""Differentiable Gaussian rasterization: projection -> binning ->
compositing (counterpart of `gsdx/render/rasterize.py`).

  1. `project_gaussians` — plain PyTorch, differentiated by autograd.
  2. `bin_gaussians`     — integer tile lists, no gradient.
  3. feature gather      — indexing whose backward is the scatter-add
                           (``index_add_``) that routes per-tile gradient
                           blocks back to Gaussians.
  4. compositor          — a `torch.autograd.Function` over the CUDA
                           forward and backward kernels (their plain
                           PyTorch versions for CPU tensors).
  5. background blend + tile reassembly.

Outputs: im (C, H, W), radius (N,), depth (H, W), final_t (H, W). An
optional (N, 2) ``mean2d_offset`` input's gradient is the screen-space
positional gradient that drives densification.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gsdx_torch.core.cameras import Camera
from gsdx_torch.kernels.composite import FEAT_DIM, composite_bwd, composite_fwd
from gsdx_torch.render.binning import TileBins, TileGrid, bin_gaussians
from gsdx_torch.render.projection import project_gaussians

# Static-N switch of binning="auto": depth-ordered lists at or below it,
# original-order lists with the compositor's per-tile depth sort above it.
BINNING_AUTO_N = 8192


class RasterizeConfig(NamedTuple):
    """Rasterizer configuration.

    tile_h 0 and sub_chunk 0 resolve by the static Gaussian count N
    (`resolve_binning`): 32-row tiles with 64-wide granules at N <= 8192,
    16-row tiles with 128-wide granules above. The granule is also the
    early-stop granularity, so it fixes the output bit for bit with gsdx.
    binning: "auto" | "sort" (depth-ordered lists) | "nosort"
    (original-order lists, depth order restored inside the compositor).
    """

    tile_h: int = 0
    tile_w: int = 128
    max_per_tile: int = 512  # K: per-tile Gaussian capacity
    max_dup: int = 16  # tiles one Gaussian may cover
    sub_chunk: int = 0
    early_stop: bool = True
    binning: str = "auto"


@dataclasses.dataclass
class RenderOutput:
    im: torch.Tensor  # (C, H, W) colour with background blended
    radius: torch.Tensor  # (N,) screen radius in pixels (0 = culled)
    depth: torch.Tensor  # (H, W) alpha-composited depth
    final_t: torch.Tensor  # (H, W) residual transmittance


def resolve_binning(cfg: RasterizeConfig, n: int) -> RasterizeConfig:
    """Pin binning "auto", sub_chunk 0 and tile_h 0 to their choices for N
    Gaussians (gsdx's `resolve_binning`; "sort" stands for gsdx's
    bit-identical "mask")."""
    binning = cfg.binning
    if binning == "auto":
        binning = "sort" if n <= BINNING_AUTO_N else "nosort"
    if binning not in ("sort", "nosort"):
        raise ValueError(f"unknown binning {cfg.binning!r}")
    sub_chunk = cfg.sub_chunk or (64 if n <= BINNING_AUTO_N else 128)
    tile_h = cfg.tile_h or (32 if (n <= BINNING_AUTO_N and sub_chunk <= 64)
                            else 16)
    return cfg._replace(binning=binning, sub_chunk=sub_chunk, tile_h=tile_h)


def tile_grid(camera: Camera, cfg: RasterizeConfig) -> TileGrid:
    return TileGrid(height=camera.height, width=camera.width,
                    tile_h=cfg.tile_h, tile_w=cfg.tile_w)


class _GatherTiles(torch.autograd.Function):
    """(N, F) Gaussian features -> (T, F, K) tile columns; the backward
    scatter-adds each tile's column gradient back to its Gaussian with
    `index_add_`.

    Slots past a tile's count carry a zero gradient but an index (0), and
    most of a 720p grid's slots are such padding. The autograd of plain
    indexing adds duplicates of one index one after another, which made
    that scatter most of a rasterize step's device time. Here each padded
    slot column goes to a spare row of its own, so no row collects more
    than T padded entries."""

    @staticmethod
    def forward(ctx, feats, gauss_idx, counts):
        ctx.save_for_backward(gauss_idx, counts)
        ctx.n = feats.shape[0]
        return feats[gauss_idx].transpose(1, 2).contiguous()

    @staticmethod
    def backward(ctx, g):
        gauss_idx, counts = ctx.saved_tensors
        n, (T, F, K) = ctx.n, g.shape
        slot = torch.arange(K, device=g.device)
        dst = torch.where(slot[None, :] < counts[:, None], gauss_idx,
                          n + slot[None, :])
        out = g.new_zeros(n + K, F).index_add_(
            0, dst.reshape(-1), g.transpose(1, 2).reshape(T * K, F))
        return out[:n], None, None


class _Composite(torch.autograd.Function):
    """Compositor with a kernel backward. The forward saves nproc and, with
    presort, the rank and sorted features; the backward replays them.
    ``tile_ids`` (T,) int32, optional, places each row at a global tile
    (``geo`` then holds the grid's ``tiles_y``); forward and backward both
    take it."""

    @staticmethod
    def forward(ctx, tile_feats, counts, geo: dict, presort: bool,
                early_stop: bool, tile_ids=None):
        accum, logt, nproc, rank, sorted_feats = composite_fwd(
            tile_feats, counts, presort=presort, early_stop=early_stop,
            tile_ids=tile_ids, **geo)
        ctx.geo = geo
        ctx.save_for_backward(sorted_feats if presort else tile_feats, counts,
                              nproc, logt, rank, tile_ids)
        return accum, logt

    @staticmethod
    def backward(ctx, g_accum, g_logt):
        feats, counts, nproc, logt, rank, tile_ids = ctx.saved_tensors
        if g_accum is None:
            g_accum = torch.zeros(logt.shape[0], ctx.geo["n_accum"],
                                  logt.shape[2], device=logt.device)
        if g_logt is None:
            g_logt = torch.zeros_like(logt)
        grad = composite_bwd(feats, counts, nproc, logt,
                             g_accum.contiguous(), g_logt.contiguous(), rank,
                             tile_ids=tile_ids, **ctx.geo)
        return grad, None, None, None, None, None


def _assemble_image(tiled: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(T, C, P) per-tile channel-major pixels -> (C, H, W) cropped image."""
    T, C, P = tiled.shape
    x = tiled.reshape(grid.tiles_y, grid.tiles_x, C, grid.tile_h, grid.tile_w)
    x = x.permute(2, 0, 3, 1, 4).reshape(
        C, grid.tiles_y * grid.tile_h, grid.tiles_x * grid.tile_w)
    return x[:, :grid.height, :grid.width]


def compute_bins(
    means3d: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    camera: Camera,
    cfg: RasterizeConfig,
    live: torch.Tensor | None = None,
    margin_px: float = 0.0,
) -> TileBins:
    """Project + bin only, for callers that reuse bins over several
    optimizer steps. ``margin_px`` inflates the binning radius so the
    coverage stays a superset of the true one under drift up to that many
    pixels. Always original-order lists: the only form that stays valid as
    depths change, since the compositor re-sorts every step."""
    cfg = resolve_binning(cfg, means3d.shape[0])
    with torch.no_grad():
        proj = project_gaussians(means3d, quats, scales, camera, live=live)
        radius = proj.radius
        if margin_px:
            radius = torch.where(radius > 0, radius + margin_px, radius)
        return bin_gaussians(proj.mean2d, radius, proj.depth, proj.mask,
                             tile_grid(camera, cfg), cfg.max_per_tile,
                             cfg.max_dup, original_order=True)


def rasterize(
    means3d: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    camera: Camera,
    cfg: RasterizeConfig = RasterizeConfig(),
    live: torch.Tensor | None = None,
    mean2d_offset: torch.Tensor | None = None,
    bg: torch.Tensor | None = None,
    bins: TileBins | None = None,
) -> RenderOutput:
    """Render N Gaussians through one camera; differentiable in every float
    input. quats may be unnormalized; opacities (N, 1) in [0, 1]; scales
    positive; colors (N, C) with C <= 9 channels (several colour targets
    fuse into one pass); ``bg`` overrides the camera background (zero-padded
    to C channels); ``bins`` reuses `compute_bins` lists."""
    n, n_chan = colors.shape
    if 7 + n_chan > FEAT_DIM:
        raise ValueError(f"too many colour channels: {n_chan}")
    if bins is not None and cfg.binning == "auto":
        cfg = cfg._replace(binning="nosort")  # compute_bins' original order
    cfg = resolve_binning(cfg, n)
    grid = tile_grid(camera, cfg)

    proj = project_gaussians(means3d, quats, scales, camera, live=live)
    mean2d = proj.mean2d
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset
    presort = cfg.binning == "nosort"
    if bins is None:
        bins = bin_gaussians(mean2d, proj.radius, proj.depth, proj.mask, grid,
                             cfg.max_per_tile, cfg.max_dup,
                             original_order=presort)

    feats = torch.cat([
        mean2d,  # 0:2
        proj.conic,  # 2:5
        opacities.reshape(n, 1) * proj.mask[:, None],  # 5
        colors,  # 6:6+C
        proj.depth[:, None],  # 6+C
        mean2d.new_zeros(n, FEAT_DIM - 7 - n_chan),
    ], dim=1)  # (N, FEAT_DIM)
    tile_feats = _GatherTiles.apply(feats, bins.gauss_idx, bins.counts)  # (T, F, K)
    geo = dict(tiles_x=grid.tiles_x, tile_h=grid.tile_h, tile_w=grid.tile_w,
               n_accum=n_chan + 1, sub_chunk=cfg.sub_chunk)
    accum, logt = _Composite.apply(tile_feats, bins.counts, geo, presort,
                                   cfg.early_stop)

    img = _assemble_image(accum, grid)  # (C+1, H, W)
    final_t = torch.exp(_assemble_image(logt, grid)[0])
    if bg is None:
        bg = camera.bg
    if bg.shape[0] < n_chan:
        bg = torch.cat([bg, bg.new_zeros(n_chan - bg.shape[0])])
    im = img[:n_chan] + final_t[None] * bg[:n_chan, None, None]
    return RenderOutput(im=im, radius=proj.radius, depth=img[n_chan],
                        final_t=final_t)


def render(rendervar: dict, camera: Camera,
           cfg: RasterizeConfig = RasterizeConfig()) -> RenderOutput:
    """Dict entry with the rendervar keys means3D, colors_precomp,
    rotations, opacities, scales, and optional means2D and live."""
    return rasterize(
        rendervar["means3D"], rendervar["rotations"], rendervar["scales"],
        rendervar["opacities"], rendervar["colors_precomp"], camera, cfg,
        live=rendervar.get("live"), mean2d_offset=rendervar.get("means2D"))
