"""Tile compositor: front-to-back alpha compositing per screen tile
(counterpart of `gsdx/kernels/composite.py`).

Five pieces:

  * `composite_tiles_torch` — the plain PyTorch version, differentiable by
    autograd; the CPU path and the kernels' oracle.
  * `composite_fwd` / `composite_bwd` — wrappers of the hand-written CUDA
    kernels in `gsdx_torch/csrc/composite.cu` (the Hopper ports of gsdx's
    Pallas `_fwd_kernel` and `_bwd_kernel`: each tile split over a
    thread-block cluster, each warp culling splats by their alpha-cut box).
    A CUDA tensor launches the kernel or raises; only CPU tensors take the
    plain version.
  * `alpha_cut_box` — the kernels' culling rule in plain PyTorch, for the
    tests and `chip_smoke.py`; the kernels compute it themselves.
  * `LAUNCHES` — per-variant kernel launch counts; `last_launch` — the
    cluster size, blocks and threads of the last launch, read back from
    the library.
  * `LIBRARY`, the lazy build (`kernels/_build.py`): `nvcc` compiles the
    source into a shared library with a plain C interface at first use,
    loaded with ctypes.

Tile features are (T, FEAT_DIM, K) f32 columns, one per listed Gaussian:
  0 mean_x | 1 mean_y | 2 conic_a | 3 conic_b | 4 conic_c | 5 opacity |
  6.. colour channels | 5 + n_accum depth | rest padding
Alpha is opacity * exp(power), clamped to 0.99, dropped where power > 0 or
alpha < 1/255. Transmittance is kept in log space. A tile stops at the first
sub-chunk boundary where every pixel has log T < LOG_T_STOP, and `nproc`
records how many sub-chunks it composited; the backward replays exactly
that prefix. With ``presort`` the per-tile lists may arrive in any order:
columns are ranked by (depth, slot) first, and the forward also returns the
rank and the sorted features that the backward consumes. ``tile_ids`` (T,)
int32, optional, names the global tile of each row (a shard of the tiles,
`dist/render_sharded.py`): it sets the row's pixel coordinates only; with
it the callers pass the grid's ``tiles_y``, and ids outside the grid are
refused before any launch.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from gsdx_torch.kernels._build import I32, PTR, CudaLibrary, Launcher, ptr

FEAT_DIM = 16
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
# log(1e-4): the reference rasterizer's per-pixel T < 1e-4 stop, applied
# per tile at sub-chunk boundaries.
LOG_T_STOP = -9.210340371976182
ACCUM_DIM = 4  # default accumulated channels: r, g, b, depth
SORT_SENTINEL = 1e30  # presort key of the columns past a tile's count

# Kernel launches per variant, each counted by its variant's `Launcher`.
LAUNCHES = {"fwd": 0, "fwd_presort": 0, "bwd": 0, "bwd_presort": 0}

# What the CUDA kernels take (see csrc/composite.cu).
KERNEL_N_ACCUM = (4, 7)
KERNEL_PATCH_H, KERNEL_PATCH_W = 4, 16  # a warp's pixel patch

# Margins of the alpha-cut box against f32 rounding (csrc/composite.cu
# `cut_box` uses the same): the cut's log-space radius grows by a*c/det
# times CUT_COND_SLACK (rounding of the power's terms) and by CUT_ABS_SLACK
# (exp and the cut's own rounding); each half-extent by CUT_REL_MARGIN of
# itself and CUT_PX_MARGIN pixels.
CUT_COND_SLACK = 1e-5
CUT_ABS_SLACK = 1e-4
CUT_REL_MARGIN = 1e-3
CUT_PX_MARGIN = 1.0
LOG_255 = math.log(255.0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------


def _pixel_coords(tile_idx: torch.Tensor, tiles_x: int, tile_h: int,
                  tile_w: int):
    """(B, P) f32 pixel-centre coordinates of tiles ``tile_idx`` (B,)."""
    P = tile_h * tile_w
    p = torch.arange(P, device=tile_idx.device)
    ty = (tile_idx // tiles_x)[:, None]
    tx = (tile_idx % tiles_x)[:, None]
    px = (tx * tile_w + p % tile_w).float()
    py = (ty * tile_h + p // tile_w).float()
    return px, py


def presort_rank(tile_feats: torch.Tensor, counts: torch.Tensor,
                 n_accum: int):
    """Front-to-back permutation of each tile's columns.

    Returns (perm (T, K) long: sorted position -> column, rank (T, K) long:
    column -> sorted position). Keys are the depth row; ties break by slot;
    columns past the count sort last in index order.
    """
    T, _, K = tile_feats.shape
    slot = torch.arange(K, device=tile_feats.device)
    key = tile_feats[:, 5 + n_accum, :].detach()
    key = torch.where(slot[None, :] < counts[:, None], key,
                      torch.full_like(key, SORT_SENTINEL))
    perm = torch.sort(key, dim=1, stable=True).indices
    rank = torch.empty_like(perm)
    rank.scatter_(1, perm, slot.expand(T, K).contiguous())
    return perm, rank


def alpha_cut_box(tile_feats: torch.Tensor):
    """Per-column box (x0, x1, y0, y1), each (T, K) f32, that holds every
    pixel where the column's splat can pass the alpha cut: the bounding box
    of {opacity * exp(power) >= 1/255}, half-extents
    sqrt(2 ln(255 op) c / (a c - b^2)) and sqrt(2 ln(255 op) a / (a c - b^2)),
    widened by the CUT_* margins.

    Opacity below 1/255 gives an empty box (x0 = y0 = inf, x1 = y1 = -inf);
    a conic that is not positive definite (a <= 0 or a c - b^2 <= 0) an
    unbounded one; a NaN input a NaN box, which no test may cull. Pixel
    coordinates are integer indices (`_pixel_coords`). The kernels compute
    the same rule per granule; this copy is for the tests and the card's
    pair counts.
    """
    f = tile_feats.detach().float()
    mx, my, a, b, c, op = (f[:, i] for i in range(6))
    det = a * c - b * b
    cut = 2.0 * (torch.log(op) + LOG_255)
    cut = torch.where(cut < 0, torch.zeros_like(cut), cut)
    cut = cut * (1.0 + CUT_COND_SLACK * (a * c / det)) + CUT_ABS_SLACK
    hx = torch.sqrt(cut * c / det) * (1.0 + CUT_REL_MARGIN) + CUT_PX_MARGIN
    hy = torch.sqrt(cut * a / det) * (1.0 + CUT_REL_MARGIN) + CUT_PX_MARGIN
    inf = torch.full_like(mx, math.inf)
    empty = op < ALPHA_MIN
    pd = (a > 0) & (det > 0)

    def side(lo, centre, half):
        bounded = centre - half if lo else centre + half
        unbounded = -inf if lo else inf
        return torch.where(empty, inf if lo else -inf,
                           torch.where(pd, bounded, unbounded))

    return side(True, mx, hx), side(False, mx, hx), side(True, my, hy), side(False, my, hy)


def _composite_batch(cf, counts, tile_idx, nproc_in, *, tiles_x, tile_h,
                     tile_w, n_accum, sub, early_stop):
    """One batch of tiles, columns already in front-to-back order.

    cf (B, F, Kb), counts (B,), tile_idx (B,). ``nproc_in`` (B,) replays a
    given prefix instead of deciding the early stop. Returns accum
    (B, n_accum, P), logt (B, 1, P), nproc (B,).
    """
    B, _, Kb = cf.shape
    px, py = _pixel_coords(tile_idx, tiles_x, tile_h, tile_w)  # (B, P)
    slot = torch.arange(Kb, device=cf.device)[None, :, None]  # (1, Kb, 1)
    mx, my = cf[:, 0, :, None], cf[:, 1, :, None]  # (B, Kb, 1)
    ca, cb, cc = cf[:, 2, :, None], cf[:, 3, :, None], cf[:, 4, :, None]
    op = cf[:, 5, :, None]
    dx = px[:, None, :] - mx  # (B, Kb, P)
    dy = py[:, None, :] - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
    keep = (power <= 0) & (alpha >= ALPHA_MIN) & (slot < counts[:, None, None])
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))

    nchunks = -(-counts.long() // sub)
    if nproc_in is not None:
        nproc = torch.minimum(nproc_in.long(), nchunks)
    elif early_stop:
        with torch.no_grad():
            cum0 = torch.cumsum(torch.log1p(-alpha), dim=1)
            bmax = cum0[:, sub - 1::sub, :].amax(dim=2)  # (B, Kb // sub)
            sat = bmax < LOG_T_STOP
            first = torch.argmax(sat.int(), dim=1) + 1
            nproc = torch.where(sat.any(dim=1), first,
                                torch.full_like(first, Kb // sub))
            nproc = torch.minimum(nproc, nchunks)
    else:
        nproc = nchunks
    count_eff = torch.minimum(counts.long(), nproc * sub)
    alpha = torch.where(slot < count_eff[:, None, None], alpha,
                        torch.zeros_like(alpha))

    l = torch.log1p(-alpha)
    cum = torch.cumsum(l, dim=1)
    w = alpha * torch.exp(cum - l)  # (B, Kb, P)
    accum = torch.bmm(cf[:, 6:6 + n_accum, :], w)  # (B, n_accum, P)
    logt = cum[:, -1:, :]
    return accum, logt, nproc


def composite_tiles_torch(
    tile_feats: torch.Tensor,
    counts: torch.Tensor,
    *,
    tiles_x: int,
    tile_h: int,
    tile_w: int,
    n_accum: int = ACCUM_DIM,
    sub_chunk: int = 128,
    presort: bool = False,
    early_stop: bool = True,
    nproc: torch.Tensor | None = None,
    batch: int = 32,
    tile_ids: torch.Tensor | None = None,
    tiles_y: int | None = None,
):
    """Plain PyTorch compositor over (T, F, K) tile features.

    Same arithmetic rules and the same sub-chunk stop granularity as the
    kernels; differentiable by autograd (each tile batch is checkpointed,
    so only its inputs are kept for the backward). Tiles run in batches of
    ``batch`` and each batch only as wide as its longest list. ``nproc``
    (T,) replays exactly that many sub-chunks per tile (the backward's
    contract) instead of deciding the stop. ``tile_ids`` (T,) places row t
    at global tile ``tile_ids[t]`` of a grid ``tiles_x`` x ``tiles_y``
    (default: row t is tile t).

    Returns accum (T, n_accum, P), logt (T, 1, P), nproc (T,) int32; with
    ``presort`` also rank (T, 1, K) f32 and the sorted features (T, F, K),
    both zero on tiles with count 0.
    """
    T, F, K = tile_feats.shape
    if F != FEAT_DIM or K % sub_chunk:
        raise ValueError(f"tile_feats {tuple(tile_feats.shape)} needs "
                         f"F={FEAT_DIM} and K a multiple of {sub_chunk}")
    counts = counts.to(torch.int32)
    feats = tile_feats
    if presort:
        perm, rank = presort_rank(tile_feats, counts, n_accum)
        feats = torch.take_along_dim(tile_feats, perm[:, None, :], dim=2)
    if tile_ids is None:
        tile_idx = torch.arange(T, device=tile_feats.device)
    else:
        _check_tile_ids(tile_ids, T, tiles_x, tiles_y, tile_feats.device)
        tile_idx = tile_ids.long()
    kw = dict(tiles_x=tiles_x, tile_h=tile_h, tile_w=tile_w, n_accum=n_accum,
              sub=sub_chunk, early_stop=early_stop)
    outs = []
    for b0 in range(0, T, batch):
        sl = slice(b0, min(T, b0 + batch))
        kb = int(counts[sl].max().item()) if T else 0
        kb = max(sub_chunk, -(-kb // sub_chunk) * sub_chunk)
        args = (feats[sl, :, :kb], counts[sl], tile_idx[sl],
                None if nproc is None else nproc[sl])
        if torch.is_grad_enabled() and feats.requires_grad:
            out = torch.utils.checkpoint.checkpoint(
                lambda *a: _composite_batch(*a, **kw), *args,
                use_reentrant=False)
        else:
            out = _composite_batch(*args, **kw)
        outs.append(out)
    accum = torch.cat([o[0] for o in outs])
    logt = torch.cat([o[1] for o in outs])
    nproc_out = torch.cat([o[2] for o in outs]).to(torch.int32)
    if not presort:
        return accum, logt, nproc_out
    empty = (counts == 0)[:, None, None]
    rank_f = torch.where(empty, 0.0, rank[:, None, :].float())
    sorted_feats = torch.where(empty, 0.0, feats.detach())
    return accum, logt, nproc_out, rank_f, sorted_feats


def composite_bwd_torch(feats, counts, nproc, g_accum, g_logt, rank=None, *,
                        tiles_x, tile_h, tile_w, n_accum, sub_chunk,
                        tile_ids=None, tiles_y=None):
    """Plain backward: autograd of `composite_tiles_torch` replaying
    ``nproc`` sub-chunks. With ``rank`` the features are the sorted copy and
    the gradient is un-sorted back to the input column order."""
    f = feats.detach().requires_grad_(True)
    with torch.enable_grad():
        accum, logt, _ = composite_tiles_torch(
            f, counts, tiles_x=tiles_x, tile_h=tile_h, tile_w=tile_w,
            n_accum=n_accum, sub_chunk=sub_chunk, nproc=nproc,
            tile_ids=tile_ids, tiles_y=tiles_y)
        (grad,) = torch.autograd.grad((accum, logt), f, (g_accum, g_logt))
    if rank is not None:
        idx = rank.long().expand(-1, FEAT_DIM, -1)
        grad = torch.take_along_dim(grad, idx, dim=2)
    return grad


# --------------------------------------------------------------------------
# CUDA kernels: lazy build + wrappers
# --------------------------------------------------------------------------

LIBRARY = CudaLibrary(
    "gsdx_composite", "composite.cu",
    {"gsdx_composite_fwd": [PTR] * 8 + [I32] * 9 + [PTR],
     "gsdx_composite_bwd": [PTR] * 9 + [I32] * 8 + [PTR],
     "gsdx_composite_last_launch": [PTR]},
    error_string="gsdx_cuda_error_string")
_FWD = Launcher(LIBRARY, "gsdx_composite_fwd", "composite_fwd", LAUNCHES, "fwd")
_FWD_PRESORT = Launcher(LIBRARY, "gsdx_composite_fwd", "composite_fwd", LAUNCHES,
                        "fwd_presort")
_BWD = Launcher(LIBRARY, "gsdx_composite_bwd", "composite_bwd", LAUNCHES, "bwd")
_BWD_PRESORT = Launcher(LIBRARY, "gsdx_composite_bwd", "composite_bwd", LAUNCHES,
                        "bwd_presort")


def last_launch() -> dict:
    """Cluster size, blocks and threads a block of the library's last
    accepted compositor launch, as the C side launched it."""
    return LIBRARY.record("gsdx_composite_last_launch", ("cluster", "blocks", "threads"))


def _check_tile_ids(tile_ids, T, tiles_x, tiles_y, device):
    """Refuse tile ids that are not contiguous (T,) int32 on ``device`` or
    that name a tile outside the ``tiles_x`` x ``tiles_y`` grid (one read
    back of their range, before any launch)."""
    if tiles_y is None:
        raise ValueError("tile_ids needs the grid's tiles_y")
    if (tile_ids.dtype != torch.int32 or tile_ids.shape != (T,)
            or tile_ids.device != device or not tile_ids.is_contiguous()):
        raise ValueError(f"tile_ids must be contiguous ({T},) int32 on {device}, got "
                         f"{tuple(tile_ids.shape)} {tile_ids.dtype} on {tile_ids.device}")
    if not T:
        return
    lo, hi = (int(v) for v in torch.aminmax(tile_ids))
    if not (0 <= lo and hi < tiles_x * tiles_y):
        raise ValueError(f"tile_ids must lie in [0, {tiles_x * tiles_y}) for a "
                         f"{tiles_x} x {tiles_y} grid")


def _check_inputs(tile_h, tile_w, n_accum, sub_chunk, K, **tensors):
    dev = None
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = torch.int32 if name in ("counts", "nproc") else torch.float32
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")
    # 128-wide tiles, each block of a cluster all of the tile's rows
    if tile_w != 128 or tile_h % 8 or not 8 <= tile_h <= 32:
        raise ValueError(f"tile {tile_h}x{tile_w} unsupported: the kernels take "
                         "128-wide tiles of 8, 16, 24 or 32 rows")
    if n_accum not in KERNEL_N_ACCUM:
        raise ValueError(f"n_accum {n_accum} unsupported by the kernels "
                         f"(built for {KERNEL_N_ACCUM})")
    if sub_chunk > 128 or K % sub_chunk or K > 1024:
        raise ValueError(f"sub_chunk {sub_chunk} / K {K} unsupported "
                         "(sub_chunk <= 128 dividing K, K <= 1024)")


def composite_fwd(tile_feats: torch.Tensor, counts: torch.Tensor, *,
                  tiles_x: int, tile_h: int, tile_w: int, n_accum: int,
                  sub_chunk: int, presort: bool = False,
                  early_stop: bool = True, tile_ids: torch.Tensor | None = None,
                  tiles_y: int | None = None):
    """Forward compositor. Returns (accum, logt, nproc, rank, sorted_feats);
    rank and sorted_feats are None without ``presort``. ``tile_ids`` (T,)
    int32 places each row at a global tile of the ``tiles_x`` x ``tiles_y``
    grid. CUDA tensors launch the kernel; CPU tensors run
    `composite_tiles_torch`."""
    kw = dict(tiles_x=tiles_x, tile_h=tile_h, tile_w=tile_w, n_accum=n_accum,
              sub_chunk=sub_chunk, presort=presort, early_stop=early_stop,
              tile_ids=tile_ids, tiles_y=tiles_y)
    if not tile_feats.is_cuda:
        with torch.no_grad():
            out = composite_tiles_torch(tile_feats, counts, **kw)
        return out if presort else (*out, None, None)

    T, F, K = tile_feats.shape
    if F != FEAT_DIM or counts.shape != (T,):
        raise ValueError("tile_feats must be (T, 16, K) and counts (T,)")
    _check_inputs(tile_h, tile_w, n_accum, sub_chunk, K,
                  tile_feats=tile_feats, counts=counts)
    if tile_ids is not None:
        _check_tile_ids(tile_ids, T, tiles_x, tiles_y, tile_feats.device)
    P = tile_h * tile_w
    accum = torch.empty((T, n_accum, P), device=tile_feats.device)
    logt = torch.empty((T, 1, P), device=tile_feats.device)
    nproc = torch.empty((T,), dtype=torch.int32, device=tile_feats.device)
    rank = sorted_feats = None
    if presort:
        rank = torch.empty((T, 1, K), device=tile_feats.device)
        sorted_feats = torch.empty_like(tile_feats)
    (_FWD_PRESORT if presort else _FWD)(
        tile_feats.device.index, tile_feats.data_ptr(), counts.data_ptr(), ptr(tile_ids),
        accum.data_ptr(), logt.data_ptr(), nproc.data_ptr(), ptr(rank), ptr(sorted_feats),
        T, K, tiles_x, tile_h, tile_w, n_accum, sub_chunk, int(presort), int(early_stop))
    return accum, logt, nproc, rank, sorted_feats


def composite_bwd(feats: torch.Tensor, counts: torch.Tensor,
                  nproc: torch.Tensor, logt: torch.Tensor,
                  g_accum: torch.Tensor, g_logt: torch.Tensor,
                  rank: torch.Tensor | None = None, *, tiles_x: int,
                  tile_h: int, tile_w: int, n_accum: int, sub_chunk: int,
                  tile_ids: torch.Tensor | None = None,
                  tiles_y: int | None = None):
    """Backward compositor: dense (T, F, K) gradient w.r.t. the forward's
    input features. With ``rank`` (presort), ``feats`` is the forward's
    sorted copy and the gradient comes back in the input column order;
    ``tile_ids`` as the forward's. CUDA tensors launch the kernel; CPU
    tensors run `composite_bwd_torch`."""
    geo = dict(tiles_x=tiles_x, tile_h=tile_h, tile_w=tile_w, n_accum=n_accum,
               sub_chunk=sub_chunk, tile_ids=tile_ids, tiles_y=tiles_y)
    if not feats.is_cuda:
        return composite_bwd_torch(feats, counts, nproc, g_accum, g_logt,
                                   rank, **geo)

    T, F, K = feats.shape
    P = tile_h * tile_w
    if (F != FEAT_DIM or counts.shape != (T,) or nproc.shape != (T,)
            or logt.shape != (T, 1, P) or g_accum.shape != (T, n_accum, P)
            or g_logt.shape != (T, 1, P)
            or (rank is not None and rank.shape != (T, 1, K))):
        raise ValueError("composite_bwd input shapes do not match the tiles")
    tensors = dict(feats=feats, counts=counts, nproc=nproc, logt=logt,
                   g_accum=g_accum, g_logt=g_logt)
    if rank is not None:
        tensors["rank"] = rank
    _check_inputs(tile_h, tile_w, n_accum, sub_chunk, K, **tensors)
    if tile_ids is not None:
        _check_tile_ids(tile_ids, T, tiles_x, tiles_y, feats.device)
    grad = torch.empty_like(feats)
    (_BWD if rank is None else _BWD_PRESORT)(
        feats.device.index, feats.data_ptr(), counts.data_ptr(), ptr(tile_ids),
        nproc.data_ptr(), logt.data_ptr(), g_accum.data_ptr(), g_logt.data_ptr(),
        ptr(rank), grad.data_ptr(), T, K, tiles_x, tile_h, tile_w, n_accum, sub_chunk,
        int(rank is not None))
    return grad
