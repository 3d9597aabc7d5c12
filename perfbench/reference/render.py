"""Plain reference of the tracking renderer: EWA projection, tile binning and
front-to-back alpha compositing, in plain PyTorch and differentiable by
autograd.

The semantics are those of the reference rasterizer
(diff-gaussian-rasterization) as the tracking path runs them at t > 0:
  * pixel = (fx x/z + cx - 0.5, fy y/z + cy - 0.5); cull at z <= 0.2;
    cov2d = J W Sigma W^T J^T + 0.3 I with x/z, y/z clamped to 1.3x the
    field of view; radius = ceil(3 sqrt(lambda_max));
  * a Gaussian is listed in the 128 x 32 pixel tiles its radius box (grown
    by the bin margin) touches, at most 16 tiles, row-major; a tile keeps
    its 512 nearest; the lists are built once a block of iterations and held;
  * per pixel, nearest first: alpha = min(0.99, opacity exp(power)), dropped
    where power > 0 or alpha < 1/255; colour += alpha T; a tile stops at the
    first 64-wide granule after which every pixel's T < 1e-4.
Written from those rules for this benchmark; it imports nothing of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.utils.checkpoint

NEAR_CULL_Z = 0.2
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
LOG_T_STOP = -9.210340371976182  # log(1e-4)


class Grid(NamedTuple):
    height: int
    width: int
    tile_h: int = 32
    tile_w: int = 128
    max_per_tile: int = 512
    max_dup: int = 16
    sub_chunk: int = 64

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)


def quat_normalize(q):
    return q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-24)


def quat_to_rotmat(q):
    r, x, y, z = quat_normalize(q).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)],
        -2)


def project(means, quats, scales, cam: dict, live):
    """Screen-space Gaussians: (mean2d (N, 2), conic (N, 3) [a, b, c] with
    power = -0.5 (a dx^2 + c dy^2) - b dx dy, depth (N,), radius (N,),
    mask (N,) bool)."""
    W, t = cam["w2c"][:3, :3], cam["w2c"][:3, 3]
    p = means @ W.T + t
    tz = p[:, 2]
    front = tz > NEAR_CULL_Z
    tz_s = torch.where(front, tz, torch.ones_like(tz))
    fx, fy = cam["fx"], cam["fy"]
    lim_x = 1.3 * cam["width"] / (2.0 * fx)
    lim_y = 1.3 * cam["height"] / (2.0 * fy)
    txz = torch.clamp(p[:, 0] / tz_s, -lim_x, lim_x)
    tyz = torch.clamp(p[:, 1] / tz_s, -lim_y, lim_y)
    zero = torch.zeros_like(tz)
    J = torch.stack([torch.stack([fx / tz_s, zero, -fx * txz / tz_s], -1),
                     torch.stack([zero, fy / tz_s, -fy * tyz / tz_s], -1)], -2)  # (N, 2, 3)
    U = J @ W @ quat_to_rotmat(quats) * scales[:, None, :]
    cov = U @ U.transpose(1, 2) + 0.3 * torch.eye(2, dtype=means.dtype, device=means.device)
    c00, c01, c11 = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
    det = c00 * c11 - c01 * c01
    ok = det != 0
    det_s = torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([c11 / det_s, -c01 / det_s, c00 / det_s], -1)
    mid = 0.5 * (c00 + c11)
    radius = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp(mid * mid - det,
                                                                          min=0.1))))
    mean2d = torch.stack([fx * p[:, 0] / tz_s + cam["cx"] - 0.5,
                          fy * p[:, 1] / tz_s + cam["cy"] - 0.5], -1)
    mask = front & ok & (radius > 0) & (live > 0)
    return mean2d, conic, tz, torch.where(mask, radius, zero), mask


@torch.no_grad()
def bins(mean2d, radius, depth, mask, grid: Grid, margin_px: float):
    """Per-tile lists (T, K) of the K nearest Gaussians whose radius box,
    grown by ``margin_px``, touches the tile (at most max_dup tiles a
    Gaussian, row-major over its box), and their counts (T,)."""
    n = mean2d.shape[0]
    dev = mean2d.device
    T, K, tx, ty = grid.tiles_y * grid.tiles_x, grid.max_per_tile, grid.tiles_x, grid.tiles_y
    radius = torch.where(radius > 0, radius + margin_px, radius)
    order = torch.sort(torch.where(mask, depth, torch.full_like(depth, float("inf"))),
                       stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    mx, my = mean2d[:, 0], mean2d[:, 1]
    x0 = torch.clamp(torch.floor((mx - radius) / grid.tile_w), 0, tx).long()
    y0 = torch.clamp(torch.floor((my - radius) / grid.tile_h), 0, ty).long()
    x1 = torch.clamp(torch.floor((mx + radius) / grid.tile_w) + 1, 0, tx).long()
    y1 = torch.clamp(torch.floor((my + radius) / grid.tile_h) + 1, 0, ty).long()
    bw = torch.clamp(x1 - x0, min=0)
    touched = bw * torch.clamp(y1 - y0, min=0)
    slot = torch.arange(grid.max_dup, device=dev)
    row = slot[None] // torch.clamp(bw, min=1)[:, None]
    tile = (y0[:, None] + row) * tx + x0[:, None] + slot[None] - row * bw[:, None]
    valid = mask[:, None] & (slot[None] < touched[:, None])
    pairs = torch.nonzero(valid)
    g, t = pairs[:, 0], tile[pairs[:, 0], pairs[:, 1]]
    key = t * n + rank[g]  # by tile, then nearest first
    srt = torch.sort(key).indices
    g, t = g[srt], t[srt]
    first = torch.searchsorted(t, torch.arange(T, device=dev))
    pos = torch.arange(t.numel(), device=dev) - first[t]
    keep = pos < K
    lists = torch.zeros(T, K, dtype=torch.long, device=dev)
    lists[t[keep], pos[keep]] = g[keep]
    counts = torch.bincount(t[keep], minlength=T)
    return lists, counts


def composite(feats, counts, grid: Grid, n_chan: int):
    """(T, K, 5 + n_chan + 1) features [mean2d, conic, opacity, colours,
    depth] of each tile's listed Gaussians, nearest first -> colour
    (T, n_chan, P) and log transmittance (T, P). Tiles in batches, each
    batch as wide as its longest list; the stop is decided on detached
    values, as the rule is a choice and not a function of the inputs."""
    T, K, _ = feats.shape
    P = grid.tile_h * grid.tile_w
    sub = grid.sub_chunk
    dev = feats.device
    p = torch.arange(P, device=dev)
    tiles = torch.arange(T, device=dev)
    px = ((tiles % grid.tiles_x)[:, None] * grid.tile_w + p % grid.tile_w).to(feats.dtype)
    py = ((tiles // grid.tiles_x)[:, None] * grid.tile_h + p // grid.tile_w).to(feats.dtype)
    def batch(f, n, x, y):
        kb = f.shape[1]
        dx = x[:, None, :] - f[:, :, 0:1]
        dy = y[:, None, :] - f[:, :, 1:2]
        power = -0.5 * (f[:, :, 2:3] * dx * dx + f[:, :, 4:5] * dy * dy) - f[:, :, 3:4] * dx * dy
        alpha = torch.clamp(f[:, :, 5:6] * torch.exp(power), max=ALPHA_MAX)
        listed = torch.arange(kb, device=dev)[None, :, None] < n[:, None, None]
        alpha = torch.where((power <= 0) & (alpha >= ALPHA_MIN) & listed, alpha,
                            torch.zeros_like(alpha))
        with torch.no_grad():
            cum = torch.cumsum(torch.log1p(-alpha.float()), 1)
            done = cum[:, sub - 1::sub, :].amax(2) < LOG_T_STOP  # (B, kb // sub)
            stop = torch.where(done.any(1), torch.argmax(done.int(), 1) + 1,
                               torch.full_like(n, kb // sub))
        used = torch.arange(kb, device=dev)[None, :, None] < (stop * sub)[:, None, None]
        alpha = torch.where(used, alpha, torch.zeros_like(alpha))
        lg = torch.log1p(-alpha)
        c = torch.cumsum(lg, 1)
        w = alpha * torch.exp(c - lg)
        return torch.einsum("bkp,bkc->bcp", w, f[:, :, 6:6 + n_chan]), c[:, -1]

    colour, logt = [], []
    for b0 in range(0, T, 16):
        sl = slice(b0, min(T, b0 + 16))
        kb = max(sub, -(-int(counts[sl].max()) // sub) * sub)
        args = (feats[sl, :kb], counts[sl], px[sl], py[sl])
        if torch.is_grad_enabled() and feats.requires_grad:
            # only the batch's inputs are kept for the backward
            out = torch.utils.checkpoint.checkpoint(batch, *args, use_reentrant=False)
        else:
            out = batch(*args)
        colour.append(out[0])
        logt.append(out[1])
    return torch.cat(colour), torch.cat(logt)


def assemble(tiled, grid: Grid):
    """(T, C, P) -> (C, H, W)."""
    T, C, P = tiled.shape
    x = tiled.reshape(grid.tiles_y, grid.tiles_x, C, grid.tile_h, grid.tile_w)
    x = x.permute(2, 0, 3, 1, 4).reshape(C, grid.tiles_y * grid.tile_h,
                                         grid.tiles_x * grid.tile_w)
    return x[:, :grid.height, :grid.width]


def render(means, quats, scales, opacities, colours, cam: dict, live, lists, counts,
           grid: Grid, bg):
    """(C, H, W) image of N Gaussians through one camera with held tile
    lists; ``bg`` (C,) behind the residual transmittance."""
    mean2d, conic, depth, radius, mask = project(means, quats, scales, cam, live)
    n_chan = colours.shape[1]
    feats = torch.cat([mean2d, conic, opacities.reshape(-1, 1) * mask[:, None], colours,
                       depth[:, None]], 1)[lists]  # (T, K, F)
    # nearest first inside each tile, ties by list slot (the lists are
    # held while the depths move)
    slot = torch.arange(lists.shape[1], device=lists.device)
    key = torch.where(slot[None] < counts[:, None], feats[:, :, -1].detach(),
                      torch.full_like(feats[:, :, -1], float("inf")))
    order = torch.sort(key, dim=1, stable=True).indices
    feats = torch.take_along_dim(feats, order[:, :, None].expand_as(feats), 1)
    colour, logt = composite(feats, counts, grid, n_chan)
    im = assemble(colour, grid)
    final_t = torch.exp(assemble(logt[:, None], grid)[0])
    return im + final_t[None] * bg[:, None, None], radius


def cam_dict(w2c, fx, fy, cx, cy, width, height, dtype=torch.float32) -> dict:
    return {"w2c": w2c.to(dtype), "fx": fx, "fy": fy, "cx": cx, "cy": cy,
            "width": width, "height": height}
