"""Plain reference of Dynamic 3D Gaussian tracking at t > 0: the state as
the first timestep leaves it, the warm start of a later timestep, the
tracking loss (L1 + SSIM of colour and segmentation renders, rigidity,
rotation, isometry, floor and background terms, with the paper's weights)
and Adam (betas 0.9 / 0.999, eps 1e-15, a learning rate per field), in plain
PyTorch, differentiated by autograd. Built from the raw point cloud; it
imports nothing of the port.

``dtype`` float32 is the reference; bfloat16, every tensor of the render and
the loss in bf16 (Adam in f32), is the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import render as R

FIELDS = ("means3d", "rgb_colors", "seg_colors", "unnorm_rotations", "logit_opacities",
          "log_scales", "cam_m", "cam_c")
MAX_CAMS = 50


def knn(points, k: int, valid=None, chunk: int = 2048):
    """Squared distances (N, k) ascending, clamped at 0, and indices of every
    point's k nearest other points (among ``valid`` ones). Distances as
    gsdx's KNN computes them, |r|^2 - 2 r.p + |p|^2 in f32 by blocks of
    ``chunk`` rows: the isometry term's gradient takes the sign of a
    current distance minus this table's, so the table has to be the same
    to the last bit (exact differences move it by ~1e-4 relative and flip
    those signs)."""
    n = points.shape[0]
    sq = (points * points).sum(-1)
    ids = torch.arange(n, device=points.device)
    d_out, i_out = [], []
    for r0 in range(0, n, chunk):
        rows = points[r0:r0 + chunk]
        d2 = (rows * rows).sum(-1)[:, None] - 2.0 * rows @ points.T + sq[None]
        if valid is not None:
            d2 = torch.where(valid[None], d2, torch.full_like(d2, 1e10))
        d2 = torch.where(ids[r0:r0 + rows.shape[0], None] == ids[None],
                         torch.full_like(d2, 1e10), d2)
        d, i = torch.topk(d2, k, 1, largest=False, sorted=True)
        d_out.append(d)
        i_out.append(i)
    return torch.clamp(torch.cat(d_out), min=0.0), torch.cat(i_out)


def initial_state(cloud, num_knn: int, pad_to: int = 128):
    """(params, variables) as the first timestep leaves them, from an (n, 7)
    [xyz, rgb, seg] cloud: identity rotations, opacity 0.5, isotropic scales
    from the mean squared distance to the 3 nearest points, the live rows
    packed at a capacity rounded up to ``pad_to``, and the rigidity tables
    (the ``num_knn`` nearest foreground points, weights exp(-2000 d^2))."""
    n = cloud.shape[0]
    dev = cloud.device
    cap = -(-n // pad_to) * pad_to
    sq3, _ = knn(cloud[:, :3], 3)
    log_scale = torch.log(torch.sqrt(torch.clamp(sq3.mean(1), min=1e-7)))

    def rows(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, device=dev)
        out[:n] = x
        return out

    seg = cloud[:, 6]
    quat = torch.zeros(n, 4, device=dev)
    quat[:, 0] = 1.0
    params = {"means3d": rows(cloud[:, :3]), "rgb_colors": rows(cloud[:, 3:6]),
              "seg_colors": rows(torch.stack([seg, torch.zeros_like(seg), 1 - seg], 1)),
              "unnorm_rotations": rows(quat), "logit_opacities": rows(torch.zeros(n, 1, device=dev)),
              "log_scales": rows(log_scale[:, None].expand(n, 3), fill=-20.0),
              "cam_m": torch.zeros(MAX_CAMS, 3, device=dev),
              "cam_c": torch.zeros(MAX_CAMS, 3, device=dev)}
    live = rows(torch.ones(n, device=dev))
    fg = (params["seg_colors"][:, 0] > 0.5) & (live > 0)
    sq, idx = knn(params["means3d"], num_knn, valid=fg)
    rot = R.quat_normalize(params["unnorm_rotations"])
    variables = {"live": live, "neighbor_indices": idx,
                 "neighbor_weight": torch.exp(-2000.0 * sq),
                 "neighbor_dist": torch.sqrt(sq),
                 "neighbor_valid": fg[:, None].expand_as(idx).float(),
                 "init_bg_pts": params["means3d"], "init_bg_rot": rot,
                 "prev_pts": params["means3d"], "prev_rot": rot}
    return params, variables


def quat_multiply(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def quat_conjugate(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def next_timestep(params, variables, moments):
    """A later timestep's start: positions and rotations continue at their
    last velocity, the rigidity reference is the state reached, and the
    Adam moments of positions and rotations are cleared."""
    pts = params["means3d"]
    rot = R.quat_normalize(params["unnorm_rotations"])
    params = dict(params, means3d=pts + (pts - variables["prev_pts"]),
                  unnorm_rotations=R.quat_normalize(rot + (rot - variables["prev_rot"])))
    variables = dict(variables, prev_inv_rot=quat_conjugate(rot),
                     prev_offset=pts[variables["neighbor_indices"]] - pts[:, None],
                     prev_pts=pts, prev_rot=rot)
    mu, nu = dict(moments["mu"]), dict(moments["nu"])
    for f in ("means3d", "unnorm_rotations"):
        mu[f] = torch.zeros_like(params[f])
        nu[f] = torch.zeros_like(params[f])
    return params, variables, {"mu": mu, "nu": nu, "count": moments["count"]}


def zero_moments(params):
    z = {f: torch.zeros_like(params[f]) for f in FIELDS}
    return {"mu": z, "nu": dict(z), "count": 0}


def learning_rates(scene_radius: float) -> dict:
    """After the first timestep only positions and rotations move."""
    lr = {f: 0.0 for f in FIELDS}
    lr["means3d"] = 0.00016 * float(np.float32(scene_radius))
    lr["unnorm_rotations"] = 0.001
    return lr


def _abs(x):
    return torch.where(x >= 0, x, -x)


def _window(dtype, device):
    w = np.exp(-((np.arange(11) - 5) ** 2) / (2 * 1.5 ** 2))
    return torch.tensor(w / w.sum(), dtype=dtype, device=device)


def blur(x):
    """11-tap Gaussian (sigma 1.5) over (C, H, W), zero padding."""
    c = x.shape[0]
    w = _window(x.dtype, x.device)
    y = F.conv2d(x[None], w.view(1, 1, 11, 1).expand(c, 1, 11, 1), padding=(5, 0), groups=c)
    return F.conv2d(y, w.view(1, 1, 1, 11).expand(c, 1, 1, 11), padding=(0, 5), groups=c)[0]


def ssim(a, b):
    mu1, mu2 = blur(a), blur(b)
    s11 = blur(a * a) - mu1 * mu1
    s22 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()


def _masked_mean(x, mask):
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1e-8)


def rigidity(params, v):
    live = v["live"]
    fg = ((params["seg_colors"][:, 0] > 0.5) & (live > 0)).to(params["means3d"].dtype)
    bg = ((params["seg_colors"][:, 0] <= 0.5) & (live > 0)).to(params["means3d"].dtype)
    pts = params["means3d"]
    rot = R.quat_normalize(params["unnorm_rotations"])
    rel = quat_multiply(rot, v["prev_inv_rot"])
    Rm = R.quat_to_rotmat(rel)
    nb = v["neighbor_indices"]
    off = pts[nb] - pts[:, None]
    off_prev = torch.einsum("nij,nki->nkj", Rm, off)
    w, mask = v["neighbor_weight"], v["neighbor_valid"] * fg[:, None]
    out = {"rigid": _masked_mean(torch.sqrt(((off_prev - v["prev_offset"]) ** 2).sum(-1) * w
                                            + 1e-20), mask),
           "rot": _masked_mean(torch.sqrt(((rel[nb] - rel[:, None]) ** 2).sum(-1) * w
                                          + 1e-20), mask),
           "iso": _masked_mean(torch.sqrt((torch.sqrt((off ** 2).sum(-1) + 1e-20)
                                           - v["neighbor_dist"]) ** 2 * w + 1e-20), mask),
           "floor": _masked_mean(torch.clamp(pts[:, 1], min=0.0), fg),
           "bg": _masked_mean(_abs(pts - v["init_bg_pts"]).sum(-1), bg)
           + _masked_mean(_abs(rot - v["init_bg_rot"]).sum(-1), bg)}
    return out


def loss(params, variables, cam: dict, target_im, target_seg, lists, counts, grid, weights,
         bg):
    """The tracking loss of one camera view at t > 0."""
    live = variables["live"]
    colours = torch.cat([params["rgb_colors"], params["seg_colors"]], 1)
    opac = torch.sigmoid(params["logit_opacities"]) * live[:, None]
    im, _ = R.render(params["means3d"], R.quat_normalize(params["unnorm_rotations"]),
                     torch.exp(params["log_scales"]), opac, colours, cam, live, lists, counts,
                     grid, bg)
    cid = cam["cam_id"]
    rgb = torch.exp(params["cam_m"][cid])[:, None, None] * im[:3] + params["cam_c"][cid][:, None, None]
    seg = im[3:6]
    terms = {"im": 0.8 * _abs(rgb - target_im).mean() + 0.2 * (1 - ssim(rgb, target_im)),
             "seg": 0.8 * _abs(seg - target_seg).mean() + 0.2 * (1 - ssim(seg, target_seg))}
    terms.update(rigidity(params, variables))
    return sum(weights[k] * v for k, v in terms.items())


def adam(params, grads, moments, lrs, b1=0.9, b2=0.999, eps=1e-15):
    count = moments["count"] + 1
    bc1 = 1 - np.float32(b1) ** np.float32(count)
    bc2 = 1 - np.float32(b2) ** np.float32(count)
    new_p, mu, nu = {}, {}, {}
    for f in FIELDS:
        g = grads[f]
        mu[f] = b1 * moments["mu"][f] + (1 - b1) * g
        nu[f] = b2 * moments["nu"][f] + (1 - b2) * g * g
        new_p[f] = params[f] - lrs[f] * (mu[f] / float(bc1)) / (
            torch.sqrt(nu[f] / float(bc2)) + eps)
    return new_p, {"mu": mu, "nu": nu, "count": count}


def fit_steps(params, variables, moments, cams: list, targets, order, grid, weights, lrs,
              margin_px: float, bg, dtype=torch.float32):
    """``len(order)`` iterations from one set of tile lists, built at the
    first from the state then. Returns (params, moments, losses)."""
    lists = []
    with torch.no_grad():
        for cam in cams:
            m2d, _, depth, radius, mask = R.project(
                params["means3d"], R.quat_normalize(params["unnorm_rotations"]),
                torch.exp(params["log_scales"]), cam, variables["live"])
            lists.append(R.bins(m2d, radius, depth, mask, grid, margin_px))
    losses = []
    for c in order:
        c = int(c)
        leaves = {f: params[f].detach().to(dtype).requires_grad_(True) for f in FIELDS}
        v = {k: (t.to(dtype) if t.is_floating_point() else t) for k, t in variables.items()}
        cam = dict(cams[c], w2c=cams[c]["w2c"].to(dtype))
        lo = loss(leaves, v, cam, targets[0][c].to(dtype), targets[1][c].to(dtype),
                  *lists[c], grid, weights, bg.to(dtype))
        grads = torch.autograd.grad(lo, list(leaves.values()), allow_unused=True)
        grads = {f: (torch.zeros_like(params[f]) if g is None else g.float())
                 for f, g in zip(FIELDS, grads)}
        with torch.no_grad():
            params, moments = adam(params, grads, moments, lrs)
        losses.append(float(lo.detach()))
    return params, moments, losses


def leaf_gaps(prog: dict, ref: dict, skip=()) -> tuple[float, str]:
    """Worst leaf's |norm(prog) - norm(ref)| over max(norm of that leaf in
    the reference, the median leaf's), and the leaf."""
    norms = {f: float(torch.linalg.vector_norm(ref[f].double())) for f in ref if f not in skip}
    if not norms:
        return math.nan, ""
    med = float(np.median(list(norms.values())))
    worst, which = 0.0, ""
    for f, n_ref in norms.items():
        n_prog = float(torch.linalg.vector_norm(prog[f].double()))
        gap = abs(n_prog - n_ref) / max(n_ref, med, 1e-30)
        if gap >= worst:
            worst, which = gap, f
    return worst, which
