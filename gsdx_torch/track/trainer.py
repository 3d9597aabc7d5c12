"""Dynamic-GS tracking driver (counterpart of `gsdx/track/trainer.py`).

Each timestep is a Python loop of optimizer iterations: render one camera
(random without replacement), backpropagate, densify on the t=0 schedule,
Adam step. For t > 0 the Gaussian set is fixed and every camera's tile
bins are rebuilt once per block of `bin_refresh` iterations (with a
`bin_margin_px` coverage margin) and held frozen in between; the
compositor restores depth order inside the kernel every step. Timestep
warm starts, KNN tables and snapshots run between timesteps. With a
``state_path`` every timestep after the first is checkpointed (flax msgpack
through `io/checkpoint.py`) and a run can resume from it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from gsdx_torch.core.cameras import Camera
from gsdx_torch.core.device import require_device
from gsdx_torch.core.gaussians import (
    GaussianParams,
    TrackingVariables,
    init_tracking_variables,
    params_from_numpy,
    to_numpy,
    variables_from_numpy,
)
from gsdx_torch.core.transforms import quat_conjugate, quat_normalize
from gsdx_torch.kernels.knn import knn
from gsdx_torch.render.rasterize import RasterizeConfig, compute_bins
from gsdx_torch.track.densify import (
    DensifyConfig,
    accumulate_densify_stats,
    densify_step,
    reset_opacities,
)
from gsdx_torch.track.losses import LossWeights, tracking_loss
from gsdx_torch.track.optimizer import FIELDS, AdamState, GroupAdam, tracking_lrs

# Parameter fields that take gradients (live is a mask).
GRAD_FIELDS = tuple(f for f in FIELDS if f != "live")


class TrackingConfig(NamedTuple):
    iters_first: int = 10000
    iters_rest: int = 2000
    num_knn: int = 20
    weights: LossWeights = LossWeights()
    densify: DensifyConfig = DensifyConfig()
    raster: RasterizeConfig = RasterizeConfig()
    seed: int = 0
    # t>0: tile bins of every camera are rebuilt every `bin_refresh`
    # iterations and frozen in between; `bin_margin_px` inflates the binning
    # radius so the frozen coverage stays a superset of the true one under
    # per-step drift. 1 rebuilds bins inside rasterize every iteration.
    bin_refresh: int = 40
    bin_margin_px: float = 4.0


def _refresh_divisor(num_iters: int, refresh: int) -> int:
    """Largest divisor of num_iters that is <= refresh (1 = no reuse)."""
    for d in range(min(refresh, num_iters), 0, -1):
        if num_iters % d == 0:
            return d
    return 1


def make_fit_timestep(cfg: TrackingConfig, is_initial: bool, num_iters: int):
    """Return ``fit(params, opt_state, variables, lrs, cams, ims, segs,
    cam_order, generator) -> (params, opt_state, variables, logs)`` running
    one timestep's `num_iters` iterations. ``cams`` is a stacked Camera,
    ``ims``/``segs`` (C, 3, H, W) targets, ``cam_order`` the camera of each
    iteration, ``generator`` the source of split-sampling noise. ``logs``
    holds per-iteration loss, psnr and num_pts tensors."""
    if is_initial and cfg.densify.interval < 1:
        raise ValueError(
            f"DensifyConfig.interval must be >= 1, got {cfg.densify.interval}")
    adam = GroupAdam()
    refresh = 1 if is_initial else _refresh_divisor(num_iters, cfg.bin_refresh)
    dcfg = cfg.densify

    def fit(params, opt_state, variables, lrs, cams, ims, segs, cam_order,
            generator=None):
        num_cams = ims.shape[0]
        logs = {"loss": [], "psnr": [], "num_pts": []}
        bins_all = None
        for i in range(num_iters):
            if refresh > 1 and i % refresh == 0:
                with torch.no_grad():
                    bins_all = [compute_bins(
                        params.means3d, params.unnorm_rotations,
                        torch.exp(params.log_scales), cams[c], cfg.raster,
                        live=params.live, margin_px=cfg.bin_margin_px)
                        for c in range(num_cams)]
            c = int(cam_order[i])
            leaves = {f: getattr(params, f).detach().requires_grad_(True)
                      for f in GRAD_FIELDS}
            p = dataclasses.replace(params, **leaves)
            m2d = torch.zeros_like(params.means3d[:, :2], requires_grad=True)
            loss, aux = tracking_loss(
                p, m2d, cams[c], ims[c], segs[c], variables, cfg.weights,
                is_initial_timestep=is_initial, raster_cfg=cfg.raster,
                bins=None if bins_all is None else bins_all[c])
            grads = torch.autograd.grad(loss, [*leaves.values(), m2d],
                                        allow_unused=True)
            g_params = GaussianParams(
                **dict(zip(GRAD_FIELDS, grads[:-1])), live=None)
            params = dataclasses.replace(
                params, **{f: t.detach() for f, t in leaves.items()})

            with torch.no_grad():
                if is_initial:
                    if i <= dcfg.end:
                        variables = accumulate_densify_stats(
                            variables, grads[-1], aux.seen, aux.radius,
                            cams.width, cams.height)
                    if i >= dcfg.start and i % dcfg.interval == 0 and i <= dcfg.end:
                        params, variables, opt_state = densify_step(
                            params, variables, opt_state, i, dcfg,
                            generator=generator)
                    if (dcfg.reset_interval > 0 and i > 0
                            and i % dcfg.reset_interval == 0 and i <= dcfg.end):
                        params, opt_state = reset_opacities(params, opt_state)
                params, opt_state = adam.update(g_params, opt_state, params, lrs)
            logs["loss"].append(loss.detach())
            logs["psnr"].append(aux.psnr.detach())
            logs["num_pts"].append(params.num_live)
        return params, opt_state, variables, {k: torch.stack(v)
                                              for k, v in logs.items()}

    return fit


def camera_order(num_iters: int, num_cams: int, rng: np.random.Generator
                 ) -> np.ndarray:
    """Random-without-replacement camera schedule."""
    reps = -(-num_iters // num_cams)
    order = np.concatenate([rng.permutation(num_cams) for _ in range(reps)])
    return order[:num_iters].astype(np.int32)


@torch.no_grad()
def initialize_per_timestep(params: GaussianParams,
                            variables: TrackingVariables, opt_state: AdamState):
    """Momentum warm start and the rigidity reference state; zeroes the Adam
    moments of means3d and rotations."""
    pts = params.means3d
    rot = quat_normalize(params.unnorm_rotations)
    new_pts = pts + (pts - variables.prev_pts)
    new_rot = quat_normalize(rot + (rot - variables.prev_rot))
    variables = dataclasses.replace(
        variables,
        prev_inv_rot=quat_conjugate(rot),
        prev_offset=pts[variables.neighbor_indices] - pts[:, None],
        prev_pts=pts,
        prev_rot=rot,
    )
    params = dataclasses.replace(params, means3d=new_pts, unnorm_rotations=new_rot)
    zero = dict(means3d=torch.zeros_like(pts), unnorm_rotations=torch.zeros_like(rot))
    opt_state = dataclasses.replace(
        opt_state, mu=dataclasses.replace(opt_state.mu, **zero),
        nu=dataclasses.replace(opt_state.nu, **zero))
    return params, variables, opt_state


@torch.no_grad()
def initialize_post_first_timestep(params: GaussianParams,
                                   variables: TrackingVariables,
                                   num_knn: int = 20) -> TrackingVariables:
    """KNN tables over the live foreground and background anchors."""
    is_fg = (params.seg_colors[:, 0] > 0.5) & (params.live > 0)
    sq_dist, idx = knn(params.means3d, num_knn, valid=is_fg)
    rot = quat_normalize(params.unnorm_rotations)
    return dataclasses.replace(
        variables,
        neighbor_indices=idx,
        neighbor_weight=torch.exp(-2000.0 * sq_dist),
        neighbor_dist=torch.sqrt(sq_dist),
        neighbor_valid=is_fg[:, None].expand_as(idx).float(),
        init_bg_pts=params.means3d,
        init_bg_rot=rot,
        prev_pts=params.means3d,
        prev_rot=rot,
    )


@torch.no_grad()
def compact_params(params: GaussianParams, variables: TrackingVariables,
                   pad_to: int = 128):
    """Repack live Gaussians to the front and shrink the capacity to the
    live count rounded up to ``pad_to`` (densification only runs at t=0)."""
    keep = torch.nonzero(params.live > 0, as_tuple=True)[0]
    n = keep.numel()
    cap = int(-(-n // pad_to) * pad_to)
    old = params.capacity

    def pack(arr, fill=0.0):
        if arr.ndim >= 1 and arr.shape[0] == old:
            out = torch.full((cap,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                             device=arr.device)
            out[:n] = arr[keep]
            return out
        return arr

    packed = {f: pack(getattr(params, f)) for f in FIELDS}
    live = torch.zeros(cap, device=params.live.device)
    live[:n] = 1.0
    packed.update(live=live, log_scales=pack(params.log_scales, fill=-20.0))
    new_vars = init_tracking_variables(
        cap, variables.neighbor_indices.shape[1],
        float(variables.scene_radius), device=params.means3d.device)
    return GaussianParams(**packed), new_vars


def snapshot_params(params: GaussianParams, full: bool) -> dict:
    """Host copy of the live rows; t=0 keeps every field, later steps only
    the moving ones."""
    live = (params.live > 0).cpu().numpy()

    def host(t):
        return t.detach().cpu().numpy()

    out = {
        "means3D": host(params.means3d)[live],
        "rgb_colors": host(params.rgb_colors)[live],
        "unnorm_rotations": host(params.unnorm_rotations)[live],
    }
    if full:
        out.update(
            seg_colors=host(params.seg_colors)[live],
            logit_opacities=host(params.logit_opacities)[live],
            log_scales=host(params.log_scales)[live],
            cam_m=host(params.cam_m),
            cam_c=host(params.cam_c),
        )
    return out


def save_tracking_state(path: str, t: int, params: GaussianParams,
                        opt_state: AdamState, variables: TrackingVariables,
                        generator: torch.Generator, rng: np.random.Generator,
                        output_params: list) -> None:
    """Mid-sequence checkpoint: the state after timestep ``t`` (params,
    Adam state, tracking variables, the split-noise generator's state and
    the camera-order RNG's state) in ``path``; the host snapshots so far in
    ``path + ".outputs"`` (a pickle, as gsdx writes it)."""
    from gsdx_torch.io.checkpoint import save_checkpoint

    save_checkpoint(path, {
        "t": np.asarray(t, np.int32), "params": to_numpy(params),
        "opt_state": to_numpy(opt_state), "variables": to_numpy(variables),
        "key": generator.get_state().numpy(),
        "camera_rng": json.dumps(rng.bit_generator.state),
    })
    with open(path + ".outputs", "wb") as f:
        pickle.dump(output_params, f)


def load_tracking_state(path: str, device: str | torch.device = "cpu"):
    """Read a `save_tracking_state` checkpoint. Returns (t, params,
    opt_state, variables, generator, rng, output_params) with the tensors
    on ``device``."""
    from gsdx_torch.io.checkpoint import load_checkpoint

    state = load_checkpoint(path)
    generator = torch.Generator(device=device)
    generator.set_state(torch.from_numpy(np.asarray(state["key"], np.uint8)))
    rng = np.random.default_rng()
    rng.bit_generator.state = json.loads(state["camera_rng"])
    with open(path + ".outputs", "rb") as f:
        outputs = pickle.load(f)
    return (int(state["t"]), params_from_numpy(state["params"], device),
            AdamState.from_numpy(state["opt_state"], device),
            variables_from_numpy(state["variables"], device), generator, rng,
            outputs)


def track_sequence(
    params: GaussianParams,
    cams: Camera,
    ims,
    segs,
    num_timesteps: int,
    cfg: TrackingConfig = TrackingConfig(),
    scene_radius: float = 1.0,
    progress: bool = False,
    on_timestep: Optional[Callable[[int, float, dict], None]] = None,
    device: str | torch.device = "cuda",
    state_path: Optional[str] = None,
    resume: bool = False,
):
    """Track a sequence; returns per-timestep host parameter snapshots.

    ``ims``/``segs`` are (T, C, 3, H, W) tensors/arrays or callables
    t -> (C, 3, H, W). ``on_timestep(t, seconds, logs)`` runs after each
    timestep's fit (seconds measured to a device synchronize). Params,
    cameras and images move to ``device``; "cuda" raises without a GPU.
    ``state_path`` checkpoints the state after every timestep t >= 1;
    ``resume`` continues from that checkpoint when it exists.
    """
    device = require_device(device)
    params = GaussianParams(**{f: getattr(params, f).to(device) for f in FIELDS})
    cams = cams.to(device)
    rng = np.random.default_rng(cfg.seed)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    adam = GroupAdam()
    variables = init_tracking_variables(params.capacity, cfg.num_knn,
                                        scene_radius, device=device)
    opt_state = adam.init(params)
    lrs = tracking_lrs(scene_radius, post_first_timestep=False)

    def frame(src, t):
        x = src(t) if callable(src) else src[t]
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.float32, device=device)

    output_params = []
    start_t = 0
    if resume and state_path and os.path.exists(state_path):
        (t_done, params, opt_state, variables, generator, rng,
         output_params) = load_tracking_state(state_path, device)
        start_t = t_done + 1
        lrs = tracking_lrs(scene_radius, post_first_timestep=True)
        if progress:
            print(f"[track] resumed at t={start_t}")
    fit_first = make_fit_timestep(cfg, is_initial=True, num_iters=cfg.iters_first)
    fit_rest = None
    for t in range(start_t, num_timesteps):
        t_ims, t_segs = frame(ims, t), frame(segs, t)
        is_initial = t == 0
        if not is_initial:
            params, variables, opt_state = initialize_per_timestep(
                params, variables, opt_state)
        num_iters = cfg.iters_first if is_initial else cfg.iters_rest
        order = camera_order(num_iters, t_ims.shape[0], rng)
        if is_initial:
            fit = fit_first
        else:
            if fit_rest is None:
                fit_rest = make_fit_timestep(cfg, is_initial=False,
                                             num_iters=cfg.iters_rest)
            fit = fit_rest
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, opt_state, variables, logs = fit(
            params, opt_state, variables, lrs, cams, t_ims, t_segs, order,
            generator)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if on_timestep is not None:
            on_timestep(t, time.perf_counter() - t0, logs)
        if progress:
            print(f"[track] t={t} loss={float(logs['loss'][-1]):.5f} "
                  f"psnr={float(logs['psnr'][-1]):.3f} "
                  f"pts={int(logs['num_pts'][-1])}")
        if state_path:
            # densification telemetry, as gsdx writes it
            state_dir = os.path.dirname(state_path) or "."
            os.makedirs(state_dir, exist_ok=True)
            with open(os.path.join(state_dir, "num_pts.txt"), "w") as f:
                f.write(f"Number of points: {int(logs['num_pts'][-1])}\n")
        if is_initial:
            params, variables = compact_params(params, variables)
            variables = initialize_post_first_timestep(params, variables,
                                                       cfg.num_knn)
            opt_state = adam.init(params)
            lrs = tracking_lrs(scene_radius, post_first_timestep=True)
        output_params.append(snapshot_params(params, full=is_initial))
        if state_path and not is_initial:
            save_tracking_state(state_path, t, params, opt_state, variables,
                                generator, rng, output_params)
    return output_params
