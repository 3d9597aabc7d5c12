"""Driver of tracking mixes: Dynamic 3D Gaussian tracking at t > 0 through
the port's `make_fit_timestep` fit, as `track_sequence` drives it.

Set-up makes the mix's cloud (from ``scenario_seed``, the same for every
run's seed, which draws the cameras' order) and its true clouds, renders the
targets of every camera with the benchmark's plain renderer, and builds the
port's state as `track_sequence` leaves it after t = 0 (`init_gaussian_params`
-> `compact_params` -> `initialize_post_first_timestep`). It then starts a
timestep (`initialize_per_timestep`) and runs its first chunk through the window's
own fit (every kernel built, every shape met), keeping that chunk's losses,
Adam moments and parameters for the check. The window starts a new
timestep every ``iters_rest`` iterations, on the next target frame, and
calls the fit in chunks of ``iters_per_call`` iterations, a divisor of the
bin refresh, so the tile lists are rebuilt where `track_sequence` rebuilds
them. It runs whole chunks until the host clock passes its length, then
synchronises: the rate is the iterations over that time.

Mix parameters: ``scenario_seed``, ``frames`` target frames rendered in set-up,
``iters_per_call``, ``trace_seconds``; the configuration's
``tracking_scene`` gives the cloud and the cameras.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench import scenes
from perfbench.reference import render as R
from perfbench.reference import tracking as T


class TrackCell:
    def __init__(self, ctx: dict):
        from gsdx_torch.core.cameras import make_camera, stack_cameras
        from gsdx_torch.core.gaussians import init_gaussian_params, init_tracking_variables
        from gsdx_torch.kernels.knn import knn
        from gsdx_torch.render.rasterize import RasterizeConfig
        from gsdx_torch.track.losses import LossWeights
        from gsdx_torch.track.optimizer import GroupAdam, tracking_lrs
        from gsdx_torch.track import trainer

        config, mix, seed, dev = ctx["config"], ctx["mix"], ctx["seed"], ctx["device"]
        self.config, self.mix, self.seed, self.device = config, mix, seed, dev
        self.t_start, self.first_window = ctx["t_start"], True
        self.trainer = trainer
        tr, sc = config["tracking"], config["tracking_scene"]
        self.tr = tr
        W, H = tr["width"], tr["height"]
        self.grid = R.Grid(height=H, width=W)

        # the benchmark's inputs: cameras, clouds, targets, camera order
        w2c = scenes.look_at_ring(sc["camera_angles"][:tr["n_cams"]], sc["centre"],
                                  sc["camera_distance_m"])
        self.scene_radius = scenes.scene_radius(w2c)
        f, bg = sc["focal_px"], sc["background"]
        self.ref_cams = [dict(R.cam_dict(torch.tensor(w, device=dev), f, f, W / 2, H / 2, W, H),
                              cam_id=c) for c, w in enumerate(w2c)]
        self.bg6 = torch.tensor(list(bg) + [0.0, 0.0, 0.0], device=dev)
        # every seed tracks the same scene, the mix's: the work of an iteration
        # follows the cloud's spread over the tiles; the run's seed draws the
        # order in which the cameras are fitted
        cloud, noisy = scenes.tracking_cloud(scenes.generator(mix["scenario_seed"], 11, dev),
                                             sc, dev)
        self.noisy = noisy
        self.frames = [self._render_targets(c) for c in
                       scenes.tracking_frames(cloud, mix["frames"], sc)]
        rng = np.random.default_rng([seed % 2**63, 12])
        n_it = tr["iters_rest"]
        self.orders = [np.concatenate([rng.permutation(tr["n_cams"])
                                       for _ in range(-(-n_it // tr["n_cams"]))])[:n_it]
                       for _ in range(mix["frames"])]

        # the port's state after t = 0
        k = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
        self.cams = stack_cameras([make_camera(k, w, W, H, tr["near"], tr["far"], bg=bg,
                                               cam_id=c, device=dev)
                                   for c, w in enumerate(w2c)])
        sq, _ = knn(noisy[:, :3], 3)
        params = init_gaussian_params(noisy.cpu().numpy(), sq.mean(-1).cpu().numpy(),
                                      capacity=tr["capacity"], device=dev)
        variables = init_tracking_variables(params.capacity, tr["num_knn"],
                                            self.scene_radius, device=dev)
        params, variables = trainer.compact_params(params, variables)
        variables = trainer.initialize_post_first_timestep(params, variables, tr["num_knn"])
        opt = GroupAdam().init(params)
        self.lrs = tracking_lrs(self.scene_radius, post_first_timestep=True)
        weights = {k_: v for k_, v in tr["weights"].items() if k_ in LossWeights._fields}
        self.cfg = trainer.TrackingConfig(iters_rest=n_it, num_knn=tr["num_knn"],
                                          weights=LossWeights(**weights),
                                          raster=RasterizeConfig(), seed=0,
                                          bin_refresh=tr["bin_refresh"],
                                          bin_margin_px=tr["bin_margin_px"])
        self.gen = scenes.generator(seed, 13, dev)
        self.chunk = mix["iters_per_call"]
        if tr["bin_refresh"] % self.chunk or n_it % self.chunk:
            raise ValueError("iters_per_call must divide the bin refresh and iters_rest")
        self.fit = trainer.make_fit_timestep(self.cfg, is_initial=False, num_iters=self.chunk)

        # a timestep's first chunk through the window's fit, kept for the check
        params, variables, opt = trainer.initialize_per_timestep(params, variables, opt)
        self.s0 = {f_: getattr(params, f_).clone() for f_ in T.FIELDS}
        ims, segs = self.frames[0]
        params, opt, variables, logs = self.fit(params, opt, variables, self.lrs, self.cams,
                                                ims, segs, self.orders[0][:self.chunk], self.gen)
        self.check_losses = logs["loss"].clone()
        self.s_check = {f_: getattr(params, f_).clone() for f_ in T.FIELDS}
        self.mu_check = {f_: getattr(opt.mu, f_).clone() for f_ in T.FIELDS}
        self.state = (params, opt, variables)
        self.frame, self.done_in_step = 0, n_it  # the window starts a timestep
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @torch.no_grad()
    def _render_targets(self, cloud):
        """(ims, segs), each (C, 3, H, W): the true cloud through every
        camera, by the plain renderer (fresh tile lists)."""
        n = cloud.shape[0]
        sc = self.config["tracking_scene"]
        quats = torch.zeros(n, 4, device=cloud.device)
        quats[:, 0] = 1.0
        scales = torch.full((n, 3), sc["true_scale_m"], device=cloud.device)
        opac = torch.full((n, 1), sc["true_opacity"], device=cloud.device)
        seg = cloud[:, 6]
        colours = torch.cat([cloud[:, 3:6], torch.stack([seg, torch.zeros_like(seg), 1 - seg],
                                                        1)], 1)
        live = torch.ones(n, device=cloud.device)
        ims, segs = [], []
        for cam in self.ref_cams:
            m2d, _, depth, radius, mask = R.project(cloud[:, :3], quats, scales, cam, live)
            lists, counts = R.bins(m2d, radius, depth, mask, self.grid, 0.0)
            im, _ = R.render(cloud[:, :3], quats, scales, opac, colours, cam, live, lists,
                             counts, self.grid, self.bg6)
            ims.append(im[:3])
            segs.append(im[3:])
        return torch.stack(ims).contiguous(), torch.stack(segs).contiguous()

    def window(self, seconds: float) -> dict:
        from gsdx_torch.kernels import composite as C

        tr = self.trainer
        params, opt, variables = self.state
        before = dict(C.LAUNCHES)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        if self.first_window:
            self.setup_s = t0 - self.t_start
        iters, marks = 0, []
        while True:
            if self.done_in_step == self.tr["iters_rest"]:
                self.frame = (self.frame + 1) % len(self.frames)
                self.done_in_step = 0
                params, variables, opt = tr.initialize_per_timestep(params, variables, opt)
            ims, segs = self.frames[self.frame]
            order = self.orders[self.frame][self.done_in_step:self.done_in_step + self.chunk]
            params, opt, variables, _ = self.fit(params, opt, variables, self.lrs, self.cams,
                                                 ims, segs, order, self.gen)
            self.done_in_step += self.chunk
            iters += self.chunk
            marks.append(time.perf_counter())
            if marks[-1] - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        self.state = (params, opt, variables)
        launches = {k: C.LAUNCHES[k] - before[k] for k in C.LAUNCHES}
        calls = np.diff([t0] + marks)
        if len(calls) >= 4:  # host seconds a call: does the rate move within the run?
            q = np.quantile(calls, [0.0, 0.25, 0.5, 0.75, 1.0])
            print("perfbench: host seconds a fit call, quantiles 0/25/50/75/100: "
                  + " ".join(f"{v:.4f}" for v in q), file=sys.stderr)
        metrics = {"track_iters_per_s": iters / elapsed}
        if self.first_window:
            metrics["setup_s"] = self.setup_s
            self.first_window = False
        return {"metrics": metrics, "attempted": iters, "units": iters, "wall_s": elapsed,
                "counters": {"iterations": iters,
                             "kernel_launches": {
                                 r"\bfwd_kernel": launches["fwd"] + launches["fwd_presort"],
                                 r"\bbwd_kernel": launches["bwd"] + launches["bwd_presort"]}}}

    def release(self) -> None:
        self.state = self.fit = self.cams = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, dtype):
        """The reference's first chunk of iterations from the raw cloud:
        (start, params, moments, losses)."""
        params, variables = T.initial_state(self.noisy, self.tr["num_knn"])
        params, variables, moments = T.next_timestep(params, variables, T.zero_moments(params))
        start = dict(params)
        weights = {k: v for k, v in self.tr["weights"].items()}
        params, moments, losses = T.fit_steps(
            params, variables, moments, self.ref_cams, self.frames[0],
            self.orders[0][:self.chunk], self.grid, weights,
            T.learning_rates(self.scene_radius), self.tr["bin_margin_px"], self.bg6, dtype)
        return start, params, moments, losses

    def check(self, control: bool = False) -> list[tuple]:
        """The window's fit's first chunk against the reference's: the worst
        iteration's loss (relative gap), Adam's first moments after it (the gradient as the
        optimizer holds it; worst leaf's gap of norms) and the change of the
        parameters (worst moving leaf's gap of norms). Leaves whose reference
        moment is under a thousandth of the median leaf's (a gradient nought
        to rounding) and leaves the reference does not move are left out.
        ``control`` judges the reference in bf16 in the program's place."""
        limits = self.config["limits"]["track"]
        cudnn = torch.backends.cudnn
        old = (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = cudnn.allow_tf32 = False
        try:
            start, p_ref, m_ref, l_ref = self.reference_steps(torch.float32)
            if control:
                _, p_got, m_got, l_got = self.reference_steps(torch.bfloat16)
                mu_got, start_got = m_got["mu"], start
            else:
                p_got, mu_got, start_got = self.s_check, self.mu_check, self.s0
                l_got = self.check_losses.tolist()
        finally:
            torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32 = old
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l_got, l_ref))
        mu_ref = m_ref["mu"]
        norms = {f: float(torch.linalg.vector_norm(mu_ref[f].double())) for f in T.FIELDS}
        med = float(np.median(list(norms.values())))
        skip = [f for f, n in norms.items() if n < 1e-3 * med]
        moment_gap, _ = T.leaf_gaps(mu_got, mu_ref, skip)
        d_ref = {f: p_ref[f] - start[f] for f in T.FIELDS}
        d_got = {f: p_got[f] - start_got[f] for f in T.FIELDS}
        still = [f for f in T.FIELDS if not bool(d_ref[f].abs().max() > 0)]
        change_gap, _ = T.leaf_gaps(d_got, d_ref, still)
        return [("loss_gap", loss_gap, limits["loss_gap"]),
                ("moment_gap", moment_gap, limits["moment_gap"]),
                ("change_gap", change_gap, limits["change_gap"])]


def setup(ctx: dict) -> TrackCell:
    return TrackCell(ctx)
