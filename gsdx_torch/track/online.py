"""Online Gaussian trainer for one static scene and GNN-driven rollouts
(counterpart of `gsdx/track/online.py`).

The live twin of the offline tracking optimizer, used by the demo apps:
fit Gaussians to one multi-view observation (the t=0 fit with
densification only), then roll the dynamics model under a push and
re-render the predicted scene. The fit renders rgb and segmentation fused
in one compositor pass forward and backward; `render` is rgb only, under
inference mode.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from gsdx_torch.core.cameras import make_camera, stack_cameras
from gsdx_torch.core.device import require_device
from gsdx_torch.core.gaussians import (
    GaussianParams,
    init_gaussian_params,
    init_tracking_variables,
)
from gsdx_torch.core.transforms import quat_normalize
from gsdx_torch.kernels.knn import knn
from gsdx_torch.render.rasterize import RasterizeConfig, rasterize
from gsdx_torch.rollout.dynamics_module import smooth_trajectory
from gsdx_torch.track.densify import DensifyConfig
from gsdx_torch.track.losses import LossWeights
from gsdx_torch.track.optimizer import GroupAdam, tracking_lrs
from gsdx_torch.track.trainer import (
    TrackingConfig,
    camera_order,
    compact_params,
    make_fit_timestep,
)


class OnlineGSConfig(NamedTuple):
    """The reference's online Gaussian-splatting settings."""

    weight_im: float = 1.0
    weight_seg: float = 3.0
    grad_thresh: float = 0.0002
    remove_threshold: float = 0.005
    remove_thresh_5k: float = 0.25
    scale_scene_radius: float = 0.05
    num_iters: int = 10000
    near: float = 0.01
    far: float = 100.0


def rt_to_w2c(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(R, t) camera-to-world -> (4, 4) f32 world-to-camera."""
    c2w = np.concatenate(
        [np.concatenate([R, t.reshape(3, 1)], axis=1),
         np.array([[0, 0, 0, 1.0]])], axis=0
    )
    return np.linalg.inv(c2w).astype(np.float32)


class OnlineGSTrainer:
    """Fit-once Gaussian trainer over live observations, on ``device``."""

    def __init__(self, cfg: OnlineGSConfig = OnlineGSConfig(),
                 raster_cfg: RasterizeConfig = RasterizeConfig(), seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.raster_cfg = raster_cfg
        self.seed = seed
        self.device = require_device(device)
        self.clear()

    def clear(self, clear_params: bool = True):
        self.init_pt_cld = None
        self.metadata = None
        self.ims = None
        self.segs = None
        self.cams = None
        if clear_params:
            self.params: Optional[GaussianParams] = None

    def update_state(self, points, colors, img_list, seg_list, R_list, t_list,
                     intr_list):
        """Set the scene from a fused point cloud and per-camera float
        images (H, W, 3) and masks (H, W). Every cloud point is foreground
        (seg 1)."""
        pts = np.asarray(points, np.float32)
        cols = np.asarray(colors, np.float32)
        seg = np.ones_like(pts[:, :1])
        self.init_pt_cld = np.concatenate([pts, cols, seg], axis=1)
        h, w = img_list[0].shape[:2]
        w2cs = [rt_to_w2c(np.asarray(R), np.asarray(t))
                for R, t in zip(R_list, t_list)]
        self.metadata = {"w": w, "h": h, "k": list(intr_list), "w2c": w2cs}
        self.cams = stack_cameras([
            make_camera(intr_list[c], w2cs[c], width=w, height=h,
                        near=self.cfg.near, far=self.cfg.far, bg=(0, 0, 0),
                        cam_id=c, device=self.device)
            for c in range(len(img_list))])
        ims, segs = [], []
        for img, sg in zip(img_list, seg_list):
            ims.append(np.asarray(img, np.float32).transpose(2, 0, 1))
            sg = np.asarray(sg, np.float32)
            segs.append(np.stack([sg, np.zeros_like(sg), 1.0 - sg], axis=0))
        self.ims = torch.as_tensor(np.stack(ims), device=self.device)
        self.segs = torch.as_tensor(np.stack(segs), device=self.device)

    def update_state_env(self, points, colors, env, imgs, masks):
        """Set the scene from an environment's cameras, its u8-scaled images
        and their masks."""
        R_list, t_list = env.get_extrinsics()
        intr_list = env.get_intrinsics()
        img_list = [imgs[c] * masks[c][:, :, None] for c in range(len(imgs))]
        seg_list = [masks[c] * 1.0 for c in range(len(masks))]
        self.update_state(points, colors, img_list, seg_list, R_list, t_list,
                          intr_list)

    def init_params(self) -> GaussianParams:
        """Unoptimized Gaussians straight from the fused point cloud (to
        show or export a scene without fitting)."""
        pts = torch.as_tensor(self.init_pt_cld[:, :3], device=self.device)
        sq_dist, _ = knn(pts, 3)
        self.params = init_gaussian_params(
            self.init_pt_cld, sq_dist.mean(-1).cpu().numpy(), device=self.device)
        return self.params

    def train(self, progress: bool = False) -> dict:
        """The ``cfg.num_iters``-iteration fit with densification; returns
        the per-iteration logs (loss, psnr, num_pts tensors)."""
        cfg = self.cfg
        params = self.init_params()
        w2c_stack = np.stack(self.metadata["w2c"])
        cam_centers = np.linalg.inv(w2c_stack)[:, :3, 3]
        scene_radius = float(1.1 * np.max(np.linalg.norm(
            cam_centers - cam_centers.mean(0, keepdims=True), axis=-1)))

        tcfg = TrackingConfig(
            iters_first=cfg.num_iters,
            weights=LossWeights(im=cfg.weight_im, seg=cfg.weight_seg),
            densify=DensifyConfig(
                grad_thresh=cfg.grad_thresh,
                remove_thresh=cfg.remove_threshold,
                remove_thresh_5k=cfg.remove_thresh_5k,
                scale_scene_radius=cfg.scale_scene_radius,
            ),
            raster=self.raster_cfg,
            seed=self.seed,
        )
        variables = init_tracking_variables(params.capacity, 20, scene_radius,
                                            device=self.device)
        opt_state = GroupAdam().init(params)
        lrs = tracking_lrs(scene_radius)
        fit = make_fit_timestep(tcfg, is_initial=True, num_iters=cfg.num_iters)
        order = camera_order(cfg.num_iters, self.ims.shape[0],
                             np.random.default_rng(self.seed))
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        params, _, variables, logs = fit(
            params, opt_state, variables, lrs, self.cams, self.ims, self.segs,
            order, generator)
        if progress:
            print(f"[online-gs] final psnr {float(logs['psnr'][-1]):.3f} "
                  f"pts {int(logs['num_pts'][-1])}")
        self.params, _ = compact_params(params, variables)
        return logs

    @torch.inference_mode()
    def render(self, rendervar: dict, cam_id: int, bg=(0.7, 0.7, 0.7)):
        """Render a rendervar (tensors or arrays) from stored camera
        ``cam_id``; returns (im (3, H, W), depth (H, W))."""
        cam = dataclasses.replace(
            self.cams[cam_id],
            bg=torch.as_tensor(np.asarray(bg, np.float32), device=self.device))

        def get(key):
            return torch.as_tensor(rendervar[key], device=self.device)

        out = rasterize(get("means3D"), get("rotations"), get("scales"),
                        get("opacities"), get("colors_precomp"), cam,
                        self.raster_cfg)
        return out.im, out.depth

    def rollout_and_render(self, dm, action, remove_black: bool = False,
                           overwrite_params: bool = True,
                           dist_thresh: float = 0.005):
        """Roll the GNN under a straight push and skin the scene to it.

        ``dm`` is a `DynamicsModule` on this trainer's device; ``action`` a
        (2, 3) [start, end] end-effector path. Returns (rendervar_list,
        visvar_list) of numpy arrays, one entry a rollout step. With
        ``overwrite_params`` the scene becomes the last step's Gaussians."""
        if self.params is None:
            raise RuntimeError("no Gaussian scene: call train() or init_params() first")
        p = self.params
        live = (p.live > 0).cpu().numpy()
        xyz_0 = p.means3d.cpu().numpy()[live]
        rgb_0 = p.rgb_colors.cpu().numpy()[live]
        quat_0 = quat_normalize(p.unnorm_rotations).cpu().numpy()[live]
        opa_0 = torch.sigmoid(p.logit_opacities).cpu().numpy()[live]
        scales_0 = np.exp(p.log_scales.cpu().numpy())[live]

        keep = opa_0[:, 0] >= 0.1
        if remove_black:
            keep &= rgb_0.sum(-1) >= 0.5
        xyz_0, rgb_0, quat_0 = xyz_0[keep], rgb_0[keep], quat_0[keep]
        opa_0, scales_0 = opa_0[keep], scales_0[keep]

        start = np.asarray(action[0], np.float32)
        end = np.asarray(action[1], np.float32)
        n_steps = max(int(np.linalg.norm(end - start) / dist_thresh), 2)
        ts = np.linspace(0, 1, n_steps)[:, None]
        eef = start[None] + (end - start)[None] * ts
        eef = np.concatenate([eef, np.tile(end[None], (dm.cfg.n_his, 1))])
        eef = eef[:, None]  # (n_steps, 1, 3)

        traj = dm.rollout(torch.as_tensor(xyz_0, device=self.device),
                          torch.as_tensor(quat_0, device=self.device), eef,
                          eef.shape[0])
        traj = smooth_trajectory(traj)
        xyz = traj["xyz"]
        # 3x binomial smoothing over time; numpy evaluates the right-hand
        # side whole before it writes
        for _ in range(3):
            xyz[1:-1] = (xyz[:-2] + 2 * xyz[1:-1] + xyz[2:]) / 4.0
        quat = traj["quat"]
        quat = quat / np.maximum(
            np.linalg.norm(quat, axis=-1, keepdims=True), 1e-12)

        rendervar_list, visvar_list = [], []
        for t in range(xyz.shape[0]):
            rendervar_list.append({
                "means3D": xyz[t],
                "colors_precomp": rgb_0,
                "rotations": quat[t],
                "opacities": opa_0,
                "scales": scales_0,
            })
            visvar_list.append({
                "xyz_bones": traj["xyz_bones"][t],
                "eef": traj["eef"][t],
            })

        if overwrite_params:
            self.params = self._params_at(xyz[-1], rgb_0, quat[-1], opa_0,
                                          scales_0)
        return rendervar_list, visvar_list

    def _params_at(self, xyz, rgb, quat, opa, scales) -> GaussianParams:
        """Gaussians re-initialised from a rollout's last frame, with the
        rotations, opacities and scales of the live rows overwritten."""
        n = xyz.shape[0]
        cld = np.concatenate([xyz, rgb, np.ones((n, 1), np.float32)], axis=1)
        new = init_gaussian_params(
            cld, np.exp(2 * np.log(np.maximum(scales.mean(-1), 1e-6))),
            device=self.device)

        def rows(field, value):
            out = getattr(new, field).clone()
            out[:n] = torch.as_tensor(value, device=self.device)
            return out

        return dataclasses.replace(
            new,
            unnorm_rotations=rows("unnorm_rotations", quat),
            logit_opacities=rows("logit_opacities",
                                 np.log(opa / np.maximum(1 - opa, 1e-6))),
            log_scales=rows("log_scales", np.log(np.maximum(scales, 1e-9))),
        )
