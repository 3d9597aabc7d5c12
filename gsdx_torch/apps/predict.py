"""Rollout and re-render CLI (counterpart of `gsdx/apps/predict.py`).

Loads the trained GNN from `<train_config.out_dir>/checkpoints`
(relative to the working directory) and a tracked episode, rolls the
dynamics forward under the recorded end-effector path, skins the
Gaussians, and re-renders every camera through the port's rasterizer,
writing `<out>/camera_{c}/frame_{t:04d}.png`.

    python -m gsdx_torch.apps.predict --config configs/rope.yaml \\
        --episode <raw episode dir> --params <tracking output dir> \\
        --out out/predict

`--overlay` blends each frame with its coverage (an all-white render
on black) over grey and draws the end effector's trail; it needs OpenCV
and matplotlib (`utils/viz.py`) and raises an ImportError naming the one
that is missing.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def tracked_gaussians(params_path: str, t: int, min_opacity: float = 0.0) -> dict:
    """Frame ``t`` of a tracking output (params.npz) as a rendervar of numpy
    arrays (normalised quaternions, sigmoid opacities, exp scales), without
    the Gaussians whose opacity is below ``min_opacity``."""
    from gsdx_torch.core.transforms import quat_normalize

    params = dict(np.load(params_path))
    opa = 1.0 / (1.0 + np.exp(-params["logit_opacities"]))
    keep = opa[:, 0] >= min_opacity
    return {"means3D": params["means3D"][t][keep],
            "colors_precomp": params["rgb_colors"][t][keep],
            "rotations": quat_normalize(
                torch.as_tensor(params["unnorm_rotations"][t])).numpy()[keep],
            "opacities": opa[keep], "scales": np.exp(params["log_scales"])[keep]}


def collect_scene_data(params_path: str, data_dir: str, output_dir: str, model,
                       train_cfg, data_cfg, max_steps: int = 1000,
                       device: str | torch.device = "cuda"):
    """Roll a tracked episode out with ``model`` (a `DynamicsPredictor` on
    ``device``): frame 0's Gaussians with opacity >= 0.1, a 1000-point
    proxy of their statistical inliers, the rollout, then
    `smooth_trajectory`. Returns (per-frame rendervars of numpy arrays,
    per-frame {"kp": bones, "tool_kp": end effector}, metadata)."""
    from gsdx_torch.core.device import require_device
    from gsdx_torch.core.pointcloud import iterative_statistical_outliers
    from gsdx_torch.io.episodes import eef_world_positions, load_metadata
    from gsdx_torch.rollout.dynamics_module import (DynamicsModule, RolloutConfig,
                                                    smooth_trajectory)

    device = require_device(device)
    g = tracked_gaussians(params_path, 0, min_opacity=0.1)
    xyz_t = torch.as_tensor(g["means3D"], device=device)
    inlier_idx = iterative_statistical_outliers(xyz_t, nb_neighbors=50)

    meta = load_metadata(os.path.join(output_dir, "metadata.json"))
    eef_xyz = eef_world_positions(data_dir, meta)
    n_steps = min(len(eef_xyz), max_steps)

    cfg = RolloutConfig(
        n_his=train_cfg.n_his, dist_thresh=train_cfg.dist_thresh,
        max_nobj=data_cfg.max_nobj, fps_radius=sum(data_cfg.fps_radius_range) / 2,
        adj_thresh=sum(data_cfg.adj_radius_range) / 2, topk=data_cfg.topk,
        connect_all=data_cfg.connect_all, max_nR=data_cfg.max_nR)
    traj = DynamicsModule(model, cfg).rollout(
        xyz_t, torch.as_tensor(g["rotations"], device=device), eef_xyz, n_steps,
        inlier_idx=inlier_idx)
    traj = smooth_trajectory(traj)

    scene_data = [dict(g, means3D=traj["xyz"][t], rotations=traj["quat"][t])
                  for t in range(n_steps)]
    vis = [{"kp": traj["xyz_bones"][t], "tool_kp": traj["eef"][t]}
           for t in range(n_steps)]
    return scene_data, vis, meta


def overlay_frames(frames, scene_data, vis, renderer, w2c, k) -> list:
    """Each frame blended by its coverage (the Gaussians rendered white on
    black) over grey 0.7, with the end effector's trail drawn on it."""
    from gsdx_torch.utils.viz import TrailVisualizer, project_points

    trail = TrailVisualizer()
    out = []
    for frame, sd, v in zip(frames, scene_data, vis):
        ones = dict(sd, colors_precomp=np.ones_like(sd["colors_precomp"]))
        alpha = renderer.render(w2c, k, ones, bg=(0, 0, 0))[0][0].cpu().numpy()[..., None]
        frame = frame * alpha + 0.7 * (1 - alpha)
        eef_px = project_points(v["tool_kp"].reshape(-1, 3), k, w2c)
        frame = trail.draw((np.clip(frame, 0, 1) * 255).astype(np.uint8), eef_px)
        out.append(frame.astype(np.float32) / 255.0)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--episode", required=True, help="raw episode data dir")
    p.add_argument("--params", required=True,
                   help="tracking output dir containing params.npz + metadata.json")
    p.add_argument("--out", default="out/predict")
    p.add_argument("--epoch", default="latest")
    p.add_argument("--cameras", type=int, default=4)
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--overlay", action="store_true",
                   help="coverage blend and end-effector trail (OpenCV, matplotlib)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from gsdx_torch.core.device import require_device
    from gsdx_torch.io.checkpoint import load_trained_model
    from gsdx_torch.io.video import chw_to_hwc, write_video
    from gsdx_torch.render.renderer import Renderer

    if args.overlay:
        from gsdx_torch.utils.viz import require_drawing_packages

        require_drawing_packages()
    device = require_device(args.device)
    train_cfg, data_cfg, model = load_trained_model(args.config, args.epoch, device)
    scene_data, vis, meta = collect_scene_data(
        os.path.join(args.params, "params.npz"), args.episode, args.params, model,
        train_cfg, data_cfg, max_steps=args.max_steps, device=device)

    renderer = Renderer(width=meta["w"], height=meta["h"], device=device)
    w2c = np.asarray(meta["w2c"][0], np.float32)
    k = np.asarray(meta["k"][0], np.float32)
    for c in range(min(args.cameras, w2c.shape[0])):
        with torch.inference_mode():
            frames = [chw_to_hwc(renderer.render(w2c[c], k[c], sd)[0].cpu().numpy())
                      for sd in scene_data]
            if args.overlay:
                frames = overlay_frames(frames, scene_data, vis, renderer, w2c[c], k[c])
        path = write_video(os.path.join(args.out, f"camera_{c}"), frames)
        print(f"wrote {path} ({len(frames)} frames)")


if __name__ == "__main__":
    main()
