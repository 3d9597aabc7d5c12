"""Preprocessing of a tracked episode (counterpart of
`gsdx/io/preprocess.py`): the unit-push frame-pair table the graph dataset
reads, and the FPS-downsampled, smoothed particle trajectories.

Everything but the farthest-point sampling is host numpy, as in gsdx; the
sampling runs on ``device``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from gsdx_torch.core.device import require_device
from gsdx_torch.io.episodes import (eef_world_positions,
                                    frame_indices_from_metadata, load_actions,
                                    load_metadata)
from gsdx_torch.kernels.fps import farthest_point_sampling

GRIPPER_Z_PREPROCESS = 0.18  # the gripper offset preprocessing uses


def test_validity(data_dir: str, output_dir: str) -> bool:
    """False when the episode's action log is more than 10 lines shorter
    than its tracked frames; raises when the tracking output is missing."""
    if not os.path.exists(os.path.join(output_dir, "params.npz")):
        raise ValueError(f"params.npz not found in {output_dir}")
    meta = load_metadata(os.path.join(output_dir, "metadata.json"))
    num_frames = len(frame_indices_from_metadata(meta))
    return len(load_actions(data_dir)) - num_frames >= -10


def extract_pushes(eef_xyz: np.ndarray, dist_thresh: float, n_his: int,
                   n_future: int) -> np.ndarray:
    """(num_frames, n_his + n_future) int64 frame rows from an end-effector
    trajectory: for every frame, walk back collecting up to n_his frames
    spaced by >= dist_thresh of end-effector motion (padded by repeating
    the earliest), then forward for n_future (the last frame of the episode
    takes 0.75 x the threshold)."""
    eef = np.asarray(eef_xyz).reshape(len(eef_xyz), -1)[:, :3]
    num_frames = len(eef)
    rows = []
    for curr in range(num_frames):
        traj, anchor, fi = [curr], eef[curr], curr
        while fi >= 0 and len(traj) < n_his:
            if np.linalg.norm(anchor - eef[fi]) >= dist_thresh:
                traj.append(fi)
                anchor = eef[fi]
            fi -= 1
        traj = (traj + [traj[-1]] * (n_his - len(traj)))[::-1]

        anchor, fi = eef[curr], curr
        while fi < num_frames and len(traj) < n_his + n_future:
            d = np.linalg.norm(anchor - eef[fi])
            if d >= dist_thresh or (fi == num_frames - 1 and d >= 0.75 * dist_thresh):
                traj.append(fi)
                anchor = eef[fi]
            fi += 1
        rows.append(traj + [traj[-1]] * (n_his + n_future - len(traj)))
    return np.asarray(rows, np.int64)


def median_outlier_mask(data: np.ndarray, m: float = 3.0) -> np.ndarray:
    """Inliers by the median absolute deviation: |x - median| / MAD < m
    (everything is an inlier when the MAD is 0)."""
    d = np.abs(data - np.median(data))
    mdev = np.median(d)
    s = d / mdev if mdev else np.zeros(len(d))
    return s < m


def downsample_trajectories(params: dict, n_downsample: int = 1000,
                            smooth_iters: int = 10,
                            device: str | torch.device = "cuda") -> np.ndarray:
    """params.npz contents -> (T, n_downsample, 3) f32 trajectories: keep
    Gaussians with a positive opacity logit, drop those whose summed motion
    is a MAD outlier, FPS on frame 0 (from index 0, the picks reused for
    every frame), then ``smooth_iters`` 3-frame moving averages."""
    xyz = np.asarray(params["means3D"], np.float32)  # (T, N, 3)
    opacity_mask = (np.asarray(params["logit_opacities"]) > 0).reshape(-1)
    xyz = xyz[:, opacity_mask]

    motion_sum = np.linalg.norm(np.diff(xyz, axis=0), axis=-1).sum(axis=0)
    xyz = xyz[:, median_outlier_mask(motion_sum, m=3.0)]
    if xyz.shape[1] < n_downsample:
        raise ValueError(f"only {xyz.shape[1]} valid particles < {n_downsample}")

    device = require_device(device)
    fps_idx = farthest_point_sampling(torch.as_tensor(xyz[0], device=device),
                                      n_downsample, start_idx=0)
    xyz = xyz[:, fps_idx.cpu().numpy()]
    for _ in range(smooth_iters):
        xyz[1:-1] = (xyz[:-2] + xyz[1:-1] + xyz[2:]) / 3.0
    return xyz


def preprocess_episode(data_dir: str, output_dir: str, save_dir: str,
                       dist_thresh: float, n_his: int, n_future: int,
                       episode_idx: int = 0, n_downsample: int = 1000,
                       device: str | torch.device = "cuda") -> Optional[np.ndarray]:
    """Preprocess one tracked episode. Writes
    ``save_dir``/frame_pairs/{episode_idx}.txt, ``save_dir``/metadata.txt
    ("dist_thresh,n_future,n_his") and ``output_dir``/param_downsampled.npy
    (beside the tracking output, where the dataset reads it); returns the
    frame-pair rows, or None for an invalid episode."""
    if not test_validity(data_dir, output_dir):
        return None
    meta = load_metadata(os.path.join(output_dir, "metadata.json"))
    eef = eef_world_positions(data_dir, meta, gripper_z=GRIPPER_Z_PREPROCESS)
    rows = extract_pushes(eef[:, 0], dist_thresh, n_his, n_future)

    os.makedirs(os.path.join(save_dir, "frame_pairs"), exist_ok=True)
    np.savetxt(os.path.join(save_dir, "frame_pairs", f"{episode_idx}.txt"),
               rows, fmt="%d")

    params = dict(np.load(os.path.join(output_dir, "params.npz")))
    xyz = downsample_trajectories(params, n_downsample=n_downsample, device=device)
    np.save(os.path.join(output_dir, "param_downsampled.npy"), xyz)

    with open(os.path.join(save_dir, "metadata.txt"), "w") as f:
        f.write(f"{dist_thresh},{n_future},{n_his}")
    return rows
