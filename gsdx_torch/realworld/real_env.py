"""Hardware environment facade: cameras + robot + calibration + actions (the
port's own copy of `gsdx/realworld/real_env.py`).

Re-implements `RealEnv` (`src/real_world/utils/real_env.py:21-654`) over the
port's camera/robot abstractions, so the same facade runs with synthetic
sources + FakeArm (CI, demos) or RealSense + xArm7 (hardware):

  * multi-camera observation with per-step timestamp alignment across views
    (`real_env.py:139-184`);
  * push choreography hover -> descend -> push -> lift -> reset
    (`real_env.py:211-232`), plus the grasp variant (`step_gripper`);
  * world<->robot-base transforms from the hand-eye calibration;
  * fixed-camera ChArUco calibration via `gsdx_torch.realworld.calibrate`
    (needs `cv2`).

Observations are numpy on the host; ``device`` (default "cuda", no silent
CPU fallback) is where the caller's perception and planning run.
"""

from __future__ import annotations

import math
import os
import pickle
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gsdx_torch.core.device import require_device
from gsdx_torch.io.episodes import rpy_to_rotation_matrix
from gsdx_torch.realworld.cameras import FrameSource, MultiCamera
from gsdx_torch.realworld.env import EEF_POINT_Z, WORKSPACE_BBOX, Env
from gsdx_torch.realworld.robot import Arm, FakeArm


class RealEnv(Env):
    def __init__(
        self,
        sources: List[FrameSource],
        arm: Optional[Arm] = None,
        capture_fps: float = 15.0,
        obs_fps: float = 15.0,
        n_obs_steps: int = 1,
        push_length: float = 0.01,
        calibration_path: Optional[str] = None,
        world_y: float = 0.01,  # eef height during pushes (`real_env.py:106`)
        device: str | torch.device = "cuda",
    ):
        self.device = require_device(device)
        self.cameras = MultiCamera(sources, put_fps=capture_fps)
        self.n_fixed_cameras = len(sources)
        self.arm = arm or FakeArm()
        self.capture_fps = capture_fps
        self.obs_fps = obs_fps
        self.n_obs_steps = n_obs_steps
        self.push_length = push_length
        self.world_y = world_y
        self.bbox = WORKSPACE_BBOX.copy()
        self.eef_point = np.array([[0.0, 0.0, EEF_POINT_Z]])
        # calibration state: per-camera cam->world + robot base->world
        self.R_cam2world: List[np.ndarray] = []
        self.t_cam2world: List[np.ndarray] = []
        self.R_base2world = np.eye(3)
        self.t_base2world = np.zeros(3)
        if calibration_path and os.path.exists(calibration_path):
            self.load_calibration(calibration_path)

    # ---- lifecycle -------------------------------------------------------
    def start(self):
        self.cameras.start()
        self.arm.start()

    def stop(self):
        self.arm.stop()
        self.cameras.stop()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    @property
    def is_ready(self) -> bool:
        return self.arm.alive

    # ---- observation -----------------------------------------------------
    def get_obs(self, get_color=True, get_depth=False) -> Dict:
        """Aligned multi-view observation (`real_env.py:139-184`): take the
        newest timestamp across cameras, bin each camera's ring buffer onto
        a shared obs_fps grid, return (n_obs_steps, ...) stacks."""
        k = math.ceil(self.n_obs_steps * (self.capture_fps / self.obs_fps))
        data = self.cameras.get(k=max(k, 1))

        dt = 1.0 / self.obs_fps
        last_ts = max(v["timestamp"][-1] for v in data.values())
        align_ts = last_ts - np.arange(self.n_obs_steps)[::-1] * dt

        obs: Dict = {}
        colors, depths = [], []
        for ci, value in data.items():
            ts = value["timestamp"]
            idxs = []
            for t in align_ts:
                before = np.nonzero(ts < t)[0]
                idxs.append(before[-1] if len(before) else 0)
            if get_color:
                colors.append(value["color"][idxs])
            if get_depth:
                depths.append(value["depth"][idxs])
        if get_color:
            stack = np.stack(colors)  # (C, n_obs, H, W, 3)
            obs["color"] = stack[:, -1] if self.n_obs_steps == 1 else stack
        if get_depth:
            stack = np.stack(depths)
            obs["depth"] = stack[:, -1] if self.n_obs_steps == 1 else stack
        obs["pose"] = self.arm.get_position()
        obs["timestamp"] = align_ts
        return obs

    def get_intrinsics(self) -> List[np.ndarray]:
        return self.cameras.get_intrinsics()

    def get_extrinsics(self) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        return (
            [R.copy() for R in self.R_cam2world],
            [t.copy() for t in self.t_cam2world],
        )

    def get_bbox(self) -> np.ndarray:
        return self.bbox.copy()

    # ---- robot motion ----------------------------------------------------
    def world_to_base(self, p_world: np.ndarray) -> np.ndarray:
        return self.R_base2world.T @ (np.asarray(p_world) - self.t_base2world)

    def base_to_world(self, p_base: np.ndarray) -> np.ndarray:
        return self.R_base2world @ np.asarray(p_base) + self.t_base2world

    def get_eef_points(self) -> np.ndarray:
        """(1, 3) gripper tool point in world (`real_env.py:556-565`)."""
        pose = self.arm.get_position()  # mm / deg
        R_g2b = rpy_to_rotation_matrix(*pose[3:6])
        t_g2b = pose[:3] / 1000.0
        R_g2w = self.R_base2world @ R_g2b
        t_g2w = self.R_base2world @ t_g2b + self.t_base2world
        return (self.eef_point @ R_g2w.T + t_g2w[None]).astype(np.float32)

    def move_to_table_position(self, p_world, yaw=None, wait=True):
        """Move the eef point to a world position (`real_env.py:186-209`)."""
        p_base = self.world_to_base(np.asarray(p_world, np.float64))
        pose = self.arm.get_position()
        pose[:3] = p_base * 1000.0
        if yaw is not None:
            pose[5] = yaw
        self.arm.set_position(pose, wait=wait)

    def reset_robot(self):
        self.arm.reset()

    def decode_action(self, action):
        """(x, y, theta, length) -> push endpoints (`real_env.py:203-209`)."""
        x0, y0, theta, repeat = action[0], action[1], action[2], int(action[3])
        x1 = x0 - self.push_length * repeat * np.cos(theta)
        y1 = y0 - self.push_length * repeat * np.sin(theta)
        return x0, y0, x1, y1

    def step(self, action, decoded: bool = True):
        """Push choreography hover -> descend -> push -> lift -> reset
        (`real_env.py:211-232`). ``action`` is [x0, y0, x1, y1] when decoded
        (the planner CLI convention) or (x, y, theta, length) otherwise."""
        assert self.is_ready
        if decoded:
            x0, y0, x1, y1 = np.asarray(action, np.float64)
        else:
            x0, y0, x1, y1 = self.decode_action(action)
        z = self.world_y
        self.reset_robot()
        self.move_to_table_position([x0, y0, z + 0.10])
        self.move_to_table_position([x0, y0, z])
        self.move_to_table_position([x1, y1, z])
        self.move_to_table_position([x1, y1, z + 0.10])
        self.reset_robot()

    def step_gripper(self, action, decoded: bool = True):
        """Grasp-and-drag variant (`real_env.py:234-258`)."""
        assert self.is_ready
        if decoded:
            x0, y0, x1, y1 = np.asarray(action, np.float64)
        else:
            x0, y0, x1, y1 = self.decode_action(action)
        norm = math.sqrt((x1 - x0) ** 2 + (y1 - y0) ** 2) + 1e-9
        yaw = 180 - math.degrees(math.atan2(y1 - y0, x1 - x0))
        x0b = x0 - 0.005 * (x1 - x0) / norm
        y0b = y0 - 0.005 * (y1 - y0) / norm
        z = self.world_y
        self.reset_robot()
        self.move_to_table_position([x0b, y0b, z + 0.10], yaw)
        self.move_to_table_position([x0b, y0b, z], yaw)
        self.arm.close_gripper()
        self.move_to_table_position([x0b, y0b, z + 0.02], yaw)
        self.move_to_table_position([x1, y1, z + 0.02], yaw)
        self.arm.open_gripper()
        self.move_to_table_position([x1, y1, z + 0.10], yaw)
        self.reset_robot()

    # ---- calibration -----------------------------------------------------
    def load_calibration(self, path: str):
        with open(path, "rb") as f:
            calib = pickle.load(f)
        self.R_base2world = calib["R_base2world"]
        self.t_base2world = calib["t_base2world"]
        self.R_cam2world = list(calib.get("R_cam2world", []))
        self.t_cam2world = list(calib.get("t_cam2world", []))

    def save_calibration(self, path: str):
        with open(path, "wb") as f:
            pickle.dump({
                "R_base2world": self.R_base2world,
                "t_base2world": self.t_base2world,
                "R_cam2world": self.R_cam2world,
                "t_cam2world": self.t_cam2world,
            }, f)

    def calibrate_fixed_cameras(self, board=None):
        """Per-camera ChArUco board pose -> cam->world extrinsics, with the
        board frame as the world frame (`calibrate`, `real_env.py:402-510`)."""
        from gsdx_torch.realworld.calibrate import _cv2, detect_charuco_pose

        cv2 = _cv2()

        obs = self.get_obs(get_color=True)
        intr = self.get_intrinsics()
        self.R_cam2world, self.t_cam2world = [], []
        for c in range(self.n_fixed_cameras):
            res = detect_charuco_pose(obs["color"][c], intr[c], board=board)
            if res is None:
                raise RuntimeError(f"ChArUco board not visible in camera {c}")
            rvec, tvec = res
            R_b2c, _ = cv2.Rodrigues(rvec)
            # world := board frame; cam->world = inv(board->cam)
            self.R_cam2world.append(R_b2c.T)
            self.t_cam2world.append(-R_b2c.T @ tvec)
        return self.R_cam2world, self.t_cam2world
