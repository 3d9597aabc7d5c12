"""Environment facade and the simulated backend (the port's own copy of
`gsdx/realworld/env.py`).

`Env` is the interface of the reference's real environment: camera and
robot lifecycle, aligned observations, push execution, calibration access.
`FakeEnv` is a robotless tabletop: a quasi-static particle scene rendered
through the port's rasterizer (so its observations run the compositor
kernel on the card), with the push semantics the planner emits.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from gsdx_torch.core.device import require_device

WORKSPACE_BBOX = np.array(
    [[0.0, 0.6], [-0.35, 0.45], [-0.10, 0.05]], np.float32)
EEF_POINT_Z = 0.175  # gripper-frame tool point (`real_env.py:105`)


class Env:
    """Interface of the hardware environment."""

    n_fixed_cameras: int = 4
    bbox = WORKSPACE_BBOX

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def get_obs(self, get_color=True, get_depth=False) -> Dict: ...

    def get_intrinsics(self) -> List[np.ndarray]: ...

    def get_extrinsics(self) -> Tuple[List[np.ndarray], List[np.ndarray]]: ...

    def step(self, action: np.ndarray) -> None:
        """action: (4,) [x_start, y_start, x_end, y_end] world push."""
        ...

    def get_eef_points(self) -> np.ndarray: ...


class FakeEnvConfig(NamedTuple):
    n_cameras: int = 4
    width: int = 320
    height: int = 240
    push_radius: float = 0.06  # particles within this of the pusher move
    push_step: float = 0.01
    table_z: float = 0.0


class FakeEnv(Env):
    """Simulated tabletop: particles, toy push dynamics, port rendering on
    ``device``."""

    def __init__(self, points: np.ndarray, colors: np.ndarray,
                 cfg: FakeEnvConfig = FakeEnvConfig(),
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = require_device(device)
        self.n_fixed_cameras = cfg.n_cameras
        self.points = np.asarray(points, np.float32).copy()
        self.colors = np.asarray(colors, np.float32).copy()
        self.eef_pos = np.array([0.3, 0.4, 0.05], np.float32)
        self._cams = self._make_cameras()

    def _make_cameras(self):
        """Four cameras on a ring looking at the workspace centre."""
        from gsdx_torch.core.cameras import make_camera

        center = np.array([0.3, 0.05, 0.0])
        cams = []
        f = 0.75 * self.cfg.width
        k = np.array([[f, 0, self.cfg.width / 2],
                      [0, f, self.cfg.height / 2], [0, 0, 1]], np.float32)
        for i in range(self.cfg.n_cameras):
            ang = 2 * np.pi * i / self.cfg.n_cameras + 0.3
            eye = center + np.array([0.7 * np.cos(ang), 0.7 * np.sin(ang), 0.55])
            fwd = center - eye
            fwd = fwd / np.linalg.norm(fwd)
            right = np.cross(fwd, np.array([0.0, 0, 1.0]))
            right /= np.linalg.norm(right)
            down = np.cross(fwd, right)
            R = np.stack([right, down, fwd], axis=0)  # world -> camera rows
            w2c = np.eye(4, dtype=np.float32)
            w2c[:3, :3] = R
            w2c[:3, 3] = -R @ eye
            cams.append(make_camera(k, w2c, width=self.cfg.width,
                                    height=self.cfg.height, cam_id=i,
                                    bg=(0.7, 0.7, 0.7), device=self.device))
        self._k = k
        return cams

    def get_intrinsics(self):
        return [np.asarray(self._k) for _ in range(self.n_fixed_cameras)]

    def get_extrinsics(self):
        R_list, t_list = [], []
        for cam in self._cams:
            c2w = np.linalg.inv(cam.w2c.cpu().numpy())
            R_list.append(c2w[:3, :3])
            t_list.append(c2w[:3, 3])
        return R_list, t_list

    def render(self) -> List:
        """The port's `RenderOutput` of every camera (float, before the
        uint8 cast)."""
        from gsdx_torch.render.rasterize import RasterizeConfig, rasterize

        n = self.points.shape[0]
        dev = self.device
        cfg = RasterizeConfig(max_per_tile=256)
        means = torch.as_tensor(self.points, device=dev)
        quats = torch.tensor([[1.0, 0, 0, 0]], device=dev).expand(n, 4).contiguous()
        scales = torch.full((n, 3), 0.008, device=dev)
        opac = torch.full((n, 1), 0.95, device=dev)
        colors = torch.as_tensor(self.colors, device=dev)
        with torch.no_grad():
            return [rasterize(means, quats, scales, opac, colors, cam, cfg)
                    for cam in self._cams]

    def get_obs(self, get_color=True, get_depth=False) -> Dict:
        """Rendered multi-view observation: color (C, H, W, 3) u8, depth
        (C, H, W) u16 mm."""
        colors, depths = [], []
        for out in self.render():
            im = np.clip(out.im.cpu().numpy().transpose(1, 2, 0), 0, 1)
            colors.append((im * 255).astype(np.uint8))
            depths.append((out.depth.cpu().numpy() * 1000).astype(np.uint16))
        obs = {"color": np.stack(colors)}
        if get_depth:
            obs["depth"] = np.stack(depths)
        obs["timestamp"] = np.float64(0.0)
        return obs

    def _apply_unit_push(self, start: np.ndarray, delta: np.ndarray):
        d = np.linalg.norm(self.points[:, :2] - start[None, :2], axis=-1)
        w = np.exp(-(d ** 2) / (2 * self.cfg.push_radius ** 2))[:, None]
        self.points[:, :2] += w * delta[None, :2]

    def step(self, action: np.ndarray) -> None:
        """Execute a full push [x0, y0, x1, y1] as unit steps."""
        a = np.asarray(action, np.float32)
        start = np.array([a[0], a[1], self.cfg.table_z], np.float32)
        end = np.array([a[2], a[3], self.cfg.table_z], np.float32)
        total = np.linalg.norm(end[:2] - start[:2])
        n_steps = max(int(np.ceil(total / self.cfg.push_step)), 1)
        pos = start.copy()
        unit = (end - start) / n_steps
        for _ in range(n_steps):
            self._apply_unit_push(pos, unit)
            pos = pos + unit
        self.eef_pos = pos

    def get_eef_points(self) -> np.ndarray:
        return self.eef_pos[None].copy()

    def get_state_points(self) -> np.ndarray:
        """Ground-truth particle state (testing convenience)."""
        return self.points.copy()
