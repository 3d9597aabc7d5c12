"""Perception: masks -> fused multi-view tabletop point cloud (the port's
own copy of what the simulated path needs from `gsdx/realworld/
perception.py`).

Per view: mask, unproject, world transform, workspace crop; then voxel
downsampling and iterative statistical outlier removal on the device
(`core/pointcloud.py`), and each kept point takes the colour of its
nearest original point.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from gsdx_torch.core.device import require_device
from gsdx_torch.core.pointcloud import statistical_outlier_mask, voxel_downsample
from gsdx_torch.realworld.env import WORKSPACE_BBOX


class SegmentationProvider:
    """Text-prompted instance segmentation interface."""

    def segment(self, image: np.ndarray, prompt: str) -> np.ndarray:
        """(H, W, 3) u8 -> (H, W) bool object mask."""
        raise NotImplementedError


class ThresholdSegmenter(SegmentationProvider):
    """Colour-threshold segmenter for robotless runs: foreground is every
    pixel that differs from the background colour."""

    def __init__(self, bg_color=(0.7, 0.7, 0.7), tol: float = 0.12):
        self.bg = np.asarray(bg_color, np.float32) * 255
        self.tol = tol * 255

    def segment(self, image: np.ndarray, prompt: str = "") -> np.ndarray:
        diff = np.abs(image.astype(np.float32) - self.bg[None, None]).max(-1)
        return diff > self.tol


class PerceptionModule:
    def __init__(self, segmenter: Optional[SegmentationProvider] = None,
                 bbox: np.ndarray = WORKSPACE_BBOX, voxel_size: float = 0.005,
                 max_points: int = 20000, device: str | torch.device = "cuda"):
        self.segmenter = segmenter or ThresholdSegmenter()
        self.bbox = np.asarray(bbox, np.float32)
        self.voxel_size = voxel_size
        self.max_points = max_points
        self.device = require_device(device)

    def get_tabletop_points(
        self,
        colors: np.ndarray,  # (C, H, W, 3) u8
        depths: np.ndarray,  # (C, H, W) u16 mm or float m
        intrinsics: List[np.ndarray],
        R_list: List[np.ndarray],  # camera -> world rotations
        t_list: List[np.ndarray],
        prompt: str = "object",
        obj_names: Optional[List[str]] = None,
        return_imgs: bool = False,
    ) -> Tuple[np.ndarray, ...]:
        """Fused object point cloud: per-view mask -> unproject -> world ->
        bbox crop -> 5 mm voxel downsampling -> iterative statistical
        outlier removal. Returns (points (M, 3), colours (M, 3) in [0, 1]);
        with ``return_imgs`` also the views' u8 images and boolean masks.

        With ``obj_names`` and a segmenter that gives instance masks
        (``table_object_masks``), a view's mask is everything but the table
        less the objects; otherwise it is the provider's object mask."""
        pts_all, col_all, mask_all = [], [], []
        table_flow = obj_names and hasattr(self.segmenter, "table_object_masks")
        for c in range(len(colors)):
            if table_flow:
                _, _, mask = self.segmenter.table_object_masks(colors[c], obj_names)
            else:
                mask = self.segmenter.segment(colors[c], prompt)
            mask = np.asarray(mask, bool)
            mask_all.append(mask)
            depth = depths[c].astype(np.float32)
            if depths[c].dtype == np.uint16:
                depth = depth / 1000.0
            k = np.asarray(intrinsics[c], np.float32)
            H, W = depth.shape
            ys, xs = np.mgrid[0:H, 0:W]
            z = depth
            x = (xs - k[0, 2]) * z / k[0, 0]
            y = (ys - k[1, 2]) * z / k[1, 1]
            pts_cam = np.stack([x, y, z], -1).reshape(-1, 3)
            valid = (mask & (depth > 1e-4)).reshape(-1)
            pts_w = pts_cam[valid] @ np.asarray(R_list[c]).T + np.asarray(t_list[c])[None]
            cols = colors[c].reshape(-1, 3)[valid].astype(np.float32) / 255.0
            inb = np.all((pts_w >= self.bbox[:, 0][None])
                         & (pts_w <= self.bbox[:, 1][None]), axis=-1)
            pts_all.append(pts_w[inb])
            col_all.append(cols[inb])
        pts = np.concatenate(pts_all, axis=0)
        cols = np.concatenate(col_all, axis=0)
        if len(pts) == 0:
            return (pts, cols, list(colors), mask_all) if return_imgs else (pts, cols)

        # fixed-capacity device pipeline
        dev = self.device
        cap = int(2 ** np.ceil(np.log2(max(len(pts), 2))))
        pts_pad = np.zeros((cap, 3), np.float32)
        pts_pad[:len(pts)] = pts
        valid = np.zeros((cap,), bool)
        valid[:len(pts)] = True
        down, mask_v = voxel_downsample(torch.as_tensor(pts_pad, device=dev),
                                        self.voxel_size, self.max_points,
                                        valid=torch.as_tensor(valid, device=dev))
        down_t = down[mask_v]

        keep = torch.ones(down_t.shape[0], dtype=torch.bool, device=dev)
        for it in range(5):
            m = statistical_outlier_mask(down_t, 25, 2.0 + 0.5 * it, valid=keep)
            if bool(torch.equal(m, keep)):
                break
            keep = m
        final_pts = down_t[keep].cpu().numpy()
        # nearest original colour per voxel point
        if len(final_pts):
            from scipy.spatial import cKDTree

            _, idx = cKDTree(pts).query(final_pts, k=1)
            final_cols = cols[idx]
        else:
            final_cols = np.zeros((0, 3), np.float32)
        if return_imgs:
            return final_pts, final_cols, list(colors), mask_all
        return final_pts, final_cols

    def get_tabletop_points_env(self, env, prompt: str = "object",
                                return_imgs: bool = False):
        """Perceive straight from an Env; ``return_imgs`` as in
        `get_tabletop_points`."""
        obs = env.get_obs(get_color=True, get_depth=True)
        R_list, t_list = env.get_extrinsics()
        return self.get_tabletop_points(obs["color"], obs["depth"],
                                        env.get_intrinsics(), R_list, t_list,
                                        prompt=prompt, return_imgs=return_imgs)
