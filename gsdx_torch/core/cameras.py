"""Pinhole camera for Gaussian-splat rendering (counterpart of
`gsdx/core/cameras.py`).

The pixel mapping is the reference rasterizer's:

    p_cam = w2c @ p_world
    pix_x = fx * x/z + cx - 0.5
    pix_y = fy * y/z + cy - 0.5
    depth = z

A `Camera` holds one view (0-d intrinsics) or, after `stack_cameras`, a
stack of views with a leading camera axis; ``cams[i]`` selects one.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """w2c (4, 4) OpenCV world-to-camera; fx, fy, cx, cy pinhole intrinsics
    in pixels (f32 tensors); bg (3,) background; cam_id the index of the
    per-camera colour correction; width/height/near/far static scalars."""

    w2c: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    bg: torch.Tensor
    cam_id: torch.Tensor
    width: int
    height: int
    near: float
    far: float

    @property
    def tan_fovx(self) -> torch.Tensor:
        return self.width / (2.0 * self.fx)

    @property
    def tan_fovy(self) -> torch.Tensor:
        return self.height / (2.0 * self.fy)

    @property
    def cam_center(self) -> torch.Tensor:
        """Camera position in world coordinates."""
        return -self.w2c[:3, :3].T @ self.w2c[:3, 3]

    def __len__(self) -> int:
        if self.w2c.ndim != 3:
            raise TypeError("a single camera has no length; stack_cameras first")
        return self.w2c.shape[0]

    def __getitem__(self, i) -> "Camera":
        """Camera ``i`` of a stack built by `stack_cameras`."""
        return dataclasses.replace(
            self, **{f: getattr(self, f)[i] for f in _TENSOR_FIELDS})

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _TENSOR_FIELDS})


_TENSOR_FIELDS = ("w2c", "fx", "fy", "cx", "cy", "bg", "cam_id")


def make_camera(
    k,
    w2c,
    width: int = 1280,
    height: int = 720,
    near: float = 0.01,
    far: float = 100.0,
    bg=(0.0, 0.0, 0.0),
    cam_id: int = 0,
    device: str | torch.device = "cpu",
) -> Camera:
    """Camera from a 3x3 intrinsics matrix and a 4x4 w2c extrinsic: K's
    (0,0), (1,1), (0,2), (1,2) entries become fx, fy, cx, cy."""
    k = torch.as_tensor(np.asarray(k, np.float32), device=device)
    return Camera(
        w2c=torch.as_tensor(np.asarray(w2c, np.float32), device=device),
        fx=k[0, 0].clone(),
        fy=k[1, 1].clone(),
        cx=k[0, 2].clone(),
        cy=k[1, 2].clone(),
        bg=torch.as_tensor(np.asarray(bg, np.float32), device=device),
        cam_id=torch.tensor(int(cam_id), dtype=torch.long, device=device),
        width=int(width),
        height=int(height),
        near=float(near),
        far=float(far),
    )


def opencv_to_opengl_w2c(w2c_opencv, device: str | torch.device = "cpu") -> torch.Tensor:
    """OpenCV <-> OpenGL extrinsics flip: ``w2c @ diag(1, -1, -1, 1)``, the
    y and z camera axes negated. The flip is float64, so the result is at
    least float64, as numpy promotes it."""
    w2c = torch.as_tensor(w2c_opencv, device=device)
    w2c = w2c.to(torch.promote_types(w2c.dtype, torch.float64))
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=w2c.dtype, device=device))
    return w2c @ flip


def stack_cameras(cams: Sequence[Camera]) -> Camera:
    """Stack single cameras of one image size along a leading camera axis."""
    first = cams[0]
    for c in cams[1:]:
        if (c.width, c.height) != (first.width, first.height):
            raise ValueError("stacked cameras must share one image size")
    return dataclasses.replace(
        first,
        **{f: torch.stack([getattr(c, f) for c in cams]) for f in _TENSOR_FIELDS},
    )
