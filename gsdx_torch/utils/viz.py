"""Visualization overlays: points, arrows, masks, keypoint trails
(counterpart of `gsdx/utils/viz.py`).

Host-side drawing utilities covering the reference's
`src/real_world/utils/gradio_utils.py:7-249` (point/arrow/mask overlays with
3D-aware projection) and `src/render/utils.py:28-47` (keypoint trail
Visualizer used by predict.py).
"""

from __future__ import annotations

import importlib
from typing import List, Optional

import numpy as np


def require_drawing_packages() -> None:
    """Raise an ImportError that names OpenCV (``cv2``) or ``matplotlib``
    when either is missing: the drawings below import them when called."""
    for name in ("cv2", "matplotlib"):
        try:
            importlib.import_module(name)
        except ImportError as e:
            raise ImportError(
                f"the overlays need the {name!r} package, which is not "
                f"installed ({e})") from e


def rgba_to_rgb(im: np.ndarray, bg: Optional[np.ndarray] = None) -> np.ndarray:
    """Alpha-composite an RGBA u8 image over a background
    (`src/data/utils.py:96-101`)."""
    if bg is None:
        bg = np.zeros((im.shape[0], im.shape[1], 3))
    alpha = im[:, :, 3:4].astype(np.float64) / 255.0
    return im[:, :, :3].astype(np.float64) * alpha + bg * (1 - alpha)


def rgb_colormap(repeat: int = 1) -> np.ndarray:
    """Primary-color keypoint map (`src/data/utils.py:103-109`)."""
    base = np.asarray([[0, 0, 255], [0, 255, 0], [255, 0, 0]])
    return np.repeat(base, repeat, axis=0)


def project_points(points: np.ndarray, intr: np.ndarray,
                   extr: np.ndarray) -> np.ndarray:
    """(N, 3) world -> (N, 2) pixels (`src/render/utils.py:7-16`)."""
    p = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    p = p @ np.asarray(extr).T
    p = p[:, :3] / np.clip(p[:, 2:3], 1e-9, None)
    p = p @ np.asarray(intr).T
    return p[:, :2] / np.clip(p[:, 2:3], 1e-9, None)


def draw_points_on_image(image: np.ndarray, points_2d: np.ndarray,
                         color=(255, 0, 0), radius: int = 5) -> np.ndarray:
    """Filled circles at pixel coordinates (`gradio_utils.py` draw_points)."""
    import cv2

    out = np.ascontiguousarray(image.copy())
    for x, y in np.asarray(points_2d):
        cv2.circle(out, (int(x), int(y)), radius, tuple(int(c) for c in color),
                   -1)
    return out


def draw_arrow_on_image(image: np.ndarray, start_2d, end_2d,
                        color=(0, 255, 0), thickness: int = 3) -> np.ndarray:
    import cv2

    out = np.ascontiguousarray(image.copy())
    cv2.arrowedLine(
        out, (int(start_2d[0]), int(start_2d[1])),
        (int(end_2d[0]), int(end_2d[1])),
        tuple(int(c) for c in color), thickness, tipLength=0.25,
    )
    return out


def draw_mask_on_image(image: np.ndarray, mask: np.ndarray,
                       color=(0, 120, 255), alpha: float = 0.5) -> np.ndarray:
    """Translucent mask overlay (`gradio_utils.py` draw_mask_on_image)."""
    out = image.astype(np.float32).copy()
    m = (np.asarray(mask) > 0.5).astype(np.float32)[..., None]
    out = out * (1 - alpha * m) + np.asarray(color, np.float32) * alpha * m
    return np.clip(out, 0, 255).astype(np.uint8)


class TrailVisualizer:
    """Keypoint trail drawing over a rolling history
    (`Visualizer.draw_keypoints`, `src/render/utils.py:18-47`)."""

    def __init__(self, history: int = 40, radius: int = 10):
        self.history = history
        self.radius = radius
        self.kps: List[np.ndarray] = []

    def draw(self, image: np.ndarray, keypoints_2d: np.ndarray) -> np.ndarray:
        import cv2
        import matplotlib.pyplot as plt

        # clamp to a sane pixel range: points behind/near the camera plane
        # project to huge coordinates that overflow cv2's int arguments
        lim = 8 * max(image.shape[0], image.shape[1])
        kp = np.nan_to_num(np.asarray(keypoints_2d, np.float64),
                           nan=0.0, posinf=lim, neginf=-lim)
        self.kps.append(np.clip(kp, -lim, lim))
        if len(self.kps) > self.history:
            self.kps.pop(0)
        out = np.ascontiguousarray(image.copy())
        cmap = plt.get_cmap("viridis")
        for k in range(len(self.kps) - 1):
            color = np.array(cmap(k / (len(self.kps) - 1 + 1e-4)))[:3][::-1] * 255
            a, b = self.kps[k], self.kps[k + 1]
            cv2.line(out, (int(a[0, 0]), int(a[0, 1])),
                     (int(b[0, 0]), int(b[0, 1])),
                     color.tolist(), self.radius)
        return out


def visualize_push(image: np.ndarray, state_2d: np.ndarray,
                   action_start_2d, action_end_2d,
                   target_2d: Optional[np.ndarray] = None) -> np.ndarray:
    """Planner overlay: object keypoints, push arrow, optional target
    (`visualize_img`, `src/real_world/utils/plan_utils.py:163-325`)."""
    out = draw_points_on_image(image, state_2d, color=(255, 80, 40), radius=4)
    if target_2d is not None:
        out = draw_points_on_image(out, target_2d, color=(60, 200, 80),
                                   radius=3)
    out = draw_arrow_on_image(out, action_start_2d, action_end_2d,
                              color=(40, 120, 255), thickness=3)
    return out
