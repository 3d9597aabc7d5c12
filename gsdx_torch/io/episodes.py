"""Episode file IO (the port's own copy of what it needs from
`gsdx/io/episodes.py`, same on-disk format).

  episode dir: camera_{i}/color_{n}.jpg, camera_{i}/seg/seg_{n}.png,
               actions.txt (one JSON per frame: joint_angles, pose in mm
               and degrees), calibration_handeye_result.pkl
  metadata: train_meta.json / metadata.json {w, h, k, w2c, fn, cam_id}
  tracking output: params.npz, per-timestep snapshots stacked over time
  scene export: `save_to_splat`, the web viewers' binary .splat
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Sequence

import numpy as np


def rpy_to_rotation_matrix(roll, pitch, yaw) -> np.ndarray:
    """Degrees -> rotation matrix Rz @ Ry @ Rx (float64)."""
    roll, pitch, yaw = (np.deg2rad(a) for a in (roll, pitch, yaw))
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def save_params(output_params: Sequence[dict], path: str) -> None:
    """Stack per-timestep snapshots into one npz: keys present at every
    timestep are stacked over time, t=0-only keys are stored once."""
    to_save = {}
    keys0 = output_params[0].keys()
    shared = keys0 if len(output_params) == 1 else output_params[1].keys()
    for k in keys0:
        if k in shared:
            to_save[k] = np.stack([p[k] for p in output_params])
        else:
            to_save[k] = output_params[0][k]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **to_save)


def load_params(path: str) -> dict:
    return dict(np.load(path))


def load_metadata(path: str) -> dict:
    """metadata.json / train_meta.json with fields w, h, k, w2c, fn, cam_id."""
    with open(path) as f:
        return json.load(f)


def load_actions(data_dir: str) -> list:
    """The lines of actions.txt (one JSON object per recorded frame)."""
    with open(os.path.join(data_dir, "actions.txt")) as f:
        return f.read().rstrip("\n").split("\n")


def load_calibration(data_dir: str) -> dict:
    """The hand-eye calibration {R_base2world (3, 3), t_base2world (3,)},
    a pickle written by the recording rig."""
    with open(os.path.join(data_dir, "calibration_handeye_result.pkl"), "rb") as f:
        return pickle.load(f)


def frame_indices_from_metadata(meta: dict) -> np.ndarray:
    """Frame numbers parsed from camera 0's file names (`color_{n}.jpg`)."""
    fn = np.array(meta["fn"])
    names = fn[:, 0] if fn.ndim > 1 else fn
    return np.array([int(str(n).split("/")[-1].split("_")[1].split(".")[0])
                     for n in names])


def eef_world_positions(data_dir: str, meta: dict,
                        gripper_z: float = 0.17) -> np.ndarray:
    """(num_frames, 1, 3) f32 gripper point in world coordinates, one per
    tracked frame. ``gripper_z`` is the gripper point's offset along the
    flange axis: 0.17 m where episodes are loaded for training and
    prediction, 0.18 m in preprocessing (gsdx keeps both values). An action
    log shorter than the frames is padded at the front with its first line;
    one more than 10 lines longer is cut; a frame without a readable line
    takes the last."""
    frame_idx = frame_indices_from_metadata(meta)
    num_frames = len(frame_idx)
    lines = load_actions(data_dir)
    if len(lines) != num_frames:
        lines = [lines[0]] * (int(frame_idx.max()) + 1 - len(lines)) + lines
    if len(lines) - num_frames > 10:
        lines = lines[:num_frames]
    calib = load_calibration(data_dir)
    r_b2w, t_b2w = calib["R_base2world"], calib["t_base2world"]
    gripper_point = np.array([0.0, 0.0, gripper_z])

    out = np.zeros((num_frames, 1, 3), np.float32)
    for i, fi in enumerate(frame_idx):
        try:
            act = json.loads(lines[fi])
        except (IndexError, json.JSONDecodeError):
            act = json.loads(lines[-1])
        pose = np.asarray(act["pose"], np.float64)
        r_g2w = r_b2w @ rpy_to_rotation_matrix(*pose[3:6])
        t_g2w = r_b2w @ (pose[:3] / 1000.0) + t_b2w
        out[i, 0] = (r_g2w @ gripper_point + t_g2w).astype(np.float32)
    return out


def load_episode_images(seq_dir: str, meta: dict, t: int):
    """(ims (C, 3, H, W) in [0, 1], segs (C, 3, H, W)) for timestep t; seg
    masks become (seg, 0, 1 - seg) colour targets."""
    from PIL import Image

    ims, segs = [], []
    for c in range(len(meta["fn"][t])):
        fn = meta["fn"][t][c]
        im = np.asarray(Image.open(os.path.join(seq_dir, fn)), np.float32) / 255.0
        directory, filename = fn.rsplit("/", 1)
        number = int(filename.split("_")[-1].split(".")[0])
        seg_path = os.path.join(seq_dir, directory.rsplit("/", 1)[0], "seg",
                                f"seg_{number:06d}.png")
        seg = np.asarray(Image.open(seg_path), np.float32)
        if seg.ndim == 3:
            seg = seg[..., 0]
        ims.append(im.transpose(2, 0, 1))
        segs.append(np.stack([seg, np.zeros_like(seg), 1.0 - seg], axis=0))
    return np.stack(ims), np.stack(segs)


def save_to_splat(pts, colors, scales, quats, opacities, output_file: str):
    """Binary .splat export for web viewers (`src/real_world/gs/convert.py:23-51`):
    per splat [pos f32x3 | scale f32x3 | rgba u8x4 | quat u8x4], scene
    centered and rotated -90 deg about x. Vectorized (the reference writes a
    python loop per splat)."""
    pts = np.asarray(pts, np.float32)
    pts = pts - pts.mean(axis=0)
    rot_x = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32)  # inv(x+90)
    pts = pts @ rot_x.T

    w = np.sqrt(np.maximum(1 + np.trace(rot_x), 1e-8)) / 2
    rq = np.array([
        w,
        (rot_x[2, 1] - rot_x[1, 2]) / (4 * w),
        (rot_x[0, 2] - rot_x[2, 0]) / (4 * w),
        (rot_x[1, 0] - rot_x[0, 1]) / (4 * w),
    ], np.float32)
    q = np.asarray(quats, np.float32)
    w1, x1, y1, z1 = rq
    w2, x2, y2, z2 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    q_rot = np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=1)
    q_rot = q_rot / np.maximum(np.linalg.norm(q_rot, axis=1, keepdims=True), 1e-9)

    n = pts.shape[0]
    rgba = np.clip(
        np.concatenate([np.asarray(colors), np.asarray(opacities).reshape(n, 1)],
                       axis=1) * 255, 0, 255
    ).astype(np.uint8)
    quat_u8 = np.clip(q_rot * 128 + 128, 0, 255).astype(np.uint8)

    rec = np.zeros(n, dtype=[("pos", "<f4", 3), ("scale", "<f4", 3),
                             ("rgba", "u1", 4), ("quat", "u1", 4)])
    rec["pos"] = pts
    rec["scale"] = np.asarray(scales, np.float32)
    rec["rgba"] = rgba
    rec["quat"] = quat_u8
    with open(output_file, "wb") as f:
        f.write(rec.tobytes())
