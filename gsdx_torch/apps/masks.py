"""Offline mask / initial-cloud / metadata tools for tracking datasets
(counterpart of `gsdx/apps/masks.py`).

Working CLI replacements for `src/tracking/utils/{obtain_mask, merge_mask,
init_pcd, metadata}.py`. Segmentation is pluggable
(`gsdx_torch.realworld.segmentation.make_segmenter`): grounded-SAM where its
packages and checkpoints are installed, the threshold segmenter otherwise.
Images are PNGs read and written by the port's own codec (`io/video.py`):
colour frames 8-bit RGB, depth 16-bit gray in millimetres, masks 8-bit
gray. gsdx also reads JPEG colour frames through PIL; the port refuses them.
The initial cloud's voxel downsampling and outlier removal run on
``--device`` (default cuda).

Usage:
  python -m gsdx_torch.apps.masks obtain   --data_path <episode> [--prompt obj]
  python -m gsdx_torch.apps.masks merge    --data_path <episode>
  python -m gsdx_torch.apps.masks initpcd  --data_path <episode> --calib <pkl>
  python -m gsdx_torch.apps.masks metadata --data_path <episode> --calib <pkl>
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle

import numpy as np
import torch


def _episode_frames(data_path: str, cam: int):
    files = sorted(glob.glob(os.path.join(data_path, f"camera_{cam}", "color_*.jpg")))
    if not files:
        files = sorted(glob.glob(os.path.join(data_path, f"camera_{cam}", "color_*.png")))
    return files


def _frame_number(path: str) -> int:
    return int(os.path.basename(path).split("_")[-1].split(".")[0])


def _read(path: str) -> np.ndarray:
    from gsdx_torch.io.video import read_png

    if not path.endswith(".png"):
        raise ValueError(f"{path}: the port reads PNG frames only (convert the "
                         "episode's JPEG frames to PNG)")
    return read_png(path)


def _read_mask(path: str) -> np.ndarray:
    seg = _read(path).astype(np.float32) / 255.0
    return seg[..., 0] if seg.ndim == 3 else seg


def _make_segmenter(device):
    """Grounded-SAM when installed with checkpoints, else the threshold
    fallback (`gsdx_torch.realworld.segmentation.make_segmenter`)."""
    from gsdx_torch.realworld.segmentation import SegmenterConfig, make_segmenter

    return make_segmenter(SegmenterConfig(device=str(device)))


def obtain_mask(data_path: str, prompt: str, n_cameras: int = 4, device="cuda"):
    """Per-frame object masks -> camera_{i}/seg/seg_{n}.png (`obtain_mask.py`)."""
    from gsdx_torch.core.device import require_device
    from gsdx_torch.io.video import write_image

    segmenter = _make_segmenter(require_device(device))
    for c in range(n_cameras):
        files = _episode_frames(data_path, c)
        seg_dir = os.path.join(data_path, f"camera_{c}", "seg")
        os.makedirs(seg_dir, exist_ok=True)
        for f in files:
            mask = segmenter.segment(_read(f)[..., :3], prompt)
            write_image(os.path.join(seg_dir, f"seg_{_frame_number(f):06d}.png"),
                        (mask * 255).astype(np.uint8))
        print(f"camera {c}: {len(files)} masks")


def merge_mask(data_path: str, n_cameras: int = 4):
    """rgb * mask -> camera_{i}/foreground/ (`merge_mask.py`)."""
    from gsdx_torch.io.video import write_image

    for c in range(n_cameras):
        files = _episode_frames(data_path, c)
        fg_dir = os.path.join(data_path, f"camera_{c}", "foreground")
        os.makedirs(fg_dir, exist_ok=True)
        for f in files:
            n = _frame_number(f)
            img = _read(f).astype(np.float32)[..., :3]
            mask = _read_mask(os.path.join(data_path, f"camera_{c}", "seg", f"seg_{n:06d}.png"))
            fg = (img * mask[..., None]).astype(np.uint8)
            write_image(os.path.join(fg_dir, f"fg_{n:06d}.png"), fg)
        print(f"camera {c}: merged {len(files)} frames")


def build_init_pcd(data_path: str, calib_path: str, n_cameras: int = 4,
                   voxel_size: float = 0.005, max_points: int = 100000, device="cuda"):
    """Fused initial point cloud -> init_pt_cld.npz (N, 7) [xyz rgb seg]
    (`init_pcd.py`). Uses frame 0 of every camera; background points come
    from the unmasked table region with seg=0. Voxel downsampling and the
    outlier filter run on ``device``."""
    from scipy.spatial import cKDTree

    from gsdx_torch.core.device import require_device
    from gsdx_torch.core.pointcloud import statistical_outlier_mask, voxel_downsample

    dev = require_device(device)
    with open(calib_path, "rb") as f:
        calib = pickle.load(f)
    intr = np.asarray(calib["intrinsics"])
    R_c2w = np.asarray(calib["R_cam2world"])
    t_c2w = np.asarray(calib["t_cam2world"])

    pts_all, col_all, seg_all = [], [], []
    for c in range(n_cameras):
        f0 = _episode_frames(data_path, c)[0]
        n = _frame_number(f0)
        img = _read(f0).astype(np.float32)[..., :3] / 255.0
        depth = _read(os.path.join(data_path, f"camera_{c}", "depth",
                                   f"depth_{n:06d}.png")).astype(np.float32) / 1000.0
        seg = _read_mask(os.path.join(data_path, f"camera_{c}", "seg", f"seg_{n:06d}.png"))

        H, W = depth.shape
        ys, xs = np.mgrid[0:H, 0:W]
        k = intr[c]
        z = depth
        x = (xs - k[0, 2]) * z / k[0, 0]
        y = (ys - k[1, 2]) * z / k[1, 1]
        p_cam = np.stack([x, y, z], -1).reshape(-1, 3)
        valid = (depth > 1e-4).reshape(-1)
        pts_all.append(p_cam[valid] @ R_c2w[c].T + t_c2w[c][None])
        col_all.append(img.reshape(-1, 3)[valid])
        seg_all.append((seg.reshape(-1)[valid] > 0.5).astype(np.float32))

    pts = np.concatenate(pts_all)
    cols = np.concatenate(col_all)
    segs = np.concatenate(seg_all)

    cap = int(2 ** np.ceil(np.log2(max(len(pts), 2))))
    pad = np.zeros((cap, 3), np.float32)
    pad[:len(pts)] = pts
    valid = np.zeros((cap,), bool)
    valid[:len(pts)] = True
    down, mask = voxel_downsample(torch.as_tensor(pad, device=dev), voxel_size, max_points,
                                  valid=torch.as_tensor(valid, device=dev))
    down = down[mask]
    down = down[statistical_outlier_mask(down, 20, 2.0)].cpu().numpy()

    _, idx = cKDTree(pts).query(down, k=1)
    data = np.concatenate([down, cols[idx], segs[idx][:, None]], axis=1).astype(np.float32)
    out = os.path.join(data_path, "init_pt_cld.npz")
    np.savez(out, data=data)
    print(f"wrote {out}: {data.shape}")
    return data


def build_metadata(data_path: str, calib_path: str, n_cameras: int = 4,
                   width: int = 1280, height: int = 720):
    """train_meta.json {w, h, k, w2c, fn, cam_id} (`metadata.py`). w2c is
    the OpenCV world->camera matrix per camera, repeated per frame."""
    with open(calib_path, "rb") as f:
        calib = pickle.load(f)
    intr = np.asarray(calib["intrinsics"])
    R_c2w = np.asarray(calib["R_cam2world"])
    t_c2w = np.asarray(calib["t_cam2world"])

    frames = [_episode_frames(data_path, c) for c in range(n_cameras)]
    n_frames = min(len(f) for f in frames)
    w2cs = []
    for c in range(n_cameras):
        c2w = np.eye(4)
        c2w[:3, :3] = R_c2w[c]
        c2w[:3, 3] = t_c2w[c]
        w2cs.append(np.linalg.inv(c2w))

    meta = {
        "w": width,
        "h": height,
        "k": [[intr[c].tolist() for c in range(n_cameras)]] * n_frames,
        "w2c": [[w2cs[c].tolist() for c in range(n_cameras)]] * n_frames,
        "fn": [[os.path.relpath(frames[c][t], data_path) for c in range(n_cameras)]
               for t in range(n_frames)],
        "cam_id": [list(range(n_cameras))] * n_frames,
    }
    out = os.path.join(data_path, "train_meta.json")
    with open(out, "w") as f:
        json.dump(meta, f)
    print(f"wrote {out}: {n_frames} frames x {n_cameras} cameras")
    return meta


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("obtain", "merge", "initpcd", "metadata"):
        sp = sub.add_parser(name)
        sp.add_argument("--data_path", required=True)
        sp.add_argument("--n_cameras", type=int, default=4)
        if name == "obtain":
            sp.add_argument("--prompt", default="object")
        if name in ("obtain", "initpcd"):
            sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        if name in ("initpcd", "metadata"):
            sp.add_argument("--calib", required=True)
        if name == "metadata":
            sp.add_argument("--width", type=int, default=1280)
            sp.add_argument("--height", type=int, default=720)
    args = p.parse_args(argv)

    if args.cmd == "obtain":
        obtain_mask(args.data_path, args.prompt, args.n_cameras, args.device)
    elif args.cmd == "merge":
        merge_mask(args.data_path, args.n_cameras)
    elif args.cmd == "initpcd":
        build_init_pcd(args.data_path, args.calib, args.n_cameras, device=args.device)
    elif args.cmd == "metadata":
        build_metadata(args.data_path, args.calib, args.n_cameras, args.width, args.height)


if __name__ == "__main__":
    main()
