"""Calibration + goal-construction CLI (counterpart of `gsdx/apps/calibrate.py`;
reference `src/real_world/calibrate.py:12-98`).

  --calibrate        fixed-camera ChArUco calibration (board on the table;
                     needs OpenCV with aruco)
  --construct_goal   capture a target point cloud from live perception

Works against real hardware (RealSense sources, which need pyrealsense2, and
the xArm7 at $XARM_IP, which needs the xArm SDK) or the simulated
environment for dry runs (`--env fake`, whose extrinsics are analytic).

    python -m gsdx_torch.apps.calibrate --env fake --calibrate --construct_goal
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--calibrate", action="store_true")
    p.add_argument("--construct_goal", action="store_true")
    p.add_argument("--out", default="out/calibration")
    p.add_argument("--env", default="fake", choices=["fake", "real"])
    p.add_argument("--serials", nargs="*", default=None,
                   help="RealSense serial numbers (real env)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from gsdx_torch.core.device import require_device

    device = require_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    if args.env == "real":
        from gsdx_torch.realworld.cameras import RealSenseSource
        from gsdx_torch.realworld.real_env import RealEnv
        from gsdx_torch.realworld.robot import XArm7

        sources = [RealSenseSource(s) for s in (args.serials or [])]
        env = RealEnv(sources, arm=XArm7(os.environ.get("XARM_IP", "")), device=device)
    else:
        from gsdx_torch.realworld.env import FakeEnv

        rng = np.random.default_rng(0)
        pts = rng.normal(scale=0.03, size=(300, 3)).astype(np.float32)
        pts += np.array([0.3, 0.05, 0.0], np.float32)
        cols = np.tile(np.array([0.8, 0.3, 0.2], np.float32), (300, 1))
        env = FakeEnv(pts, cols, device=device)

    env.start()
    try:
        if args.calibrate:
            if args.env == "fake":
                print("fake env has analytic extrinsics; writing them out")
                R_list, t_list = env.get_extrinsics()
            else:
                R_list, t_list = env.calibrate_fixed_cameras()
                env.save_calibration(os.path.join(args.out, "calibration_handeye_result.pkl"))
            np.save(os.path.join(args.out, "R_list.npy"), np.stack(R_list))
            np.save(os.path.join(args.out, "t_list.npy"), np.stack(t_list))
            np.save(os.path.join(args.out, "intr_list.npy"), np.stack(env.get_intrinsics()))
            print(f"wrote extrinsics/intrinsics to {args.out}")

        if args.construct_goal:
            from gsdx_torch.io.ply import save_ply
            from gsdx_torch.realworld.perception import PerceptionModule

            pts, cols = PerceptionModule(device=device).get_tabletop_points_env(env)
            save_ply(os.path.join(args.out, "target.ply"), pts, cols)
            np.save(os.path.join(args.out, "target.npy"), pts)
            print(f"wrote goal cloud ({len(pts)} points) to {args.out}")
    finally:
        env.stop()


if __name__ == "__main__":
    main()
