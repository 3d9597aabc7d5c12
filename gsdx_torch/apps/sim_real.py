"""Headless perceive -> Gaussian fit -> rollout -> act loop on the
simulated environment (counterpart of `gsdx/apps/sim_real.py`).

Each trial perceives the object, fits the online Gaussian scene, rolls the
GNN under a fixed 12 cm push through the object's centre, renders the
rollout from camera 0 (PNG frames under `<out>/sim_cam0`), and executes
the push on the environment.

    python -m gsdx_torch.apps.sim_real --config configs/rope.yaml \\
        [--trials 3] [--gs_iters 2000] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--epoch", default="latest")
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--gs_iters", type=int, default=2000)
    p.add_argument("--out", default="out/sim_real")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from gsdx_torch.apps.demo import DemoSession
    from gsdx_torch.realworld.env import FakeEnv
    from gsdx_torch.realworld.perception import PerceptionModule

    rng = np.random.default_rng(args.seed)
    pts = rng.normal(scale=0.04, size=(400, 3)).astype(np.float32)
    pts += np.array([0.3, 0.05, 0.0], np.float32)
    cols = np.tile(np.array([0.85, 0.3, 0.15], np.float32), (400, 1))
    session = DemoSession(args.config, args.epoch, assets=None,
                          out_dir=args.out, gs_iters=args.gs_iters,
                          seed=args.seed, device=args.device)
    env = FakeEnv(pts, cols, device=session.device)
    env.start()
    pm = PerceptionModule(device=session.device)

    for trial in range(args.trials):
        print(f"--- trial {trial} ---")
        fused, fused_cols = pm.get_tabletop_points_env(env)
        print(f"perceived {len(fused)} points")
        obs = env.get_obs(get_color=True)
        masks = [
            (np.abs(obs["color"][c].astype(np.float32) - 255 * 0.7).max(-1)
             > 30).astype(np.float32)
            for c in range(env.n_fixed_cameras)
        ]
        imgs = [obs["color"][c].astype(np.float32) / 255.0 * masks[c][..., None]
                for c in range(env.n_fixed_cameras)]
        R_list, t_list = env.get_extrinsics()
        session.gs.update_state(fused, fused_cols, imgs, masks, R_list, t_list,
                                env.get_intrinsics())
        session.gs.train(progress=True)
        session._set_particles()

        start, end = push_through_centre(session.particle_pos, session.mean_z)
        action = np.stack([start, end])
        rendervars, _ = session.gs.rollout_and_render(session.dm, action)
        session.render_rollout(rendervars, cam_id=0)

        env.step(np.array([start[0], start[1], end[0], end[1]]))
        print(f"executed push {start[:2]} -> {end[:2]}")

    env.stop()
    print("sim_real loop done")


def push_through_centre(particles: np.ndarray, z: float):
    """A 12 cm push along +x through the particles' centre at height ``z``:
    from 8 cm before the centre to 4 cm past it."""
    center = particles.mean(0)
    start = center + np.array([-0.08, 0.0, 0.0])
    end = center + np.array([0.04, 0.0, 0.0])
    start[2] = end[2] = z
    return start, end


if __name__ == "__main__":
    main()
