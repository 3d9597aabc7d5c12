"""Closed-loop MPPI planning CLI (counterpart of `gsdx/apps/plan.py`).

Runs perceive -> plan -> execute for n_actions pushes, logging the chamfer
distance to the target cloud, against the simulated environment
(`--env fake`). Real hardware (`--env real`) waits for the port of
`realworld/`'s cameras and robot. The trained model is read from
`<train_config.out_dir>/checkpoints/<epoch>.ckpt`, relative to the working
directory. Resumable from the saved interaction files.

    python -m gsdx_torch.apps.plan --config configs/rope.yaml --env fake
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def get_state_cur(env, pm, max_nobj: int, fps_radius: float,
                  prompt: str = "object", device="cuda"):
    """Perceive the current object keypoint state: fused cloud -> FPS ->
    radius-stopping FPS. Returns (state (n, 3), full cloud (M, 3)) numpy."""
    from gsdx_torch.kernels.fps import farthest_point_sampling, fps_rad_idx

    pts, _ = pm.get_tabletop_points_env(env, prompt=prompt)
    if len(pts) == 0:
        raise RuntimeError("perception returned no points")
    n = min(max_nobj, len(pts))
    pts_t = torch.as_tensor(pts, device=device)
    down = pts_t[farthest_point_sampling(pts_t, n, start_idx=0)]
    idx2, keep = fps_rad_idx(down, fps_radius, max_samples=n)
    state = down[idx2][keep].cpu().numpy()
    return state, pts


def chamfer_np(x, y):
    d = np.linalg.norm(x[:, None] - y[None], axis=-1)
    return d.min(1).mean() + d.min(0).mean()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--epoch", default="latest")
    p.add_argument("--env", default="fake", choices=["fake", "real"])
    p.add_argument("--target", default=None,
                   help="target point cloud .npy; default: shifted initial")
    p.add_argument("--n_actions", type=int, default=10)
    p.add_argument("--n_chunks", type=int, default=10)
    p.add_argument("--n_sample", type=int, default=1000)
    p.add_argument("--out", default="out/plan")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--prompt", default="object",
                   help="perception text prompt (grounded-SAM when available)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from gsdx_torch.core.device import require_device
    from gsdx_torch.io.checkpoint import load_trained_model
    from gsdx_torch.plan.cost import running_cost
    from gsdx_torch.plan.dynamics_rollout import RolloutSpec, make_batched_rollout
    from gsdx_torch.plan.planner import MPPIConfig, Planner
    from gsdx_torch.realworld.env import WORKSPACE_BBOX, FakeEnv
    from gsdx_torch.realworld.perception import PerceptionModule
    from gsdx_torch.realworld.segmentation import make_segmenter

    device = require_device(args.device)
    if args.env == "real":
        raise NotImplementedError(
            "--env real needs the cameras and robot of realworld/, which are "
            "not ported yet; use --env fake")
    train_cfg, data_cfg, model = load_trained_model(args.config, args.epoch, device)

    rng = np.random.default_rng(args.seed)
    pts = rng.normal(scale=0.03, size=(400, 3)).astype(np.float32)
    pts += np.array([0.3, 0.0, 0.0], np.float32)
    cols = np.tile(np.array([0.9, 0.2, 0.1], np.float32), (400, 1))
    env = FakeEnv(pts, cols, device=device)
    env.start()
    pm = PerceptionModule(segmenter=make_segmenter(), device=device)

    fps_radius = sum(data_cfg.fps_radius_range) / 2
    adj_thresh = sum(data_cfg.adj_radius_range) / 2
    state_cur, full_pts = get_state_cur(env, pm, data_cfg.max_nobj, fps_radius,
                                        args.prompt, device)
    if args.target:
        target_state = np.load(args.target).astype(np.float32)
    else:
        target_state = full_pts + np.array([0.08, -0.05, 0.0], np.float32)

    n_obj = state_cur.shape[0]
    spec = RolloutSpec(n_his=train_cfg.n_his, max_nobj=n_obj, max_nR=data_cfg.max_nR,
                       topk=data_cfg.topk, adj_thresh=adj_thresh,
                       connect_all=data_cfg.connect_all)
    rollout = make_batched_rollout(model, spec)
    bbox = torch.as_tensor(WORKSPACE_BBOX, device=device)
    tgt = torch.as_tensor(target_state, device=device)

    def evaluate(state_seqs, act_seqs, state_cur):
        return running_cost(state_seqs, act_seqs, state_cur, tgt, bbox)

    mppi = MPPIConfig(n_sample=args.n_sample)
    planner = Planner(mppi, rollout, evaluate, device=device)

    os.makedirs(args.out, exist_ok=True)
    start_i = 0
    if args.resume:
        start_i = len(glob.glob(os.path.join(args.out, "interaction_*.npz")))

    generator = torch.Generator(device=device).manual_seed(args.seed)
    init_act = torch.zeros((mppi.n_look_ahead, 4), device=device)
    init_act[:, 3] = 10.0
    chamfers = []
    for i in range(start_i, args.n_actions):
        state_cur, full_pts = get_state_cur(env, pm, data_cfg.max_nobj, fps_radius,
                                            args.prompt, device)
        cd_before = chamfer_np(full_pts, target_state)
        # pad the perceived state to the planner's n_obj
        sc = np.zeros((n_obj, 3), np.float32)
        sc[:min(len(state_cur), n_obj)] = state_cur[:n_obj]
        res = planner.plan_chunked(generator, torch.as_tensor(sc, device=device),
                                   init_act, n_chunks=args.n_chunks)
        act = res["act_seq"][0].cpu().numpy()  # (4,) x, y, theta, length
        x0, y0, theta, length = act
        x1 = x0 - 0.01 * length * np.cos(theta)
        y1 = y0 - 0.01 * length * np.sin(theta)
        env.step(np.array([x0, y0, x1, y1]))

        _, full_after = get_state_cur(env, pm, data_cfg.max_nobj, fps_radius,
                                      args.prompt, device)
        cd_after = chamfer_np(full_after, target_state)
        chamfers.append(cd_after)
        reward = float(res["best_reward"])
        np.savez(os.path.join(args.out, f"interaction_{i}.npz"), action=act,
                 state=sc, chamfer_before=cd_before, chamfer_after=cd_after,
                 reward=reward)
        print(f"interaction {i}: chamfer {cd_before:.4f} -> {cd_after:.4f} "
              f"(reward {reward:.4f})")
    env.stop()
    with open(os.path.join(args.out, "stats.txt"), "w") as f:
        f.write(f"final chamfer: {chamfers[-1] if chamfers else 'n/a'}\n")


if __name__ == "__main__":
    main()
