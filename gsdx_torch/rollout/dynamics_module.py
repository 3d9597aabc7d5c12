"""GNN rollout over a Gaussian scene (counterpart of
`gsdx/rollout/dynamics_module.py`).

`DynamicsModule.rollout` keeps a 1000-point FPS proxy of the splat set,
and for every step the end effector moves predicts sparse bone motions
with the GNN and skins every Gaussian to them (`skinning.py`). A step is
one device function (`step`: FPS -> radius FPS -> edges -> GNN module
forward -> skinning) with no host read; the host loop sequences the steps
and skips a step whose end-effector motion is below ``dist_thresh``,
deciding from the recorded numpy positions, as gsdx does. Everything runs
under `torch.inference_mode()`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gsdx_torch.dynamics.model import DynamicsPredictor
from gsdx_torch.graph.edges import construct_edges
from gsdx_torch.kernels.fps import farthest_point_sampling, fps_rad_idx
from gsdx_torch.rollout.skinning import interpolate_motions, relations_to_matrix


class RolloutConfig(NamedTuple):
    n_his: int = 3
    dist_thresh: float = 0.01  # skip steps with less end-effector motion
    max_nobj: int = 100
    fps_radius: float = 0.03
    adj_thresh: float = 0.08
    topk: int = 5
    connect_all: bool = False
    n_fps_proxy: int = 1000
    max_nR: int = 500


class DynamicsModule:
    """The rollout loop around a trained `DynamicsPredictor` (on the device
    the rollout runs on)."""

    def __init__(self, model: DynamicsPredictor, cfg: RolloutConfig):
        self.model = model
        self.cfg = cfg

    @torch.inference_mode()
    def step(self, fps_pos_history, eef_pos_history, eef_delta, all_pos, all_quat):
        """One dynamics step and the skinning.

        fps_pos_history (n_his, n_proxy, 3) proxy history, eef_pos_history
        (n_his, n_tool, 3), eef_delta (n_tool, 3); all_pos / all_quat the
        full Gaussian set. Returns (new all_pos, new all_quat, bones
        (max_nobj, 3) zeroed where masked, bone mask (max_nobj,))."""
        cfg = self.cfg
        n_proxy, n_tool = fps_pos_history.shape[1], eef_pos_history.shape[1]
        N = cfg.max_nobj + n_tool
        dev = fps_pos_history.device

        proxy = fps_pos_history[-1]
        n1 = min(cfg.max_nobj, n_proxy)
        fps1 = farthest_point_sampling(proxy, n1, start_idx=0)
        idx2, keep = fps_rad_idx(proxy[fps1], cfg.fps_radius, max_samples=n1)
        fps_idx = fps1[idx2]
        keep_f = keep[:, None].to(torch.float32)

        states = proxy.new_zeros((cfg.n_his, N, 3))
        states[:, :cfg.max_nobj] = fps_pos_history[:, fps_idx] * keep_f[None]
        states[:, cfg.max_nobj:] = eef_pos_history
        states_delta = proxy.new_zeros((N, 3))
        states_delta[cfg.max_nobj:] = eef_delta
        attrs = proxy.new_zeros((N, 2))
        attrs[:cfg.max_nobj, 0] = keep_f[:, 0]
        attrs[cfg.max_nobj:, 1] = 1.0
        ones = torch.ones(n_tool, dtype=torch.bool, device=dev)
        state_mask = torch.cat([keep, ones])
        tool_mask = torch.cat([torch.zeros(cfg.max_nobj, dtype=torch.bool, device=dev), ones])

        Rr, Rs = construct_edges(states[-1], cfg.adj_thresh, state_mask, tool_mask,
                                 n_obj=cfg.max_nobj, topk=cfg.topk, max_nR=cfg.max_nR,
                                 connect_all=cfg.connect_all)
        pred, _ = self.model(states[None], attrs[None], Rr[None], Rs[None],
                             keep_f[None], states_delta[None])
        pred = pred[0]

        bones = states[-1, :cfg.max_nobj]
        motions = (pred - bones) * keep_f
        relations = relations_to_matrix(Rr, Rs, cfg.max_nobj)
        new_pos, new_quat, _ = interpolate_motions(bones, motions, relations, all_pos,
                                                   quat=all_quat, bone_mask=keep)
        return new_pos, new_quat, pred * keep_f, keep

    @torch.inference_mode()
    def rollout(self, xyz_0: torch.Tensor, quat_0: torch.Tensor, eef_xyz: np.ndarray,
                n_steps: int, inlier_idx: Optional[np.ndarray] = None) -> dict:
        """Autoregressive rollout of the Gaussians ``xyz_0`` (n, 3) /
        ``quat_0`` (n, 4) under the end-effector path ``eef_xyz`` (n_steps,
        n_tool, 3). The proxy is an FPS of the ``inlier_idx`` Gaussians.
        Returns numpy trajectories: xyz (n_steps, n, 3), quat, xyz_bones
        (n_steps, max_nobj, 3) and eef (n_steps, n_tool, 3)."""
        cfg = self.cfg
        dev = xyz_0.device
        if inlier_idx is None:
            inlier_idx = np.arange(xyz_0.shape[0])
        inlier = torch.as_tensor(inlier_idx, device=dev)

        fps_all_idx = farthest_point_sampling(
            xyz_0[inlier], min(cfg.n_fps_proxy, len(inlier_idx)), start_idx=0)
        proxy = xyz_0[inlier][fps_all_idx]
        fps_hist = proxy[None].repeat(cfg.n_his, 1, 1)
        eef_hist = torch.as_tensor(eef_xyz[0], device=dev)[None].repeat(cfg.n_his, 1, 1)

        all_pos, all_quat = xyz_0, quat_0
        eef_pos = np.asarray(eef_xyz[0])
        xyz_out = [xyz_0.cpu().numpy()]
        quat_out = [quat_0.cpu().numpy()]
        bones_out = [np.zeros((cfg.max_nobj, 3), np.float32)]
        eef_out = [eef_pos]

        for i in range(1, n_steps):
            delta = np.asarray(eef_xyz[i]) - eef_pos
            if np.linalg.norm(delta) < cfg.dist_thresh:
                xyz_out.append(xyz_out[-1])
                quat_out.append(quat_out[-1])
                bones_out.append(bones_out[-1])
                eef_out.append(eef_out[-1])
                continue

            all_pos, all_quat, bones, _ = self.step(
                fps_hist, eef_hist, torch.as_tensor(delta, device=dev), all_pos, all_quat)
            proxy = all_pos[inlier][fps_all_idx]
            fps_hist = torch.cat([fps_hist[1:], proxy[None]], 0)
            eef_pos = np.asarray(eef_xyz[i])
            eef_hist = torch.cat([eef_hist[1:], torch.as_tensor(eef_pos, device=dev)[None]], 0)
            xyz_out.append(all_pos.cpu().numpy())
            quat_out.append(all_quat.cpu().numpy())
            bones_out.append(bones.cpu().numpy())
            eef_out.append(eef_pos)

        return {"xyz": np.stack(xyz_out), "quat": np.stack(quat_out),
                "xyz_bones": np.stack(bones_out), "eef": np.stack(eef_out)}


def smooth_trajectory(traj: dict) -> dict:
    """Replace the frames between change points (where nothing moved) by a
    linear interpolation toward the next change point, renormalising the
    quaternions (numpy, f32)."""
    xyz = traj["xyz"]
    moved = np.linalg.norm(np.diff(xyz, axis=0), axis=-1).sum(-1) > 0
    change = np.concatenate([[0], np.nonzero(moved)[0] + 1])
    out = {k: v.copy().astype(np.float32) for k, v in traj.items()}
    for a, b in zip(change[:-1], change[1:]):
        if b - a < 2:
            continue
        t = np.linspace(0, 1, b - a + 1, dtype=np.float32)[:-1]
        for v in out.values():
            v[a:b] = v[a] + (v[b] - v[a]) * t.reshape((len(t),) + (1,) * (v.ndim - 1))
    q = out["quat"]
    out["quat"] = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    return out
