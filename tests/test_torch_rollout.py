"""gsdx_torch.rollout (skinning, dynamics_module) against gsdx.rollout on
the CPU, at small widths, and `tests/test_rollout.py`'s cases on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gsdx.dynamics.model import DynamicsPredictor as JModel
from gsdx.dynamics.model import ModelConfig as JModelConfig
from gsdx.dynamics.train import TrainConfig as JTrainConfig
from gsdx.dynamics.train import init_params as j_init_params
from gsdx.graph.dataset import GraphDatasetConfig as JDataConfig
from gsdx.rollout import dynamics_module as jdm
from gsdx.rollout import skinning as jsk
from gsdx_torch.core.transforms import quat_to_rotmat
from gsdx_torch.dynamics.model import (FORWARDS, DynamicsPredictor, ModelConfig,
                                       load_flax_params, reset_forwards)
from gsdx_torch.rollout import dynamics_module as tdm
from gsdx_torch.rollout import skinning as tsk

torch.set_num_threads(min(2, torch.get_num_threads()))

T = torch.from_numpy


def unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_relations_to_matrix_exact(rng):
    N, nR = 12, 40
    Rr = np.zeros((nR, N), np.float32)
    Rs = np.zeros((nR, N), np.float32)
    for e in range(30):  # 10 empty slots, some sender-only rows
        Rr[e, rng.integers(N)] = 1
        Rs[e, rng.integers(N)] = 1
    Rs[33, 4] = 1
    for n in (N, 8):
        np.testing.assert_array_equal(tsk.relations_to_matrix(T(Rr), T(Rs), n).numpy(),
                                      np.asarray(jsk.relations_to_matrix(Rr, Rs, n)))


def test_interpolate_motions_matches_on_well_conditioned_bones(rng):
    """Bones with many non-colinear neighbours (rank-3 F): positions and
    quaternions within 1e-5, with and without a bone mask."""
    nb, n = 24, 300
    bones = rng.normal(size=(nb, 3)).astype(np.float32) * 0.1
    motions = rng.normal(size=(nb, 3)).astype(np.float32) * 0.01
    rel = (rng.uniform(size=(nb, nb)) > 0.4).astype(np.float32)
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    quat = unit_quats(rng, n)
    mask = rng.uniform(size=nb) > 0.2
    fn = jax.jit(jsk.interpolate_motions)
    for m in (None, mask):
        out_t = tsk.interpolate_motions(T(bones), T(motions), T(rel), T(xyz), quat=T(quat),
                                        bone_mask=None if m is None else T(m))
        out_j = fn(bones, motions, rel, xyz, quat=quat, bone_mask=m)
        for a, b in zip(out_t, out_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def skin(bones, motions, rel, xyz, quat=None, mask=None):
    return tsk.interpolate_motions(T(bones), T(motions), T(rel), T(xyz),
                                   quat=None if quat is None else T(quat),
                                   bone_mask=None if mask is None else T(mask))


def test_skinning_pure_translation(rng):
    bones = rng.normal(size=(12, 3)).astype(np.float32)
    delta = np.array([0.1, -0.2, 0.3], np.float32)
    rel = np.ones((12, 12), np.float32) - np.eye(12, dtype=np.float32)
    xyz = rng.normal(size=(200, 3)).astype(np.float32)
    quat = np.tile(np.array([1.0, 0, 0, 0], np.float32), (200, 1))
    new_xyz, new_quat, w = skin(bones, np.tile(delta, (12, 1)), rel, xyz, quat)
    np.testing.assert_allclose(new_xyz.numpy(), xyz + delta, atol=1e-4)
    np.testing.assert_allclose(np.abs(new_quat[:, 0].numpy()), 1.0, atol=1e-4)
    np.testing.assert_allclose(w.sum(1).numpy(), 1.0, atol=1e-5)


def test_skinning_pure_rotation(rng):
    theta = 0.3
    R = np.array([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                  [0, 0, 1]], np.float32)
    bones = rng.normal(size=(16, 3)).astype(np.float32)
    rel = np.ones((16, 16), np.float32) - np.eye(16, dtype=np.float32)
    xyz = rng.normal(size=(100, 3)).astype(np.float32) * 0.5
    quat = np.tile(np.array([1.0, 0, 0, 0], np.float32), (100, 1))
    new_xyz, new_quat, _ = skin(bones, bones @ R.T - bones, rel, xyz, quat)
    np.testing.assert_allclose(new_xyz.numpy(), xyz @ R.T, atol=5e-2)
    np.testing.assert_allclose(quat_to_rotmat(new_quat)[0].numpy(), R, atol=1e-2)


def test_skinning_masked_bones_ignored(rng):
    bones = rng.normal(size=(8, 3)).astype(np.float32)
    motions = np.zeros((8, 3), np.float32)
    motions[4:] = 100.0  # masked bones have absurd motion
    mask = np.arange(8) < 4
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    new_xyz, _, _ = skin(bones, motions, np.ones((8, 8), np.float32), xyz, mask=mask)
    np.testing.assert_allclose(new_xyz.numpy(), xyz, atol=1e-3)


MODEL = dict(nf_particle=32, nf_relation=32, nf_effect=32, n_his=2)
ROLL = dict(n_his=2, max_nobj=16, n_fps_proxy=32, max_nR=96, topk=3, dist_thresh=0.01,
            fps_radius=0.02, adj_thresh=0.5)


def modules():
    cfg = JModelConfig(**MODEL)
    params = j_init_params(JModel(cfg), JTrainConfig(n_his=2),
                           JDataConfig(n_his=2, max_nobj=16, max_nR=96, topk=3),
                           jax.random.PRNGKey(0))
    tm = load_flax_params(DynamicsPredictor(ModelConfig(**MODEL)), jax.device_get(params))
    return (jdm.DynamicsModule(cfg, params, jdm.RolloutConfig(**ROLL)),
            tdm.DynamicsModule(tm.eval(), tdm.RolloutConfig(**ROLL)))


def test_rollout_skips_static_eef(rng):
    _, dm = modules()
    xyz0 = T(rng.normal(size=(64, 3)).astype(np.float32) * 0.1)
    quat0 = torch.tensor([1.0, 0, 0, 0]).repeat(64, 1)
    eef = np.zeros((6, 1, 3), np.float32)
    eef[3:] += 0.05  # only step 3 moves
    traj = dm.rollout(xyz0, quat0, eef, n_steps=6)
    assert traj["xyz"].shape == (6, 64, 3)
    assert np.isfinite(traj["xyz"]).all() and np.isfinite(traj["quat"]).all()
    np.testing.assert_array_equal(traj["xyz"][1], traj["xyz"][0])
    np.testing.assert_array_equal(traj["xyz"][2], traj["xyz"][1])
    assert not np.array_equal(traj["xyz"][3], traj["xyz"][2])
    np.testing.assert_array_equal(traj["xyz"][5], traj["xyz"][4])
    smoothed = tdm.smooth_trajectory(traj)
    assert smoothed["xyz"].shape == traj["xyz"].shape
    assert not np.array_equal(smoothed["xyz"][1], smoothed["xyz"][0])


def test_rollout_matches_gsdx(rng):
    """Six steps (one static) with the same flax weights: positions within
    1e-5 m, quaternions within 1e-5, bones within 1e-5 m; then the
    smoothing equal. The module's forwards take one-hot rows."""
    jm, tm = modules()
    n = 120
    xyz0 = (rng.normal(size=(n, 3)) * 0.08).astype(np.float32)
    quat0 = unit_quats(rng, n)
    eef = np.zeros((6, 1, 3), np.float32)
    eef[:, 0, 0] = -0.1 + 0.02 * np.array([0, 1, 2, 2, 3, 4])
    inliers = np.sort(rng.choice(n, 100, replace=False))
    ref = jm.rollout(jnp.asarray(xyz0), jnp.asarray(quat0), eef, 6, inlier_idx=inliers)
    reset_forwards()
    out = tm.rollout(T(xyz0), T(quat0), eef, 6, inlier_idx=inliers)
    assert FORWARDS["one_hot"] > 0 and FORWARDS["indexed"] == 0
    assert not np.array_equal(out["xyz"][-1], xyz0)
    for k in ("xyz", "quat", "xyz_bones", "eef"):
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-5, err_msg=k)
    sm_t, sm_j = tdm.smooth_trajectory(ref), jdm.smooth_trajectory(ref)
    for k in sm_j:
        np.testing.assert_array_equal(sm_t[k], sm_j[k])


def test_rollout_runs_in_inference_mode(rng, monkeypatch):
    """The step and the rollout record no autograd graph."""
    _, dm = modules()
    seen = []
    forward = dm.model.forward

    def spy(*a, **k):
        seen.append(torch.is_inference_mode_enabled())
        return forward(*a, **k)

    monkeypatch.setattr(dm.model, "forward", spy)
    xyz0 = T(rng.normal(size=(40, 3)).astype(np.float32) * 0.1)
    eef = np.zeros((3, 1, 3), np.float32)
    eef[1:, 0, 0] = [0.03, 0.06]
    traj = dm.rollout(xyz0, torch.tensor([1.0, 0, 0, 0]).repeat(40, 1), eef, 3)
    assert seen == [True, True] and np.isfinite(traj["xyz"]).all()
