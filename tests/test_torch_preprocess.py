"""gsdx_torch preprocessing (io/episodes, kernels/fps batched forms,
io/preprocess, apps/preprocess) against gsdx on the CPU, on the committed
tracked rope episode (copied to a temporary directory) and on seeded
synthetic inputs."""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdx.io import episodes as jep
from gsdx.io import preprocess as jprep
from gsdx.kernels.fps import farthest_point_sampling as j_fps
from gsdx.kernels.fps import fps_rad_idx as j_fps_rad
from gsdx_torch.io import episodes as tep
from gsdx_torch.io import preprocess as tprep
from gsdx_torch.kernels.fps import farthest_point_sampling_batch, fps_rad_idx_batch

torch.set_num_threads(min(2, torch.get_num_threads()))

REPO = os.path.join(os.path.dirname(__file__), "..")
EPISODE = os.path.join(REPO, "benchmarks", "out", "pipeline")


@pytest.fixture
def episode(tmp_path):
    """The committed episode's tracking output and raw data, copied."""
    out, data = tmp_path / "out", tmp_path / "data"
    shutil.copytree(os.path.join(EPISODE, "ckpts"), out)
    shutil.copytree(os.path.join(EPISODE, "data"), data)
    return str(data), str(out)


@pytest.mark.parametrize("seed,dist,n_his,n_future",
                         [(0, 0.005, 3, 3), (1, 0.01, 3, 5), (2, 0.02, 2, 4)])
def test_extract_pushes_equal(seed, dist, n_his, n_future):
    rng = np.random.default_rng(seed)
    # a pusher that pauses, moves in 2-12 mm steps, and pauses again
    steps = rng.uniform(0.002, 0.012, size=(40, 3)) * (rng.uniform(size=(40, 1)) > 0.3)
    eef = np.cumsum(steps, 0).astype(np.float32)[:, None]
    np.testing.assert_array_equal(tprep.extract_pushes(eef, dist, n_his, n_future),
                                  jprep.extract_pushes(eef, dist, n_his, n_future))


def test_frame_indices_and_median_outliers_equal(rng):
    meta = {"fn": [[f"camera_0/color_{7 * t + 3:06d}.jpg", f"camera_1/color_{t:06d}.jpg"]
                   for t in range(9)]}
    np.testing.assert_array_equal(tep.frame_indices_from_metadata(meta),
                                  jep.frame_indices_from_metadata(meta))
    for data in (rng.normal(size=200), np.r_[rng.normal(size=50), [40.0, -30.0]],
                 np.ones(10)):
        np.testing.assert_array_equal(tprep.median_outlier_mask(data),
                                      jprep.median_outlier_mask(data))


@pytest.mark.parametrize("P,n", [(64, 16), (300, 100)])
def test_batched_fps_equals_gsdx_rows(rng, P, n):
    B = 5
    pts = rng.normal(size=(B, P, 3)).astype(np.float32)
    pts[:, 5] = pts[:, 9]  # duplicated points: the first maximum must win
    starts = rng.integers(0, P, size=B)
    radius = rng.uniform(1.0, 2.0, size=B).astype(np.float32)
    idx_t = farthest_point_sampling_batch(torch.from_numpy(pts), n,
                                          start_idx=torch.from_numpy(starts))
    rad_t, keep_t = fps_rad_idx_batch(torch.from_numpy(pts), torch.from_numpy(radius), n)
    for b in range(B):
        ref = np.asarray(j_fps(jnp.asarray(pts[b]), n, start_idx=int(starts[b])))
        np.testing.assert_array_equal(idx_t[b].numpy(), ref)
        ref_i, ref_k = j_fps_rad(jnp.asarray(pts[b]), jnp.float32(radius[b]), n)
        np.testing.assert_array_equal(rad_t[b].numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(keep_t[b].numpy(), np.asarray(ref_k))
    assert keep_t.any(1).all() and not keep_t.all()  # the stop fired in some rows


@pytest.mark.parametrize("gripper_z", [0.17, 0.18])
def test_eef_world_positions_match(episode, gripper_z):
    data, out = episode
    meta = jep.load_metadata(os.path.join(out, "metadata.json"))
    np.testing.assert_allclose(tep.eef_world_positions(data, meta, gripper_z),
                               jep.eef_world_positions(data, meta, gripper_z),
                               rtol=0, atol=1e-6)


def test_eef_world_positions_pad_and_fallback(tmp_path):
    """An action log shorter than the frame numbers is padded at the front;
    an unreadable line falls back to the last."""
    lines = [json.dumps({"pose": [100.0 + 7 * t, 20.0, 50.0, 170.0, 5.0, 80.0 + t]})
             for t in range(7)]
    lines[4] = "not json"  # frame 5 after the padding of 3 lines
    (tmp_path / "actions.txt").write_text("\n".join(lines) + "\n")
    import pickle

    with open(tmp_path / "calibration_handeye_result.pkl", "wb") as f:
        pickle.dump({"R_base2world": np.eye(3)[[1, 0, 2]], "t_base2world": np.ones(3)}, f)
    meta = {"fn": [[f"camera_0/color_{n:06d}.jpg"] for n in (0, 2, 5, 8, 9)]}
    np.testing.assert_allclose(tep.eef_world_positions(str(tmp_path), meta),
                               jep.eef_world_positions(str(tmp_path), meta),
                               rtol=0, atol=1e-6)


def test_downsample_trajectories_match(rng):
    T, N = 6, 700
    xyz = rng.normal(size=(1, N, 3)).astype(np.float32) * 0.1
    drift = np.cumsum(rng.normal(scale=0.002, size=(T, N, 3)), 0).astype(np.float32)
    drift[:, :15] *= 40  # motion outliers
    params = {"means3D": xyz + drift,
              "logit_opacities": rng.normal(size=(N, 1)).astype(np.float32) + 1.0}
    out_t = tprep.downsample_trajectories(params, n_downsample=200, device="cpu")
    out_j = jprep.downsample_trajectories(params, n_downsample=200)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        tprep.downsample_trajectories(params, n_downsample=N, device="cpu")


def test_preprocess_episode_writes_what_gsdx_writes(episode, tmp_path):
    """The committed episode through both packages' `preprocess_episode`
    (the committed settings), each on its own copy: the same files, and the
    frame pairs equal the committed ones gsdx wrote."""
    data, out = episode
    out_j = str(tmp_path / "out_j")
    shutil.copytree(out, out_j)
    kw = dict(dist_thresh=0.005, n_his=3, n_future=3, episode_idx=0, n_downsample=1000)
    rows_t = tprep.preprocess_episode(data, out, str(tmp_path / "prep_t"), device="cpu", **kw)
    rows_j = jprep.preprocess_episode(data, out_j, str(tmp_path / "prep_j"), **kw)
    np.testing.assert_array_equal(rows_t, rows_j)
    for name in ("frame_pairs/0.txt", "metadata.txt"):
        with open(tmp_path / "prep_t" / name) as a, open(tmp_path / "prep_j" / name) as b:
            assert a.read() == b.read()
    np.testing.assert_allclose(np.load(os.path.join(out, "param_downsampled.npy")),
                               np.load(os.path.join(out_j, "param_downsampled.npy")),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        rows_t, np.loadtxt(os.path.join(EPISODE, "prep", "frame_pairs", "0.txt")).astype(int))


def test_preprocess_rejects_short_action_logs(episode):
    data, out = episode
    with open(os.path.join(data, "actions.txt"), "w") as f:
        f.write("{}\n")  # 1 line for 16 frames
    assert not tprep.test_validity(data, out)
    assert tprep.preprocess_episode(data, out, out, 0.005, 3, 3, device="cpu") is None
    with pytest.raises(ValueError):
        tprep.test_validity(data, os.path.dirname(out))


def test_preprocess_cli_on_the_cpu(episode, tmp_path, monkeypatch):
    """`python -m gsdx_torch.apps.preprocess` over a two-episode tree, from
    a working directory of its own, against gsdx's CLI on a copy."""
    from gsdx.apps import preprocess as japp
    from gsdx_torch.apps import preprocess as tapp

    data, out = episode
    trees = {}
    for which in ("t", "j"):
        base = tmp_path / which / "d3dg"
        for idx in (0, 1):
            ep = f"episode_{idx:02d}"
            shutil.copytree(data, base / "data" / "toy" / ep)
            shutil.copytree(out, base / "ckpts" / "exp_toy" / ep / "toy" / ep)
        cfg = tmp_path / which / "cfg.yaml"
        cfg.write_text("train_config:\n  dist_thresh: 0.005\n  n_his: 3\n  n_future: 3\n"
                       "dataset_config:\n  datasets:\n    - name: toy\n      base_dir: d3dg\n")
        trees[which] = cfg
    monkeypatch.chdir(tmp_path / "t")
    tapp.main(["--config", str(trees["t"]), "--device", "cpu"])
    monkeypatch.chdir(tmp_path / "j")
    japp.main(["--config", str(trees["j"])])
    for idx in (0, 1):
        ep = f"episode_{idx:02d}"
        got = [np.loadtxt(tmp_path / w / "d3dg" / "preprocessed" / "exp_toy" / ep
                          / "frame_pairs" / f"{idx}.txt") for w in ("t", "j")]
        np.testing.assert_array_equal(*got)
        down = [np.load(tmp_path / w / "d3dg" / "ckpts" / "exp_toy" / ep / "toy" / ep
                        / "param_downsampled.npy") for w in ("t", "j")]
        np.testing.assert_allclose(*down, rtol=0, atol=1e-6)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapp.main(["--config", str(trees["t"])])
