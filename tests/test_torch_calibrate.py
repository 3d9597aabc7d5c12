"""The port's calibration (`gsdx_torch/realworld/calibrate.py`, `RealEnv`'s
fixed-camera path) against gsdx's, on synthetic data (mirrors
tests/test_calibrate.py)."""

import time

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from gsdx.realworld import calibrate as jcal  # noqa: E402
from gsdx_torch.realworld import calibrate as tcal  # noqa: E402


def _board_image(px_per_m=2500):
    board, _ = tcal.make_charuco_board()
    sx, sy = board.getChessboardSize()
    sq = board.getSquareLength()
    return board, board.generateImage((int(sx * sq * px_per_m), int(sy * sq * px_per_m)))


def _rot(axis, deg):
    r, _ = cv2.Rodrigues(np.asarray(axis, np.float64) * np.deg2rad(deg))
    return r


def _hom(r, t):
    m = np.eye(4)
    m[:3, :3] = r
    m[:3, 3] = np.asarray(t).reshape(3)
    return m


def test_charuco_pose_self_consistent_and_equal_to_gsdx():
    board, img = _board_image()
    h, w = img.shape[:2]
    canvas = np.full((h + 200, w + 200), 255, np.uint8)
    canvas[100:100 + h, 100:100 + w] = img
    k = np.array([[1200.0, 0, canvas.shape[1] / 2],
                  [0, 1200.0, canvas.shape[0] / 2], [0, 0, 1]])
    rvec, tvec = tcal.detect_charuco_pose(canvas, k, board=board)
    detector = cv2.aruco.CharucoDetector(board)
    corners, ids, _, _ = detector.detectBoard(canvas)
    proj, _ = cv2.projectPoints(board.getChessboardCorners()[ids.reshape(-1)],
                                rvec, tvec, k, np.zeros(5))
    assert np.abs(proj.reshape(-1, 2) - corners.reshape(-1, 2)).max() < 1.0
    rj, tj = jcal.detect_charuco_pose(canvas, k, board=board)
    np.testing.assert_array_equal(rvec, rj)  # the same OpenCV calls
    np.testing.assert_array_equal(tvec, tj)
    assert tcal.detect_charuco_pose(np.full_like(canvas, 255), k, board=board) is None


def test_solve_hand_eye_equals_gsdx_and_recovers_truth(tmp_path):
    rng = np.random.default_rng(3)
    T_b2w = _hom(_rot([0, 0, 1], 30.0), [0.2, -0.1, 0.05])
    T_g2c = _hom(_rot([1, 0, 0], -15.0), [0.01, 0.03, -0.02])
    R_board2cam, t_board2cam, R_g2b, t_g2b = [], [], [], []
    for _ in range(8):
        ax = rng.normal(size=3)
        T_g2b_i = _hom(_rot(ax / np.linalg.norm(ax), rng.uniform(5, 60)),
                       rng.uniform(-0.3, 0.3, 3))
        T_w2c = T_g2c @ np.linalg.inv(T_g2b_i) @ np.linalg.inv(T_b2w)
        # measurement noise, so the least squares have something to do
        R_board2cam.append(_rot(rng.normal(size=3), 0.05) @ T_w2c[:3, :3])
        t_board2cam.append(T_w2c[:3, 3] + rng.normal(scale=1e-4, size=3))
        R_g2b.append(T_g2b_i[:3, :3])
        t_g2b.append(T_g2b_i[:3, 3])
    got = tcal.solve_hand_eye(R_board2cam, t_board2cam, R_g2b, t_g2b)
    want = jcal.solve_hand_eye(R_board2cam, t_board2cam, R_g2b, t_g2b)
    for key in want:  # the same float64 numpy on both sides
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["R_base2world"], T_b2w[:3, :3], atol=2e-3)
    np.testing.assert_allclose(got["t_base2world"], T_b2w[:3, 3], atol=2e-3)
    path = str(tmp_path / "hand_eye.pkl")
    tcal.save_calibration(path, got)
    back = jcal.load_calibration(path)  # the same pickle layout
    for key in got:
        np.testing.assert_array_equal(back[key], got[key])


def test_real_env_calibrate_fixed_cameras(tmp_path):
    from gsdx.realworld.real_env import RealEnv as JRealEnv
    from gsdx_torch.realworld.cameras import StaticImageSource
    from gsdx_torch.realworld.real_env import RealEnv
    from gsdx_torch.realworld.robot import FakeArm

    board, img = _board_image(px_per_m=1500)
    h, w = img.shape[:2]
    canvas = np.full((h + 120, w + 120), 255, np.uint8)
    canvas[60:60 + h, 60:60 + w] = img
    color = np.repeat(canvas[:, :, None], 3, axis=2)
    k = np.array([[900.0, 0, color.shape[1] / 2],
                  [0, 900.0, color.shape[0] / 2], [0, 0, 1]], np.float32)
    env = RealEnv([StaticImageSource(color, k=k, fps=60)], arm=FakeArm(),
                  capture_fps=30, obs_fps=30, device="cpu")
    try:
        env.start()
        time.sleep(0.4)
        R_c2w, t_c2w = env.calibrate_fixed_cameras(board=board)
    finally:
        env.stop()
    assert not env.cameras.cameras[0].is_alive()
    rvec, tvec = jcal.detect_charuco_pose(color, k, board=board)
    R_b2c, _ = cv2.Rodrigues(rvec)
    np.testing.assert_allclose(R_c2w[0], R_b2c.T, atol=1e-6)
    np.testing.assert_allclose(t_c2w[0], -R_b2c.T @ tvec, atol=1e-6)

    path = str(tmp_path / "calib.pkl")
    env.R_base2world = np.eye(3)
    env.t_base2world = np.zeros(3)
    env.save_calibration(path)
    from gsdx.realworld.cameras import StaticImageSource as JStatic

    env_j = JRealEnv([JStatic(color, k=k)])  # gsdx reads the port's file
    try:
        env_j.load_calibration(path)
    finally:
        env_j.cameras.shm_manager.shutdown()
    np.testing.assert_allclose(env_j.R_cam2world[0], R_c2w[0])
    np.testing.assert_allclose(env_j.t_cam2world[0], t_c2w[0])


def test_calibrate_cli_fake_env_equals_gsdx(tmp_path, monkeypatch):
    """`apps.calibrate --env fake`: the analytic extrinsics and intrinsics
    equal gsdx's files; `--construct_goal` perceives the simulated rope (the
    port's simulated environment at 80x60 to keep the CPU render short)."""
    from gsdx.apps import calibrate as japp
    from gsdx_torch.apps import calibrate as tapp
    from gsdx_torch.realworld import env as env_mod

    japp.main(["--env", "fake", "--calibrate", "--out", str(tmp_path / "j")])
    tapp.main(["--env", "fake", "--calibrate", "--device", "cpu", "--out", str(tmp_path / "t")])
    for name in ("R_list.npy", "t_list.npy", "intr_list.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / name),
                                      np.load(tmp_path / "j" / name), err_msg=name)

    orig = env_mod.FakeEnv
    monkeypatch.setattr(env_mod, "FakeEnv", lambda p, c, device="cuda": orig(
        p, c, env_mod.FakeEnvConfig(width=80, height=60), device=device))
    tapp.main(["--env", "fake", "--construct_goal", "--device", "cpu",
               "--out", str(tmp_path / "g")])
    goal = np.load(tmp_path / "g" / "target.npy")
    assert len(goal) > 10 and np.abs(goal.mean(0)[:2] - [0.3, 0.05]).max() < 0.05
    assert (tmp_path / "g" / "target.ply").stat().st_size > 0
    with pytest.raises(ImportError, match="pyrealsense2"):
        tapp.main(["--env", "real", "--calibrate", "--device", "cpu", "--serials", "1",
                   "--out", str(tmp_path / "r")])
