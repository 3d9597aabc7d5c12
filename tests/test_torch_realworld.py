"""The port's hardware stack against gsdx's (mirrors tests/test_realworld.py):
shared-memory IPC, timestamp alignment, capture processes, and `RealEnv`'s
observations and robot choreography on static sources and a fake arm.

Every process join takes its own timeout and the test asserts the process
ended (the suite runs without pytest-timeout).
"""

import multiprocessing as mp
import time
from multiprocessing.managers import SharedMemoryManager
from queue import Empty, Full

import numpy as np
import pytest

from gsdx.realworld import cameras as j_cameras
from gsdx.realworld import real_env as j_real_env
from gsdx.realworld import robot as j_robot
from gsdx.realworld import timestamps as j_ts
from gsdx_torch.realworld import cameras as t_cameras
from gsdx_torch.realworld import real_env as t_real_env
from gsdx_torch.realworld import robot as t_robot
from gsdx_torch.realworld import timestamps as t_ts
from gsdx_torch.realworld.shared_memory import (
    SharedAtomicCounter,
    SharedMemoryQueue,
    SharedMemoryRingBuffer,
)

JOIN_S = 20.0


@pytest.fixture
def shm():
    m = SharedMemoryManager()
    m.start()
    yield m
    m.shutdown()


def test_atomic_counter(shm):
    c = SharedAtomicCounter(shm)
    assert c.load() == 0
    c.add(5)
    assert c.add(3) == 5  # fetch-add returns the value before
    assert c.load() == 8
    c.store(42)
    assert c.load() == 42


def _worker_add(counter, n):
    for _ in range(n):
        counter.add(1)


def test_atomic_counter_cross_process(shm):
    c = SharedAtomicCounter(shm)
    procs = [mp.Process(target=_worker_add, args=(c, 500)) for _ in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
        assert not p.is_alive() and p.exitcode == 0
    assert c.load() == 2000  # lock-free increments must not be lost


def test_ring_buffer_filo(shm):
    rb = SharedMemoryRingBuffer.create_from_examples(
        shm, {"x": np.zeros((4,), np.float32), "t": 0.0},
        get_max_k=4, get_time_budget=0.2, put_desired_frequency=1000)
    for i in range(10):
        rb.put({"x": np.full((4,), i, np.float32), "t": float(i)})
    assert rb.get()["x"][0] == 9.0
    np.testing.assert_array_equal(rb.get_last_k(3)["x"][:, 0], [7, 8, 9])
    assert rb.count == 10


def test_ring_buffer_wraparound_and_overrun(shm):
    rb = SharedMemoryRingBuffer.create_from_examples(
        shm, {"x": 0.0}, get_max_k=3, get_time_budget=0.001, put_desired_frequency=2000)
    n = rb.buffer_size + 2  # force a wrap
    for i in range(n):
        rb.put({"x": float(i)})
    np.testing.assert_array_equal(rb.get_last_k(3)["x"], [n - 3, n - 2, n - 1])
    # a writer that laps the reader's window within the time budget, without
    # waiting, is refused once readers are live
    fast = SharedMemoryRingBuffer.create_from_examples(
        shm, {"x": 0.0}, get_max_k=2, get_time_budget=5.0, put_desired_frequency=1)
    fast.ready_for_get = True
    with pytest.raises(TimeoutError):
        for i in range(fast.buffer_size + 1):
            fast.put({"x": float(i)}, wait=False)


def test_queue_fifo(shm):
    q = SharedMemoryQueue.create_from_examples(shm, {"cmd": 0, "value": 0.0}, buffer_size=4)
    assert q.empty()
    with pytest.raises(Empty):
        q.get()
    for i in range(4):
        q.put({"cmd": i, "value": i * 0.5})
    with pytest.raises(Full):
        q.put({"cmd": 9, "value": 9.0})
    assert q.get()["cmd"] == 0
    np.testing.assert_array_equal(q.get_all()["cmd"], [1, 2, 3])
    assert q.empty()


def test_timestamp_binning_equals_gsdx(rng):
    for _ in range(5):
        ts = np.sort(rng.uniform(-0.2, 3.0, size=40)).tolist()
        dt = float(rng.uniform(0.03, 0.2))
        for nxt, neg in ((0, False), (None, False), (2, True)):
            assert (t_ts.get_accumulate_timestamp_idxs(ts, 0.0, dt, next_global_idx=nxt,
                                                       allow_negative=neg)
                    == j_ts.get_accumulate_timestamp_idxs(ts, 0.0, dt, next_global_idx=nxt,
                                                          allow_negative=neg))
        targets = list(range(3, 3 + int(rng.integers(1, 60))))
        assert (t_ts.align_timestamps(ts, targets, 0.0, dt)
                == j_ts.align_timestamps(ts, targets, 0.0, dt))
    # a late frame fills every elapsed bin
    assert t_ts.get_accumulate_timestamp_idxs([0.55], 0.0, 0.1)[:2] == ([0] * 6, list(range(6)))


def test_obs_and_action_accumulators_equal_gsdx(rng):
    accs = [(t_ts.TimestampObsAccumulator(0.0, 0.1), t_ts.TimestampActionAccumulator(0.0, 0.1)),
            (j_ts.TimestampObsAccumulator(0.0, 0.1), j_ts.TimestampActionAccumulator(0.0, 0.1))]
    t0 = 0.0
    for _ in range(6):  # past the first 128-slot allocation: realloc doubling
        ts = t0 + np.sort(rng.uniform(0, 5.0, size=30))
        t0 = ts[-1]
        v = rng.normal(size=(30, 2)).astype(np.float32)
        for obs, act in accs:
            obs.put({"v": v}, ts)
            act.put_actions(v, ts)
    (to, ta), (jo, ja) = accs
    assert len(to) == len(jo) > 128
    np.testing.assert_array_equal(to.data["v"], jo.data["v"])
    np.testing.assert_array_equal(to.timestamps, jo.timestamps)
    np.testing.assert_array_equal(ta.actions, ja.actions)
    acc = t_ts.TimestampObsAccumulator(start_time=0.0, dt=0.1)
    acc.put({"v": np.arange(5, dtype=np.float32)}, np.array([0.05, 0.15, 0.25, 0.27, 0.55]))
    np.testing.assert_array_equal(acc.data["v"], [0, 1, 2, 4, 4, 4])


def test_camera_process_puts_frames_and_joins():
    rig = t_cameras.MultiCamera([t_cameras.SyntheticSource(width=64, height=48, fps=60)],
                                put_fps=30)
    try:
        rig.start()
        time.sleep(0.5)
        obs = rig.get()
        assert obs[0]["color"].shape == (48, 64, 3)
        assert obs[0]["depth"].shape == (48, 64)
        assert rig.cameras[0].ring_buffer.count > 3
        last = rig.get(k=3)[0]["camera_capture_timestamp"]
        assert np.all(np.diff(last) > 0)
        assert rig.get_intrinsics()[0].shape == (3, 3)
    finally:
        rig.stop()
    assert not rig.cameras[0].is_alive() and rig.cameras[0].exitcode == 0


def test_gated_sdks_name_their_package():
    with pytest.raises(ImportError, match="pyrealsense2"):
        t_cameras.RealSenseSource("000")
    with pytest.raises(ImportError, match="xarm"):
        t_robot.XArm7("10.0.0.1")


# ----------------------------------------------------------------- RealEnv


def _views(rng, n=2, h=48, w=64):
    colors = [rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8) for _ in range(n)]
    depths = [rng.integers(300, 2000, size=(h, w), dtype=np.uint16) for _ in range(n)]
    ks = [np.array([[50.0 + i, 0, w / 2], [0, 51.0, h / 2], [0, 0, 1]], np.float32)
          for i in range(n)]
    return colors, depths, ks


def _calib(env, rng):
    from scipy.spatial.transform import Rotation

    env.R_base2world = Rotation.from_rotvec(rng.normal(size=3) * 0.3).as_matrix()
    env.t_base2world = rng.normal(size=3) * 0.1
    env.R_cam2world = [np.eye(3), Rotation.from_rotvec([0.1, 0.2, 0.0]).as_matrix()]
    env.t_cam2world = [np.zeros(3), np.array([0.1, 0.0, 0.5])]


def test_real_env_get_obs_equals_gsdx(rng):
    colors, depths, ks = _views(rng)
    out = []
    for cams, renv in ((t_cameras, t_real_env), (j_cameras, j_real_env)):
        kw = {"device": "cpu"} if renv is t_real_env else {}
        env = renv.RealEnv([cams.StaticImageSource(c, d, k, fps=60)
                            for c, d, k in zip(colors, depths, ks)],
                           capture_fps=30, obs_fps=30, **kw)
        try:
            env.start()
            time.sleep(0.4)
            out.append((env.get_obs(get_color=True, get_depth=True), env.get_intrinsics()))
        finally:
            env.stop()
        assert not any(c.is_alive() for c in env.cameras.cameras)
    (ot, kt), (oj, kj) = out
    for key in ("color", "depth", "pose"):
        np.testing.assert_array_equal(ot[key], oj[key])
    assert ot["color"].shape == (2, 48, 64, 3) and ot["depth"].dtype == np.uint16
    np.testing.assert_array_equal(np.stack(kt), np.stack(kj))


def _recording_arm(mod):
    arm = mod.FakeArm()
    calls = []
    orig = arm.set_position

    def set_position(pose, wait=True):
        calls.append(np.asarray(pose, np.float64).copy())
        orig(pose, wait)

    arm.set_position = set_position
    arm.grip = []
    arm.open_gripper = lambda: arm.grip.append(("open", len(calls)))
    arm.close_gripper = lambda: arm.grip.append(("close", len(calls)))
    return arm, calls


@pytest.mark.parametrize("gripper", [False, True])
@pytest.mark.parametrize("decoded", [True, False])
def test_real_env_step_issues_gsdx_poses(rng, gripper, decoded):
    colors, depths, ks = _views(rng)
    action = (np.array([0.32, 0.04, 0.41, 0.09]) if decoded
              else np.array([0.32, 0.04, 0.7, 6.0]))
    seed = int(rng.integers(1 << 30))
    got = []
    for cams, renv, rob in ((t_cameras, t_real_env, t_robot),
                            (j_cameras, j_real_env, j_robot)):
        arm, calls = _recording_arm(rob)
        kw = {"device": "cpu"} if renv is t_real_env else {}
        env = renv.RealEnv([cams.StaticImageSource(c, d, k)
                            for c, d, k in zip(colors, depths, ks)], arm=arm, **kw)
        try:
            _calib(env, np.random.default_rng(seed))
            (env.step_gripper if gripper else env.step)(action, decoded=decoded)
            eef = env.get_eef_points()
        finally:
            env.cameras.shm_manager.shutdown()  # cameras never started
        got.append((np.stack(calls), arm.grip, eef))
    (ct, gt, et), (cj, gj, ej) = got
    assert len(ct) == (7 if gripper else 6)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-9)
    assert gt == gj
    np.testing.assert_allclose(et, ej, atol=1e-6)


def test_real_env_refuses_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_real_env.RealEnv([t_cameras.SyntheticSource(width=8, height=8)])
