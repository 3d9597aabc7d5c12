"""Robot arm interface: xArm7 wrapper + fake arm (the port's own copy of
`gsdx/realworld/robot.py`).

Interface of the reference `XARM7` (`src/real_world/utils/xarm_wrapper.py:
8-170`): position-mode motion, gripper open/close, liveness tracking via
error callbacks. The real backend gates on the xArm SDK; `FakeArm` applies
commanded poses instantly for robotless loops.
"""

from __future__ import annotations

import time

import numpy as np

INIT_POSE = np.array([250.0, 0.0, 450.0, 180.0, 0.0, 0.0])  # mm / deg


class Arm:
    alive: bool = True

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def get_position(self) -> np.ndarray:
        """(6,) [x, y, z, roll, pitch, yaw] in mm/deg."""
        raise NotImplementedError

    def set_position(self, pose: np.ndarray, wait: bool = True) -> None: ...

    def open_gripper(self) -> None: ...

    def close_gripper(self) -> None: ...

    def reset(self) -> None: ...


class FakeArm(Arm):
    def __init__(self, latency_s: float = 0.0):
        self.pose = INIT_POSE.copy()
        self.gripper_open = True
        self.latency_s = latency_s
        self.alive = True

    def start(self):
        self.alive = True

    def stop(self):
        self.alive = False

    def get_position(self):
        return self.pose.copy()

    def set_position(self, pose, wait: bool = True):
        assert self.alive, "robot marked dead"
        if self.latency_s and wait:
            time.sleep(self.latency_s)
        self.pose = np.asarray(pose, np.float64).copy()

    def open_gripper(self):
        self.gripper_open = True

    def close_gripper(self):
        self.gripper_open = False

    def reset(self):
        self.set_position(INIT_POSE)


class XArm7(Arm):
    """Real xArm7 over TCP (requires the `xarm` SDK)."""

    def __init__(self, ip: str):
        try:
            from xarm.wrapper import XArmAPI  # gate on SDK availability
        except ImportError as e:
            raise ImportError("XArm7 needs the xArm Python SDK (package `xarm`, "
                              "xArm-Python-SDK); use FakeArm without a robot") from e

        self.ip = ip
        self._api_cls = XArmAPI
        self.arm = None
        self.alive = False

    def start(self):
        arm = self._api_cls(self.ip)
        arm.motion_enable(enable=True)
        arm.set_mode(0)
        arm.set_state(state=0)
        arm.register_error_warn_changed_callback(self._error_cb)
        arm.register_state_changed_callback(self._state_cb)
        self.arm = arm
        self.alive = True
        self.reset()

    def _error_cb(self, data):
        if data and data.get("error_code", 0) != 0:
            self.alive = False

    def _state_cb(self, data):
        if data and data.get("state", 0) == 4:
            self.alive = False

    def stop(self):
        if self.arm is not None:
            self.arm.disconnect()
        self.alive = False

    def get_position(self):
        assert self.alive
        code, pos = self.arm.get_position()
        assert code == 0
        return np.asarray(pos, np.float64)

    def set_position(self, pose, wait: bool = True):
        assert self.alive
        code = self.arm.set_position(*np.asarray(pose).tolist(), wait=wait)
        assert code == 0

    def open_gripper(self):
        self.arm.set_gripper_position(800, wait=True)

    def close_gripper(self):
        self.arm.set_gripper_position(0, wait=True)

    def reset(self):
        self.set_position(INIT_POSE)
