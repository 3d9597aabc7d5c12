"""Camera capture processes over the shared-memory ring buffer (the port's
own copy of `gsdx/realworld/cameras.py`).

Re-designs the reference RealSense stack (`src/real_world/camera/
single_realsense.py:25-446`, `multi_realsense.py:9-180`) around a pluggable
frame source so the same process/IPC machinery runs with real hardware
(pyrealsense2, if present) or a synthetic/replay source for robotless
operation and tests — the fake backend the reference lacks (SURVEY.md §4).

Each camera runs one `mp.Process` that pulls frames from its source, bins
timestamps to the requested put frequency, and writes into a lock-free
SharedMemoryRingBuffer. Commands (exposure, record flags, ...) arrive via a
SharedMemoryQueue. A source error triggers restart (the reference
hardware-resets the device, `single_realsense.py:316-323`).

The capture processes fork from the caller, which on the card already holds
a CUDA context; so this module and what it imports are numpy only, and a
capture process never touches torch or CUDA.
"""

from __future__ import annotations

import multiprocessing as mp
import time
from multiprocessing.managers import SharedMemoryManager
from typing import Dict, List, Optional

import numpy as np

from gsdx_torch.realworld.shared_memory import (
    SharedMemoryQueue,
    SharedMemoryRingBuffer,
)
from gsdx_torch.realworld.timestamps import get_accumulate_timestamp_idxs


class FrameSource:
    """Interface a camera backend implements."""

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def get_frame(self) -> Dict[str, np.ndarray]:
        """Blocking: returns {color (H,W,3) u8, depth (H,W) u16 mm,
        timestamp float}."""
        raise NotImplementedError

    def get_intrinsics(self) -> np.ndarray: ...


class SyntheticSource(FrameSource):
    """Deterministic synthetic frames for tests/demos: a colored square
    moving across the image with a flat depth plane."""

    def __init__(self, width=640, height=480, fps=30, seed=0):
        self.width, self.height, self.fps = width, height, fps
        self.t0 = None
        self.seed = seed

    def start(self):
        self.t0 = time.monotonic()

    def stop(self):
        pass

    def get_intrinsics(self) -> np.ndarray:
        f = 0.75 * self.width
        return np.array([[f, 0, self.width / 2], [0, f, self.height / 2],
                         [0, 0, 1]], np.float32)

    def get_frame(self):
        time.sleep(1.0 / self.fps)
        t = time.monotonic()
        color = np.zeros((self.height, self.width, 3), np.uint8)
        x = int((np.sin(t) * 0.4 + 0.5) * self.width)
        color[:, max(0, x - 20):x + 20] = (0, 200, 50)
        depth = np.full((self.height, self.width), 1000, np.uint16)
        return {"color": color, "depth": depth, "timestamp": t}


class StaticImageSource(FrameSource):
    """Serves a fixed (color, depth) frame — replayed captures, calibration
    board shots, golden scenes."""

    def __init__(self, color: np.ndarray, depth: np.ndarray | None = None,
                 k: np.ndarray | None = None, fps: int = 30):
        self.color = np.ascontiguousarray(color, np.uint8)
        h, w = self.color.shape[:2]
        self.height, self.width = h, w
        self.depth = (np.full((h, w), 1000, np.uint16) if depth is None
                      else np.ascontiguousarray(depth, np.uint16))
        f = 0.75 * w
        self.k = (np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                           np.float32) if k is None else np.asarray(k, np.float32))
        self.fps = fps

    def start(self):
        pass

    def stop(self):
        pass

    def get_intrinsics(self) -> np.ndarray:
        return self.k

    def get_frame(self):
        time.sleep(1.0 / self.fps)
        return {"color": self.color.copy(), "depth": self.depth.copy(),
                "timestamp": time.monotonic()}


class RealSenseSource(FrameSource):
    """librealsense-backed source (only if pyrealsense2 is installed)."""

    def __init__(self, serial_number: str, width=640, height=480, fps=30):
        try:
            import pyrealsense2 as rs  # noqa: F401 — gate at construction
        except ImportError as e:
            raise ImportError("RealSenseSource needs pyrealsense2 (Intel's "
                              "librealsense Python bindings); use StaticImageSource "
                              "or SyntheticSource without cameras") from e

        self.serial = serial_number
        self.width, self.height, self.fps = width, height, fps
        self.pipeline = None

    def start(self):
        import pyrealsense2 as rs

        cfg = rs.config()
        cfg.enable_device(self.serial)
        cfg.enable_stream(rs.stream.color, self.width, self.height,
                          rs.format.rgb8, self.fps)
        cfg.enable_stream(rs.stream.depth, self.width, self.height,
                          rs.format.z16, self.fps)
        self.pipeline = rs.pipeline()
        self.profile = self.pipeline.start(cfg)
        self.align = rs.align(rs.stream.color)

    def stop(self):
        if self.pipeline is not None:
            self.pipeline.stop()

    def get_intrinsics(self):
        intr = (self.profile.get_stream(__import__("pyrealsense2").stream.color)
                .as_video_stream_profile().get_intrinsics())
        return np.array([[intr.fx, 0, intr.ppx], [0, intr.fy, intr.ppy],
                         [0, 0, 1]], np.float32)

    def get_frame(self):
        import pyrealsense2 as rs

        frames = self.align.process(self.pipeline.wait_for_frames())
        color = np.asarray(frames.get_color_frame().get_data())
        depth = np.asarray(frames.get_depth_frame().get_data())
        ts = frames.get_timestamp() / 1000.0
        return {"color": color, "depth": depth, "timestamp": ts}


class CameraProcess(mp.Process):
    """One capture process writing into a ring buffer
    (`SingleRealsense`, `single_realsense.py:25-446`)."""

    def __init__(self, shm_manager: SharedMemoryManager, source: FrameSource,
                 name: str, put_fps: float = 15.0, get_max_k: int = 30,
                 max_restarts: int = 3):
        super().__init__(daemon=True)
        self.source = source
        self.cam_name = name
        self.put_fps = put_fps
        self.max_restarts = max_restarts
        example = {
            "color": np.zeros((source.height, source.width, 3), np.uint8),
            "depth": np.zeros((source.height, source.width), np.uint16),
            "timestamp": 0.0,
            "camera_capture_timestamp": 0.0,
        }
        self.ring_buffer = SharedMemoryRingBuffer.create_from_examples(
            shm_manager, example, get_max_k=get_max_k,
            get_time_budget=0.2, put_desired_frequency=put_fps,
        )
        self.stop_event = mp.Event()
        self.ready_event = mp.Event()

    def run(self):
        restarts = 0
        while not self.stop_event.is_set():
            try:
                self.source.start()
                put_idx = None
                start_time = time.monotonic()
                while not self.stop_event.is_set():
                    frame = self.source.get_frame()
                    ts = frame["timestamp"]
                    # put-frequency downsampling via timestamp bins
                    # (`single_realsense.py` put_downsample)
                    local_idxs, global_idxs, put_idx = (
                        get_accumulate_timestamp_idxs(
                            [ts], start_time, 1.0 / self.put_fps,
                            next_global_idx=put_idx,
                        )
                    )
                    for _ in global_idxs:
                        self.ring_buffer.put({
                            "color": frame["color"],
                            "depth": frame["depth"],
                            "timestamp": time.time(),
                            "camera_capture_timestamp": ts,
                        }, wait=False, serial_number=self.cam_name)
                    if not self.ready_event.is_set():
                        self.ring_buffer.ready_for_get = True
                        self.ready_event.set()
                break
            except Exception:
                # source failure -> restart (hardware reset analogue,
                # `single_realsense.py:316-323`)
                restarts += 1
                try:
                    self.source.stop()
                except Exception:
                    pass
                if restarts > self.max_restarts:
                    raise
                time.sleep(0.5)
        self.source.stop()

    def start_wait(self, timeout: float = 10.0):
        self.start()
        if not self.ready_event.wait(timeout):
            raise TimeoutError(f"camera {self.cam_name} failed to start")

    def stop(self):
        self.stop_event.set()
        self.join(timeout=5.0)

    def get(self, k: Optional[int] = None):
        if k is None:
            return self.ring_buffer.get()
        return self.ring_buffer.get_last_k(k)


class MultiCamera:
    """Dict-of-cameras facade (`MultiRealsense`, `multi_realsense.py:9-180`)."""

    def __init__(self, sources: List[FrameSource], put_fps: float = 15.0):
        self.shm_manager = SharedMemoryManager()
        self.shm_manager.start()
        self.cameras = [
            CameraProcess(self.shm_manager, src, name=f"cam_{i}",
                          put_fps=put_fps)
            for i, src in enumerate(sources)
        ]
        self.sources = sources

    @property
    def n_cameras(self) -> int:
        return len(self.cameras)

    def start(self):
        for c in self.cameras:
            c.start_wait()

    def stop(self):
        for c in self.cameras:
            c.stop()
        self.shm_manager.shutdown()

    def get(self, k: Optional[int] = None) -> Dict[int, dict]:
        return {i: c.get(k) for i, c in enumerate(self.cameras)}

    def get_intrinsics(self) -> List[np.ndarray]:
        return [s.get_intrinsics() for s in self.sources]
