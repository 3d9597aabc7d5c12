"""Timestamp binning and obs/action accumulation (the port's own copy of
`gsdx/realworld/timestamps.py`; reference `src/real_world/camera/utils.py:6-222`).

Timestamps are binned into fixed-dt global indices anchored at start_time;
dropped frames repeat into their bins so multi-source streams align.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np


def get_accumulate_timestamp_idxs(
    timestamps: List[float],
    start_time: float,
    dt: float,
    eps: float = 1e-5,
    next_global_idx: Optional[int] = 0,
    allow_negative: bool = False,
) -> Tuple[List[int], List[int], Optional[int]]:
    """For each timestamp, the global index is floor((t - start_time) / dt).

    Returns (local_idxs, global_idxs, next_global_idx): pairs selecting which
    timestamps fill which global bins, repeating on drops — exact semantics
    of `get_accumulate_timestamp_idxs` (`camera/utils.py:6-46`).
    """
    local_idxs, global_idxs = [], []
    for local_idx, ts in enumerate(timestamps):
        global_idx = math.floor((ts - start_time) / dt + eps)
        if (not allow_negative) and (global_idx < 0):
            continue
        if next_global_idx is None:
            next_global_idx = global_idx
        for gi in range(next_global_idx, global_idx + 1):
            local_idxs.append(local_idx)
            global_idxs.append(gi)
            next_global_idx = gi + 1
    return local_idxs, global_idxs, next_global_idx


def align_timestamps(timestamps: List[float], target_global_idxs: List[int],
                     start_time: float, dt: float, eps: float = 1e-5):
    """Select one source timestamp per target global index
    (`camera/utils.py:49-72`)."""
    if isinstance(target_global_idxs, np.ndarray):
        target_global_idxs = target_global_idxs.tolist()
    assert len(target_global_idxs) > 0

    local_idxs, global_idxs, _ = get_accumulate_timestamp_idxs(
        timestamps=timestamps,
        start_time=start_time,
        dt=dt,
        eps=eps,
        next_global_idx=target_global_idxs[0],
        allow_negative=True,
    )
    if len(global_idxs) > len(target_global_idxs):
        # more source bins than targets: clip
        local_idxs = local_idxs[: len(target_global_idxs)]
        global_idxs = global_idxs[: len(target_global_idxs)]
    for _ in range(len(target_global_idxs) - len(global_idxs)):
        # repeat last to pad
        local_idxs.append(len(timestamps) - 1)
        global_idxs.append(global_idxs[-1] + 1 if global_idxs else
                           target_global_idxs[0])
    assert len(local_idxs) == len(target_global_idxs)
    return local_idxs


class TimestampObsAccumulator:
    """Accumulate dict-of-array observations into global time bins with
    realloc-doubling storage (`camera/utils.py:75-152`)."""

    def __init__(self, start_time: float, dt: float, eps: float = 1e-5):
        self.start_time = start_time
        self.dt = dt
        self.eps = eps
        self.obs_buffer = {}
        self.timestamp_buffer = None
        self.next_global_idx = 0

    def __len__(self):
        return self.next_global_idx

    @property
    def data(self):
        if self.timestamp_buffer is None:
            return {}
        return {k: v[: len(self)] for k, v in self.obs_buffer.items()}

    @property
    def timestamps(self):
        if self.timestamp_buffer is None:
            return np.array([])
        return self.timestamp_buffer[: len(self)]

    def put(self, data: dict, timestamps: np.ndarray):
        local_idxs, global_idxs, self.next_global_idx = (
            get_accumulate_timestamp_idxs(
                list(timestamps), self.start_time, self.dt, self.eps,
                self.next_global_idx,
            )
        )
        if len(global_idxs) == 0:
            return
        if self.timestamp_buffer is None:
            self.obs_buffer = {
                k: np.zeros((128,) + v.shape[1:], dtype=v.dtype)
                for k, v in data.items()
            }
            self.timestamp_buffer = np.zeros((128,), np.float64)
        needed = global_idxs[-1] + 1
        while needed > len(self.timestamp_buffer):
            new_size = len(self.timestamp_buffer) * 2
            self.obs_buffer = {
                k: np.resize(v, (new_size,) + v.shape[1:])
                for k, v in self.obs_buffer.items()
            }
            self.timestamp_buffer = np.resize(self.timestamp_buffer, new_size)
        for k, v in self.obs_buffer.items():
            v[global_idxs] = data[k][local_idxs]
        self.timestamp_buffer[global_idxs] = np.asarray(timestamps)[local_idxs]


class TimestampActionAccumulator(TimestampObsAccumulator):
    """Action variant — same binning over (action, timestamp) pairs
    (`camera/utils.py:155-222`)."""

    @property
    def actions(self):
        if self.timestamp_buffer is None:
            return np.array([])
        return self.obs_buffer["action"][: len(self)]

    def put_actions(self, actions: np.ndarray, timestamps: np.ndarray):
        self.put({"action": np.asarray(actions)}, timestamps)
