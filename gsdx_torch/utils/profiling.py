"""Timing and profiler hooks (counterpart of `gsdx/utils/profiling.py`).

A stats-accumulating timer for host-level stages, and a context manager
that records a `torch.profiler` trace of the host and the device, written
as a Chrome trace (open it in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


class Timer:
    """Accumulating named timer. Synchronise the device inside the timed
    region (`torch.cuda.synchronize()`) or device work will be
    under-counted."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot, cnt = self.totals[name], self.counts[name]
            lines.append(
                f"{name:30s} {tot:8.3f}s total  {tot / cnt * 1000:8.2f} ms/call"
                f"  x{cnt}"
            )
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


_GLOBAL_TIMER = Timer()


def timed(name: str):
    """Module-level convenience: `with timed("render"): ...`."""
    return _GLOBAL_TIMER(name)


def timing_summary() -> str:
    return _GLOBAL_TIMER.summary()


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Capture a host and device profile: `with trace_to("trace"): step()`
    writes ``log_dir``/trace.json (the device's activity where CUDA is
    available)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
