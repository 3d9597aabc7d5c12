"""The traced window: `torch.profiler` over one window of a cell, reduced to
what the per-layer readers and the result line take.

Kernel intervals give the busy time (their union) and the device time by
kernel name; the host's operator events name what the host was doing in each
gap between kernels. A profiler session can drop kernels (seen on this card:
1-2 of 30, at times a third), which would overstate the idle time, so the
kernels it saw are checked against the port's own launch counters, and a
session that missed any is taken again (at most ``attempts`` times).
"""

from __future__ import annotations

import bisect
import re
import sys
import time

SHORT_GAP_US = 20.0  # gaps shorter than this are launch spacing, pooled
TOP = 10


def _events(prof):
    """(kernels, host ops): lists of (name, start_us, end_us)."""
    from torch.autograd import DeviceType

    kernels, host = [], []
    for e in prof.events():
        tr = e.time_range
        row = (e.name, float(tr.start), float(tr.end))
        if e.device_type == DeviceType.CUDA:
            kernels.append(row)
        elif e.device_type == DeviceType.CPU:
            host.append(row)
    kernels.sort(key=lambda k: k[1])
    host.sort(key=lambda k: k[1])
    return kernels, host


def busy_union(kernels) -> tuple[float, list]:
    """Seconds covered by the union of kernel intervals, and the gaps
    between them as (start_us, end_us)."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for _, s, e in kernels:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6, gaps


def _host_at(host, starts, t_us: float, lookback: int = 400) -> str:
    """The innermost host operator running at ``t_us``: the latest-started
    one that still covers it, runtime calls (cuda*) only where no operator
    does."""
    i = bisect.bisect_right(starts, t_us)
    runtime = None
    for j in range(i - 1, max(-1, i - 1 - lookback), -1):
        name, s, e = host[j]
        if e >= t_us:
            if name.startswith("cuda"):
                runtime = runtime or name
                continue
            return name
    return runtime or "host outside any operator"


def breakdown(kernels, host, gaps) -> dict:
    by_kernel: dict[str, float] = {}
    for name, s, e in kernels:
        by_kernel[name] = by_kernel.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP]
    starts = [h[1] for h in host]
    idle: dict[str, float] = {}
    for s, e in gaps:
        key = (f"gaps under {SHORT_GAP_US:g} us" if e - s < SHORT_GAP_US
               else _host_at(host, starts, 0.5 * (s + e)))
        idle[key] = idle.get(key, 0.0) + (e - s) / 1e6
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:120], v] for n, v in ops],
            "idle_gaps": [[n[:120], v] for n, v in gaps_top]}


def missed_launches(kernels, expected: dict) -> dict:
    """{pattern: (launched, seen)} for every pattern whose kernels the trace
    holds fewer of than the port's counters launched."""
    out = {}
    for pattern, launched in expected.items():
        seen = sum(1 for k in kernels if re.search(pattern, k[0]))
        if seen < launched:
            out[pattern] = (launched, seen)
    return out


def traced_window(cell, seconds: float, device, attempts: int = 3):
    """Run ``cell.window(seconds)`` under the profiler. Returns (the window's
    record, {"kernels", "busy_s", "window_s", "breakdown"})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    missed = {}
    for _ in range(attempts):
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            record = cell.window(seconds)
            torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
        kernels, host = _events(prof)
        missed = missed_launches(kernels, record["counters"].get("kernel_launches", {}))
        if not missed:
            break
        print(f"perfbench: the profiler missed kernels {missed}; tracing again",
              file=sys.stderr)
    busy_s, gaps = busy_union(kernels)
    traced = {"kernels": kernels, "busy_s": busy_s, "window_s": window_s,
              "breakdown": breakdown(kernels, host, gaps)}
    if missed:
        traced["missed"] = {k: list(v) for k, v in missed.items()}
    return record, traced
