"""Spans and the profiler exporter of the port (the counterpart
of `gsdx/utils/profiling.py`, whose timer `span` replaces).

`span(name, device=None)` marks a stretch of host code. While the recorder
is off it costs a flag check and returns one shared no-op object. It is on
between `enable()` and `disable()`, and by itself while a `torch.profiler`
session records: each span then also opens a profiler range of its name, so
that it lies on the profiler's timeline beside the kernels it launched. A
span with no open span around it is a root; the recorder keeps, for each
root, the count, host milliseconds, host self milliseconds (less its child
spans), milliseconds waited in `host_read` and device milliseconds of each
span name under it, and the last `KEEP` roots of each name. A span given a
CUDA ``device`` records a CUDA event on the device's current stream at
each end; the events are read in `snapshot()`, never inside the span, so no
span synchronises. A root left by an exception is marked ``cut``.

`host_read(site, tensor)` is the one way a device value reaches the host on
the planning and training paths: ``tensor.tolist()``, in a span
``read.<site>`` while the recorder is on, so a root's spans count its host
reads. The recorder follows one thread, as the port's paths run on one.

`trace_to(log_dir)` writes a `torch.profiler` trace of the host, the device
and the spans as one Chrome trace (open it in Perfetto or
chrome://tracing).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

KEEP = 4096  # roots kept of each name

# A profiler range that the profiler lists as a host operator and not as a
# user annotation: an annotation is mirrored on the device's timeline as an
# event of its own, which a reader of the trace's kernels would count.
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None)

_on = False
_stack: list = []
_roots: dict = {}  # root name -> deque of its last KEEP closed roots
_devices: set = set()  # CUDA devices with events to read
_ids = itertools.count()
_clock = time.perf_counter_ns


def enable() -> None:
    """Record spans without a profiler session."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Root:
    __slots__ = ("id", "name", "cut", "host_ns", "self_ns", "wait_ns", "device_ms",
                 "spans", "events")

    def __init__(self, name: str):
        self.id, self.name, self.cut = next(_ids), name, False
        self.host_ns = self.self_ns = self.wait_ns = 0
        self.device_ms = None
        self.spans = {}  # name -> [count, host_ns, self_ns, wait_ns, device_ms]
        self.events = []  # (span name, None for the root itself; start; end)


_streams: dict = {}  # (device index, stream id) -> torch.cuda.Stream


def _event(device: torch.device):
    """A CUDA event recorded on ``device``'s current stream. The stream is
    looked up by its id: building its Python object takes most of an
    event's host time."""
    key = (device.index, torch._C._cuda_getCurrentStream(device.index)[0])
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream(device)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Span:
    __slots__ = ("name", "device", "read", "parent", "root", "t0", "child_ns", "wait_ns",
                 "start", "range")

    def __init__(self, name: str, device, read: bool = False):
        self.name = name
        if device is not None and device.type != "cuda":
            device = None
        elif device is not None and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.read = read

    def __enter__(self):
        self.parent = _stack[-1] if _stack else None
        self.root = _Root(self.name) if self.parent is None else self.parent.root
        self.range = None
        if _autograd_profiler._is_profiler_enabled and _Range is not None:
            self.range = _Range(self.name)
            self.range.__enter__()
        self.start = _event(self.device) if self.device is not None else None
        self.child_ns = self.wait_ns = 0
        _stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        ns = _clock() - self.t0
        _stack.pop()
        if self.start is not None:
            end = _event(self.device)
            _devices.add(self.device)
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        if self.read:
            self.wait_ns = ns
            for s in _stack:
                s.wait_ns += ns
        root = self.root
        if self.parent is None:
            root.host_ns, root.self_ns, root.wait_ns = ns, ns - self.child_ns, self.wait_ns
            root.cut = exc_type is not None
            if self.start is not None:
                root.events.append((None, self.start, end))
            if root.name not in _roots:
                _roots[root.name] = collections.deque(maxlen=KEEP)
            _roots[root.name].append(root)
            return False
        self.parent.child_ns += ns
        agg = root.spans.get(self.name)
        if agg is None:
            agg = root.spans[self.name] = [0, 0, 0, 0, None]
        agg[0] += 1
        agg[1] += ns
        agg[2] += ns - self.child_ns
        agg[3] += self.wait_ns
        if self.start is not None:
            root.events.append((self.name, self.start, end))
        return False


def span(name: str, device: torch.device | None = None):
    """``with span("plan.cost"): ...``; with a CUDA ``device`` the span also
    times the device's current stream between its ends."""
    if _on or _autograd_profiler._is_profiler_enabled:
        return _Span(name, device)
    return OFF


def host_read(site: str, tensor: torch.Tensor):
    """``tensor.tolist()``; while the recorder is on, in a span
    ``read.<site>`` whose time counts as waited in every span around it."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return tensor.tolist()
    with _Span("read." + site, None, read=True):
        return tensor.tolist()


def _ms(ns: int) -> float:
    return ns / 1e6


def snapshot() -> dict:
    """Plain dicts: ``roots`` (root name -> its kept roots, oldest first,
    each {"id", "name", "cut", "host_ms", "self_ms", "wait_ms",
    "device_ms", "spans": {name: {"count", "host_ms", "self_ms",
    "wait_ms", "device_ms"}}}; ``device_ms`` None where no event was
    recorded). Synchronises the devices once to read the events."""
    for device in _devices:
        torch.cuda.synchronize(device)
    _devices.clear()
    roots = {}
    for name, kept in _roots.items():
        out = []
        for r in kept:
            for span_name, start, end in r.events:
                ms = start.elapsed_time(end)
                if span_name is None:
                    r.device_ms = (r.device_ms or 0.0) + ms
                else:
                    agg = r.spans[span_name]
                    agg[4] = (agg[4] or 0.0) + ms
            r.events = []
            out.append({"id": r.id, "name": r.name, "cut": r.cut, "host_ms": _ms(r.host_ns),
                        "self_ms": _ms(r.self_ns), "wait_ms": _ms(r.wait_ns),
                        "device_ms": r.device_ms,
                        "spans": {n: {"count": a[0], "host_ms": _ms(a[1]), "self_ms": _ms(a[2]),
                                      "wait_ms": _ms(a[3]), "device_ms": a[4]}
                                  for n, a in r.spans.items()}})
        roots[name] = out
    return {"roots": roots}


def reset() -> None:
    """Forget the kept roots."""
    _roots.clear()


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Capture a host and device profile, spans included: ``with
    trace_to("trace"): step()`` writes ``log_dir``/trace.json (the device's
    activity where CUDA is available)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
