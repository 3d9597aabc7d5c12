"""Device milliseconds a tracking iteration of the compositor's kernels
(`fwd_kernel`, `bwd_kernel` of kernels/composite.py, by name), from the
profiler over the traced window."""

import re

PATTERN = re.compile(r"\b(fwd|bwd)_kernel\b")


def read(trace):
    n = trace["counters"].get("iterations")
    ms = sum(e - s for name, s, e in trace["kernels"] if PATTERN.search(name)) / 1e3
    if not n or not ms:
        return None
    return ms / n
