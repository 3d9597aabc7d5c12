"""Host microseconds of a push step (a ``rollout.step`` span: edges, pads,
the GNN's check and launches, the advance) less its time waiting in host
reads, over the traced window's ``plan.iteration`` roots. A profiled host
time: the profiler's cost is per aten operator, so it stretches a step's
operators more than its Python and ctypes work, and the reading is not what
an untraced step costs."""

from perfbench.spans import roots


def read(trace):
    steps = [r["spans"].get("rollout.step") for r in roots(trace, "plan.iteration")]
    steps = [s for s in steps if s]
    n = sum(s["count"] for s in steps)
    if not n:
        return None
    return 1e3 * sum(s["host_ms"] - s["wait_ms"] for s in steps) / n
