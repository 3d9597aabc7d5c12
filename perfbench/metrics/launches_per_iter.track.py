"""Device kernels a tracking iteration, from the profiler: every kernel in
the traced window over the iterations the window completed (a count of the
host's dispatch work)."""


def read(trace):
    n = trace["counters"].get("iterations")
    if not n or not trace["kernels"]:
        return None
    return len(trace["kernels"]) / n
