"""Arithmetic several per-layer readers share."""


def idle_share(trace):
    """Percent of the wall time in which no kernel ran on the device: the
    traced window's busy seconds a unit of work (an iteration, a step) over
    the untraced window's wall seconds a unit, since the profiler slows the
    host; None where the trace holds no kernel."""
    plain = trace["plain"]
    if not trace["kernels"] or not trace["units"] or not plain["units"]:
        return None
    return 100.0 * (1.0 - (trace["busy_s"] / trace["units"])
                    / (plain["wall_s"] / plain["units"]))
