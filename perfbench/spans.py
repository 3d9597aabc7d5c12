"""The port's spans (`gsdx_torch.utils.profiling`) as the per-layer readers
take them: the roots of one name that the traced window completed."""


def roots(trace, name):
    """The last ``trace["units"]`` roots named ``name`` that no exception
    cut (the window's close cuts the one running then), oldest first: one a
    unit of the window, so that a window the profiler took again counts
    once. Empty where the program records no spans or the window holds
    fewer such roots than units."""
    from gsdx_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    n = trace["units"]
    if snapshot is None or not n:
        return []
    done = [r for r in snapshot()["roots"].get(name, []) if not r["cut"]]
    return done[-n:] if len(done) >= n else []


def mean(values):
    """The mean, or None where a value is missing (no device time on the
    CPU) or there is none."""
    values = list(values)
    if not values or any(v is None for v in values):
        return None
    return sum(values) / len(values)
