"""Host reads a MPPI iteration (`profiling.host_read`: each a wait for the
device), from the spans of the traced window's ``plan.iteration`` roots:
the count of their ``read.*`` spans, the mean over the iterations."""

from perfbench.spans import mean, roots


def read(trace):
    return mean(sum(s["count"] for name, s in r["spans"].items() if name.startswith("read."))
                for r in roots(trace, "plan.iteration"))
