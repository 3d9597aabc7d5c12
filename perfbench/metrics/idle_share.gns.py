"""Share of the wall time in which no kernel ran on the device, in the GNS
training cell: the union of the profiler's kernel intervals a step over the
wall seconds a step of the untraced window the traced run makes first
(`metrics_common.idle_share`)."""

from perfbench.metrics_common import idle_share


def read(trace):
    return idle_share(trace)
