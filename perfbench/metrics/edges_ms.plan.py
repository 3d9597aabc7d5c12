"""Device milliseconds of the radius graph a MPPI iteration: the
``edges_kernel`` intervals of the traced window (`gsdx_torch/csrc/edges.cu`,
one launch a push step) over the window's iterations. None where the trace
holds no such kernel (a program that builds its graph otherwise). No span
is read: CUDA events at the ends of ``graph.edges`` would also time the
host's launch work, on a device the push loop leaves idle."""

import re

PATTERN = re.compile(r"\bedges_kernel")


def read(trace):
    times = [e - s for name, s, e in trace["kernels"] if PATTERN.search(name)]
    if not times or not trace["units"]:
        return None
    return sum(times) / 1e3 / trace["units"]
