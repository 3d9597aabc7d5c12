"""Kernel #3's share of its roofline in a planning cell: the least time the
card needs for the GNN steps the window's samples need (each sample's own
repeat count, at the configuration's published shapes, `perfbench.flops`),
over the device time of the port's GNN kernels (`gnn_*_kernel`) in the
trace. Work the program does past a sample's own repeat count is not
counted."""

import re

from perfbench.flops import bound_s

PATTERN = re.compile(r"\bgnn_\w+_kernel")


def read(trace):
    c = trace["counters"]
    gnn_s = sum(e - s for name, s, e in trace["kernels"] if PATTERN.search(name)) / 1e6
    if not gnn_s or not c.get("needed_sample_pushes"):
        return None
    n = c["needed_sample_pushes"]
    return 100.0 * bound_s(n * c["step_flops"], n * c["step_bytes"]) / gnn_s
