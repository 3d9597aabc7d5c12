"""Device milliseconds of GNS's radius graph (the ``gns.graph`` span of
`GNS.forward`: the cell list, the candidates' distances, the packing and
its one host read), from CUDA events at the span's ends, the mean over the
traced window's ``train.step`` roots. None where the program has no such
span."""

from perfbench.spans import mean, roots


def read(trace):
    return mean(r["spans"].get("gns.graph", {}).get("device_ms")
                for r in roots(trace, "train.step"))
