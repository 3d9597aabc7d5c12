"""Device milliseconds of GNS's processor in the forward (the
``gns.process`` span of `GNS.forward`: the message-passing blocks'
gathers, edge and node MLPs and receiver sums), from CUDA events at the
span's ends, the mean over the traced window's ``train.step`` roots. None
where the program has no such span."""

from perfbench.spans import mean, roots


def read(trace):
    return mean(r["spans"].get("gns.process", {}).get("device_ms")
                for r in roots(trace, "train.step"))
