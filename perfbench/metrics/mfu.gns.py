"""The whole GNS train step's share of the card's bf16 peak: the forward
operations the window's graphs need, counted from their real nodes and
edges (`perfbench/flops_gns.py`), times 3 (forward and backward), over the
window's seconds times 989 TFLOP/s: the untraced window the traced run makes
first, since the profiler slows the host. The peak is bf16 whatever the
program computes in, as `mfu.train`."""

from perfbench.flops import PEAK_BF16_FLOP_S


def read(trace):
    plain = trace["plain"]
    c = plain["counters"]
    if not c.get("forward_flops") or not plain["wall_s"]:
        return None
    return 100.0 * 3 * c["forward_flops"] / (plain["wall_s"] * PEAK_BF16_FLOP_S)
