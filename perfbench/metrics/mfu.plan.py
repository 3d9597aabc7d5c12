"""The whole MPPI iteration's share of the card's bf16 peak in a planning
cell: the operations of the GNN steps the window's samples need, at the
configuration's published shapes (`perfbench.flops`), over the window's
seconds times 989 TFLOP/s. Both from the untraced window the traced run
makes first: the profiler slows the host."""

from perfbench.flops import PEAK_BF16_FLOP_S


def read(trace):
    plain = trace["plain"]
    c = plain["counters"]
    if not c.get("needed_sample_pushes") or not plain["wall_s"]:
        return None
    return 100.0 * c["needed_sample_pushes"] * c["step_flops"] / (
        plain["wall_s"] * PEAK_BF16_FLOP_S)
