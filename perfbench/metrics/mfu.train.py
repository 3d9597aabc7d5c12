"""The whole train step's share of the card's bf16 peak: the network's
operations a sample at the configuration's published shapes
(`perfbench.flops`), times 3 (forward and backward) times the n_future
unrolled steps, times the samples the window trained, over the window's
seconds times 989 TFLOP/s: the untraced window the traced run makes first,
since the profiler slows the host. The peak is bf16 whatever the program
computes in, so a move off f32 shows as a gain."""

from perfbench.flops import PEAK_BF16_FLOP_S


def read(trace):
    plain = trace["plain"]
    c = plain["counters"]
    if not c.get("samples") or not plain["wall_s"]:
        return None
    return 100.0 * c["samples"] * c["sample_step_flops"] / (plain["wall_s"] * PEAK_BF16_FLOP_S)
