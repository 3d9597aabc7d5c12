"""Device milliseconds of a GNS train step (the ``train.step`` span of
`make_train_step`'s step: the one-step loss with its radius graph, the
backward, Adam), from CUDA events at the span's ends, the mean over the
traced window's steps."""

from perfbench.spans import mean, roots


def read(trace):
    return mean(r["device_ms"] for r in roots(trace, "train.step"))
