"""Device milliseconds of a batch's assembly (the ``train.sample`` span of
`GraphSampler.sample`), from CUDA events at the span's ends, the mean over
the traced window's batches."""

from perfbench.spans import mean, roots


def read(trace):
    return mean(r["device_ms"] for r in roots(trace, "train.sample"))
