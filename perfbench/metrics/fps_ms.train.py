"""Device milliseconds of FPS in a batch's assembly (the ``kernels.fps``
spans, both launches, `kernels/fps.py`), from CUDA events at each span's
ends, the mean over the traced window's ``train.sample`` roots."""

from perfbench.spans import mean, roots


def read(trace):
    return mean(r["spans"].get("kernels.fps", {}).get("device_ms")
                for r in roots(trace, "train.sample"))
