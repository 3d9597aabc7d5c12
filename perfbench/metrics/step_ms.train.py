"""Device-clock milliseconds of a train step (`make_train_step`'s step: the
unroll, the backward, Adam), from CUDA events around each call in the
traced window, their mean."""


def read(trace):
    return trace["counters"].get("step_ms")
