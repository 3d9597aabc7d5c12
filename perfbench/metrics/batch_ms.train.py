"""Device-clock milliseconds of a batch's assembly (`GraphSampler.sample`:
FPS, edges, augmentation), from CUDA events around each call in the traced
window, their mean."""


def read(trace):
    return trace["counters"].get("batch_ms")
