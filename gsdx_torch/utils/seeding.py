"""Deterministic seeding (counterpart of `gsdx/utils/seeding.py`).

Seeds the Python and numpy RNGs that host-side pipelines use (camera
schedules, dataset shuffles) and returns a `torch.Generator` where gsdx
returns a root PRNG key.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed `random` and `numpy.random`; returns a CPU generator seeded
    with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
