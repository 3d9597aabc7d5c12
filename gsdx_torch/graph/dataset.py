"""Graph dataset (counterpart of `gsdx/graph/dataset.py`).

For now the config alone: `GraphSampler` and `EpisodeStore` are a later
slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple


class GraphDatasetConfig(NamedTuple):
    """Mirrors the dataset_config yaml block."""

    n_his: int = 3
    n_future: int = 5
    max_nobj: int = 100
    max_tool: int = 1
    max_nR: int = 500
    fps_radius_range: tuple = (0.03, 0.03)
    adj_radius_range: tuple = (0.08, 0.08)
    state_noise_train: float = 0.003
    state_noise_valid: float = 0.0
    topk: int = 5
    connect_all: bool = False
