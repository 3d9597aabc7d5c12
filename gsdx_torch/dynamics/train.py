"""GNN dynamics training (counterpart of `gsdx/dynamics/train.py`).

For now the config alone: the training loop is a later slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple


class TrainConfig(NamedTuple):
    """Mirrors the train_config yaml block."""

    batch_size: int = 16
    n_epochs: int = 1000
    n_iters_per_epoch_train: int = 100
    n_iters_per_epoch_valid: int = 10
    lr: float = 1e-3
    n_his: int = 3
    n_future: int = 5
    mse_weight: float = 1.0
    length_weight: float = 0.01
    rigid_weight: float = 0.0  # 0.05 when train_config['rigid_loss'] is set
    random_seed: int = 42
    log_interval: int = 10
    out_dir: str = "log/run"
    dist_thresh: float = 0.01
