"""Data-parallel GNN training over the ranks of a mesh (counterpart of
`gsdx/dist/train_dp.py`).

Every rank holds the whole model and takes its contiguous rows of the
global batch; `DistributedDataParallel` all-reduces the gradients (their
mean over the ranks) during the backward, and every rank then takes the
same Adam step. The mean of the ranks' losses is the whole batch's loss, so
the step is gsdx's (and the single-device step's) up to the order of the
sums: the MSE and length terms are means over equal slices, and the rigid
term's normaliser, the batch's count of masked particles, is all-reduced
before the unroll.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from gsdx_torch.dist.mesh import Mesh, shard_rows
from gsdx_torch.dynamics.model import DynamicsPredictor
from gsdx_torch.dynamics.train import TrainConfig, unrolled_loss
from gsdx_torch.graph.dataset import GraphBatch

PARTS = ("mse", "length", "rigid")


def shard_batch(batch: GraphBatch, mesh: Mesh, axis: str = "data") -> GraphBatch:
    """This rank's contiguous rows of every field of a global batch; the
    batch size must divide over the axis."""
    rows = shard_rows(batch.state.shape[0], mesh, axis)
    return GraphBatch(**{f.name: getattr(batch, f.name)[rows]
                         for f in dataclasses.fields(batch)})


class _Unroll(torch.nn.Module):
    """The whole unroll as one forward, so that DDP sees one forward a
    step."""

    def __init__(self, model: DynamicsPredictor, cfg: TrainConfig):
        super().__init__()
        self.model = model
        self.cfg = cfg

    def forward(self, batch: GraphBatch, rigid_count):
        return unrolled_loss(self.model, batch, self.cfg, rigid_count=rigid_count)


def make_dp_train_step(model: DynamicsPredictor, cfg: TrainConfig, mesh: Mesh,
                       axis: str = "data"):
    """Returns (train_step, optimizer). ``train_step(local_batch)`` takes one
    Adam step (optax's `adam` settings, as `dynamics.train.make_train_step`)
    on ``model``'s weights, the same on every rank, and returns the global
    batch's (loss, {"mse", "length", "rigid"}), all-reduced and detached.
    DDP broadcasts the first rank's weights when it is made."""
    group, n = mesh.axis_groups[axis], mesh.shape[axis]
    ddp = DistributedDataParallel(_Unroll(model, cfg), process_group=group)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8)

    def train_step(local_batch: GraphBatch):
        rigid_count = None
        if cfg.rigid_weight > 0:
            total = local_batch.obj_mask.sum().to(torch.float32)
            dist.all_reduce(total, group=group)
            rigid_count = total / n
        optimizer.zero_grad(set_to_none=True)
        loss, parts = ddp(local_batch, rigid_count)
        loss.backward()
        optimizer.step()
        stats = torch.stack([loss.detach()] + [
            torch.as_tensor(parts[k], dtype=loss.dtype, device=loss.device).detach()
            for k in PARTS])
        dist.all_reduce(stats, group=group)
        stats = stats / n
        return stats[0], dict(zip(PARTS, stats[1:]))

    return train_step, optimizer
