"""`make_train_step`, the one train step of the port's networks: cloth's
interaction network keeps its numbers and its operators, and GNS trains
through the same step.

cloth's step is held to the step as it stood before it took a loss of its
choice, written out inline: optax's Adam on `unrolled_loss`, its backward
and Adam's step. Two steps of a tiny cloth model (width 32, 20 objects, 120
relation slots, a 3-step unroll) on batches of a seeded store, one thread,
each way from the same start: the losses and the weights after them are
compared bit for bit, and the aten operators the first step issues
(forward, backward and Adam, listed by a dispatch mode) one by one: every
added host operator shows in cloth.train's host-bound step.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gsdx_torch.dynamics.model import DynamicsPredictor, ModelConfig
from gsdx_torch.dynamics.train import TrainConfig, make_train_step, unrolled_loss
from gsdx_torch.graph.dataset import EpisodeStore, GraphDatasetConfig, GraphSampler


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _cloth_store():
    rng = np.random.default_rng(7)
    T, P = 14, 60
    xyz = (rng.uniform(-0.1, 0.1, size=(1, P, 3))
           + np.cumsum(rng.normal(scale=0.003, size=(T, P, 3)), 0)).astype(np.float32)
    eef = np.zeros((T, 1, 3), np.float32)
    eef[:, 0, 0] = -0.12 + 0.006 * np.arange(T)
    rows = np.array([np.clip(np.arange(t - 2, t + 4), 0, T - 1) for t in range(T)])
    pairs = np.concatenate([np.zeros((T, 1), np.int64), rows], 1)
    return EpisodeStore.from_numpy([xyz], [eef], [pairs], device="cpu")


def _inline_step(model, cfg: TrainConfig):
    """The train step before it took a loss of its choice, without its
    spans (which issue no operator on the CPU)."""
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss, parts = unrolled_loss(model, batch, cfg)
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: torch.as_tensor(v).detach() for k, v in parts.items()}

    return step


def cloth_steps(make_step):
    """(losses, weights after, aten operators of the first step) of two
    tiny cloth train steps of ``make_step(model, cfg)``'s step."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        data = GraphDatasetConfig(n_his=3, n_future=3, max_nobj=20, max_tool=1, max_nR=120,
                                  fps_radius_range=(0.01, 0.03),
                                  adj_radius_range=(0.05, 0.09), topk=6, connect_all=True)
        sampler = GraphSampler(_cloth_store(), data, "train")
        g = torch.Generator().manual_seed(3)
        batches = [sampler.sample(g, 4) for _ in range(2)]
        cfg = ModelConfig(nf_particle=32, nf_relation=32, nf_effect=32, state_dim=1,
                          motion_dim=3)
        model = DynamicsPredictor(cfg, generator=torch.Generator().manual_seed(1))
        step = make_step(model, TrainConfig(n_future=3, lr=1e-3, length_weight=0.1))
        with _Ops() as ops:
            first, _ = step(batches[0])
        second, _ = step(batches[1])
        return [first, second], [p.detach().clone() for p in model.parameters()], ops.names
    finally:
        torch.set_num_threads(threads)


def test_cloth_step_keeps_its_numbers_and_operators():
    losses, weights, ops = cloth_steps(lambda model, cfg: make_train_step(model, cfg)[0])
    want_losses, want_weights, want_ops = cloth_steps(_inline_step)
    assert all(torch.equal(a, b) for a, b in zip(losses, want_losses)), (losses, want_losses)
    assert len(weights) == len(want_weights)
    assert all(torch.equal(a, b) for a, b in zip(weights, want_weights))
    assert ops == want_ops and len(ops) > 1000


def _gns_step():
    from gsdx_torch.dynamics.gns import GNS, GNSConfig, one_step_loss, statistics
    from gsdx_torch.graph.dataset import WindowSampler, window_rows

    g = torch.Generator().manual_seed(4)
    pos = 0.3 + 0.4 * torch.rand(1, 1, 200, 3, generator=g) + torch.cumsum(
        0.003 * torch.randn(2, 10, 200, 3, generator=g), 1)
    sampler = WindowSampler(EpisodeStore(pos, pos.new_zeros(2, 10, 0, 3),
                                         window_rows(2, 10, 7, "cpu")),
                            torch.full((200,), 5), 6.7e-4)
    cfg = GNSConfig(message_passing_steps=2, connectivity_radius=0.1)
    model = GNS(cfg, generator=torch.Generator().manual_seed(5))
    model.set_statistics(statistics(pos, cfg.noise_std))
    step, _, _ = make_train_step(model, TrainConfig(lr=1e-4), one_step_loss)
    return model, step, sampler.sample(g, 2)


def _cloth_step():
    data = GraphDatasetConfig(n_his=3, n_future=3, max_nobj=20, max_tool=1, max_nR=120, topk=6,
                              connect_all=True)
    sampler = GraphSampler(_cloth_store(), data, "train")
    model = DynamicsPredictor(ModelConfig(nf_particle=32, nf_relation=32, nf_effect=32,
                                          state_dim=1, motion_dim=3))
    step, _, _ = make_train_step(model, TrainConfig(n_future=3))
    return model, step, sampler.sample(torch.Generator().manual_seed(0), 4)


@pytest.mark.parametrize("network", ["interaction", "gns"])
def test_make_train_step_runs_both_networks(network):
    """One step of each network: its loss through the same spans, every
    weight moved by the same Adam."""
    from gsdx_torch.utils import profiling

    model, step, batch = (_cloth_step if network == "interaction" else _gns_step)()
    before = [p.detach().clone() for p in model.parameters()]
    profiling.reset()
    profiling.enable()
    try:
        loss, parts = step(batch)
        root = profiling.snapshot()["roots"]["train.step"][-1]
    finally:
        profiling.disable()
        profiling.reset()
    assert torch.isfinite(loss) and "mse" in parts
    assert {"train.unroll", "train.backward", "train.adam"} <= set(root["spans"])
    assert all(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
