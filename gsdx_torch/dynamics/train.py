"""GNN dynamics training (counterpart of `gsdx/dynamics/train.py`).

A train step is the n_future-step autoregressive unroll (each prediction
fed back as the next step's object state, backpropagated through the
whole unroll), then one Adam step with optax's `adam` settings. Batches
come from `graph/dataset.py`'s `GraphSampler` on the same device; the
model and the length loss take their relations as the batch's index lists
(`recv`, `send`), so endpoints are gathered and messages summed by
receiver, not multiplied by one-hot rows. The products stay f32: nothing
in the slice enables TF32.

GNS (`dynamics/gns.py`) trains through the same step with its own loss
(`gns.one_step_loss`, on `WindowSampler` batches) and its decaying rate
(`gns.learning_rate`).
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from gsdx_torch.dynamics.gns import GNS, GNSConfig, learning_rate, one_step_loss, state_tree
from gsdx_torch.dynamics.model import DynamicsPredictor, ModelConfig, flax_tree, relations
from gsdx_torch.dynamics.utils import length_loss, mse_loss, rigid_loss
from gsdx_torch.graph.dataset import GraphBatch, GraphSampler, WindowSampler
from gsdx_torch.io.checkpoint import adam_state_tree, save_checkpoint
from gsdx_torch.utils.profiling import host_read, span


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


def unrolled_loss(model: DynamicsPredictor, batch: GraphBatch, cfg: TrainConfig,
                  rigid_count=None):
    """(total loss, {"mse", "length", "rigid"} sums) of the n_future-step
    unroll. Step 0 takes ``batch.action``; after step fi the predicted
    objects overwrite the object slots of ``tool_future[:, fi]``, the
    history shifts by one, and the next step takes ``action_future[:, fi]``.
    ``rigid_count`` is `rigid_loss`'s ``mask_count``."""
    state, action = batch.state, batch.action
    N, n_p = state.shape[2], batch.state_future.shape[2]
    # one graph for the whole unroll: its relations are built once
    recv, send = relations(batch.recv, N), relations(batch.send, N)
    recv_obj, send_obj = relations(batch.recv, n_p), relations(batch.send, n_p)
    total = 0.0
    parts = {"mse": 0.0, "length": 0.0, "rigid": 0.0}
    for fi in range(cfg.n_future):
        pred, _ = model(state, batch.attrs, recv, send, batch.p_instance, action)
        l_mse = mse_loss(pred, batch.state_future[:, fi])
        l_len = length_loss(pred, state, recv_obj, send_obj)
        step_loss = cfg.mse_weight * l_mse + cfg.length_weight * l_len
        parts["mse"] += l_mse
        parts["length"] += l_len
        if cfg.rigid_weight > 0:
            l_rig = rigid_loss(pred, state, batch.obj_mask, rigid_count)
            step_loss = step_loss + cfg.rigid_weight * l_rig
            parts["rigid"] += l_rig
        total = total + step_loss

        if fi < cfg.n_future - 1:
            nxt = torch.cat([pred, batch.tool_future[:, fi, n_p:]], 1)
            state = torch.cat([state[:, 1:], nxt[:, None]], 1)
            action = batch.action_future[:, fi]
    return total, parts


def make_train_step(model: torch.nn.Module, cfg: TrainConfig, loss_fn=unrolled_loss,
                    schedule=None):
    """Returns (train_step, eval_step, optimizer). ``train_step(batch)``
    takes one Adam step on ``loss_fn(model, batch, cfg)`` -> (loss, parts)
    (lr from the config, then ``schedule(k)`` after k steps where one is
    given; betas 0.9 / 0.999, eps 1e-8 outside the square root: optax's
    `adam`) and returns the detached (loss, parts);
    ``eval_step(batch)`` the loss without gradients. A train step is a span
    ``train.step`` timed on the device, holding ``train.unroll`` (the loss),
    ``train.backward`` and ``train.adam``."""
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    device = next(model.parameters()).device
    steps = [0]

    def train_step(batch):
        with span("train.step", device):
            with span("train.unroll"):
                optimizer.zero_grad(set_to_none=True)
                loss, parts = loss_fn(model, batch, cfg)
            with span("train.backward"):
                loss.backward()
            with span("train.adam"):
                optimizer.step()
                if schedule is not None:
                    steps[0] += 1
                    for group in optimizer.param_groups:
                        group["lr"] = schedule(steps[0])
                return loss.detach(), {k: torch.as_tensor(v).detach() for k, v in parts.items()}

    def eval_step(batch):
        with torch.no_grad():
            return loss_fn(model, batch, cfg)

    return train_step, eval_step, optimizer


def init_params(model_cfg: ModelConfig | GNSConfig, seed: int,
                device: str | torch.device) -> torch.nn.Module:
    """A fresh network of ``model_cfg``'s kind, drawn from a CPU generator
    seeded with ``seed``, on ``device``: a `DynamicsPredictor` with flax's
    initialisation (lecun-normal kernels, zero biases), or a `GNS` with
    Sonnet's."""
    net = GNS if isinstance(model_cfg, GNSConfig) else DynamicsPredictor
    return net(model_cfg, generator=torch.Generator().manual_seed(seed)).to(device)


def train_dynamics(train_sampler: GraphSampler | WindowSampler,
                   valid_sampler: Optional[GraphSampler | WindowSampler],
                   model_cfg: ModelConfig | GNSConfig, cfg: TrainConfig, progress: bool = True,
                   statistics: dict | None = None):
    """The training loop on the samplers' device, with the reference's
    checkpoint schedule under ``cfg.out_dir``/checkpoints: model_{e}.ckpt
    after epochs 1-9, every 10th to 100, then every 100th; latest.ckpt and
    latest_optim.ckpt (Adam's state in optax's layout) every epoch; and
    loss.png. A `GNSConfig` trains GNS on `WindowSampler` batches by its
    one-step loss at its decaying rate, normalised by ``statistics``
    (`gns.statistics`), and its trees are its state dict split at the dots
    (`gns.state_tree`). Returns
    (model, optimizer, history)."""
    device = train_sampler.store.device
    g = torch.Generator(device=device).manual_seed(cfg.random_seed)
    model = init_params(model_cfg, cfg.random_seed, device)
    if isinstance(model, GNS):
        model.set_statistics(statistics)
        loss_fn, tree, schedule = one_step_loss, state_tree, learning_rate(model_cfg, cfg.lr)
    else:
        loss_fn, tree, schedule = unrolled_loss, flax_tree, None
    train_step, eval_step, optimizer = make_train_step(model, cfg, loss_fn, schedule)

    ckpt_dir = os.path.join(cfg.out_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    history = {"train": [], "valid": []}
    for epoch in range(cfg.n_epochs):
        t0 = time.time()
        losses = []
        for i in range(cfg.n_iters_per_epoch_train):
            loss, _ = train_step(train_sampler.sample(g, cfg.batch_size))
            if progress and i % cfg.log_interval == 0:
                losses.append(host_read("train_loss", loss))
        history["train"].append(float(np.mean(losses)) if losses
                                else host_read("train_loss", loss))

        if valid_sampler is not None:
            vlosses = [host_read("valid_loss",
                                 eval_step(valid_sampler.sample(g, cfg.batch_size))[0])
                       for _ in range(cfg.n_iters_per_epoch_valid)]
            history["valid"].append(float(np.mean(vlosses)))
            if progress:
                print(f"Epoch {epoch}, train {history['train'][-1]:.6f}, "
                      f"valid {history['valid'][-1]:.6f}, {time.time() - t0:.2f}s")

        e = epoch + 1
        params = tree(model.state_dict())
        if e < 10 or (e < 100 and e % 10 == 0) or e % 100 == 0:
            save_checkpoint(os.path.join(ckpt_dir, f"model_{e}.ckpt"), params)
        save_checkpoint(os.path.join(ckpt_dir, "latest.ckpt"), params)
        save_checkpoint(os.path.join(ckpt_dir, "latest_optim.ckpt"),
                        adam_state_tree(model, optimizer, tree))
        _plot_losses(history, os.path.join(cfg.out_dir, "loss.png"))
    return model, optimizer, history


def _plot_losses(history: dict, path: str) -> None:
    """Per-epoch train / valid loss plot; skipped where matplotlib is
    missing (it is an output file only)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    plt.figure(figsize=(20, 5))
    plt.plot(history["train"], label="train")
    if history.get("valid"):
        plt.plot(history["valid"], label="valid")
    plt.legend()
    plt.savefig(path, dpi=150)
    plt.close()
