"""GNN dynamics training CLI (counterpart of `gsdx/apps/train.py`).

Reads the episodes `apps/preprocess.py` wrote (the dataset's `base_dir`
relative to the working directory), splits them 80/20 by episode into
train and valid, and trains with checkpoints under
`<train_config.out_dir>/checkpoints`, relative to the working directory.

    python -m gsdx_torch.apps.train --config configs/rope.yaml

A configuration whose model_config reads ``network: gns``
(`configs/gns_water3d.yaml`) trains GNS on windows of n_his + 1
consecutive frames of every particle of the same episodes
(`load_window_store`), normalised by the train episodes' statistics.

`--dp` trains data-parallel, one rank a GPU, as gsdx's `--dp` loop: every
rank draws the same global batch from the same seeded generator and takes
its rows (`gsdx_torch.dist`), and the first rank prints each epoch's loss
and writes `latest.ckpt`. Launch it with torchrun (alone it is a world of
one):

    torchrun --nproc-per-node=N -m gsdx_torch.apps.train --config <yaml> --dp
"""

from __future__ import annotations

import argparse
import glob
import os
from pathlib import Path

import numpy as np
import torch


def load_episode_store(raw_cfg: dict, phase: str, device):
    """An `EpisodeStore` of the preprocessed episodes of ``phase``: the
    first 80% of the sorted episode indices (rounded down) train, the rest
    valid; frame rows that reach past an episode's trajectory are dropped."""
    from gsdx_torch.graph.dataset import EpisodeStore
    from gsdx_torch.io.episodes import eef_world_positions, load_metadata

    ds = raw_cfg["dataset_config"]["datasets"][0]
    base, name = Path(ds["base_dir"]), ds["name"]
    data_root = base / "data" / name
    out_root = base / "ckpts" / f"exp_{name}"
    prep_root = base / "preprocessed" / f"exp_{name}"

    idxs = [int(e.split("_")[-1]) for e in sorted(glob.glob(str(prep_root / "episode_*")))]
    cut = int(len(idxs) * 0.8)
    idxs = idxs[:cut] if phase == "train" else idxs[cut:]

    particle_list, eef_list, pair_list = [], [], []
    for idx in idxs:
        ep = f"episode_{idx:02d}"
        out_dir = out_root / ep / name / ep
        xyz = np.load(out_dir / "param_downsampled.npy")
        eef = eef_world_positions(str(data_root / ep),
                                  load_metadata(str(out_dir / "metadata.json")))
        pairs = np.loadtxt(prep_root / ep / "frame_pairs" / f"{idx}.txt").astype(np.int64)
        pairs = pairs[pairs.max(1) < len(xyz)]
        ep_col = np.full((len(pairs), 1), len(particle_list), np.int64)
        pair_list.append(np.concatenate([ep_col, pairs], axis=1))
        particle_list.append(xyz)
        eef_list.append(eef)
    return EpisodeStore.from_numpy(particle_list, eef_list, pair_list, device=device)


def load_window_store(raw_cfg: dict, phase: str, window: int, device):
    """An `EpisodeStore` of the ``phase`` episodes' trajectories (the same
    80/20 split) whose frame rows are every window of ``window``
    consecutive frames; every episode has to hold one particle count."""
    from gsdx_torch.graph.dataset import EpisodeStore, window_rows

    ds = raw_cfg["dataset_config"]["datasets"][0]
    name = ds["name"]
    root = Path(ds["base_dir"]) / "ckpts" / f"exp_{name}"
    paths = sorted(glob.glob(str(root / "episode_*" / name / "episode_*" /
                                 "param_downsampled.npy")))
    cut = int(len(paths) * 0.8)
    xyz = [np.load(p) for p in (paths[:cut] if phase == "train" else paths[cut:])]
    if len({x.shape for x in xyz}) != 1:
        raise ValueError(f"GNS batches whole clouds: the {phase} episodes' trajectories "
                         f"differ in shape ({sorted({x.shape for x in xyz})})")
    pos = torch.as_tensor(np.stack(xyz).astype(np.float32), device=device)
    E, T, P, _ = pos.shape
    return EpisodeStore(pos, pos.new_zeros((E, T, 0, 3)), window_rows(E, T, window, device))


def train_gns(raw: dict, train_cfg, model_cfg, device) -> None:
    from gsdx_torch.dynamics.gns import statistics
    from gsdx_torch.dynamics.train import train_dynamics
    from gsdx_torch.graph.dataset import WindowSampler

    kind = raw["dataset_config"]["datasets"][0].get("particle_type", 5)
    samplers = []
    for phase in ("train", "valid"):
        store = load_window_store(raw, phase, model_cfg.n_his + 1, device)
        types = torch.full((store.particle_pos.shape[2],), kind, dtype=torch.int64)
        samplers.append(WindowSampler(store, types, model_cfg.noise_std,
                                      model_cfg.kinematic_type))
    train_dynamics(*samplers, model_cfg, train_cfg,
                   statistics=statistics(samplers[0].store.particle_pos, model_cfg.noise_std))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over the ranks of torchrun")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from gsdx_torch.core.device import require_device
    from gsdx_torch.dynamics.gns import GNSConfig
    from gsdx_torch.dynamics.train import train_dynamics
    from gsdx_torch.graph.dataset import GraphSampler
    from gsdx_torch.io.config import load_config, parse_yaml

    train_cfg, model_cfg, data_cfg = load_config(args.config)
    gns = isinstance(model_cfg, GNSConfig)
    if args.dp and gns:
        raise SystemExit("--dp trains the interaction network; GNS trains on one device")
    if args.dp:
        train_dp(args.config, args.device)
        return
    device = require_device(args.device)
    with open(args.config) as f:
        raw = parse_yaml(f.read())
    if gns:
        train_gns(raw, train_cfg, model_cfg, device)
        return
    train_sampler = GraphSampler(load_episode_store(raw, "train", device), data_cfg, "train")
    valid_sampler = GraphSampler(load_episode_store(raw, "valid", device), data_cfg, "valid")
    train_dynamics(train_sampler, valid_sampler, model_cfg, train_cfg)


def train_dp(config: str, device: str) -> None:
    """gsdx's `--dp` loop (`gsdx/apps/train.py`) over the ranks of this
    process group, which it starts and ends."""
    import torch.distributed as dist

    from gsdx_torch.dist import get_mesh, initialize_distributed, make_dp_train_step, shard_batch
    from gsdx_torch.dynamics.model import flax_params
    from gsdx_torch.dynamics.train import init_params
    from gsdx_torch.graph.dataset import GraphSampler
    from gsdx_torch.io.checkpoint import save_checkpoint
    from gsdx_torch.io.config import load_config, parse_yaml

    device = initialize_distributed(device=device)
    try:
        with open(config) as f:
            raw = parse_yaml(f.read())
        train_cfg, model_cfg, data_cfg = load_config(config)
        sampler = GraphSampler(load_episode_store(raw, "train", device), data_cfg, "train")
        mesh = get_mesh()
        model = init_params(model_cfg, train_cfg.random_seed, device)
        step, _ = make_dp_train_step(model, train_cfg, mesh)
        g = torch.Generator(device=device).manual_seed(train_cfg.random_seed)
        ckpt_dir = os.path.join(train_cfg.out_dir, "checkpoints")
        first = dist.get_rank() == mesh.ranks[0]
        if first:
            os.makedirs(ckpt_dir, exist_ok=True)
        for epoch in range(train_cfg.n_epochs):
            for _ in range(train_cfg.n_iters_per_epoch_train):
                loss, _ = step(shard_batch(sampler.sample(g, train_cfg.batch_size), mesh))
            if first:
                print(f"epoch {epoch} loss {float(loss):.6f}")
                save_checkpoint(os.path.join(ckpt_dir, "latest.ckpt"), flax_params(model))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
