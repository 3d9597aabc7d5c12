"""Graph dataset on the device (counterpart of `gsdx/graph/dataset.py`).

An `EpisodeStore` holds every episode's downsampled particle trajectories
and end-effector positions as device tensors. A batch is built in two
steps, both batched over B:

  * `draw_samples` draws each sample's randomness from a `torch.Generator`:
    the FPS start, the FPS radius, the uniform state noise over the
    history, the z-rotation and the adjacency radius (`SampleDraws`);
  * `build_batch` builds the batch from the frame rows and those draws with
    no randomness of its own: FPS -> radius FPS on the last history frame,
    history / future / tool tensors, noise, then the rotation (right
    multiplied, as gsdx does), then edges on the rotated, noisy last frame.

Splitting the two lets a test replay gsdx's `jax.random` draws through the
port's `build_batch`. All shapes are static; variable particle counts become
masks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from gsdx_torch.core.device import require_device
from gsdx_torch.graph.edges import construct_edges_batch
from gsdx_torch.kernels.fps import farthest_point_sampling_batch, fps_rad_idx_batch
from gsdx_torch.utils.profiling import span


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


@dataclasses.dataclass
class GraphBatch:
    """One training batch; N = max_nobj + max_tool node slots, object slots
    first."""

    state: torch.Tensor  # (B, n_his, N, 3) position history
    action: torch.Tensor  # (B, N, 3) tool delta of the first step
    tool_future: torch.Tensor  # (B, n_future - 1, N, 3) tool poses, zeros else
    action_future: torch.Tensor  # (B, n_future - 1, N, 3) tool deltas
    state_future: torch.Tensor  # (B, n_future, max_nobj, 3) ground truth
    attrs: torch.Tensor  # (B, N, 2) [object, tool]
    p_instance: torch.Tensor  # (B, max_nobj, 1)
    obj_mask: torch.Tensor  # (B, max_nobj) bool
    state_mask: torch.Tensor  # (B, N) bool
    tool_mask: torch.Tensor  # (B, N) bool
    Rr: torch.Tensor  # (B, max_nR, N) one-hot receivers
    Rs: torch.Tensor  # (B, max_nR, N) one-hot senders

    def to(self, device) -> "GraphBatch":
        return GraphBatch(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


@dataclasses.dataclass
class EpisodeStore:
    """Device-resident episodes.

    particle_pos: (E, T, P, 3) downsampled trajectories, padded over T;
    eef_pos: (E, T, n_tool, 3) end-effector positions;
    pair_list: (n_pairs, 1 + n_his + n_future) int64 rows
               [episode, frame...] from `frame_pairs/{ep}.txt`.
    """

    particle_pos: torch.Tensor
    eef_pos: torch.Tensor
    pair_list: torch.Tensor

    @staticmethod
    def from_numpy(particle_pos: Sequence[np.ndarray],
                   eef_pos: Sequence[np.ndarray],
                   pair_lists: Sequence[np.ndarray],
                   device: str | torch.device = "cuda") -> "EpisodeStore":
        """Stack ragged per-episode arrays on ``device``; each episode's
        last frame is repeated into the time padding."""
        device = require_device(device)
        E = len(particle_pos)
        T = max(p.shape[0] for p in particle_pos)
        P = max(p.shape[1] for p in particle_pos)
        n_tool = eef_pos[0].shape[1]
        pp = np.zeros((E, T, P, 3), np.float32)
        ee = np.zeros((E, T, n_tool, 3), np.float32)
        for i, (p, e) in enumerate(zip(particle_pos, eef_pos)):
            pp[i, : p.shape[0], : p.shape[1]] = p
            ee[i, : e.shape[0]] = e[:T]
            pp[i, p.shape[0]:] = pp[i, p.shape[0] - 1]
            ee[i, e.shape[0]:] = ee[i, min(e.shape[0], T) - 1]
        pairs = np.concatenate(pair_lists, axis=0).astype(np.int64)
        return EpisodeStore(*(torch.as_tensor(a, device=device) for a in (pp, ee, pairs)))

    @property
    def device(self) -> torch.device:
        return self.particle_pos.device


class SampleDraws(NamedTuple):
    """Each sample's random values: FPS start (B,) int64, FPS radius (B,),
    state noise (B, n_his, N, 3), rotation angle (B,), adjacency radius
    (B,); floats f32."""

    start: torch.Tensor
    radius: torch.Tensor
    noise: torch.Tensor
    theta: torch.Tensor
    adj: torch.Tensor


def _uniform(g: torch.Generator, shape, lo: float, hi: float, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def draw_samples(g: torch.Generator, batch_size: int, n_points: int,
                 cfg: GraphDatasetConfig, noise: float, device) -> SampleDraws:
    """Draw what `build_batch` needs for ``batch_size`` samples over
    ``n_points`` particles, from ``g`` (on ``device``)."""
    B, N = batch_size, cfg.max_nobj + cfg.max_tool
    return SampleDraws(
        start=torch.randint(0, n_points, (B,), generator=g, device=device),
        radius=_uniform(g, (B,), *cfg.fps_radius_range, device),
        noise=_uniform(g, (B, cfg.n_his, N, 3), -noise, noise, device),
        theta=_uniform(g, (B,), -math.pi, math.pi, device),
        adj=_uniform(g, (B,), *cfg.adj_radius_range, device))


def _rot_z(theta):
    """(B,) angles -> (B, 3, 3) rotations about z."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _right_mul(x, R):
    """x (B, ..., 3) @ R (B, 3, 3), summed over the three products in order
    and each product rounded (no fused multiply-add): the rounding of XLA's
    CPU dot on all but a vector remainder of rows, and the same on every
    device."""
    R = R.reshape(R.shape[:1] + (1,) * (x.ndim - 2) + (3, 3))
    return (x[..., 0:1] * R[..., 0, :] + x[..., 1:2] * R[..., 1, :]) + x[..., 2:3] * R[..., 2, :]


def build_batch(store: EpisodeStore, pair_rows: torch.Tensor, draws: SampleDraws,
                cfg: GraphDatasetConfig) -> GraphBatch:
    """The batch of frame rows ``pair_rows`` (B, 1 + F) under ``draws``.
    A row shorter than n_his + n_future frames repeats its last frame
    (gsdx's out-of-range indices clamp)."""
    n_his, n_fut = cfg.n_his, cfg.n_future
    max_nobj, max_tool = cfg.max_nobj, cfg.max_tool
    N = max_nobj + max_tool
    B, dev = pair_rows.shape[0], store.device
    rows = torch.arange(B, device=dev)

    ep = pair_rows[:, 0]
    cols = torch.arange(n_his + n_fut, device=dev).clamp(max=pair_rows.shape[1] - 2)
    frames = pair_rows[:, 1:][:, cols]  # (B, n_his + n_fut)
    obj_kps = store.particle_pos[ep[:, None], frames]  # (B, F, P, 3)
    tool_kps = store.eef_pos[ep[:, None], frames]  # (B, F, n_tool, 3)
    P, n_tool = obj_kps.shape[2], tool_kps.shape[2]

    # FPS on the last history frame from each sample's start, then radius
    # FPS of those with each sample's radius: one kernel launch each on the
    # card, which reads the starts and radii there (no host read)
    anchor = obj_kps[:, n_his - 1]
    n1 = min(max_nobj, P)
    fps1 = farthest_point_sampling_batch(anchor, n1, start_idx=draws.start)
    down = anchor[rows[:, None], fps1]
    idx2, obj_mask = fps_rad_idx_batch(down, draws.radius, n1)
    fps_idx = torch.gather(fps1, 1, idx2)  # greedy selection order
    if n1 < max_nobj:  # fewer particles than object slots
        fps_idx = torch.cat([fps_idx, fps_idx.new_zeros((B, max_nobj - n1))], 1)
        obj_mask = torch.cat([obj_mask, obj_mask.new_zeros((B, max_nobj - n1))], 1)
    keep_f = obj_mask[:, None, :, None].to(torch.float32)
    taken = obj_kps[rows[:, None, None], torch.arange(n_his + n_fut, device=dev)[None, :, None],
                    fps_idx[:, None, :]] * keep_f  # (B, F, max_nobj, 3)

    tool = slice(max_nobj, max_nobj + n_tool)
    state_history = obj_kps.new_zeros((B, n_his, N, 3))
    state_history[:, :, :max_nobj] = taken[:, :n_his]
    state_history[:, :, tool] = tool_kps[:, :n_his]
    states_delta = obj_kps.new_zeros((B, N, 3))
    states_delta[:, tool] = tool_kps[:, n_his] - tool_kps[:, n_his - 1]
    state_future = taken[:, n_his:]
    tool_future = obj_kps.new_zeros((B, n_fut - 1, N, 3))
    action_future = obj_kps.new_zeros((B, n_fut - 1, N, 3))
    tool_future[:, :, tool] = tool_kps[:, n_his:n_his + n_fut - 1]
    action_future[:, :, tool] = (tool_kps[:, n_his + 1:n_his + n_fut]
                                 - tool_kps[:, n_his:n_his + n_fut - 1])

    ones = torch.ones((B, max_tool), dtype=torch.bool, device=dev)
    state_mask = torch.cat([obj_mask, ones], 1)
    tool_mask = torch.cat([torch.zeros_like(obj_mask), ones], 1)
    attrs = obj_kps.new_zeros((B, N, 2))
    attrs[:, :max_nobj, 0] = obj_mask.to(torch.float32)
    attrs[:, max_nobj:, 1] = 1.0
    p_instance = obj_mask[..., None].to(torch.float32)

    # augmentation: noise on the history, then one z-rotation of everything
    state_history = state_history + draws.noise
    R = _rot_z(draws.theta)
    state_history = _right_mul(state_history, R)
    states_delta = _right_mul(states_delta, R)
    tool_future = _right_mul(tool_future, R)
    action_future = _right_mul(action_future, R)
    state_future = _right_mul(state_future, R)

    Rr, Rs = construct_edges_batch(state_history[:, -1], draws.adj, state_mask,
                                   tool_mask, n_obj=max_nobj, topk=cfg.topk,
                                   max_nR=cfg.max_nR, connect_all=cfg.connect_all)
    return GraphBatch(state=state_history, action=states_delta,
                      tool_future=tool_future, action_future=action_future,
                      state_future=state_future, attrs=attrs, p_instance=p_instance,
                      obj_mask=obj_mask, state_mask=state_mask, tool_mask=tool_mask,
                      Rr=Rr, Rs=Rs)


class GraphSampler:
    """Batched sampler over an `EpisodeStore`: uniform frame rows, then
    `draw_samples` and `build_batch`, all on the store's device."""

    def __init__(self, store: EpisodeStore, cfg: GraphDatasetConfig,
                 phase: str = "train"):
        self.store = store
        self.cfg = cfg
        self.noise = cfg.state_noise_train if phase == "train" else cfg.state_noise_valid

    @property
    def num_pairs(self) -> int:
        return int(self.store.pair_list.shape[0])

    def sample(self, g: torch.Generator, batch_size: int) -> GraphBatch:
        """A batch, in a span ``train.sample`` timed on the device."""
        dev = self.store.device
        with span("train.sample", dev):
            rows = torch.randint(0, self.num_pairs, (batch_size,), generator=g, device=dev)
            draws = draw_samples(g, batch_size, self.store.particle_pos.shape[2], self.cfg,
                                 self.noise, dev)
            return build_batch(self.store, self.store.pair_list[rows], draws, self.cfg)
