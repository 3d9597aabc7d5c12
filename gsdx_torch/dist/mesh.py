"""Process groups and a named mesh over them (counterpart of
`gsdx/dist/mesh.py`).

gsdx lays its devices out as a `jax.sharding.Mesh` and lets XLA insert the
collectives. Here every rank is one process with one device, the mesh is a
named tuple of process groups, and the modules of this package call the
collectives themselves:

  data — graph batches (GNN training), MPPI samples, image tiles
         (compositing), camera views (tracking)

Launch several ranks with `torchrun --nproc-per-node=N` (one GPU each, NCCL),
or with `spawn_ranks` on one host. A rank that runs alone is a world of one:
its collectives run all the same.
"""

from __future__ import annotations

import itertools
import math
import os
import time
from typing import Callable, NamedTuple, Sequence

import torch
import torch.distributed as dist

from gsdx_torch.core.device import require_device


class Mesh(NamedTuple):
    """Named axes over a set of ranks. ``ranks`` are global ranks in
    row-major order over ``sizes``; ``group`` spans them all and
    ``axis_groups[name]`` is this rank's group along the axis ``name``
    (the ranks that differ from it only in that coordinate)."""

    names: tuple
    sizes: tuple
    ranks: tuple
    group: object
    axis_groups: dict

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.sizes))

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return dist.get_rank(self.axis_groups[axis])


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None,
                           device: str | torch.device = "cuda") -> torch.device:
    """Join (or make) the default process group; returns this rank's device.

    * Under `torchrun` (``RANK`` and ``WORLD_SIZE`` set, no ``coordinator``)
      the group reads its address from the environment (``env://``).
    * With ``num_processes > 1`` it meets the others at ``coordinator``:
      ``host:port`` (TCP) or a URL (``tcp://...``, ``file:///...``), as
      rank ``process_id``.
    * Otherwise it is a world of one on an in-process store.

    The backend is NCCL for a CUDA device and gloo for the CPU, unless
    ``backend`` names one. ``device="cuda"`` gives rank i the card
    ``LOCAL_RANK`` (or ``process_id``); a device with an index, such as
    ``"cuda:0"``, is shared by every rank (NCCL refuses that: pass
    ``backend="gloo"``).
    """
    if dist.is_initialized():
        raise RuntimeError("the default process group is already initialised")
    device = require_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    torchrun = coordinator is None and "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if device.type == "cuda" and device.index is None:
        local = os.environ.get("LOCAL_RANK") if torchrun else None
        device = torch.device("cuda", int(local) if local is not None else (process_id or 0))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if torchrun:
        dist.init_process_group(backend, init_method="env://")
    elif num_processes is not None and num_processes > 1:
        if coordinator is None or process_id is None:
            raise ValueError("several processes need a coordinator and a process_id")
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return device


def get_mesh(axes: Sequence[tuple[str, int]] | None = None,
             ranks: Sequence[int] | None = None) -> Mesh | None:
    """A mesh over ``ranks`` (default: the whole world); default axes: one
    'data' axis over them. Every rank of the world calls it (it makes the
    groups collectively); a rank outside ``ranks`` gets None."""
    world = dist.get_world_size()
    ranks = tuple(range(world)) if ranks is None else tuple(sorted(ranks))
    if axes is None:
        axes = [("data", len(ranks))]
    names = tuple(a[0] for a in axes)
    sizes = tuple(int(a[1]) for a in axes)
    assert math.prod(sizes) == len(ranks), f"mesh {sizes} != {len(ranks)} ranks"
    whole = ranks == tuple(range(world))
    group = dist.group.WORLD if whole else dist.new_group(list(ranks))
    me = dist.get_rank()
    axis_groups = {}
    for a, name in enumerate(names):
        if len(names) == 1:
            axis_groups[name] = group
            continue
        others = [range(s) for i, s in enumerate(sizes) if i != a]
        for coord in itertools.product(*others):  # every line along axis a
            line = []
            for k in range(sizes[a]):
                full = list(coord)
                full.insert(a, k)
                line.append(ranks[_flat_index(full, sizes)])
            g = dist.new_group(line)
            if me in line:
                axis_groups[name] = g
    if me not in ranks:
        return None
    return Mesh(names, sizes, ranks, group, axis_groups)


def _flat_index(coord, sizes) -> int:
    i = 0
    for c, s in zip(coord, sizes):
        i = i * s + c
    return i


def replicated(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` as the mesh's first rank holds it, on every rank of the mesh
    (a broadcast, in place; returns ``x``)."""
    dist.broadcast(x, src=mesh.ranks[0], group=mesh.group)
    return x


def shard_rows(n: int, mesh: Mesh, axis: str = "data") -> slice:
    """The contiguous rows of ``n`` that this rank owns along ``axis``;
    ``n`` must divide evenly, as gsdx's ``P(axis)`` sharding requires."""
    size = mesh.shape[axis]
    if n % size:
        raise ValueError(f"{n} rows do not divide over the {size} ranks of axis {axis!r}")
    per = n // size
    i = mesh.axis_index(axis)
    return slice(i * per, (i + 1) * per)


def batch_sharding(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous rows (leading axis) of ``x``."""
    return x[shard_rows(x.shape[0], mesh, axis)]


def gather_rows(local: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """Every rank's ``local`` rows along ``axis``, concatenated in rank
    order, on every rank (each rank's rows must have the same shape)."""
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, local, group=mesh.axis_groups[axis])
    return torch.cat(parts)


def spawn_ranks(fn: Callable, world_size: int, args: tuple = (),
                timeout: float = 300.0) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh processes
    (the ``spawn`` start method: the caller may hold CUDA or JAX state) and
    wait for all of them. Raises if one fails, or kills them all and raises
    if they take longer than ``timeout`` seconds. ``fn`` must be importable
    by name, and it joins the group itself (`initialize_distributed`)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world_size, *args), nprocs=world_size,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
