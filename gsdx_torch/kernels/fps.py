"""Farthest-point sampling (counterpart of `gsdx/kernels/fps.py`, a
`jax.jit` around a `lax.fori_loop` there).

Greedy FPS over a batch of point sets at once: (B, P, D) points with a
start index per row; `fps_rad_idx*` is the radius-stopping variant (greedy
FPS that stops once every point lies within ``radius`` of a sample), which
runs a fixed ``max_samples`` trips and returns a keep mask.

  * The public functions launch the hand-written CUDA kernel of
    `gsdx_torch/csrc/fps.cu` for CUDA tensors (the whole loop in one launch,
    a thread-block cluster a row; no host synchronisation) and run the plain
    version for CPU tensors. Both take the same arguments and refuse what
    the kernel does not take, before dispatch: a `ValueError` names the
    argument. A CUDA tensor never falls back to the plain loop.
  * `farthest_point_sampling_batch_plain` / `fps_rad_idx_batch_plain`: the
    plain PyTorch version, a loop of n masked distance updates.
  * `LAUNCHES` counts the kernel launches; `last_launch` reads back the
    cluster size, blocks, threads and points a thread of the last one;
    `fps_latency_floor` launches the kernel at a shape's launch shape and
    steps with no distances computed (the floor of its serial chain).

Indices equal gsdx's exactly: the argmax takes the FIRST maximum (as
`jnp.argmax` and `torch.argmax`), so duplicated and tying points resolve to
the same index, and each distance is summed over the coordinates in order,
one fused multiply-add a coordinate rounded once to f32 (`_sq_dist`), as
XLA's CPU backend computes ``jnp.sum((p - c) ** 2, -1)``.
"""

from __future__ import annotations

import ctypes
import operator

import torch

from gsdx_torch.kernels._build import F32, I32, PTR, CudaLibrary, Launcher

_INF = 1e10
MAX_P = 65536  # points a row: 8 blocks of 512 threads x 16 points
MAX_D = 4  # coordinates a point (the planner's action grid is 4-D)
MAX_ROWS = 65535  # rows a launch (the grid's y dimension)

# Kernel launches, counted by the wrappers where they launch.
LAUNCHES = {"fps": 0, "fps_radius": 0}

_POINTS = [PTR, PTR, I32, PTR, I32]  # points, start and its value, valid and its stride
LIBRARY = CudaLibrary(
    "gsdx_fps", "fps.cu",
    {"gsdx_fps": _POINTS + [PTR] + [I32] * 4 + [PTR],
     "gsdx_fps_radius": _POINTS + [PTR, F32, PTR, PTR] + [I32] * 4 + [PTR],
     "gsdx_fps_floor": [PTR, PTR] + [I32] * 4 + [PTR],
     "gsdx_fps_last_launch": [PTR]},
    error_string="gsdx_fps_error_string")
_FPS = Launcher(LIBRARY, "gsdx_fps", "farthest_point_sampling")
_FPS_RADIUS = Launcher(LIBRARY, "gsdx_fps_radius", "fps_rad_idx")
_FLOOR = Launcher(LIBRARY, "gsdx_fps_floor", "fps_latency_floor")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def last_launch() -> dict:
    """Cluster size, blocks, threads a block and points a thread of the
    library's last accepted launch, as the C side launched it."""
    out = (ctypes.c_int * 4)()
    LIBRARY.load().gsdx_fps_last_launch(ctypes.cast(out, ctypes.c_void_p))
    return {"cluster": out[0], "blocks": out[1], "threads": out[2], "points_a_thread": out[3]}


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------


def _fma_square(t: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``t * t + acc`` of f32 tensors rounded once to f32, as a fused
    multiply-add. f64 holds the product exactly, but rounding the f64 sum
    to f32 rounds twice, and a sum that f64 rounds onto an f32 midpoint then
    ties to even where the exact sum lies to one side. So the f64 sum is
    rounded to odd first: its exact error (Knuth's two-sum) says whether it
    is exact, and an inexact sum with an even last bit moves one f64 ulp
    towards the exact value. Rounding to odd with 29 spare bits, then to
    f32, is one correct rounding."""
    p = t.double() * t.double()
    a = acc.double()
    s = a + p
    bb = s - a
    err = (a - (s - bb)) + (p - bb)
    even = (s.view(torch.int64) & 1) == 0
    towards = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, towards), s)
    return s.to(t.dtype)


def _sq_dist(points, centroid):
    """Squared distances (..., P) of ``points`` (..., P, D) from
    ``centroid`` (..., 1, D), accumulated over the coordinates in order
    (any width; the planner's action grid is 4-D), each step one fused
    multiply-add rounded once to f32 (`_fma_square`), as XLA's CPU backend
    computes ``jnp.sum((p - c) ** 2, -1)``. The exact rounding matters on
    grids, where many distances tie."""
    d = points - centroid
    out = torch.zeros(points.shape[:-1], dtype=points.dtype, device=points.device)
    for c in range(d.shape[-1]):
        out = _fma_square(d[..., c], out)
    return out


def _start(start_idx, B: int, device) -> torch.Tensor:
    return torch.as_tensor(start_idx, dtype=torch.int64, device=device).expand(B).clone()


def _init_dist(valid, shape, device):
    if valid is None:
        return torch.full(shape, _INF, device=device)
    return torch.where(valid, _INF, -_INF).to(torch.float32).expand(shape).clone()


def _step(points, dist, farthest, valid):
    """One greedy step: fold the distances from the points at ``farthest``
    (B,) into ``dist`` (B, P); returns (dist, next farthest (B,))."""
    rows = torch.arange(points.shape[0], device=points.device)
    d = _sq_dist(points, points[rows, farthest][:, None])
    if valid is not None:
        d = torch.where(valid, d, -_INF)
    dist = torch.minimum(dist, d)
    return dist, torch.argmax(dist, dim=1)  # first maximum, as jnp.argmax


def farthest_point_sampling_batch_plain(points: torch.Tensor, n_samples: int,
                                        start_idx: torch.Tensor | int = 0,
                                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """`farthest_point_sampling_batch` in plain PyTorch: a loop of
    ``n_samples`` greedy steps issued from the host."""
    B, P, _ = points.shape
    dist = _init_dist(valid, (B, P), points.device)
    idxs = torch.zeros((B, n_samples), dtype=torch.int64, device=points.device)
    farthest = _start(start_idx, B, points.device)
    for i in range(n_samples):
        idxs[:, i] = farthest
        dist, farthest = _step(points, dist, farthest, valid)
    return idxs


def fps_rad_idx_batch_plain(points: torch.Tensor, radius, max_samples: int,
                            start_idx: torch.Tensor | int = 0,
                            valid: torch.Tensor | None = None):
    """`fps_rad_idx_batch` in plain PyTorch."""
    B, P, _ = points.shape
    dist = _init_dist(valid, (B, P), points.device)
    r = torch.as_tensor(radius, dtype=torch.float32, device=points.device)
    r2 = (r * r).expand(B)
    idxs = torch.zeros((B, max_samples), dtype=torch.int64, device=points.device)
    keep = torch.zeros((B, max_samples), dtype=torch.bool, device=points.device)
    farthest = _start(start_idx, B, points.device)
    active = torch.ones(B, dtype=torch.bool, device=points.device)
    for i in range(max_samples):
        idxs[:, i] = farthest
        keep[:, i] = active
        dist, farthest = _step(points, dist, farthest, valid)
        active = active & (torch.max(dist, dim=1).values > r2)
    return idxs, keep


# --------------------------------------------------------------------------
# the wrappers: checks, then the kernel (CUDA) or the plain version (CPU)
# --------------------------------------------------------------------------


def _check(points, n_samples, start_idx, valid, radius=None, radius_mode=False) -> None:
    """Raise a ValueError naming the argument the kernel does not take.
    Reads nothing from the device: a tensor ``start_idx`` is drawn in range
    by its caller."""
    if not torch.is_tensor(points) or points.dim() != 3:
        raise ValueError("points must be a (B, P, D) tensor (or (P, D) for one row)")
    dev = points.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"points must lie on the CPU or a CUDA device, not {dev}")
    if points.dtype != torch.float32:
        raise ValueError(f"points must be float32, not {points.dtype}")
    B, P, D = points.shape
    if not 1 <= D <= MAX_D:
        raise ValueError(f"points have {D} coordinates: the kernel takes 1 to {MAX_D}")
    if not 1 <= P <= MAX_P:
        raise ValueError(f"points hold {P} points a row: the kernel takes 1 to {MAX_P}")
    if B > MAX_ROWS:
        raise ValueError(f"points hold {B} rows: the kernel takes at most {MAX_ROWS}")
    what = "max_samples" if radius_mode else "n_samples"
    if isinstance(n_samples, bool) or not isinstance(n_samples, int) or n_samples < 0:
        raise ValueError(f"{what} must be an int >= 0, not {n_samples!r}")
    if torch.is_tensor(start_idx):
        if start_idx.device != dev:
            raise ValueError(f"start_idx is on {start_idx.device}, points on {dev}")
        if start_idx.dtype != torch.int64:
            raise ValueError(f"start_idx must be int64, not {start_idx.dtype}")
        if start_idx.shape != (B,):
            raise ValueError(f"start_idx has shape {tuple(start_idx.shape)}, expected ({B},)")
    else:
        try:
            s = operator.index(start_idx)
        except TypeError:
            raise ValueError(f"start_idx must be an int or an int64 tensor, "
                             f"not {type(start_idx).__name__}") from None
        if not 0 <= s < P:
            raise ValueError(f"start_idx {s} is outside [0, {P})")
    if valid is not None:
        if not torch.is_tensor(valid) or valid.device != dev:
            raise ValueError(f"valid must be a tensor on {dev}")
        if valid.dtype != torch.bool:
            raise ValueError(f"valid must be bool, not {valid.dtype}")
        if valid.shape not in (torch.Size([P]), torch.Size([B, P])):
            raise ValueError(f"valid has shape {tuple(valid.shape)}, expected ({P},) or ({B}, {P})")
    if radius_mode and torch.is_tensor(radius):
        if radius.device != dev:
            raise ValueError(f"radius is on {radius.device}, points on {dev}")
        if radius.dtype != torch.float32:
            raise ValueError(f"radius must be float32, not {radius.dtype}")
        if radius.shape != (B,):
            raise ValueError(f"radius has shape {tuple(radius.shape)}, expected ({B},)")
    elif radius_mode:
        try:
            float(radius)
        except (TypeError, ValueError):
            raise ValueError(f"radius must be a float or a float32 tensor, "
                             f"not {type(radius).__name__}") from None


def _per_row(x, cast):
    """(pointer, value) of a per-row argument: a (B,) tensor read on the
    device, or one value for every row."""
    if torch.is_tensor(x):
        return x.contiguous(), cast(0)
    return None, cast(x)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(points, n, start_idx, valid, radius=None, radius_mode=False):
    """The kernel on CUDA tensors (checked): (idx (B, n) int64, keep (B, n)
    bool or None)."""
    B, P, D = points.shape
    points = points.contiguous()
    valid_c = valid.contiguous() if valid is not None else None
    idx = torch.empty((B, n), dtype=torch.int64, device=points.device)
    keep = torch.empty((B, n), dtype=torch.bool, device=points.device) if radius_mode else None
    if B == 0 or n == 0:
        return idx, keep
    start_t, start_v = _per_row(start_idx, operator.index)
    vp = valid_c.data_ptr() if valid_c is not None else None
    vs = P if valid_c is not None and valid_c.dim() == 2 else 0
    dev = points.device.index
    args = (points.data_ptr(), _ptr(start_t), start_v, vp, vs)
    if radius_mode:
        radius_t, radius_v = _per_row(radius, float)
        _FPS_RADIUS(dev, *args, _ptr(radius_t), radius_v, idx.data_ptr(), keep.data_ptr(),
                    B, P, D, n)
        LAUNCHES["fps_radius"] += 1
    else:
        _FPS(dev, *args, idx.data_ptr(), B, P, D, n)
        LAUNCHES["fps"] += 1
    return idx, keep


def farthest_point_sampling_batch(points: torch.Tensor, n_samples: int,
                                  start_idx: torch.Tensor | int = 0,
                                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Indices (B, n_samples) int64 of greedy farthest points of each row
    of ``points`` (B, P, D) f32, D 1-4, P at most 65,536; row b starts at
    ``start_idx[b]`` (an int64 (B,) tensor, read on the device, or one int
    in [0, P) for all). ``valid`` (P,) or (B, P) bool masks points out. With
    fewer valid points than n_samples indices repeat."""
    _check(points, n_samples, start_idx, valid)
    if points.is_cuda:
        return _launch(points, n_samples, start_idx, valid)[0]
    return farthest_point_sampling_batch_plain(points, n_samples, start_idx, valid)


def fps_rad_idx_batch(points: torch.Tensor, radius, max_samples: int,
                      start_idx: torch.Tensor | int = 0,
                      valid: torch.Tensor | None = None):
    """Radius-stopping FPS of each row of ``points`` (B, P, D): (indices
    (B, max_samples) int64, keep (B, max_samples) bool). keep marks the
    samples taken before the farthest remaining point came within
    ``radius`` (a float, or a float32 (B,) tensor read on the device)."""
    _check(points, max_samples, start_idx, valid, radius, radius_mode=True)
    if points.is_cuda:
        return _launch(points, max_samples, start_idx, valid, radius, radius_mode=True)
    return fps_rad_idx_batch_plain(points, radius, max_samples, start_idx, valid)


def _one_row(points, *per_row):
    """``points`` (P, D) as one row, and each per-row argument that is a
    tensor of one value as a (1,) tensor."""
    if not torch.is_tensor(points) or points.dim() != 2:
        raise ValueError("points must be a (P, D) tensor")
    return (points[None], *(x.reshape(1) if torch.is_tensor(x) and x.dim() == 0 else x
                            for x in per_row))


def farthest_point_sampling(points: torch.Tensor, n_samples: int,
                            start_idx: torch.Tensor | int = 0,
                            valid: torch.Tensor | None = None) -> torch.Tensor:
    """Indices (n_samples,) int64 of greedy farthest points among ``points``
    (N, D); the first is ``start_idx``. With fewer valid points than
    n_samples indices repeat."""
    rows, start_idx = _one_row(points, start_idx)
    return farthest_point_sampling_batch(rows, n_samples, start_idx, valid)[0]


def fps_rad_idx(points: torch.Tensor, radius: float, max_samples: int,
                start_idx: torch.Tensor | int = 0, valid: torch.Tensor | None = None):
    """Radius-stopping FPS of one point set (N, D): (indices (max_samples,)
    int64, keep (max_samples,) bool)."""
    rows, start_idx, radius = _one_row(points, start_idx, radius)
    idxs, keep = fps_rad_idx_batch(rows, radius, max_samples, start_idx, valid)
    return idxs[0], keep[0]


def fps_latency_floor(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """The kernel at the launch shape and steps of ``points`` (B, P, D) on a
    CUDA device and ``n_samples``, with no distances computed: its device
    time is the floor of the greedy loop's serial chain. The indices it
    returns mean nothing. Not counted in `LAUNCHES`."""
    _check(points, n_samples, 0, None)
    if not points.is_cuda:
        raise ValueError("points must be a CUDA tensor: the floor is the kernel's")
    B, P, D = points.shape
    points = points.contiguous()
    idx = torch.empty((B, n_samples), dtype=torch.int64, device=points.device)
    if B and n_samples:
        _FLOOR(points.device.index, points.data_ptr(), idx.data_ptr(), B, P, D, n_samples)
    return idx
