"""The two probe kernels (counterparts of the Pallas TPU kernels in
`benchmarks/probe_transcendental.py` and `benchmarks/probe_dynamic_roll.py`).

  * `composite_hot_loop` — the tile compositor's hot loop with its three
    transcendentals (``transcend=True``) or with the probe's polynomial
    stand-ins (``False``); the time between the two variants is what the
    transcendentals cost. `composite_hot_loop_plain` is its plain PyTorch
    version.
  * `dynamic_roll` — ``torch.roll(x, shift, dims=1)`` with the shift read on
    the device from an int32 tensor; `dynamic_roll_plain` is its plain
    version.

Both wrappers launch the hand-written CUDA kernels of
`gsdx_torch/csrc/probes.cu` for CUDA tensors (or raise) and run the plain
version for CPU tensors. `LAUNCHES` counts the kernel launches.
`tools/transcendental_probe.py` and `tools/dynamic_roll_probe.py` drive them.
"""

from __future__ import annotations

import torch

from gsdx_torch.kernels._build import I32, PTR, CudaLibrary

FEAT_DIM = 16
TILE_H, TILE_W = 16, 128
P = TILE_H * TILE_W
N_ACCUM = 4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
SUBS = (64, 128)  # granule widths the kernel is built for

# Kernel launches per variant, counted by the wrappers where they launch.
LAUNCHES = {"hot_loop": 0, "hot_loop_poly": 0, "dynamic_roll": 0}

LIBRARY = CudaLibrary(
    "gsdx_probes", "probes.cu",
    {"gsdx_probe_hot_loop": [PTR] * 4 + [I32] * 4 + [PTR],
     "gsdx_probe_roll": [PTR] * 3 + [I32] * 2 + [PTR]},
    error_string="gsdx_probes_error_string")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_cuda(**tensors) -> torch.device:
    dev = None
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


# --------------------------------------------------------------------------
# kernel #4: the compositor's hot loop, with and without its transcendentals
# --------------------------------------------------------------------------


def composite_hot_loop_plain(feats: torch.Tensor, counts: torch.Tensor,
                             sub: int, transcend: bool):
    """The probe's `_kernel` in PyTorch: per tile, ``ceil(count / sub)``
    granules of ``sub`` splats with no early stop, over the tile's 16 x 128
    pixels at the probe's coordinates (px the flat pixel index, py its
    column / 10). Returns (accum (T, 4, P), logt (T, 1, P)) f32.

    Within a granule the log T steps are summed by a cumulative sum, as the
    TPU's triangular-matmul prefix; the carried log T is added after it.
    Counts outside [0, K] are clamped to it."""
    T, _, K = feats.shape
    dev = feats.device
    p = torch.arange(P, device=dev, dtype=torch.float32)
    px = p[None, None, :]
    py = ((p % TILE_W) * 0.1)[None, None, :]
    accum = torch.zeros(T, N_ACCUM, P, device=dev)
    logt = torch.zeros(T, 1, P, device=dev)
    counts = counts.long().clamp(0, K)
    granules = (counts + sub - 1) // sub
    for j in range(int(granules.max()) if T else 0):
        cf = feats[:, :, j * sub:(j + 1) * sub]
        mx, my, ca, cb, cc, op = (cf[:, r, :, None] for r in range(6))
        dx = px - mx
        dy = py - my
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        e = torch.exp(power) if transcend else 1.0 + power + 0.5 * power * power
        alpha = torch.minimum(torch.tensor(ALPHA_MAX, device=dev), op * e)
        slot = j * sub + torch.arange(sub, device=dev)
        keep = (power <= 0) & (alpha >= ALPHA_MIN) & (slot[None, :, None] < counts[:, None, None])
        alpha = torch.where(keep, alpha, torch.zeros((), device=dev))
        l = torch.log1p(-alpha) if transcend else -alpha - 0.5 * alpha * alpha
        cum = torch.cumsum(l, dim=1)
        ltb = logt + cum - l
        w = alpha * (torch.exp(ltb) if transcend else 1.0 + ltb + 0.5 * ltb * ltb)
        live = (j < granules)[:, None, None]
        accum = torch.where(live, accum + torch.bmm(cf[:, 6:6 + N_ACCUM, :], w), accum)
        logt = torch.where(live, logt + cum[:, -1:, :], logt)
    return accum, logt


def composite_hot_loop(feats: torch.Tensor, counts: torch.Tensor, sub: int,
                       transcend: bool):
    """Kernel #4. ``feats`` (T, 16, K) f32, ``counts`` (T,) i32 (clamped to
    [0, K]) with K a multiple of ``sub`` (64 or 128). CUDA tensors launch the kernel;
    CPU tensors run `composite_hot_loop_plain`."""
    if not feats.is_cuda:
        return composite_hot_loop_plain(feats, counts, sub, transcend)
    T, F, K = feats.shape
    if F != FEAT_DIM or counts.shape != (T,):
        raise ValueError("feats must be (T, 16, K) and counts (T,)")
    if feats.dtype != torch.float32 or counts.dtype != torch.int32:
        raise ValueError("feats must be float32 and counts int32")
    if sub not in SUBS or K % sub:
        raise ValueError(f"sub {sub} / K {K} unsupported (sub in {SUBS}, dividing K)")
    dev = _check_cuda(feats=feats, counts=counts)
    accum = torch.empty((T, N_ACCUM, P), device=dev)
    logt = torch.empty((T, 1, P), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = LIBRARY.load().gsdx_probe_hot_loop(
        feats.data_ptr(), counts.data_ptr(), accum.data_ptr(), logt.data_ptr(),
        T, K, sub, int(transcend), stream)
    LIBRARY.check(err, "composite_hot_loop")
    LAUNCHES["hot_loop" if transcend else "hot_loop_poly"] += 1
    return accum, logt


# --------------------------------------------------------------------------
# kernel #5: roll along axis 1 by a shift read on the device
# --------------------------------------------------------------------------


def dynamic_roll_plain(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``np.roll(x, shift, axis=1)``: out[r, (c + shift) mod W] = x[r, c]."""
    return torch.roll(x, int(shift.reshape(-1)[0]), dims=1)


def dynamic_roll(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Kernel #5. ``x`` (R, W) f32, ``shift`` (1,) i32. CUDA tensors launch
    the kernel, which reads the shift on the device; CPU tensors run
    `dynamic_roll_plain`."""
    if not x.is_cuda:
        return dynamic_roll_plain(x, shift)
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError("x must be a 2-D float32 tensor")
    if shift.shape != (1,) or shift.dtype != torch.int32:
        raise ValueError("shift must be a (1,) int32 tensor")
    dev = _check_cuda(x=x, shift=shift)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = LIBRARY.load().gsdx_probe_roll(x.data_ptr(), shift.data_ptr(), out.data_ptr(),
                                         x.shape[0], x.shape[1], stream)
    LIBRARY.check(err, "dynamic_roll")
    LAUNCHES["dynamic_roll"] += 1
    return out
