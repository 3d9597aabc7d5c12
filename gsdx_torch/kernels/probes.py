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
version for CPU tensors, through `_build.Launcher` (the C function resolved
once, the stream's raw handle). `LAUNCHES` counts the kernel launches.
`empty_launch` launches a kernel that does nothing by the same path: its
device time is the floor of any launch, and so of #5's bound.
`tools/transcendental_probe.py` and `tools/dynamic_roll_probe.py` drive them.
"""

from __future__ import annotations

import torch

from gsdx_torch.kernels._build import I32, PTR, CudaLibrary, Launcher

FEAT_DIM = 16
TILE_H, TILE_W = 16, 128
P = TILE_H * TILE_W
N_ACCUM = 4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
LOG2E = 1.4426950408889634
SUBS = (64, 128)  # granule widths the kernel is built for
MAX_T = 8192  # tiles a hot-loop launch (its sort's shared memory)

F32, I32T = torch.float32, torch.int32
_ONE = torch.Size([1])
# Kernel launches per variant, each counted by its variant's `Launcher`.
LAUNCHES = {"hot_loop": 0, "hot_loop_poly": 0, "dynamic_roll": 0}

LIBRARY = CudaLibrary(
    "gsdx_probes", "probes.cu",
    {"gsdx_probe_hot_loop": [PTR] * 5 + [I32] * 4 + [PTR],
     "gsdx_probe_roll": [PTR] * 3 + [I32] * 2 + [PTR],
     "gsdx_probe_empty": [PTR]},
    error_string="gsdx_probes_error_string")
_HOT_LOOP = Launcher(LIBRARY, "gsdx_probe_hot_loop", "composite_hot_loop", LAUNCHES,
                     "hot_loop")
_HOT_LOOP_POLY = Launcher(LIBRARY, "gsdx_probe_hot_loop", "composite_hot_loop", LAUNCHES,
                          "hot_loop_poly")
_ROLL = Launcher(LIBRARY, "gsdx_probe_roll", "dynamic_roll", LAUNCHES, "dynamic_roll")
_EMPTY = Launcher(LIBRARY, "gsdx_probe_empty", "empty_launch")


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


def _exp(x: torch.Tensor) -> torch.Tensor:
    """e^x of a float32 tensor, float64 exp2 rounded to float32. Not
    `torch.exp`: on the CPU that is MKL's vector math, whose code path MKL
    picks at run time (``MKL_CBWR`` and ``MKL_ENABLE_INSTRUCTIONS`` change
    its results), and in a fresh pytest worker its first call has returned
    other values for part of a tile. ATen runs exp2 in its own kernel."""
    return torch.exp2(x.double() * LOG2E).float()


def composite_hot_loop_plain(feats: torch.Tensor, counts: torch.Tensor,
                             sub: int, transcend: bool):
    """The probe's `_kernel` in PyTorch: per tile, ``ceil(count / sub)``
    granules of ``sub`` splats with no early stop, over the tile's 16 x 128
    pixels at the probe's coordinates (px the flat pixel index, py its
    column / 10). Returns (accum (T, 4, P), logt (T, 1, P)) f32.

    Within a granule the log T steps are summed by a cumulative sum, as the
    TPU's triangular-matmul prefix; the carried log T is added after it.
    Counts outside [0, K] are clamped to it.

    Nothing here runs MKL, whose code path is picked at run time: the exps
    are `_exp`, and the channel sums a product summed over the splats where
    `torch.bmm` would call MKL's GEMM."""
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
        e = _exp(power) if transcend else 1.0 + power + 0.5 * power * power
        alpha = torch.minimum(torch.tensor(ALPHA_MAX, device=dev), op * e)
        slot = j * sub + torch.arange(sub, device=dev)
        keep = (power <= 0) & (alpha >= ALPHA_MIN) & (slot[None, :, None] < counts[:, None, None])
        alpha = torch.where(keep, alpha, torch.zeros((), device=dev))
        l = torch.log1p(-alpha) if transcend else -alpha - 0.5 * alpha * alpha
        cum = torch.cumsum(l, dim=1)
        ltb = logt + cum - l
        w = alpha * (_exp(ltb) if transcend else 1.0 + ltb + 0.5 * ltb * ltb)
        live = (j < granules)[:, None, None]
        rgbd = cf[:, 6:6 + N_ACCUM, :, None]
        accum = torch.where(live, accum + (rgbd * w[:, None]).sum(2), accum)
        logt = torch.where(live, logt + cum[:, -1:, :], logt)
    return accum, logt


def composite_hot_loop(feats: torch.Tensor, counts: torch.Tensor, sub: int,
                       transcend: bool):
    """Kernel #4. ``feats`` (T, 16, K) f32, 16-byte aligned, ``counts`` (T,)
    i32 (clamped to [0, K]) with K a multiple of ``sub`` (64 or 128) and T
    at most MAX_T. CUDA tensors launch the kernel; CPU tensors run
    `composite_hot_loop_plain`. With ``transcend`` the kernel's exp and
    log1p are MUFU approximations (ex2/lg2.approx), within the probe's check
    of the plain version's libm ones."""
    if not feats.is_cuda:
        return composite_hot_loop_plain(feats, counts, sub, transcend)
    T, F, K = feats.shape
    if F != FEAT_DIM or counts.shape != (T,):
        raise ValueError("feats must be (T, 16, K) and counts (T,)")
    if feats.dtype != torch.float32 or counts.dtype != torch.int32:
        raise ValueError("feats must be float32 and counts int32")
    if sub not in SUBS or K % sub:
        raise ValueError(f"sub {sub} / K {K} unsupported (sub in {SUBS}, dividing K)")
    if T > MAX_T:
        raise ValueError(f"{T} tiles: the kernel takes at most {MAX_T}")
    dev = _check_cuda(feats=feats, counts=counts)
    if feats.data_ptr() % 16:
        raise ValueError("feats must be 16-byte aligned")
    accum = torch.empty((T, N_ACCUM, P), device=dev)
    logt = torch.empty((T, 1, P), device=dev)
    next_unit = torch.empty(1, dtype=torch.int32, device=dev)
    (_HOT_LOOP if transcend else _HOT_LOOP_POLY)(
        dev.index, feats.data_ptr(), counts.data_ptr(), accum.data_ptr(), logt.data_ptr(),
        next_unit.data_ptr(), T, K, sub, int(transcend))
    return accum, logt


# --------------------------------------------------------------------------
# kernel #5: roll along axis 1 by a shift read on the device
# --------------------------------------------------------------------------


def dynamic_roll_plain(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``np.roll(x, shift, axis=1)``: out[r, (c + shift) mod W] = x[r, c]."""
    return torch.roll(x, int(shift.reshape(-1)[0]), dims=1)


def dynamic_roll(x: torch.Tensor, shift: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel #5. ``x`` (R, W) f32, ``shift`` (1,) i32, both contiguous on
    one device. CUDA tensors launch the kernel, which reads the shift on the
    device; CPU tensors run `dynamic_roll_plain`. ``out``, where the caller
    gives one, is a contiguous f32 tensor of x's shape on x's device apart
    from x: the result is written there and returned, and the call
    allocates nothing.

    The kernel takes about a microsecond of the device, so the call's host
    work is its time: each tensor method call costs a fraction of a
    microsecond, so the checks are one expression each, reading every
    attribute once (`_refuse_roll` names what failed), and `Launcher`
    holds the C function and the stream getter, bound once."""
    dev = x.get_device()
    if dev < 0:
        if out is not None:
            _refuse_roll(x, shift, out, cuda=False)
            return out.copy_(dynamic_roll_plain(x, shift))
        return dynamic_roll_plain(x, shift)
    xs = x.shape
    if not (x.dtype is F32 and len(xs) == 2 and shift.dtype is I32T and shift.shape == _ONE
            and shift.get_device() == dev and x.is_contiguous()):
        _refuse_roll(x, shift, out)
    px = x.data_ptr()
    if out is None:
        out = torch.empty_like(x)
        po = out.data_ptr()
    else:
        po, n = out.data_ptr(), 4 * xs[0] * xs[1]
        if not (out.dtype is F32 and out.shape == xs and out.get_device() == dev
                and out.is_contiguous() and (po + n <= px or px + n <= po)):
            _refuse_roll(x, shift, out)
    _ROLL(dev, px, shift.data_ptr(), po, xs[0], xs[1])
    return out


def _apart(x: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether two contiguous tensors' bytes do not overlap."""
    n = x.numel() * x.element_size()
    return out.data_ptr() + n <= x.data_ptr() or x.data_ptr() + n <= out.data_ptr()


def _refuse_roll(x: torch.Tensor, shift: torch.Tensor, out: torch.Tensor | None = None,
                 cuda: bool = True) -> None:
    """Raise the error that one of `dynamic_roll`'s one-expression checks
    stands for (``cuda``: the tensors must also be contiguous CUDA tensors
    on one device)."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError("x must be a 2-D float32 tensor")
    if shift.shape != (1,) or shift.dtype != torch.int32:
        raise ValueError("shift must be a (1,) int32 tensor")
    tensors = {"x": x, "shift": shift}
    if out is not None:
        if out.shape != x.shape or out.dtype != torch.float32:
            raise ValueError("out must be a float32 tensor of x's shape")
        if out.device != x.device:
            raise ValueError(f"out is on {out.device}, expected {x.device}")
        tensors["out"] = out
    if cuda:
        _check_cuda(**tensors)
    if out is not None and not (out.is_contiguous() and _apart(x, out)):
        raise ValueError("out must be contiguous and must not overlap x")


def empty_launch(device_index: int) -> None:
    """One launch, on the current stream of CUDA device ``device_index`` and
    through the probes' ctypes path, of a kernel that does nothing
    (`empty_kernel`); not counted in LAUNCHES."""
    _EMPTY(device_index)
