"""Fused GNN dynamics forward for the MPPI rollout (counterpart of
`gsdx/kernels/gnn_forward.py`).

Five pieces:

  * `pack_gnn_params` — the flax-layout param tree repacked as gsdx packs it:
    the relation encoder's first layer split by input block, the particle
    encoder's node-state block folded into one f32 matrix (`w1p_st`, zero
    for rope), the motion head padded to 8 columns and the (12, F) bias
    stack; then the weights as the kernels read them: the first-layer blocks
    side by side, and a K-major (N, K) copy of every weight whose depth is
    the hidden width F. Weights are bf16 by default.
  * `gnn_forward_plain` — the plain PyTorch version (the counterpart of
    `gnn_forward_xla_twin`): the CPU path and the kernels' oracle. Edge
    selections are row gathers (-1 reads as zero), the aggregation over
    receivers an `index_add_`. ``operands="bf16"`` rounds the activation
    operand of every product of depth F to bf16, as the kernels store it.
  * `gnn_gemm` — the wrapper of the bf16 tensor-core GEMM in
    `gsdx_torch/csrc/gnn_gemm.cu`, which computes every product of depth F;
    `gnn_gemm_plain` is its plain version.
  * `gnn_segments` and `gnn_message` — the wrappers of the message round's
    kernels: the receiver segments, built once a forward, and the
    aggregation that walks them; `receiver_segments_plain` and
    `gnn_message_plain` are their plain versions.
  * `fused_gnn_forward` — the wrapper that sequences the hand-written CUDA
    kernels of `gsdx_torch/csrc/gnn_forward.cu` (node-input layers, edge
    layer 1, receiver segments, message rounds) and `gnn_gemm.cu` (the
    Hopper port of gsdx's Pallas `_gnn_kernel`). A CUDA tensor launches them
    or raises; only CPU tensors take the plain version. `LAUNCHES` counts
    the launches.

Inputs, per sample b of a chunk: attrs (B, n_pad, 2), action (B, n_pad, 3),
state_t (B, n_pad, 3 * n_his) history-major node positions, g (B, n_pad, 1)
the instance column, recv/send (B, E) int32 node indices with -1 on empty
slots. Output (B, n_pad, 8) f32 raw motion, columns 0:3 meaningful.
Supported families: attr_dim 2, rel_group_dim 1, rel_distance_dim 3 * n_his,
action_dim 3, nf_particle == nf_relation == nf_effect, with the rope
particle inputs (attr + action) or the cloth/dog/sloth ones (attr + z
history + motion + action).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from gsdx_torch.kernels._build import I32, PTR, CudaLibrary
from gsdx_torch.utils.profiling import host_read, span

# Node slots the kernels are padded to (objects + tool), as in gsdx.
N_PAD_CHOICES = (128, 256)

# Launches counted by the wrappers where they launch: one "gnn_forward" per
# fused forward, and each of its five kernels per launch ("gnn_linear" the
# node-input layers, "gnn_gemm" every product of depth F); "edges" the push
# step's radius graph (`kernels/edges.py`).
LAUNCHES = {"gnn_forward": 0, "gnn_linear": 0, "gnn_gemm": 0,
            "gnn_edge_first": 0, "gnn_segments": 0, "gnn_message": 0, "edges": 0}

# The K-major weight copies hold a multiple of GEMM_BN rows: the narrow GEMM
# tile's width (its wide tile, 256, is taken only where N is a multiple).
GEMM_BN = 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class PackedGNN(NamedTuple):
    """Weights of `DynamicsPredictor` repacked for the fused forward (field
    order and meaning as gsdx's `PackedGNN`)."""

    w1r_attr_r: torch.Tensor  # (2, F)
    w1r_attr_s: torch.Tensor  # (2, F)
    w1r_g: torch.Tensor  # (1, F)
    w1r_dist: torch.Tensor  # (3 * n_his, F)
    w2r: torch.Tensor  # (F, F)
    w3r: torch.Tensor  # (F, F)
    w1p_attr: torch.Tensor  # (2, F)
    w1p_st: torch.Tensor  # (3 * n_his, F) f32: folded z-state + motion rows
    w1p_act: torch.Tensor  # (3, F)
    w2p: torch.Tensor  # (F, F)
    w3p: torch.Tensor  # (F, F)
    wr0: torch.Tensor  # (F, F) relation propagator, segment 0 (enc_r)
    wr1: torch.Tensor  # (F, F) segment 1 (receiver effect)
    wr2: torch.Tensor  # (F, F) segment 2 (sender effect)
    wp0: torch.Tensor  # (F, F) particle propagator, segment 0 (enc_p)
    wp1: torch.Tensor  # (F, F) segment 1 (aggregated effect)
    wh1: torch.Tensor  # (F, F)
    wh2: torch.Tensor  # (F, F)
    wh3: torch.Tensor  # (F, 8), 3 columns used
    biases: torch.Tensor  # (12, F) f32: b1r b2r b3r brp b1p b2p b3p bpp bh1 bh2 bh3 0
    # the same weights as the kernels read them (not in gsdx's pack)
    w_nrs: torch.Tensor  # (3 * n_his + 2, 2F): [w1r_dist | -w1r_dist] over [w1r_attr_r | w1r_attr_s]
    w_pa: torch.Tensor  # (5, F): w1p_attr over w1p_act
    # K-major (N, K) copies for the GEMM: wt_x = x.T
    wt_2r: torch.Tensor
    wt_3r: torch.Tensor
    wt_r0: torch.Tensor
    wt_2p: torch.Tensor
    wt_3p: torch.Tensor
    wt_p0: torch.Tensor
    wt_rs: torch.Tensor  # (2F, F): (wr1 | wr2).T
    wt_p1: torch.Tensor
    wt_h1: torch.Tensor
    wt_h2: torch.Tensor
    wt_h3: torch.Tensor  # (GEMM_BN, F): wh3.T over zero rows


# The fields of gsdx's PackedGNN, in its order: each weight once.
GSDX_FIELDS = PackedGNN._fields[:20]
# Each GEMM weight copy and the gsdx weights it transposes, side by side.
GEMM_WEIGHTS = {"wt_2r": ("w2r",), "wt_3r": ("w3r",), "wt_r0": ("wr0",),
                "wt_2p": ("w2p",), "wt_3p": ("w3p",), "wt_p0": ("wp0",),
                "wt_rs": ("wr1", "wr2"), "wt_p1": ("wp1",), "wt_h1": ("wh1",),
                "wt_h2": ("wh2",), "wt_h3": ("wh3",)}


def pack_gnn_params(params, n_his: int = 3, dtype=torch.bfloat16,
                    device: str | torch.device = "cpu") -> PackedGNN:
    """Repack a flax-layout DynamicsPredictor param tree (nested dicts of
    numpy arrays or tensors, with or without the top "params" level).

    The first-layer rows are split by input block; for the cloth/dog/sloth
    layout the z-selection and forward-difference operators fold into one
    (3 * n_his, F) matrix over the history-major node state, computed in
    f32 and kept f32. bf16 casts round to nearest even, as JAX's do, so the
    pack equals gsdx's bit for bit."""
    p = params["params"] if "params" in params else params

    def t(x):
        if torch.is_tensor(x):
            return x.to(device=device, dtype=torch.float32)
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    def dense(mod, i):
        d = p[mod][f"Dense_{i}"]
        return t(d["kernel"]), t(d["bias"])

    k1r, b1r = dense("relation_encoder", 0)
    k2r, b2r = dense("relation_encoder", 1)
    k3r, b3r = dense("relation_encoder", 2)
    k1p, b1p = dense("particle_encoder", 0)
    k2p, b2p = dense("particle_encoder", 1)
    k3p, b3p = dense("particle_encoder", 2)
    kh1, bh1 = dense("non_rigid_predictor", 0)
    kh2, bh2 = dense("non_rigid_predictor", 1)
    kh3, bh3 = dense("non_rigid_predictor", 2)
    krel, brel = t(p["relation_propagator"]["kernel"]), t(p["relation_propagator"]["bias"])
    kpar, bpar = t(p["particle_propagator"]["kernel"]), t(p["particle_propagator"]["bias"])

    F = k2r.shape[0]
    nd = 3 * n_his
    if k1r.shape[0] != 5 + nd:
        raise ValueError(f"the fused forward takes the rope-layout relation "
                         f"inputs (5 + 3 * n_his rows), got {tuple(k1r.shape)}")
    n_state_in = 2 + n_his + 3 * (n_his - 1) + 3
    if k1p.shape[0] == 5:  # rope: attr (2) + action (3)
        w1p_st = torch.zeros((nd, F), dtype=torch.float32, device=device)
        k1p_act = k1p[2:5]
    elif k1p.shape[0] == n_state_in:
        # attr (2) + state z (n_his) + motion (3 * (n_his - 1)) + action (3)
        k1p_z = k1p[2:2 + n_his]
        k1p_mo = k1p[2 + n_his:2 + n_his + 3 * (n_his - 1)]
        k1p_act = k1p[n_state_in - 3:n_state_in]
        s_z = np.zeros((nd, n_his), np.float32)
        for h in range(n_his):
            s_z[3 * h + 2, h] = 1.0
        dmat = np.zeros((nd, 3 * (n_his - 1)), np.float32)
        for h in range(n_his - 1):
            for dd in range(3):
                dmat[3 * (h + 1) + dd, 3 * h + dd] += 1.0
                dmat[3 * h + dd, 3 * h + dd] -= 1.0
        w1p_st = t(s_z) @ k1p_z + t(dmat) @ k1p_mo
    else:
        raise ValueError(f"unsupported particle-encoder input layout: "
                         f"{tuple(k1p.shape)}")

    wh3 = torch.zeros((F, 8), dtype=torch.float32, device=device)
    wh3[:, :3] = kh3
    bh3_pad = torch.zeros((F,), dtype=torch.float32, device=device)
    bh3_pad[:3] = bh3
    biases = torch.stack([b1r, b2r, b3r, brel, b1p, b2p, b3p, bpar, bh1, bh2,
                          bh3_pad, torch.zeros_like(b1r)])

    def w(x):
        return x.to(dtype).contiguous()

    w1r_attr_r, w1r_attr_s, w1r_dist = w(k1r[0:2]), w(k1r[2:4]), w(k1r[5:5 + nd])
    w1p_attr, w1p_act = w(k1p[0:2]), w(k1p_act)
    wr1, wr2 = w(krel[F:2 * F]), w(krel[2 * F:3 * F])
    fields = dict(
        w1r_attr_r=w1r_attr_r, w1r_attr_s=w1r_attr_s, w1r_g=w(k1r[4:5]),
        w1r_dist=w1r_dist, w2r=w(k2r), w3r=w(k3r),
        w1p_attr=w1p_attr, w1p_st=w1p_st.contiguous(), w1p_act=w1p_act,
        w2p=w(k2p), w3p=w(k3p),
        wr0=w(krel[0:F]), wr1=wr1, wr2=wr2,
        wp0=w(kpar[0:F]), wp1=w(kpar[F:2 * F]),
        wh1=w(kh1), wh2=w(kh2), wh3=w(wh3), biases=biases.contiguous(),
        w_nrs=torch.cat([torch.cat([w1r_dist, -w1r_dist], 1),
                         torch.cat([w1r_attr_r, w1r_attr_s], 1)]).contiguous(),
        w_pa=torch.cat([w1p_attr, w1p_act]).contiguous())
    for kt, names in GEMM_WEIGHTS.items():
        x = torch.cat([fields[name] for name in names], 1).t()
        rows = -(-x.shape[0] // GEMM_BN) * GEMM_BN
        fields[kt] = torch.cat([x, x.new_zeros(rows - x.shape[0], F)]).contiguous()
    return PackedGNN(**fields)


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------


def _select(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (B, E) of ``x`` (B, N, C) per sample; -1 reads as zero
    (the one-hot product of the TPU kernel, which is exact)."""
    rows = torch.gather(x, 1, idx.clamp(min=0).long()[..., None].expand(
        -1, -1, x.shape[2]))
    return torch.where((idx >= 0)[..., None], rows, torch.zeros_like(rows))


def gnn_forward_plain(packed: PackedGNN, attrs, action, state_t, g, recv_idx,
                      send_idx, pstep: int = 3, operands: str = "f32") -> torch.Tensor:
    """The fused forward's function in plain PyTorch (any device): the same
    grouping of products as `gnn_forward_xla_twin`, with bf16 weights
    widened at use to the type of the activations, f32 (f64 inputs and an
    f64 `biases`/`w1p_st` give the same function with f64 sums).

    ``operands="f32"``: f32 activations throughout, `gnn_forward_xla_twin`'s
    math. ``operands="bf16"``: what the CUDA kernels compute. The activation
    operand of every product of depth F is rounded to bf16 (nearest even),
    as the kernels store the layer outputs that only a product reads (h1,
    the encoders' hidden layers, enc_r, agg, the head's hidden layers) and
    the bf16 copy of enc_p and of each round's effect. The node-input
    layers, rel_pre, node_pre, the message terms and the residual effect
    stay f32."""
    if operands not in ("f32", "bf16"):
        raise ValueError(f"operands must be 'f32' or 'bf16', got {operands!r}")
    B, n_pad, _ = attrs.shape
    b = packed.biases

    def dot(a, w):
        return a @ w.to(a.dtype)

    def mm(a, w):  # a product of depth F: the GEMM's
        if operands == "bf16":
            a = a.to(torch.bfloat16).to(a.dtype)
        return a @ w.to(a.dtype)

    nr = dot(attrs, packed.w1r_attr_r) + dot(state_t, packed.w1r_dist)
    ns = dot(attrs, packed.w1r_attr_s) - dot(state_t, packed.w1r_dist)
    gdiff = torch.abs(_select(g, recv_idx) - _select(g, send_idx))
    h = torch.relu(_select(nr, recv_idx) + _select(ns, send_idx)
                   + gdiff * packed.w1r_g.to(gdiff.dtype)[0] + b[0])
    h = torch.relu(mm(h, packed.w2r) + b[1])
    enc_r = torch.relu(mm(h, packed.w3r) + b[2])
    rel_pre = mm(enc_r, packed.wr0) + b[3]
    hp = torch.relu(dot(attrs, packed.w1p_attr) + dot(state_t, packed.w1p_st)
                    + dot(action, packed.w1p_act) + b[4])
    hp = torch.relu(mm(hp, packed.w2p) + b[5])
    enc_p = torch.relu(mm(hp, packed.w3p) + b[6])
    node_pre = mm(enc_p, packed.wp0) + b[7]

    F = enc_p.shape[2]
    # receiver of each slot as a row of the flattened (B * (n_pad + 1), F)
    # sum; empty slots go to a spare row per sample that is dropped
    recv = recv_idx.long()
    sink = torch.where(recv >= 0, recv, torch.full_like(recv, n_pad))
    rows = (sink + torch.arange(B, device=recv.device)[:, None] * (n_pad + 1)).reshape(-1)
    effect = enc_p
    for _ in range(pstep):
        ewr = mm(effect, packed.wr1)
        ews = mm(effect, packed.wr2)
        erel = torch.relu(rel_pre + _select(ewr, recv_idx) + _select(ews, send_idx))
        agg = torch.zeros((B * (n_pad + 1), F), dtype=erel.dtype, device=erel.device)
        agg.index_add_(0, rows, erel.reshape(-1, F))
        agg = agg.reshape(B, n_pad + 1, F)[:, :n_pad]
        effect = torch.relu(node_pre + mm(agg, packed.wp1) + effect)
    hh = torch.relu(mm(effect, packed.wh1) + b[8])
    hh = torch.relu(mm(hh, packed.wh2) + b[9])
    return mm(hh, packed.wh3) + b[10, :8]


def gnn_gemm_plain(x: torch.Tensor, wt: torch.Tensor, n: int | None = None, *,
                   bias=None, r1=None, r2=None, relu: bool = False,
                   f32: bool = True, bf16: bool = False):
    """`gnn_gemm`'s function in plain PyTorch: act(x @ wt[:n].T + bias + r1
    + r2) with f32 sums, returned as (f32 or None, bf16 or None)."""
    n = wt.shape[0] if n is None else n
    y = x.float() @ wt[:n].float().t()
    for extra in (bias, r1, r2):
        if extra is not None:
            y = y + extra
    if relu:
        y = torch.relu(y)
    return (y if f32 else None), (y.to(torch.bfloat16) if bf16 else None)


def receiver_segments_plain(recv_idx: torch.Tensor, n_pad: int):
    """`gnn_segments`' function in plain PyTorch: per sample, the non-empty
    slots of ``recv_idx`` (B, E) sorted stably by receiver. Returns seg_off
    (B, n_pad + 1) int32, where receiver n's slots start (seg_off[:, n_pad]
    is the count of non-empty slots), and seg_slot (B, E) int32, the slots
    of each receiver in ascending order, then -1. A slot whose receiver lies
    outside [0, n_pad) is empty."""
    B, E = recv_idx.shape
    inside = (recv_idx >= 0) & (recv_idx < n_pad)
    key = torch.where(inside, recv_idx, n_pad).long()  # empty slots last
    order = torch.sort(key, dim=1, stable=True).indices
    rows = key + torch.arange(B, device=key.device)[:, None] * (n_pad + 1)
    counts = torch.bincount(rows.reshape(-1), minlength=B * (n_pad + 1))
    counts = counts.reshape(B, n_pad + 1)[:, :n_pad]
    seg_off = torch.cat([counts.new_zeros(B, 1), torch.cumsum(counts, 1)], 1)
    pos = torch.arange(E, device=key.device)[None]
    seg_slot = torch.where(pos < seg_off[:, -1:], order, torch.full_like(order, -1))
    return seg_off.to(torch.int32), seg_slot.to(torch.int32)


def gnn_message_plain(rel_pre: torch.Tensor, ew: torch.Tensor, seg_off: torch.Tensor,
                      seg_slot: torch.Tensor, send_idx: torch.Tensor, n_pad: int,
                      bf16: bool = True) -> torch.Tensor:
    """`gnn_message`'s function in plain PyTorch: agg (B * n_pad, F), row
    (b, n) the sum over receiver n's segment, in slot order, of
    relu((rel_pre[slot] + ewr[b, n]) + ews[b, send[slot]]) (ews of an empty
    sender reads as zero). rel_pre (B * E, F) and ew (B * n_pad, 2F) =
    ewr | ews f32, the segments of `receiver_segments_plain`. The sum runs
    one padded segment column at a time, each row adding its j-th slot (or
    zero past its segment), so every entry is the kernel's sequence of f32
    adds: bit-equal on the card. bf16 (nearest even) as the kernel stores
    it, or the f32 sums."""
    B, E = send_idx.shape
    F = ew.shape[1] // 2
    dev = ew.device
    ewr, ews = ew[:, :F], ew[:, F:]
    beg = seg_off[:, :-1].long()
    cnt = seg_off[:, 1:].long() - beg
    base_e = (torch.arange(B, device=dev) * E)[:, None]
    base_n = (torch.arange(B, device=dev) * n_pad)[:, None]
    acc = torch.zeros(B * n_pad, F, dtype=torch.float32, device=dev)
    slots, send = seg_slot.long(), send_idx.long()
    for j in range(int(cnt.max()) if cnt.numel() else 0):
        valid = j < cnt  # (B, n_pad)
        slot = torch.gather(slots, 1, (beg + j).clamp(max=max(E - 1, 0)))
        slot = torch.where(valid, slot, torch.zeros_like(slot))
        s = torch.gather(send, 1, slot)
        rp = rel_pre[(base_e + slot).reshape(-1)]
        es = ews[(base_n + s.clamp(min=0)).reshape(-1)]
        es = torch.where((s >= 0).reshape(-1, 1), es, torch.zeros_like(es))
        term = torch.relu(rp + ewr + es)
        acc = acc + torch.where(valid.reshape(-1, 1), term, torch.zeros_like(term))
    return acc.to(torch.bfloat16) if bf16 else acc


# --------------------------------------------------------------------------
# CUDA kernels: wrappers
# --------------------------------------------------------------------------

LIBRARY = CudaLibrary(
    "gsdx_gnn_forward", "gnn_forward.cu",
    {"gsdx_gnn_linear": [PTR, I32, PTR, I32, PTR, PTR, PTR, PTR, I32, I32, I32, I32, PTR],
     "gsdx_gnn_edge_first": [PTR] * 7 + [I32] * 4 + [PTR],
     "gsdx_gnn_segments": [PTR] * 3 + [I32] * 3 + [PTR],
     "gsdx_gnn_message": [PTR] * 6 + [I32] * 4 + [PTR]},
    error_string="gsdx_gnn_error_string")

GEMM_LIBRARY = CudaLibrary(
    "gsdx_gnn_gemm", "gnn_gemm.cu",
    {"gsdx_gnn_gemm": [PTR, PTR, I32, I32, I32, PTR, PTR, PTR, PTR, PTR, I32, PTR],
     "gsdx_gnn_gemm_last_launch": [PTR]},
    error_string="gsdx_gnn_gemm_error_string")

GEMM_LAUNCH_FIELDS = ("grid", "tiles", "block_m", "block_n", "stages", "sms", "tma_store",
                      "persistent")


def gemm_last_launch() -> dict:
    """The GEMM's last accepted launch as the C side made it: blocks in the
    grid, output tiles, the tile's rows and columns, ring stages, the
    device's SM count, and whether the epilogue stored by TMA and the grid
    was persistent (1 or 0)."""
    out = (ctypes.c_int * len(GEMM_LAUNCH_FIELDS))()
    GEMM_LIBRARY.load().gsdx_gnn_gemm_last_launch(ctypes.cast(out, ctypes.c_void_p))
    return dict(zip(GEMM_LAUNCH_FIELDS, out))


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def gnn_gemm(x: torch.Tensor, wt: torch.Tensor, n: int | None = None, *,
             bias=None, r1=None, r2=None, relu: bool = False, f32: bool = True,
             bf16: bool = False):
    """act(x @ wt[:n].T + bias + r1 + r2) -> (f32 or None, bf16 or None).

    x (M, K) bf16, wt (N_w, K) a K-major bf16 weight copy of `pack_gnn_params`
    (N_w the multiple of 128 at or above n, default N_w), bias (n,), r1 and
    r2 (M, n) f32. CUDA tensors launch the tensor-core GEMM of
    `csrc/gnn_gemm.cu`; CPU tensors run `gnn_gemm_plain`."""
    if not x.is_cuda:
        return gnn_gemm_plain(x, wt, n, bias=bias, r1=r1, r2=r2, relu=relu,
                              f32=f32, bf16=bf16)
    n = wt.shape[0] if n is None else n
    M, K = x.shape
    if (x.dtype != torch.bfloat16 or wt.dtype != torch.bfloat16 or x.dim() != 2
            or not x.is_contiguous() or not wt.is_contiguous() or wt.shape[1] != K
            or K % 64 or n % 8 or n <= 0
            or wt.shape[0] != -(-n // GEMM_BN) * GEMM_BN or wt.device != x.device):
        raise ValueError(f"gnn_gemm: x {tuple(x.shape)} {x.dtype}, wt {tuple(wt.shape)} "
                         f"{wt.dtype}, n {n}: wants contiguous bf16 on one device, "
                         "K a multiple of 64, n of 8, wt rows n rounded up to 128")
    for name, t, shape in (("bias", bias, (n,)), ("r1", r1, (M, n)), ("r2", r2, (M, n))):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != shape
                              or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"gnn_gemm: {name} must be a contiguous f32 {shape} "
                             f"tensor on {x.device}")
    if not (f32 or bf16):
        raise ValueError("gnn_gemm: ask for an f32 or a bf16 output")
    y = torch.empty((M, n), dtype=torch.float32, device=x.device) if f32 else None
    yb = torch.empty((M, n), dtype=torch.bfloat16, device=x.device) if bf16 else None
    err = GEMM_LIBRARY.load().gsdx_gnn_gemm(
        x.data_ptr(), wt.data_ptr(), M, n, K, _ptr(bias), _ptr(r1), _ptr(r2),
        _ptr(y), _ptr(yb), int(relu), torch.cuda.current_stream(x.device).cuda_stream)
    GEMM_LIBRARY.check(err, "gnn_gemm")
    LAUNCHES["gnn_gemm"] += 1
    return y, yb


def gnn_segments(recv_idx: torch.Tensor, n_pad: int):
    """(seg_off (B, n_pad + 1), seg_slot (B, E)) int32 of ``recv_idx`` (B, E)
    int32, as `receiver_segments_plain` gives them (a receiver outside
    [0, n_pad) makes its slot empty). A CUDA tensor launches
    `gnn_segments_kernel`; a CPU tensor runs the plain version."""
    if not recv_idx.is_cuda:
        return receiver_segments_plain(recv_idx, n_pad)
    if recv_idx.dtype != torch.int32 or recv_idx.dim() != 2 or not 0 < n_pad <= 1024:
        raise ValueError(f"gnn_segments: recv_idx {tuple(recv_idx.shape)} {recv_idx.dtype}, "
                         f"n_pad {n_pad}: wants (B, E) int32 and n_pad in (0, 1024]")
    recv_idx = recv_idx.contiguous()
    B, E = recv_idx.shape
    seg_off = torch.empty((B, n_pad + 1), dtype=torch.int32, device=recv_idx.device)
    seg_slot = torch.empty((B, E), dtype=torch.int32, device=recv_idx.device)
    err = LIBRARY.load().gsdx_gnn_segments(
        recv_idx.data_ptr(), seg_off.data_ptr(), seg_slot.data_ptr(), B, E, n_pad,
        torch.cuda.current_stream(recv_idx.device).cuda_stream)
    LIBRARY.check(err, "gnn_segments")
    LAUNCHES["gnn_segments"] += 1
    return seg_off, seg_slot


def gnn_message(rel_pre: torch.Tensor, ew: torch.Tensor, seg_off: torch.Tensor,
                seg_slot: torch.Tensor, send_idx: torch.Tensor, n_pad: int) -> torch.Tensor:
    """One message round's aggregation, agg (B * n_pad, F) bf16; the
    arguments as `gnn_message_plain`'s. CUDA tensors launch
    `gnn_message_kernel`; CPU tensors run the plain version. Senders are
    not checked here (`fused_gnn_forward` checks them): each must lie in
    [-1, n_pad)."""
    if not ew.is_cuda:
        return gnn_message_plain(rel_pre, ew, seg_off, seg_slot, send_idx, n_pad)
    B, E = send_idx.shape
    F = ew.shape[1] // 2
    want = {"rel_pre": (rel_pre, torch.float32, (B * E, F)),
            "ew": (ew, torch.float32, (B * n_pad, 2 * F)),
            "seg_off": (seg_off, torch.int32, (B, n_pad + 1)),
            "seg_slot": (seg_slot, torch.int32, (B, E)),
            "send_idx": (send_idx, torch.int32, (B, E))}
    for name, (t, dtype, shape) in want.items():
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != ew.device):
            raise ValueError(f"gnn_message: {name} must be a contiguous {dtype} {shape} "
                             f"tensor on {ew.device}, got {t.dtype} {tuple(t.shape)}")
    agg = torch.empty((B * n_pad, F), dtype=torch.bfloat16, device=ew.device)
    err = LIBRARY.load().gsdx_gnn_message(
        rel_pre.data_ptr(), ew.data_ptr(), seg_off.data_ptr(), seg_slot.data_ptr(),
        send_idx.data_ptr(), agg.data_ptr(), B, E, n_pad, F,
        torch.cuda.current_stream(ew.device).cuda_stream)
    LIBRARY.check(err, "gnn_message")
    LAUNCHES["gnn_message"] += 1
    return agg


def _check_inputs(packed: PackedGNN, **tensors) -> torch.device:
    dev = None
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        want = torch.int32 if name in ("recv_idx", "send_idx") else torch.float32
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")
    for name, t in packed._asdict().items():
        want = torch.float32 if name in ("w1p_st", "biases") else torch.bfloat16
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"packed.{name} must be a contiguous {want} tensor "
                             f"on {dev}, got {t.dtype} on {t.device}")
    F = packed.w2r.shape[0]
    if F % 128 or F > 4096:
        raise ValueError(f"width {F} unsupported: the kernels take a multiple "
                         "of 128 up to 4096")
    return dev


def _check_indices(recv_idx: torch.Tensor, send_idx: torch.Tensor, n_pad: int) -> None:
    """Every slot holds -1 (empty) or a node row below ``n_pad``: the kernels
    read the rows unchecked. One host read."""
    if recv_idx.device != send_idx.device:
        raise ValueError(f"recv_idx is on {recv_idx.device}, send_idx on {send_idx.device}")
    if recv_idx.numel() == 0:
        return
    lo_r, hi_r, lo_s, hi_s = host_read("gnn_indices", torch.stack([*torch.aminmax(recv_idx),
                                                                   *torch.aminmax(send_idx)]))
    if min(lo_r, lo_s) < -1 or max(hi_r, hi_s) >= n_pad:
        raise ValueError(f"edge indices must lie in [-1, {n_pad}), got recv in "
                         f"[{lo_r}, {hi_r}], send in [{lo_s}, {hi_s}]")


def fused_gnn_forward(packed: PackedGNN, attrs, action, state_t, g, recv_idx,
                      send_idx, pstep: int = 3) -> torch.Tensor:
    """Batched fused forward; see the module docstring for shapes. CUDA
    tensors launch the kernels of `csrc/gnn_forward.cu` and `csrc/gnn_gemm.cu`
    (bf16 weights and product operands, f32 sums); CPU tensors run
    `gnn_forward_plain(operands="bf16")`, their plain version. An edge index
    outside [-1, n_pad) raises on either. Spans: ``gnn.check`` (the index
    check and its host read), ``gnn.launch`` (the launches)."""
    with span("gnn.check"):
        _check_indices(recv_idx, send_idx, attrs.shape[1])
    if not attrs.is_cuda:
        return gnn_forward_plain(packed, attrs, action, state_t, g, recv_idx,
                                 send_idx, pstep, operands="bf16")
    with span("gnn.launch"):
        return _launch_forward(packed, attrs, action, state_t, g, recv_idx, send_idx, pstep)


def _launch_forward(packed: PackedGNN, attrs, action, state_t, g, recv_idx,
                    send_idx, pstep: int) -> torch.Tensor:
    """The CUDA launches of `fused_gnn_forward`, after its index check."""
    B, n_pad, _ = attrs.shape
    E = recv_idx.shape[1]
    nd = state_t.shape[2]
    if (n_pad not in N_PAD_CHOICES or attrs.shape[2] != 2
            or action.shape != (B, n_pad, 3) or state_t.shape[:2] != (B, n_pad)
            or g.shape != (B, n_pad, 1) or send_idx.shape != (B, E)
            or packed.w1r_dist.shape[0] != nd):
        raise ValueError("fused_gnn_forward: input shapes do not match "
                         f"(attrs {tuple(attrs.shape)}, n_pad in {N_PAD_CHOICES})")
    dev = _check_inputs(packed, attrs=attrs, action=action, state_t=state_t,
                        g=g, recv_idx=recv_idx, send_idx=send_idx)
    recv_idx, send_idx = recv_idx.contiguous(), send_idx.contiguous()
    g = g.contiguous()
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    F = packed.w2r.shape[0]
    Mn, Me = B * n_pad, B * E
    bias = packed.biases

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    def linear(x, ldx, w, M, N, K, *, y=None, yb=None, b=None, r=None, relu=False):
        """A node-input layer (K <= 32) on the CUDA cores."""
        err = lib.gsdx_gnn_linear(
            x.data_ptr(), ldx, w.data_ptr(), int(w.dtype == torch.float32), _ptr(b),
            _ptr(r), _ptr(y), _ptr(yb), M, N, K, int(relu), stream)
        LIBRARY.check(err, "gnn_linear")
        LAUNCHES["gnn_linear"] += 1

    # node inputs side by side: [state | attrs | action], (Mn, nd + 5), so
    # that the first layers are products with packed.w_nrs and w_pa
    x_node = torch.cat([state_t, attrs, action], -1).reshape(Mn, nd + 5).contiguous()
    ldn = nd + 5

    nrs = empty(Mn, 2 * F)  # nr | ns
    linear(x_node, ldn, packed.w_nrs, Mn, 2 * F, nd + 2, y=nrs)
    st_w = empty(Mn, F)
    linear(x_node, ldn, packed.w1p_st, Mn, F, nd, y=st_w)  # st @ w1p_st
    hp = empty(Mn, F, dtype=torch.bfloat16)
    x_pa = x_node[:, nd:]  # attrs | action, row stride ldn
    linear(x_pa, ldn, packed.w_pa, Mn, F, 5, yb=hp, b=bias[4], r=st_w, relu=True)
    del st_w
    _, hp = gnn_gemm(hp, packed.wt_2p, bias=bias[5], relu=True, f32=False, bf16=True)
    enc_p, enc_p16 = gnn_gemm(hp, packed.wt_3p, bias=bias[6], relu=True, bf16=True)
    node_pre, _ = gnn_gemm(enc_p16, packed.wt_p0, bias=bias[7])

    h1 = empty(Me, F, dtype=torch.bfloat16)
    err = lib.gsdx_gnn_edge_first(nrs.data_ptr(), g.data_ptr(), recv_idx.data_ptr(),
                                  send_idx.data_ptr(), packed.w1r_g.data_ptr(),
                                  bias[0].data_ptr(), h1.data_ptr(), B, E, n_pad,
                                  F, stream)
    LIBRARY.check(err, "gnn_edge_first")
    LAUNCHES["gnn_edge_first"] += 1
    del nrs
    _, h = gnn_gemm(h1, packed.wt_2r, bias=bias[1], relu=True, f32=False, bf16=True)
    del h1
    _, h = gnn_gemm(h, packed.wt_3r, bias=bias[2], relu=True, f32=False, bf16=True)
    rel_pre, _ = gnn_gemm(h, packed.wt_r0, bias=bias[3])
    del h

    # the receiver segments, once for the three rounds
    seg_off, seg_slot = gnn_segments(recv_idx, n_pad)
    effect, effect16 = enc_p, enc_p16
    for r in range(pstep):
        ew, _ = gnn_gemm(effect16, packed.wt_rs)  # (Mn, 2F): ewr | ews
        agg = gnn_message(rel_pre, ew, seg_off, seg_slot, send_idx, n_pad)
        # the last round's effect is read only by the head's product
        effect, effect16 = gnn_gemm(agg, packed.wt_p1, r1=node_pre, r2=effect,
                                    relu=True, f32=r < pstep - 1, bf16=True)

    _, hh = gnn_gemm(effect16, packed.wt_h1, bias=bias[8], relu=True, f32=False, bf16=True)
    _, hh = gnn_gemm(hh, packed.wt_h2, bias=bias[9], relu=True, f32=False, bf16=True)
    out, _ = gnn_gemm(hh, packed.wt_h3, 8, bias=bias[10, :8])
    LAUNCHES["gnn_forward"] += 1
    return out.reshape(B, n_pad, 8)


def forward_flops(n_rows: int, n_edges: int, F: int, nd: int, pstep: int,
                  n_messages: int | None = None) -> int:
    """Multiply-add operations (2 per MAC) of one fused forward in the
    index form: ``n_rows`` node rows, ``n_edges`` edge rows, ``n_messages``
    edges that reach an aggregation (default all)."""
    n_messages = n_edges if n_messages is None else n_messages
    node_first = 2 * n_rows * F * (2 * (nd + 2) + nd + 5)
    edge_first = 6 * n_edges * F
    mlp = 2 * F * F * (3 * n_edges + 3 * n_rows)
    rounds = pstep * (2 * n_rows * F * 3 * F + 4 * n_messages * F)
    head = 2 * n_rows * F * (2 * F + 8)
    return node_first + edge_first + mlp + rounds + head


def message_counts(recv_idx: torch.Tensor, send_idx: torch.Tensor, n_pad: int) -> dict:
    """What a message round of these (B, E) slots must read, as
    `forward_bytes` takes it: the slots that reach an aggregation
    (``n_messages``), the distinct receivers among them (the ewr rows
    read, ``n_receivers``) and the distinct senders (the ews rows read,
    ``n_senders``)."""
    B = recv_idx.shape[0]
    base = torch.arange(B, device=recv_idx.device)[:, None] * n_pad
    msg = (recv_idx >= 0) & (recv_idx < n_pad)
    used = msg & (send_idx >= 0)
    return {"n_messages": int(msg.sum()),
            "n_receivers": int(torch.unique((recv_idx + base)[msg]).numel()),
            "n_senders": int(torch.unique((send_idx + base)[used]).numel())}


def forward_bytes(n_rows: int, n_edges: int, F: int, nd: int, pstep: int,
                  n_messages: int | None = None, n_samples: int = 1,
                  n_receivers: int | None = None, n_senders: int | None = None) -> dict:
    """Device-memory bytes of one forward in this unfused design, by
    kernel: each launch reads its inputs once and writes its outputs once
    (weights and indices included), for ``n_rows`` node rows and
    ``n_edges`` edge rows (slots) of ``n_samples`` samples, with the
    activation types of `fused_gnn_forward`. A message round reads the
    rel_pre rows and indices only of the ``n_messages`` slots that reach an
    aggregation, the ewr rows of their ``n_receivers`` receivers and the
    ews rows of their ``n_senders`` senders (default all; `message_counts`
    counts them)."""
    bf, f4, i4 = 2, 4, 4
    Mn, Me = n_rows, n_edges
    n_messages = n_edges if n_messages is None else n_messages
    n_receivers = n_rows if n_receivers is None else n_receivers
    n_senders = n_rows if n_senders is None else n_senders

    def gemm(M, N, residuals=0, f32=False, bf16=False, bias=True):
        return (M * F * bf + N * F * bf + bias * N * f4 + residuals * M * N * f4
                + f32 * M * N * f4 + bf16 * M * N * bf)

    x_node = Mn * (nd + 5) * f4
    linear = (x_node + (nd + 2) * 2 * F * bf + Mn * 2 * F * f4  # nr | ns
              + x_node + nd * F * f4 + Mn * F * f4  # st @ w1p_st
              + x_node + Mn * F * f4 + 5 * F * bf + Mn * F * bf)  # hp, bf16
    products = (gemm(Mn, F, bf16=True) + gemm(Mn, F, f32=True, bf16=True)
                + gemm(Mn, F, f32=True) + 2 * gemm(Me, F, bf16=True) + gemm(Me, F, f32=True)
                + 2 * gemm(Mn, F, bf16=True) + gemm(Mn, 8, f32=True))
    seg_off = (Mn + n_samples) * i4
    # receivers in; segment starts and slots out
    segments = Me * i4 + seg_off + Me * i4
    message = 0
    for r in range(pstep):
        products += gemm(Mn, 2 * F, f32=True, bias=False)
        products += gemm(Mn, F, residuals=2, f32=r < pstep - 1, bf16=True, bias=False)
        # rel_pre rows, slots and senders of the messages; the receivers'
        # ewr and the senders' ews rows, the segment starts; agg bf16 out
        message += (n_messages * (F * f4 + 2 * i4) + (n_receivers + n_senders) * F * f4
                    + seg_off + Mn * F * bf)
    # edge layer 1: nr | ns, g, two index vectors in; h1 bf16 out
    edge_first = Mn * 2 * F * f4 + Mn * f4 + 2 * Me * 4 + 2 * F * f4 + Me * F * bf
    return {"gnn_linear": linear, "gnn_gemm": products, "gnn_edge_first": edge_first,
            "gnn_segments": segments, "gnn_message": message}
