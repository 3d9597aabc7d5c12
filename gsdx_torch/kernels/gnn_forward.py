"""Fused GNN dynamics forward for the MPPI rollout (counterpart of
`gsdx/kernels/gnn_forward.py`).

Three pieces:

  * `pack_gnn_params` — the flax-layout param tree repacked as gsdx packs it:
    the relation encoder's first layer split by input block, the particle
    encoder's node-state block folded into one f32 matrix (`w1p_st`, zero
    for rope), the motion head padded to 8 columns and the (12, F) bias
    stack; then three blocks concatenated as the kernels read them. Weights
    are bf16 by default.
  * `gnn_forward_plain` — the plain PyTorch version (the counterpart of
    `gnn_forward_xla_twin`): the CPU path and the kernel's oracle. Edge
    selections are row gathers (-1 reads as zero), the aggregation over
    receivers an `index_add_`.
  * `fused_gnn_forward` — the wrapper of the hand-written CUDA kernels in
    `gsdx_torch/csrc/gnn_forward.cu` (the Hopper port of gsdx's Pallas
    `_gnn_kernel`). A CUDA tensor launches them or raises; only CPU tensors
    take the plain version. `LAUNCHES` counts the launches.

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

from typing import NamedTuple

import numpy as np
import torch

from gsdx_torch.kernels._build import I32, PTR, CudaLibrary

# Node slots the kernels are padded to (objects + tool), as in gsdx.
N_PAD_CHOICES = (128, 256)

# Launches counted by the wrapper where it launches: one "gnn_forward" per
# fused forward, and each of its three kernels per launch.
LAUNCHES = {"gnn_forward": 0, "gnn_linear": 0, "gnn_edge_first": 0,
            "gnn_message": 0}


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
    w_rs: torch.Tensor  # (F, 2F): wr1 | wr2


# The fields of gsdx's PackedGNN, in its order: each weight once.
GSDX_FIELDS = PackedGNN._fields[:20]


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
    return PackedGNN(
        w1r_attr_r=w1r_attr_r, w1r_attr_s=w1r_attr_s, w1r_g=w(k1r[4:5]),
        w1r_dist=w1r_dist, w2r=w(k2r), w3r=w(k3r),
        w1p_attr=w1p_attr, w1p_st=w1p_st.contiguous(), w1p_act=w1p_act,
        w2p=w(k2p), w3p=w(k3p),
        wr0=w(krel[0:F]), wr1=wr1, wr2=wr2,
        wp0=w(kpar[0:F]), wp1=w(kpar[F:2 * F]),
        wh1=w(kh1), wh2=w(kh2), wh3=w(wh3), biases=biases.contiguous(),
        w_nrs=torch.cat([torch.cat([w1r_dist, -w1r_dist], 1),
                         torch.cat([w1r_attr_r, w1r_attr_s], 1)]).contiguous(),
        w_pa=torch.cat([w1p_attr, w1p_act]).contiguous(),
        w_rs=torch.cat([wr1, wr2], 1).contiguous())


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
                      send_idx, pstep: int = 3) -> torch.Tensor:
    """The fused forward's function in plain PyTorch (any device): the same
    grouping of products and the same f32 math as `gnn_forward_xla_twin`,
    with bf16 weights widened to f32 at use."""
    B, n_pad, _ = attrs.shape
    b = packed.biases

    def dot(a, w):
        return a @ w.float()

    nr = dot(attrs, packed.w1r_attr_r) + dot(state_t, packed.w1r_dist)
    ns = dot(attrs, packed.w1r_attr_s) - dot(state_t, packed.w1r_dist)
    gdiff = torch.abs(_select(g, recv_idx) - _select(g, send_idx))
    h = torch.relu(_select(nr, recv_idx) + _select(ns, send_idx)
                   + gdiff * packed.w1r_g.float()[0] + b[0])
    h = torch.relu(dot(h, packed.w2r) + b[1])
    enc_r = torch.relu(dot(h, packed.w3r) + b[2])
    rel_pre = dot(enc_r, packed.wr0) + b[3]
    hp = torch.relu(dot(attrs, packed.w1p_attr) + dot(state_t, packed.w1p_st)
                    + dot(action, packed.w1p_act) + b[4])
    hp = torch.relu(dot(hp, packed.w2p) + b[5])
    enc_p = torch.relu(dot(hp, packed.w3p) + b[6])
    node_pre = dot(enc_p, packed.wp0) + b[7]

    F = enc_p.shape[2]
    # receiver of each slot as a row of the flattened (B * (n_pad + 1), F)
    # sum; empty slots go to a spare row per sample that is dropped
    recv = recv_idx.long()
    sink = torch.where(recv >= 0, recv, torch.full_like(recv, n_pad))
    rows = (sink + torch.arange(B, device=recv.device)[:, None] * (n_pad + 1)).reshape(-1)
    effect = enc_p
    for _ in range(pstep):
        ewr = dot(effect, packed.wr1)
        ews = dot(effect, packed.wr2)
        erel = torch.relu(rel_pre + _select(ewr, recv_idx) + _select(ews, send_idx))
        agg = torch.zeros((B * (n_pad + 1), F), dtype=erel.dtype, device=erel.device)
        agg.index_add_(0, rows, erel.reshape(-1, F))
        agg = agg.reshape(B, n_pad + 1, F)[:, :n_pad]
        effect = torch.relu(node_pre + dot(agg, packed.wp1) + effect)
    hh = torch.relu(dot(effect, packed.wh1) + b[8])
    hh = torch.relu(dot(hh, packed.wh2) + b[9])
    return dot(hh, packed.wh3) + b[10, :8]


# --------------------------------------------------------------------------
# CUDA kernels: wrapper
# --------------------------------------------------------------------------

LIBRARY = CudaLibrary(
    "gsdx_gnn_forward", "gnn_forward.cu",
    {"gsdx_gnn_linear": [PTR, I32, PTR, I32, I32, PTR, PTR, PTR, I32, PTR,
                         I32, I32, I32, I32, I32, PTR],
     "gsdx_gnn_edge_first": [PTR] * 7 + [I32] * 4 + [PTR],
     "gsdx_gnn_message": [PTR] * 5 + [I32] * 4 + [PTR]},
    error_string="gsdx_gnn_error_string")


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
    lo_r, hi_r, lo_s, hi_s = torch.stack([*torch.aminmax(recv_idx),
                                          *torch.aminmax(send_idx)]).tolist()
    if min(lo_r, lo_s) < -1 or max(hi_r, hi_s) >= n_pad:
        raise ValueError(f"edge indices must lie in [-1, {n_pad}), got recv in "
                         f"[{lo_r}, {hi_r}], send in [{lo_s}, {hi_s}]")


def fused_gnn_forward(packed: PackedGNN, attrs, action, state_t, g, recv_idx,
                      send_idx, pstep: int = 3) -> torch.Tensor:
    """Batched fused forward; see the module docstring for shapes. CUDA
    tensors launch the kernels of `csrc/gnn_forward.cu` (bf16 weights, f32
    activations and arithmetic); CPU tensors run `gnn_forward_plain`. An
    edge index outside [-1, n_pad) raises on either."""
    _check_indices(recv_idx, send_idx, attrs.shape[1])
    if not attrs.is_cuda:
        return gnn_forward_plain(packed, attrs, action, state_t, g, recv_idx,
                                 send_idx, pstep)
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

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def linear(x, ldx, w, y, ldy, M, N, K, *, ldw=None, b=None, r1=None,
               r2=None, ldr=0, relu=False):
        err = lib.gsdx_gnn_linear(
            x.data_ptr(), ldx, w.data_ptr(), int(w.dtype == torch.float32),
            ldw or N, None if b is None else b.data_ptr(),
            None if r1 is None else r1.data_ptr(),
            None if r2 is None else r2.data_ptr(), ldr, y.data_ptr(), ldy,
            M, N, K, int(relu), stream)
        LIBRARY.check(err, "gnn_linear")
        LAUNCHES["gnn_linear"] += 1

    # node inputs side by side: [state | attrs | action], (Mn, nd + 5), so
    # that the first layers are products with packed.w_nrs and w_pa
    x_node = torch.cat([state_t, attrs, action], -1).reshape(Mn, nd + 5).contiguous()
    ldn = nd + 5

    nrs = empty(Mn, 2 * F)  # nr | ns
    linear(x_node, ldn, packed.w_nrs, nrs, 2 * F, Mn, 2 * F, nd + 2)
    n_a, n_b, n_c, n_d = empty(Mn, F), empty(Mn, F), empty(Mn, F), empty(Mn, F)
    linear(x_node, ldn, packed.w1p_st, n_a, F, Mn, F, nd)  # st @ w1p_st
    x_pa = x_node[:, nd:]  # attrs | action, row stride ldn
    linear(x_pa, ldn, packed.w_pa, n_b, F, Mn, F, 5, b=bias[4], r1=n_a, ldr=F, relu=True)
    linear(n_b, F, packed.w2p, n_a, F, Mn, F, F, b=bias[5], relu=True)
    enc_p = n_b
    linear(n_a, F, packed.w3p, enc_p, F, Mn, F, F, b=bias[6], relu=True)
    node_pre = n_c
    linear(enc_p, F, packed.wp0, node_pre, F, Mn, F, F, b=bias[7])

    e_a, e_b = empty(Me, F), empty(Me, F)
    err = lib.gsdx_gnn_edge_first(nrs.data_ptr(), g.data_ptr(), recv_idx.data_ptr(),
                                  send_idx.data_ptr(), packed.w1r_g.data_ptr(),
                                  bias[0].data_ptr(), e_a.data_ptr(), B, E, n_pad,
                                  F, stream)
    LIBRARY.check(err, "gnn_edge_first")
    LAUNCHES["gnn_edge_first"] += 1
    linear(e_a, F, packed.w2r, e_b, F, Me, F, F, b=bias[1], relu=True)
    linear(e_b, F, packed.w3r, e_a, F, Me, F, F, b=bias[2], relu=True)
    rel_pre = e_b
    linear(e_a, F, packed.wr0, rel_pre, F, Me, F, F, b=bias[3])
    del e_a

    ew = nrs  # (Mn, 2F): ewr | ews, reusing the first layer's buffer
    agg = n_a
    effect, spare = enc_p, n_d
    for _ in range(pstep):
        linear(effect, F, packed.w_rs, ew, 2 * F, Mn, 2 * F, F)
        err = lib.gsdx_gnn_message(rel_pre.data_ptr(), ew.data_ptr(),
                                   recv_idx.data_ptr(), send_idx.data_ptr(),
                                   agg.data_ptr(), B, E, n_pad, F, stream)
        LIBRARY.check(err, "gnn_message")
        LAUNCHES["gnn_message"] += 1
        linear(agg, F, packed.wp1, spare, F, Mn, F, F, r1=node_pre, r2=effect,
               ldr=F, relu=True)
        effect, spare = spare, effect

    linear(effect, F, packed.wh1, spare, F, Mn, F, F, b=bias[8], relu=True)
    linear(spare, F, packed.wh2, agg, F, Mn, F, F, b=bias[9], relu=True)
    out = empty(Mn, 8)
    linear(agg, F, packed.wh3, out, 8, Mn, 8, F, b=bias[10])
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
