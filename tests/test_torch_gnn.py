"""gsdx_torch.kernels.gnn_forward (pack, plain version), graph.edges and
kernels.fps against gsdx, on the CPU.

The Pallas kernel runs as gsdx's own tests run it: in interpret mode, and
through its plain-XLA twin. The card-only comparison of the CUDA kernels
with the plain version is tests/test_torch_gnn_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdx.graph import edges as jedges
from gsdx.kernels import fps as jfps
from gsdx.kernels import gnn_forward as jg
from gsdx_torch.dynamics.model import ModelConfig
from gsdx_torch.graph import edges as tedges
from gsdx_torch.kernels import fps as tfps
from gsdx_torch.kernels import gnn_forward as tg

from test_torch_dynamics import _jax_tree, trained_tree


@pytest.mark.parametrize("weights", ["trained_rope", "random_cloth"])
def test_pack_equals_gsdx_bit_for_bit(weights):
    if weights == "trained_rope":
        tree = trained_tree()
    else:
        tree = _jax_tree(ModelConfig(state_dim=1, motion_dim=3))
    ref = jg.pack_gnn_params(jax.tree.map(jnp.asarray, tree), n_his=3)
    port = tg.pack_gnn_params(tree, n_his=3)
    assert tg.GSDX_FIELDS == ref._fields
    for name, a, b in zip(ref._fields, ref, port):
        want = jnp.float32 if name in ("w1p_st", "biases") else jnp.bfloat16
        assert a.dtype == want and b.dtype == getattr(torch, jnp.dtype(want).name)
        a32 = np.asarray(a.astype(jnp.float32))
        assert a32.shape == tuple(b.shape), name
        assert a32.view(np.uint32).tobytes() == b.float().numpy().view(
            np.uint32).tobytes(), name
    # the kernels' blocks are those weights side by side
    assert torch.equal(port.w_nrs, torch.cat([
        torch.cat([port.w1r_dist, -port.w1r_dist], 1),
        torch.cat([port.w1r_attr_r, port.w1r_attr_s], 1)]))
    assert torch.equal(port.w_pa, torch.cat([port.w1p_attr, port.w1p_act]))
    # the GEMM's K-major copies are gsdx's weights (side by side) transposed,
    # bit for bit, over zero rows up to a multiple of the GEMM's 128-row tile
    gsdx = {name: np.asarray(a.astype(jnp.float32)) for name, a in zip(ref._fields, ref)}
    assert len(tg.GEMM_WEIGHTS) == 11  # every product of depth F
    for kt, names in tg.GEMM_WEIGHTS.items():
        weight = np.concatenate([gsdx[name] for name in names], 1)
        copy = getattr(port, kt).float().numpy()
        n, k = weight.shape[1], weight.shape[0]
        assert copy.shape == (-(-n // tg.GEMM_BN) * tg.GEMM_BN, k), kt
        assert copy[:n].view(np.uint32).tobytes() == np.ascontiguousarray(
            weight.T).view(np.uint32).tobytes(), kt
        assert not copy[n:].any(), kt


def _inputs(rng, B, n_pad, n_obj, E, n_edges):
    """Padded node inputs and receiver-sorted slots, -1 past n_edges."""
    N = n_obj + 1
    attrs = np.zeros((B, n_pad, 2), np.float32)
    attrs[:, :n_obj, 0] = 1
    attrs[:, n_obj:N, 1] = 1
    act = np.zeros((B, n_pad, 3), np.float32)
    act[:, n_obj] = rng.normal(0, 0.01, (B, 3))
    st = np.zeros((B, n_pad, 9), np.float32)
    st[:, :N] = rng.normal(0, 0.05, (B, N, 9))
    g = np.zeros((B, n_pad, 1), np.float32)
    g[:, :n_obj] = 1
    recv = np.full((B, E), -1, np.int32)
    send = recv.copy()
    for b in range(B):
        recv[b, :n_edges] = np.sort(rng.integers(0, N, n_edges))
        send[b, :n_edges] = rng.integers(0, N, n_edges)
    return attrs, act, st, g, recv, send


CASES = [("trained_rope", 128, 40, 160, 130), ("random_cloth", 256, 140, 400, 380)]


@pytest.mark.parametrize("weights,n_pad,n_obj,E,n_edges", CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_equals_gsdx_twin(rng, weights, n_pad, n_obj, E, n_edges, dtype):
    cfg = ModelConfig() if weights == "trained_rope" else ModelConfig(state_dim=1, motion_dim=3)
    tree = trained_tree() if weights == "trained_rope" else _jax_tree(cfg)
    ref_pack = jg.pack_gnn_params(jax.tree.map(jnp.asarray, tree), n_his=3,
                                  dtype=getattr(jnp, dtype))
    port_pack = tg.pack_gnn_params(tree, n_his=3, dtype=getattr(torch, dtype))
    ins = _inputs(rng, 2, n_pad, n_obj, E, n_edges)
    ref = np.asarray(jg.gnn_forward_xla_twin(ref_pack, *map(jnp.asarray, ins)))
    out = tg.gnn_forward_plain(port_pack, *map(torch.as_tensor, ins)).numpy()
    # the same f32 math, products and the receiver sums in another order:
    # 1e-5 of the output's largest entry
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # on the CPU the wrapper runs the plain version of what the kernels
    # compute: bf16 product operands
    wrapped = tg.fused_gnn_forward(port_pack, *map(torch.as_tensor, ins)).numpy()
    kernels_plain = tg.gnn_forward_plain(port_pack, *map(torch.as_tensor, ins),
                                         operands="bf16").numpy()
    np.testing.assert_array_equal(wrapped, kernels_plain)


@pytest.mark.parametrize("weights,n_pad,n_obj,E,n_edges", CASES)
def test_plain_bf16_operands_against_gsdx_twin(rng, weights, n_pad, n_obj, E, n_edges):
    """The kernels' numerics (`operands="bf16"`: each product of depth F
    rounds its activation operand to bf16, the TPU kernel's DEFAULT-precision
    class) against gsdx's f32-activation twin."""
    cfg = ModelConfig() if weights == "trained_rope" else ModelConfig(state_dim=1, motion_dim=3)
    tree = trained_tree() if weights == "trained_rope" else _jax_tree(cfg)
    ref_pack = jg.pack_gnn_params(jax.tree.map(jnp.asarray, tree), n_his=3)
    port_pack = tg.pack_gnn_params(tree, n_his=3)
    ins = _inputs(rng, 2, n_pad, n_obj, E, n_edges)
    ref = np.asarray(jg.gnn_forward_xla_twin(ref_pack, *map(jnp.asarray, ins)))
    out = tg.gnn_forward_plain(port_pack, *map(torch.as_tensor, ins), operands="bf16").numpy()
    # about 14 layers, each rounding its input to bf16 (2^-9 relative):
    # 5.3e-3 (rope) and 6.2e-3 (cloth) of the output's largest entry
    # measured; 1e-2 bounds it
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    assert np.abs(out - ref).max() > 0  # the operands were rounded
    with pytest.raises(ValueError):
        tg.gnn_forward_plain(port_pack, *map(torch.as_tensor, ins), operands="fp8")


@pytest.mark.parametrize("n", [8, 256])
@pytest.mark.parametrize("epilogue", ["none", "bias_relu", "bias_r1_r2_relu"])
def test_gemm_on_cpu_is_its_plain_version(rng, n, epilogue):
    """`gnn_gemm` on CPU tensors runs `gnn_gemm_plain`: act(x @ wt[:n].T +
    bias + r1 + r2), f32 and bf16 outputs, against numpy in f64."""
    M, K = 37, 128
    x = torch.as_tensor(rng.normal(size=(M, K)).astype(np.float32)).to(torch.bfloat16)
    w = rng.normal(0, K ** -0.5, (n, K)).astype(np.float32)
    wt = torch.zeros(-(-n // tg.GEMM_BN) * tg.GEMM_BN, K, dtype=torch.bfloat16)
    wt[:n] = torch.as_tensor(w)
    extras = {}
    if epilogue != "none":
        extras["bias"] = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    if epilogue == "bias_r1_r2_relu":
        extras["r1"] = torch.as_tensor(rng.normal(size=(M, n)).astype(np.float32))
        extras["r2"] = torch.as_tensor(rng.normal(size=(M, n)).astype(np.float32))
    relu = epilogue != "none"
    y, yb = tg.gnn_gemm(x, wt, n, relu=relu, bf16=True, **extras)
    ref = x.double().numpy() @ wt[:n].double().numpy().T
    for v in extras.values():
        ref = ref + v.double().numpy()
    if relu:
        ref = np.maximum(ref, 0)
    # f32 sums of exact bf16 products: K * 2^-24 of the magnitudes
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=K * 2.0 ** -24 * np.abs(ref).max() + 1e-6)
    np.testing.assert_array_equal(yb.float().numpy(), y.to(torch.bfloat16).float().numpy())
    assert tg.gnn_gemm(x, wt, n, f32=False, bf16=True)[0] is None


def test_plain_equals_interpreted_pallas_kernel(rng):
    tree = trained_tree()
    ref_pack = jg.pack_gnn_params(jax.tree.map(jnp.asarray, tree), n_his=3)
    port_pack = tg.pack_gnn_params(tree, n_his=3)
    ins = _inputs(rng, 1, 128, 30, 96, 80)
    ref = np.asarray(jg.fused_gnn_forward(ref_pack, *map(jnp.asarray, ins),
                                          interpret=True))
    out = tg.gnn_forward_plain(port_pack, *map(torch.as_tensor, ins)).numpy()
    # as tests/test_gnn_fused.py holds the interpreted kernel to its twin
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


BAD_INDICES = [("recv", 128), ("send", 200), ("recv", -2), ("send", -7)]


@pytest.mark.parametrize("which,bad", BAD_INDICES)
def test_wrapper_refuses_edge_indices_out_of_range(rng, which, bad):
    # the kernels read node rows unchecked, so the wrapper checks them on
    # every device; here -1 slots alone pass
    port_pack = tg.pack_gnn_params(trained_tree(), n_his=3)
    ins = list(map(torch.as_tensor, _inputs(rng, 2, 128, 30, 96, 80)))
    tg.fused_gnn_forward(port_pack, *ins)
    k = 4 if which == "recv" else 5
    ins[k] = ins[k].clone()
    ins[k][1, 5] = bad
    with pytest.raises(ValueError, match="edge indices"):
        tg.fused_gnn_forward(port_pack, *ins)


def test_wrapper_with_an_error_word_reads_nothing_back(rng, monkeypatch):
    port_pack = tg.pack_gnn_params(trained_tree(), n_his=3)
    ins = list(map(torch.as_tensor, _inputs(rng, 2, 128, 30, 96, 80)))
    reads = []
    monkeypatch.setattr(tg, "host_read", lambda site, t: reads.append(site) or t.tolist())
    before = dict(tg.CHECKS)
    want = tg.fused_gnn_forward(port_pack, *ins)
    errors = torch.zeros(1, dtype=torch.int32)
    out = tg.fused_gnn_forward(port_pack, *ins, errors=errors)
    assert torch.equal(out, want) and int(errors) == 0
    assert reads == ["gnn_indices"]  # the call without the word alone
    assert {k: tg.CHECKS[k] - before[k] for k in before} == {"host": 1, "device": 1}
    for bad_word in (torch.zeros(1, dtype=torch.int64), torch.zeros(2, dtype=torch.int32)):
        with pytest.raises(ValueError, match="errors must be"):
            tg.fused_gnn_forward(port_pack, *ins, errors=bad_word)


@pytest.mark.parametrize("which,bad", BAD_INDICES)
def test_wrapper_flags_edge_indices_out_of_range_in_the_error_word(rng, which, bad):
    # with the word the call does not raise: the slot reads as empty, as the
    # kernels read it, and its bit is set for the caller to raise on
    port_pack = tg.pack_gnn_params(trained_tree(), n_his=3)
    ins = list(map(torch.as_tensor, _inputs(rng, 2, 128, 30, 96, 80)))
    k = 4 if which == "recv" else 5
    emptied = list(ins)
    ins[k], emptied[k] = ins[k].clone(), ins[k].clone()
    ins[k][1, 5], emptied[k][1, 5] = bad, -1
    errors = torch.zeros(1, dtype=torch.int32)
    out = tg.fused_gnn_forward(port_pack, *ins, errors=errors)
    assert int(errors) == tg.INDEX_ERROR_BITS[which]
    assert torch.equal(out, tg.fused_gnn_forward(port_pack, *emptied))
    with pytest.raises(ValueError, match=f"edge indices.*{which}"):
        tg.raise_on_index_errors(int(errors), 128)
    with pytest.raises(ValueError, match="edge indices"):
        tg.fused_gnn_forward(port_pack, *ins)


def test_pack_refuses_unsupported_layouts():
    # z-state without motion: a particle-encoder input gsdx's pack refuses too
    with pytest.raises(ValueError):
        tg.pack_gnn_params(_jax_tree(ModelConfig(state_dim=1)), n_his=3)
    with pytest.raises(AssertionError):
        jg.pack_gnn_params(jax.tree.map(jnp.asarray, _jax_tree(ModelConfig(state_dim=1))),
                           n_his=3)


# ---------------------------------------------------------------- edges


def _edge_case(rng, kind):
    B, n_obj = 3, 40
    N = n_obj + 1
    st = rng.normal(0, 0.05, (B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), bool)
    tool = np.zeros((B, N), bool)
    tool[:, n_obj:] = True
    max_nR, connect_all = 400, False
    if kind == "zero_padded":  # perceived states padded with zero rows tie
        st[:, 22:n_obj] = 0.0
    elif kind == "masked":
        mask[:, 30:n_obj] = False
    elif kind == "connect_all":
        connect_all = True
    elif kind == "overflow":
        max_nR = 120
    return st, mask, tool, dict(n_obj=n_obj, topk=5, max_nR=max_nR,
                                connect_all=connect_all)


@pytest.mark.parametrize("kind", ["plain", "zero_padded", "masked", "connect_all",
                                  "overflow"])
def test_edges_equal_gsdx(rng, kind):
    st, mask, tool, kw = _edge_case(rng, kind)
    j_args = (jnp.asarray(st), 0.08, jnp.asarray(mask), jnp.asarray(tool))
    t_args = (torch.as_tensor(st), 0.08, torch.as_tensor(mask), torch.as_tensor(tool))
    r_j, s_j = jedges.construct_edge_indices_batch(*j_args, **kw)
    r_t, s_t = tedges.construct_edge_indices_batch(*t_args, **kw)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    n_valid = int((r_t >= 0).sum())
    assert n_valid > 0
    if kind == "overflow":
        assert n_valid == 3 * kw["max_nR"]
    Rr_j, Rs_j = jedges.construct_edges_batch(*j_args, **kw)
    Rr_t, Rs_t = tedges.construct_edges_batch(*t_args, **kw)
    np.testing.assert_array_equal(Rr_t.numpy(), np.asarray(Rr_j))
    np.testing.assert_array_equal(Rs_t.numpy(), np.asarray(Rs_j))
    # single-graph forms
    r1, s1 = tedges.construct_edge_indices(torch.as_tensor(st[0]), 0.08,
                                           torch.as_tensor(mask[0]),
                                           torch.as_tensor(tool[0]), **kw)
    np.testing.assert_array_equal(r1.numpy(), np.asarray(r_j[0]))
    Rr1_j, Rs1_j = jedges.construct_edges(jnp.asarray(st[0]), 0.08, jnp.asarray(mask[0]),
                                          jnp.asarray(tool[0]), **kw)
    Rr1_t, Rs1_t = tedges.construct_edges(torch.as_tensor(st[0]), 0.08,
                                          torch.as_tensor(mask[0]),
                                          torch.as_tensor(tool[0]), **kw)
    np.testing.assert_array_equal(Rr1_t.numpy(), np.asarray(Rr1_j))
    np.testing.assert_array_equal(Rs1_t.numpy(), np.asarray(Rs1_j))


# ---------------------------------------------------------------- FPS


def test_fps_equals_gsdx_with_duplicates(rng):
    pts = rng.normal(0, 0.1, (600, 3)).astype(np.float32)
    pts[100:160] = pts[3]  # duplicated points: both argmaxes take the first
    pts[300:320] = pts[450]
    valid = np.ones(600, bool)
    valid[500:] = False
    for kw in ({}, {"start_idx": 7}):
        a = jfps.farthest_point_sampling(jnp.asarray(pts), 120, **kw)
        b = tfps.farthest_point_sampling(torch.as_tensor(pts), 120, **kw)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    a = jfps.farthest_point_sampling(jnp.asarray(pts), 80, valid=jnp.asarray(valid))
    b = tfps.farthest_point_sampling(torch.as_tensor(pts), 80, valid=torch.as_tensor(valid))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    a, ka = jfps.fps_rad_idx(jnp.asarray(pts), 0.08, max_samples=100)
    b, kb = tfps.fps_rad_idx(torch.as_tensor(pts), 0.08, 100)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(kb.numpy(), np.asarray(ka))
    assert 0 < int(kb.sum()) < 100  # the radius stop fired
