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
    assert torch.equal(port.w_rs, torch.cat([port.wr1, port.wr2], 1))


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
    # on the CPU the wrapper runs the plain version
    wrapped = tg.fused_gnn_forward(port_pack, *map(torch.as_tensor, ins)).numpy()
    np.testing.assert_array_equal(wrapped, out)


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


@pytest.mark.parametrize("which,bad", [("recv", 128), ("send", 200), ("recv", -2),
                                       ("send", -7)])
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
