"""The message round's plain versions against numpy and gsdx, on the CPU.

`receiver_segments_plain` (the plain version of the `gnn_segments` kernel)
against a numpy stable argsort, and `gnn_message_plain` (the plain version
of the `gnn_message` kernel) against the one-hot aggregation of gsdx's
`gnn_forward_xla_twin`, `ohr.T @ relu(rel_pre + ohr @ ewr + ohs @ ews)`, run
in JAX on the same numpy inputs. The CUDA kernels are held against these
plain versions on the card (tests/test_torch_gnn_kernel.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdx_torch.kernels import gnn_forward as G


def _numpy_segments(recv: np.ndarray, n_pad: int):
    B, E = recv.shape
    off = np.zeros((B, n_pad + 1), np.int64)
    slots = np.full((B, E), -1, np.int64)
    for b in range(B):
        idx = np.nonzero((recv[b] >= 0) & (recv[b] < n_pad))[0]
        order = idx[np.argsort(recv[b, idx], kind="stable")]
        slots[b, :len(order)] = order
        off[b, 1:] = np.cumsum(np.bincount(recv[b, idx], minlength=n_pad))
    return off, slots


def _slots(case: str, rng):
    """(recv, send, n_pad) of one layout of edge slots."""
    if case == "one_receiver":
        B, E, n_pad = 3, 504, 128
        recv = np.full((B, E), 17, np.int32)
        recv[1, 400:] = -1
    elif case == "all_empty":
        B, E, n_pad = 2, 504, 128
        recv = np.full((B, E), -1, np.int32)
    else:
        B, E, n_pad, n_obj, n_edges = {"receiver_major": (4, 504, 128, 101, 420),
                                       "permuted": (4, 504, 128, 101, 420),
                                       "n256_e1200": (3, 1200, 256, 151, 1100),
                                       "out_of_range": (4, 504, 128, 101, 420)}[case]
        recv = np.full((B, E), -1, np.int32)
        for b in range(B):
            recv[b, :n_edges] = np.sort(rng.integers(0, n_obj, n_edges))
        if case == "permuted":
            recv = recv[:, rng.permutation(E)]
        if case == "out_of_range":  # receivers past n_pad: empty slots
            recv[:, 3::11] = n_pad + rng.integers(0, 1000, recv[:, 3::11].shape)
    send = np.where(recv >= 0, rng.integers(0, n_pad, recv.shape), -1).astype(np.int32)
    send[recv >= 0] = np.where(rng.random(int((recv >= 0).sum())) < 0.05, -1,
                               send[recv >= 0])  # a few empty senders
    return recv, send, n_pad


CASES = ["receiver_major", "permuted", "all_empty", "one_receiver", "n256_e1200",
         "out_of_range"]


@pytest.mark.parametrize("case", CASES)
def test_segments_match_numpy_stable_argsort(case):
    rng = np.random.default_rng(CASES.index(case))
    recv, _, n_pad = _slots(case, rng)
    seg_off, seg_slot = G.receiver_segments_plain(torch.as_tensor(recv), n_pad)
    off, slots = _numpy_segments(recv, n_pad)
    assert seg_off.dtype == torch.int32 and seg_slot.dtype == torch.int32
    np.testing.assert_array_equal(seg_off.numpy(), off)
    np.testing.assert_array_equal(seg_slot.numpy(), slots)


def _gsdx_one_hot_aggregation(rel_pre, ewr, ews, recv, send, n_pad):
    """`gnn_forward_xla_twin`'s round, per sample: the one-hot selections
    of the receiver and sender effects, then `ohr.T @ erel`."""

    def one(rel_pre, ewr, ews, recv, send):
        iota_n = jnp.arange(n_pad, dtype=jnp.int32)
        ohr = (recv[:, None] == iota_n[None, :]).astype(jnp.float32)
        ohs = (send[:, None] == iota_n[None, :]).astype(jnp.float32)
        erel = jax.nn.relu(rel_pre + ohr @ ewr + ohs @ ews)
        return ohr.T @ erel

    return np.asarray(jax.vmap(one)(rel_pre, ewr, ews, recv, send))


# f32 sums of non-negative terms in two orders (slot order here, XLA's dot
# order there): each within a few ulps of the exact sum at these segment
# lengths, so 1e-6 of each entry, plus 1e-6 of the largest for the entries
# that sum to (near) zero.
MESSAGE_RTOL = 1e-6


@pytest.mark.parametrize("case,F", [("receiver_major", 128), ("permuted", 256),
                                    ("all_empty", 128), ("n256_e1200", 128),
                                    ("out_of_range", 128)])
def test_message_matches_gsdx_one_hot(case, F):
    rng = np.random.default_rng(10 + CASES.index(case))
    recv, send, n_pad = _slots(case, rng)
    B, E = recv.shape
    rel_pre = rng.normal(0, 1, (B, E, F)).astype(np.float32)
    ewr = rng.normal(0, 1, (B, n_pad, F)).astype(np.float32)
    ews = rng.normal(0, 1, (B, n_pad, F)).astype(np.float32)
    ref = _gsdx_one_hot_aggregation(rel_pre, ewr, ews, recv, send, n_pad)
    seg_off, seg_slot = G.receiver_segments_plain(torch.as_tensor(recv), n_pad)
    ew = torch.as_tensor(np.concatenate([ewr, ews], -1).reshape(B * n_pad, 2 * F))
    agg = G.gnn_message_plain(torch.as_tensor(rel_pre.reshape(B * E, F)), ew, seg_off,
                              seg_slot, torch.as_tensor(send), n_pad, bf16=False)
    agg = agg.numpy().reshape(B, n_pad, F)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(agg, ref, rtol=MESSAGE_RTOL, atol=MESSAGE_RTOL * scale)
    if case == "all_empty":
        assert not agg.any()


def test_message_bf16_is_the_rounded_f32_sum_and_the_wrappers_take_it_on_cpu():
    """The bf16 output is the f32 sum rounded to nearest even, and on CPU
    tensors the kernel wrappers run the plain versions without a launch."""
    rng = np.random.default_rng(7)
    recv, send, n_pad = _slots("permuted", rng)
    B, E = recv.shape
    F = 128
    rel_pre = torch.as_tensor(rng.normal(0, 1, (B * E, F)).astype(np.float32))
    ew = torch.as_tensor(rng.normal(0, 1, (B * n_pad, 2 * F)).astype(np.float32))
    recv_t, send_t = torch.as_tensor(recv), torch.as_tensor(send)
    before = dict(G.LAUNCHES)
    seg = G.gnn_segments(recv_t, n_pad)
    for a, b in zip(seg, G.receiver_segments_plain(recv_t, n_pad)):
        assert torch.equal(a, b)
    agg = G.gnn_message(rel_pre, ew, *seg, send_t, n_pad)
    f32 = G.gnn_message_plain(rel_pre, ew, *seg, send_t, n_pad, bf16=False)
    assert agg.dtype == torch.bfloat16 and torch.equal(agg, f32.to(torch.bfloat16))
    assert G.LAUNCHES == before


def test_message_plain_matches_the_forward_index_add():
    """The segment walk gives the aggregation `gnn_forward_plain` takes with
    `index_add_` (its oracle against gsdx), within f32 summation order."""
    rng = np.random.default_rng(8)
    recv, send, n_pad = _slots("n256_e1200", rng)
    B, E = recv.shape
    F = 128
    rel_pre = torch.as_tensor(rng.normal(0, 1, (B * E, F)).astype(np.float32))
    ew = torch.as_tensor(rng.normal(0, 1, (B * n_pad, 2 * F)).astype(np.float32))
    recv_t, send_t = torch.as_tensor(recv), torch.as_tensor(send)
    ewr, ews = ew[:, :F].reshape(B, n_pad, F), ew[:, F:].reshape(B, n_pad, F)
    erel = torch.relu(rel_pre.reshape(B, E, F) + G._select(ewr, recv_t)
                      + G._select(ews, send_t))
    sink = torch.where(recv_t >= 0, recv_t.long(), n_pad)
    rows = (sink + torch.arange(B)[:, None] * (n_pad + 1)).reshape(-1)
    ref = torch.zeros(B * (n_pad + 1), F).index_add_(0, rows, erel.reshape(-1, F))
    ref = ref.reshape(B, n_pad + 1, F)[:, :n_pad].reshape(B * n_pad, F)
    agg = G.gnn_message_plain(rel_pre, ew, *G.receiver_segments_plain(recv_t, n_pad),
                              send_t, n_pad, bf16=False)
    torch.testing.assert_close(agg, ref, rtol=MESSAGE_RTOL,
                               atol=MESSAGE_RTOL * float(ref.abs().max()))


def test_forward_bytes_counts_the_message_floor():
    """At the rope chunk with every slot filled and every node row a
    receiver and a sender, a round reads 129 MB of f32 rel_pre and 65.5 MB
    of ewr | ews and writes 16.4 MB of bf16 agg: 0.063 ms at 3.35 TB/s; the
    segments are built once a forward. A round reads the ewr rows of the
    receivers and the ews rows of the senders only."""
    B, n_pad, E, F = 125, 128, 504, 512
    full = G.forward_bytes(B * n_pad, B * E, F, 9, 3, n_samples=B)
    per_round = full["gnn_message"] / 3
    assert 211e6 < per_round < 212e6
    assert 0.0630 < 1e3 * per_round / 3.35e12 < 0.0632
    assert full["gnn_segments"] == (2 * B * E + B * (n_pad + 1)) * 4
    half = G.forward_bytes(B * n_pad, B * E, F, 9, 3, n_messages=B * E // 2, n_samples=B)
    assert full["gnn_message"] - half["gnn_message"] == 3 * (B * E // 2) * (F * 4 + 8)
    # 101 of 128 rows (100 particles and the tool) receive and send
    real = G.forward_bytes(B * n_pad, B * E, F, 9, 3, n_samples=B,
                           n_receivers=B * 101, n_senders=B * 101)
    assert full["gnn_message"] - real["gnn_message"] == 3 * 2 * B * 27 * F * 4
    assert 0.0589 < 1e3 * real["gnn_message"] / 3 / 3.35e12 < 0.0591


def test_message_counts_the_rows_a_round_reads():
    """`message_counts` against numpy: the slots with a receiver in
    [0, n_pad), their distinct (sample, receiver) pairs, and the distinct
    (sample, sender) pairs of those with a sender."""
    rng = np.random.default_rng(9)
    recv, send, n_pad = _slots("out_of_range", rng)
    msg = (recv >= 0) & (recv < n_pad)
    rows = np.arange(recv.shape[0])[:, None] * n_pad
    want = {"n_messages": int(msg.sum()),
            "n_receivers": len(np.unique((recv + rows)[msg])),
            "n_senders": len(np.unique((send + rows)[msg & (send >= 0)]))}
    assert G.message_counts(torch.as_tensor(recv), torch.as_tensor(send), n_pad) == want
    assert want["n_receivers"] < recv.shape[0] * n_pad
