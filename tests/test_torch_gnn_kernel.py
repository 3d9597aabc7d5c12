"""The CUDA GNN forward kernels against their plain PyTorch version.

These need an NVIDIA GPU with nvcc; without one they skip. The file imports
no JAX, so on a machine with the card it runs on its own:

    python -m pytest --noconftest -o addopts="" tests/test_torch_gnn_kernel.py

`chip_smoke.py` makes the same comparison at the full rope and cloth widths.
"""

import numpy as np
import pytest
import torch

from gsdx_torch.kernels import gnn_forward as G

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _random_tree(rng, F, n_his, layout):
    nd = 3 * n_his
    p_in = 5 if layout == "rope" else 2 + n_his + 3 * (n_his - 1) + 3

    def dense(i, o):
        return {"kernel": rng.normal(0, 1 / np.sqrt(i), (i, o)).astype(np.float32),
                "bias": rng.normal(0, 0.05, (o,)).astype(np.float32)}

    mlp = lambda i, o, last: {f"Dense_{k}": dense(i if k == 0 else F, F if k < 2 else last)  # noqa: E731
                              for k in range(3)}
    return {"params": {
        "particle_encoder": mlp(p_in, F, F),
        "relation_encoder": mlp(5 + nd, F, F),
        "non_rigid_predictor": mlp(F, F, 3),
        "relation_propagator": dense(3 * F, F),
        "particle_propagator": dense(2 * F, F)}}


def _inputs(rng, B, n_pad, n_obj, E, n_edges, n_his, device):
    """Random node inputs and receiver-sorted edge slots, -1 past n_edges."""
    N = n_obj + 1
    attrs = np.zeros((B, n_pad, 2), np.float32)
    attrs[:, :n_obj, 0] = 1
    attrs[:, n_obj:N, 1] = 1
    act = np.zeros((B, n_pad, 3), np.float32)
    act[:, n_obj] = rng.normal(0, 0.01, (B, 3))
    st = np.zeros((B, n_pad, 3 * n_his), np.float32)
    st[:, :N] = rng.normal(0, 0.05, (B, N, 3 * n_his))
    g = np.zeros((B, n_pad, 1), np.float32)
    g[:, :n_obj] = 1
    recv = np.full((B, E), -1, np.int32)
    send = recv.copy()
    for b in range(B):
        recv[b, :n_edges] = np.sort(rng.integers(0, N, n_edges))
        send[b, :n_edges] = rng.integers(0, N, n_edges)
    return [torch.as_tensor(x, device=device) for x in (attrs, act, st, g, recv, send)]


# Kernels against `gnn_forward_plain(operands="bf16")`, which rounds the
# same product operands to bf16. The two sum in f32 in other orders (the
# tensor cores' own order and rounding, the message kernel's slot order), so
# an activation that lands within an f32 rounding of a bf16 boundary rounds
# one way here and the other way there: one bf16 ulp (2^-8 relative) in
# that entry, which the layers after it carry to the output. These random
# 512-wide nets carry it far: the plain version itself moves by up to 1.5e-2
# of the output's largest entry when its sums are taken in f64 instead of
# f32, and the kernels differ from it by up to 1.24e-2 (measured on the
# card). FORWARD_TOL, of the output's largest entry, bounds that.
FORWARD_TOL = 3e-2


def _check_forward(out, packed, ins):
    ref = G.gnn_forward_plain(packed, *ins, operands="bf16")
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    scale = float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=FORWARD_TOL * scale)


@pytest.mark.parametrize("B,n_pad,n_obj,E,n_edges,layout", [
    (1, 128, 30, 160, 120, "rope"),
    (5, 128, 100, 504, 504, "rope"),
    (3, 128, 100, 504, 311, "rope"),
    (2, 256, 150, 1200, 1000, "cloth"),
    (7, 256, 130, 1040, 0, "cloth"),
])
def test_kernel_matches_plain(cuda, B, n_pad, n_obj, E, n_edges, layout):
    rng = np.random.default_rng(B * 1000 + E)
    packed = G.pack_gnn_params(_random_tree(rng, 512, 3, layout), device=cuda)
    ins = _inputs(rng, B, n_pad, n_obj, E, n_edges, 3, cuda)
    before = dict(G.LAUNCHES)
    out = G.fused_gnn_forward(packed, *ins)
    # every product of depth F on the GEMM; the segments once, a message a round
    want = {"gnn_forward": 1, "gnn_linear": 3, "gnn_gemm": 15, "gnn_edge_first": 1,
            "gnn_segments": 1, "gnn_message": 3}
    assert {k: G.LAUNCHES[k] - before[k] for k in want} == want
    _check_forward(out, packed, ins)


def test_unordered_slots_and_refusals(cuda):
    """Slots in any order (the segments kernel sorts them by receiver, and
    each message row walks its segment in slot order), and a CUDA input the
    kernels do not take raises instead of falling back."""
    rng = np.random.default_rng(3)
    packed = G.pack_gnn_params(_random_tree(rng, 512, 3, "rope"), device=cuda)
    ins = _inputs(rng, 2, 128, 60, 320, 300, 3, cuda)
    perm = torch.randperm(320, generator=torch.Generator().manual_seed(0)).to(cuda)
    ins[4], ins[5] = ins[4][:, perm].contiguous(), ins[5][:, perm].contiguous()
    _check_forward(G.fused_gnn_forward(packed, *ins), packed, ins)
    with pytest.raises(ValueError):
        G.fused_gnn_forward(packed, ins[0].double(), *ins[1:])
    with pytest.raises(ValueError):
        G.fused_gnn_forward(packed, ins[0][:, :100].contiguous(), *ins[1:])
    # the GEMM takes only the kernel-side bf16 weight copies
    with pytest.raises(ValueError):
        G.fused_gnn_forward(packed._replace(wt_2r=packed.wt_2r.float()), *ins)
    # an edge index past the node rows, or below -1, raises before a launch
    for k, bad in ((4, 128), (5, -2)):
        idx = ins[k].clone()
        idx[1, 7] = bad
        n0 = G.LAUNCHES["gnn_forward"]
        with pytest.raises(ValueError, match="edge indices"):
            G.fused_gnn_forward(packed, *ins[:k], idx, *ins[k + 1:])
        assert G.LAUNCHES["gnn_forward"] == n0


# A push step's chunk: 125 samples, rope (128 node slots, 504 edge slots) and
# cloth (256, 1,200).
CHUNKS = {"rope": (125, 128, 100, 504), "cloth": (125, 256, 150, 1200)}


@pytest.mark.parametrize("layout", list(CHUNKS))
def test_error_word_leaves_the_forward_bit_equal(cuda, layout):
    B, n_pad, n_obj, E = CHUNKS[layout]
    rng = np.random.default_rng(n_pad)
    packed = G.pack_gnn_params(_random_tree(rng, 512, 3, layout), device=cuda)
    ins = _inputs(rng, B, n_pad, n_obj, E, E - 40, 3, cuda)
    errors = torch.zeros(1, dtype=torch.int32, device=cuda)
    out = G.fused_gnn_forward(packed, *ins, errors=errors)
    assert torch.equal(out, G.fused_gnn_forward(packed, *ins))
    assert int(errors) == 0


# An index at n_pad, below -1, or past every node row of the chunk.
BAD_SLOTS = [("recv", "n_pad"), ("send", "n_pad"), ("recv", -2), ("send", -2),
             ("recv", "past"), ("send", "past")]


@pytest.mark.parametrize("which,bad", BAD_SLOTS)
def test_error_word_flags_a_bad_slot_which_reads_as_empty(cuda, which, bad):
    B, n_pad, n_obj, E = CHUNKS["rope"]
    rng = np.random.default_rng(7)
    packed = G.pack_gnn_params(_random_tree(rng, 512, 3, "rope"), device=cuda)
    ins = _inputs(rng, B, n_pad, n_obj, E, E, 3, cuda)
    k = 4 if which == "recv" else 5
    bad = {"n_pad": n_pad, "past": B * n_pad + 7}.get(bad, bad)
    broken, emptied = list(ins), list(ins)
    broken[k], emptied[k] = ins[k].clone(), ins[k].clone()
    broken[k][3, 100], emptied[k][3, 100] = bad, -1
    errors = torch.zeros(1, dtype=torch.int32, device=cuda)
    out = G.fused_gnn_forward(packed, *broken, errors=errors)
    assert int(errors) == G.INDEX_ERROR_BITS[which]
    assert torch.equal(out, G.fused_gnn_forward(packed, *emptied))
    clean = G.fused_gnn_forward(packed, *ins)
    others = torch.arange(B, device=cuda) != 3
    assert torch.equal(out[others], clean[others])


def test_rollout_raises_on_a_bad_edge_index_once_the_call_ends(cuda, monkeypatch):
    from gsdx_torch.dynamics.model import ModelConfig
    from gsdx_torch.dynamics.train import init_params
    from gsdx_torch.plan import dynamics_rollout as DR

    gen = torch.Generator().manual_seed(0)
    roll = DR.make_batched_rollout(init_params(ModelConfig(), 0, cuda), DR.RolloutSpec())
    state = (0.05 * torch.randn(100, 3, generator=gen)).to(cuda)
    lo, hi = torch.tensor([-0.1, -0.1, -3.0, 2.0]), torch.tensor([0.1, 0.1, 3.0, 5.0])
    acts = (lo + (hi - lo) * torch.rand(32, 1, 4, generator=gen)).to(cuda)
    with torch.no_grad():
        roll(state, acts)  # in range: no raise
        build, steps = DR.construct_edge_indices_batch, []

        def corrupted(*a, **kw):
            recv, send = build(*a, **kw)
            steps.append(None)
            if len(steps) == 2:
                send = send.clone()
                send[1, 0] = 128
            return recv, send

        monkeypatch.setattr(DR, "construct_edge_indices_batch", corrupted)
        n0 = G.LAUNCHES["gnn_forward"]
        with pytest.raises(ValueError, match="edge indices.*send"):
            roll(state, acts)
    # every push step of the call launched its forward before the raise
    assert len(steps) > 2 and G.LAUNCHES["gnn_forward"] - n0 == len(steps)


# The GEMM's epilogues: (bias, residuals, relu, outputs), together every option.
EPILOGUES = {
    "none": (False, 0, False, "f32"),
    "bias": (True, 0, False, "f32"),
    "bias_relu": (True, 0, True, "bf16"),
    "r1_relu": (False, 1, True, "both"),
    "bias_r1_r2_relu": (True, 2, True, "both"),
}


@pytest.mark.parametrize("M,N,K", [(256, 128, 512), (1000, 512, 512), (63000, 512, 512),
                                   (16000, 512, 512), (1000, 1024, 512), (1000, 8, 512),
                                   (300, 256, 1024)])
@pytest.mark.parametrize("epilogue", list(EPILOGUES))
def test_gemm_matches_plain(cuda, M, N, K, epilogue):
    """The tensor-core GEMM against the same bf16 operands multiplied in
    f64, ragged M (1000, 63,000 rows: TMA fills the last tile with zeros
    and clips the stores) and N = 8 (a weight copy padded to 128 rows)
    included; 128x256 tiles where N is a multiple of 256, 128x128 else.
    The launch is persistent: min(SMs, tiles) blocks."""
    use_bias, n_res, relu, outs = EPILOGUES[epilogue]
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    x = torch.randn(M, K, device=cuda, generator=g).to(torch.bfloat16)
    w = (torch.randn(N, K, device=cuda, generator=g) / K ** 0.5).to(torch.bfloat16)
    rows = -(-N // G.GEMM_BN) * G.GEMM_BN
    wt = torch.cat([w, w.new_zeros(rows - N, K)]).contiguous()
    bias = torch.randn(N, device=cuda, generator=g) if use_bias else None
    res = [torch.randn(M, N, device=cuda, generator=g) for _ in range(n_res)]
    r1, r2 = (res + [None, None])[:2]
    n0 = G.LAUNCHES["gnn_gemm"]
    y, yb = G.gnn_gemm(x, wt, N, bias=bias, r1=r1, r2=r2, relu=relu,
                       f32=outs != "bf16", bf16=outs != "f32")
    assert G.LAUNCHES["gnn_gemm"] == n0 + 1
    launch = G.gemm_last_launch()
    assert launch["block_n"] == 128 or N % 256 == 0
    tiles = -(-M // launch["block_m"]) * -(-N // launch["block_n"])
    assert launch["tiles"] == tiles and launch["grid"] == min(launch["sms"], tiles)
    torch.cuda.synchronize()
    ref = x.double() @ w.double().t()
    for extra in (bias, r1, r2):
        if extra is not None:
            ref = ref + extra.double()
    if relu:
        ref = torch.relu(ref)
    # products of bf16 values are exact in f32; a K-term f32 sum in any
    # order, rounding or truncating each add (as a tensor core may), is
    # within K * 2^-23 of the sum of the terms' magnitudes, and each of the
    # epilogue's three adds rounds once more
    mag = x.abs().double() @ w.abs().double().t()
    for extra in (bias, r1, r2):
        if extra is not None:
            mag = mag + extra.abs().double()
    bound = (K + 3) * 2.0 ** -23 * mag
    if y is not None:
        assert y.shape == (M, N) and y.dtype == torch.float32
        assert ((y.double() - ref).abs() <= bound).all()
    if yb is not None:
        assert yb.shape == (M, N) and yb.dtype == torch.bfloat16
        # and the rounding to bf16, nearest even: at most half an ulp,
        # 2^-8 of the value
        assert ((yb.double() - ref).abs() <= bound * (1 + 2.0 ** -8)
                + 2.0 ** -8 * ref.abs()).all()
    assert (y is None) == (outs == "bf16") and (yb is None) == (outs == "f32")


def _segment_inputs(case, device):
    """recv, send (B, E) int32 and n_pad of one slot layout."""
    rng = np.random.default_rng(len(case))
    B, E, n_pad, n_obj, n_edges = {"sorted": (6, 504, 128, 101, 470),
                                   "permuted": (6, 504, 128, 101, 470),
                                   "cloth": (4, 1200, 256, 151, 1150),
                                   "one_receiver": (3, 504, 128, 101, 504),
                                   "empty": (2, 504, 128, 101, 0),
                                   "out_of_range": (3, 504, 128, 101, 470)}[case]
    recv = np.full((B, E), -1, np.int32)
    for b in range(B):
        recv[b, :n_edges] = (np.full(n_edges, 100) if case == "one_receiver"
                             else np.sort(rng.integers(0, n_obj, n_edges)))
    if case == "permuted":
        recv = recv[:, rng.permutation(E)]
    if case == "out_of_range":  # receivers at and past n_pad: empty slots
        recv[:, 5::9] = n_pad + rng.integers(0, 1 << 20, recv[:, 5::9].shape)
    send = np.where(recv >= 0, rng.integers(-1, n_obj, recv.shape), -1).astype(np.int32)
    return torch.as_tensor(recv, device=device), torch.as_tensor(send, device=device), n_pad


SEGMENT_CASES = ["sorted", "permuted", "cloth", "one_receiver", "empty", "out_of_range"]


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segments_match_plain(cuda, case):
    recv, _, n_pad = _segment_inputs(case, cuda)
    n0 = G.LAUNCHES["gnn_segments"]
    seg_off, seg_slot = G.gnn_segments(recv, n_pad)
    assert G.LAUNCHES["gnn_segments"] == n0 + 1
    ref_off, ref_slot = G.receiver_segments_plain(recv, n_pad)
    torch.cuda.synchronize()
    assert torch.equal(seg_off, ref_off) and torch.equal(seg_slot, ref_slot)


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_message_bit_equal_to_plain(cuda, case):
    """The message kernel adds each segment in slot order, as its plain
    version does one padded segment column at a time: the same f32 adds,
    so the same bits, on every run."""
    recv, send, n_pad = _segment_inputs(case, cuda)
    B, E = recv.shape
    F = 512
    g = torch.Generator(device=cuda).manual_seed(E)
    rel_pre = torch.randn(B * E, F, device=cuda, generator=g)
    ew = torch.randn(B * n_pad, 2 * F, device=cuda, generator=g)
    seg = G.gnn_segments(recv, n_pad)
    n0 = G.LAUNCHES["gnn_message"]
    agg = G.gnn_message(rel_pre, ew, *seg, send, n_pad)
    again = G.gnn_message(rel_pre, ew, *seg, send, n_pad)
    assert G.LAUNCHES["gnn_message"] == n0 + 2
    ref = G.gnn_message_plain(rel_pre, ew, *seg, send, n_pad)
    torch.cuda.synchronize()
    assert agg.dtype == torch.bfloat16 and agg.shape == (B * n_pad, F)
    assert torch.equal(agg, ref) and torch.equal(agg, again)
