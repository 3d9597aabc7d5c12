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
    n0 = G.LAUNCHES["gnn_forward"]
    out = G.fused_gnn_forward(packed, *ins)
    assert G.LAUNCHES["gnn_forward"] == n0 + 1
    ref = G.gnn_forward_plain(packed, *ins)
    torch.cuda.synchronize()
    # f32 products summed in another order than the plain version's matmuls
    # (and its atomic index_add_): 1e-4 of the output's largest entry, as the
    # JAX tests hold the interpret-mode kernel against its twin
    scale = float(ref.abs().max())
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * scale)


def test_unordered_slots_and_refusals(cuda):
    """Slots in any order (the message kernel scans every slot), and a CUDA
    input the kernels do not take raises instead of falling back."""
    rng = np.random.default_rng(3)
    packed = G.pack_gnn_params(_random_tree(rng, 512, 3, "rope"), device=cuda)
    ins = _inputs(rng, 2, 128, 60, 320, 300, 3, cuda)
    perm = torch.randperm(320, generator=torch.Generator().manual_seed(0)).to(cuda)
    ins[4], ins[5] = ins[4][:, perm].contiguous(), ins[5][:, perm].contiguous()
    out = G.fused_gnn_forward(packed, *ins)
    ref = G.gnn_forward_plain(packed, *ins)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
    with pytest.raises(ValueError):
        G.fused_gnn_forward(packed, ins[0].double(), *ins[1:])
    with pytest.raises(ValueError):
        G.fused_gnn_forward(packed, ins[0][:, :100].contiguous(), *ins[1:])
    # an edge index past the node rows, or below -1, raises before a launch
    for k, bad in ((4, 128), (5, -2)):
        idx = ins[k].clone()
        idx[1, 7] = bad
        n0 = G.LAUNCHES["gnn_forward"]
        with pytest.raises(ValueError, match="edge indices"):
            G.fused_gnn_forward(packed, *ins[:k], idx, *ins[k + 1:])
        assert G.LAUNCHES["gnn_forward"] == n0
