"""The radius-graph kernel (`gsdx_torch/csrc/edges.cu`, `kernels/edges.py`)
against its plain twin (`graph/edges.py` `construct_edge_indices_batch_plain`),
and the rule that routes `construct_edge_indices_batch` between them.

The ``cuda`` tests need an NVIDIA GPU with nvcc and skip without one; the
file imports no JAX, so on a machine with the card it runs on its own:

    python -m pytest --noconftest -o addopts="" tests/test_torch_edges_kernel.py

The other tests run on the CPU: the twin route, the routing rule, and the
rollout asking for its padded width once a push step.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gsdx_torch.dynamics.model import ModelConfig
from gsdx_torch.dynamics.train import init_params
from gsdx_torch.graph import edges as E
from gsdx_torch.kernels import edges as K
from gsdx_torch.kernels import gnn_forward as G
from gsdx_torch.plan.dynamics_rollout import RolloutSpec, make_batched_rollout


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rope(rng, B, n_obj):
    """Chains of n_obj points about 0.01 apart, and a pusher near each."""
    steps = rng.normal(0, 0.006, (B, n_obj, 3)).astype(np.float32)
    steps[..., 0] += 0.008
    obj = np.cumsum(steps, 1)
    tool = obj[np.arange(B), rng.integers(0, n_obj, B)][:, None] + 0.02
    return np.concatenate([obj, tool], 1)


def _cloth(rng, B, rows, cols):
    """A rows x cols sheet 0.02 apart with noise, and a pusher above it."""
    gx, gy = np.meshgrid(np.arange(cols) * 0.02, np.arange(rows) * 0.02)
    sheet = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(1, -1, 3)
    sheet = sheet + rng.normal(0, 0.004, (B, rows * cols, 3))
    tool = sheet[:, :1] + np.array([0.05, 0.05, 0.01])
    return np.concatenate([sheet, tool], 1).astype(np.float32)


def _case(kind, rng):
    """(states (B, N, 3), adj_thresh, mask (B, N), tool (B, N), keywords)."""
    n_tool = 1
    if kind == "rope":
        st = _rope(rng, 125, 100)
        kw = dict(n_obj=100, topk=5, max_nR=500, out_width=504)
        thresh = 0.08
    elif kind in ("cloth", "cloth_train"):
        st = _cloth(rng, 125 if kind == "cloth" else 64, 10, 15)
        kw = dict(n_obj=150, topk=6, max_nR=1200, connect_all=True)
        thresh = 0.075
    elif kind == "one_graph":
        st = _rope(rng, 1, 100)
        kw = dict(n_obj=100, topk=5, max_nR=500)
        thresh = 0.08
    elif kind == "n256":
        st = _cloth(rng, 8, 15, 17)  # 255 objects
        kw = dict(n_obj=255, topk=32, max_nR=4000, connect_all=True)
        thresh = 0.05
    elif kind == "ties":
        # zero-padded and duplicated points: distances tie constantly
        st = _rope(rng, 16, 60)
        st[:, 40:60] = 0.0
        st[:, 20:30] = st[:, 10:20]
        st[:, 5] = st[:, 6]
        kw = dict(n_obj=60, topk=7, max_nR=600)
        thresh = 0.03
    elif kind == "overflow":
        st = _rope(rng, 32, 100)
        kw = dict(n_obj=100, topk=8, max_nR=300, connect_all=True, out_width=320)
        thresh = 1.0
    elif kind == "tool_inside":
        # tools inside the object block and a larger top-k than objects
        st = _rope(rng, 12, 30)
        kw = dict(n_obj=20, topk=24, max_nR=400, connect_all=True)
        thresh = 0.05
        n_tool = 14
    elif kind == "nan":
        st = _rope(rng, 8, 40)
        st[:, 3] = np.nan
        st[1, :, 2] = np.nan
        kw = dict(n_obj=40, topk=5, max_nR=200)
        thresh = 0.08
    else:
        raise KeyError(kind)
    B, N, _ = st.shape
    mask = np.ones((B, N), bool)
    tool = np.zeros((B, N), bool)
    tool[:, N - n_tool:] = True
    if kind == "cloth_train":
        mask[:, :150] = rng.random((B, 150)) < 0.85  # FPS keeps part of the sheet
        thresh = rng.uniform(0.07, 0.08, B).astype(np.float32)
    if kind == "ties":
        mask[:, 50:60] = False
    return st, thresh, mask, tool, kw


KINDS = ["rope", "cloth", "cloth_train", "one_graph", "n256", "ties", "overflow",
         "tool_inside", "nan"]


def _acts(B, L, gen):
    """Pushes of 2-5 unit steps from around the origin."""
    lo = torch.tensor([-0.1, -0.1, -3.0, 2.0])
    hi = torch.tensor([0.1, 0.1, 3.0, 5.0])
    return lo + (hi - lo) * torch.rand(B, L, 4, generator=gen)


def _on(device, st, thresh, mask, tool):
    t = torch.as_tensor(thresh, device=device) if isinstance(thresh, np.ndarray) else thresh
    return (torch.as_tensor(st, device=device), t, torch.as_tensor(mask, device=device),
            torch.as_tensor(tool, device=device))


# --------------------------------------------------------------------- CPU


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_takes_the_twin_and_launches_nothing(kind):
    st, thresh, mask, tool, kw = _case(kind, np.random.default_rng(0))
    args = _on("cpu", st, thresh, mask, tool)
    before = dict(K.LAUNCHES)
    r, s = E.construct_edge_indices_batch(*args, **kw)
    r_p, s_p = E.construct_edge_indices_batch_plain(*args, **kw)
    assert K.LAUNCHES == before
    assert r.dtype == s.dtype == torch.int32
    assert r.shape == s.shape == (st.shape[0], kw.get("out_width", kw["max_nR"]))
    assert torch.equal(r, r_p) and torch.equal(s, s_p)


def test_out_width_pads_the_same_graph_with_minus_one():
    st, thresh, mask, tool, kw = _case("rope", np.random.default_rng(1))
    args = _on("cpu", st, thresh, mask, tool)
    kw.pop("out_width")
    r, s = E.construct_edge_indices_batch(*args, **kw)
    r8, s8 = E.construct_edge_indices_batch(*args, out_width=504, **kw)
    assert torch.equal(r8[:, :500], r) and torch.equal(s8[:, :500], s)
    assert (r8[:, 500:] == -1).all() and (s8[:, 500:] == -1).all()
    assert (r >= 0).any()
    with pytest.raises(ValueError, match="max_nR"):
        E.construct_edge_indices_batch(*args, out_width=499, **kw)


def _states(device="cuda", dtype=torch.float32, N=101, D=3):
    return SimpleNamespace(is_cuda=device == "cuda", dtype=dtype, shape=(4, N, D),
                           dim=lambda: 3, device=device)


@pytest.mark.parametrize("states,n_obj,topk,takes", [
    (_states(), 100, 5, True),
    (_states(N=256), 255, 32, True),
    (_states(N=1), 0, 0, True),
    (_states(device="cpu"), 100, 5, False),
    (_states(N=257), 256, 5, False),
    (_states(), 100, 33, False),
    (_states(dtype=torch.float64), 100, 5, False),
    (_states(D=4), 100, 5, False),
    (_states(), -1, 5, False),
])
def test_routing_rule_reads_shape_type_and_device(states, n_obj, topk, takes):
    """CUDA states go to the kernel whatever their shape; the kernel takes
    these and refuses the rest, so no input the kernel misses runs the
    twin on the card."""
    if takes:
        K.check(states, n_obj, topk)
    else:
        with pytest.raises(ValueError, match="edges kernel takes"):
            K.check(states, n_obj, topk)


def test_routing_sends_cuda_states_to_the_kernel(monkeypatch):
    """The route reads the device alone: a CUDA tensor reaches
    `edge_indices` (stood in for here), whose check refuses what it does
    not take; a CPU tensor never does."""
    calls = []
    monkeypatch.setattr(K, "edge_indices", lambda *a: calls.append(a) or ("kernel",) * 2)
    st = torch.zeros(2, 5, 3)
    mask = torch.ones(2, 5, dtype=torch.bool)
    E.construct_edge_indices_batch(st, 0.1, mask, ~mask, 4, 2, 10)
    assert not calls
    cuda_like = SimpleNamespace(is_cuda=True, shape=(2, 300, 3))
    assert E.construct_edge_indices_batch(cuda_like, 0.1, mask, ~mask, 4, 2, 10) == \
        ("kernel", "kernel")
    assert len(calls) == 1 and calls[0][0] is cuda_like


@pytest.mark.parametrize("N,topk", [(257, 5), (40, 33)])
def test_cpu_beyond_the_kernel_runs_the_twin(N, topk):
    rng = np.random.default_rng(2)
    st = torch.as_tensor(_rope(rng, 3, N - 1))
    mask = torch.ones(3, N, dtype=torch.bool)
    tool = torch.zeros(3, N, dtype=torch.bool)
    tool[:, -1] = True
    before = dict(K.LAUNCHES)
    r, s = E.construct_edge_indices_batch(st, 0.05, mask, tool, N - 1, topk, 4 * N)
    r_p, s_p = E.construct_edge_indices_batch_plain(st, 0.05, mask, tool, N - 1, topk, 4 * N)
    assert K.LAUNCHES == before
    assert torch.equal(r, r_p) and torch.equal(s, s_p)
    # the same input on the card is refused, not built by the twin
    with pytest.raises(ValueError, match="edges kernel takes"):
        K.check(SimpleNamespace(is_cuda=True, dtype=st.dtype, shape=st.shape, dim=st.dim,
                                device="cuda"), N - 1, topk)


def test_rollout_asks_the_route_for_its_padded_width_once_a_push_step(monkeypatch):
    """The rollout calls the route once a push step, at the GNN's padded
    width, and hands the GNN what it returns."""
    import gsdx_torch.plan.dynamics_rollout as DR

    calls = []

    def recorded(states, adj_thresh, mask, tool_mask, **kw):
        calls.append((states.shape, mask.dtype, kw.get("out_width")))
        return E.construct_edge_indices_batch(states, adj_thresh, mask, tool_mask, **kw)

    monkeypatch.setattr(DR, "construct_edge_indices_batch", recorded)
    forwards = []
    plain = DR.gnn_forward_plain

    def counted(packed, attrs, action, state_t, g, recv, send, **kw):
        forwards.append((recv.shape, recv.is_contiguous(), send.is_contiguous()))
        return plain(packed, attrs, action, state_t, g, recv, send, **kw)

    monkeypatch.setattr(DR, "gnn_forward_plain", counted)
    gen = torch.Generator().manual_seed(3)
    model = init_params(ModelConfig(nf_particle=32, nf_relation=32, nf_effect=32), 3, "cpu")
    spec = RolloutSpec(max_nobj=12, max_nR=42, topk=3, max_repeat=4, sort_chunks=2,
                       fused="twin")
    make_batched_rollout(model, spec)(0.05 * torch.randn(12, 3, generator=gen),
                                      _acts(8, 1, gen))
    assert calls and len(calls) == len(forwards)
    assert all(c == (torch.Size([4, 13, 3]), torch.bool, 48) for c in calls)
    assert all(f == (torch.Size([4, 48]), True, True) for f in forwards)


# -------------------------------------------------------------------- card


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_equals_the_twin_integer_for_integer(cuda, kind):
    st, thresh, mask, tool, kw = _case(kind, np.random.default_rng(10))
    args = _on(cuda, st, thresh, mask, tool)
    before = K.LAUNCHES["edges"]
    r, s = E.construct_edge_indices_batch(*args, **kw)
    assert K.LAUNCHES["edges"] == before + 1
    r_p, s_p = E.construct_edge_indices_batch_plain(*args, **kw)
    torch.cuda.synchronize()
    assert r.shape == r_p.shape and r.dtype == torch.int32
    bad = ((r != r_p) | (s != s_p)).sum().item()
    assert bad == 0, f"{bad} slots differ"
    if kind == "overflow":
        assert (r[:, kw["max_nR"] - 1] >= 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,topk", [((3, 257, 3), torch.float32, 5),
                                              ((3, 40, 3), torch.float32, 33),
                                              ((3, 40, 3), torch.float64, 5),
                                              ((3, 40, 4), torch.float32, 5)])
def test_kernel_refuses_what_it_does_not_take(cuda, shape, dtype, topk):
    """On the card no input falls back to the twin: one the kernel does not
    take raises, and nothing is launched."""
    st = torch.zeros(shape, dtype=dtype, device=cuda)
    mask = torch.ones(shape[:2], dtype=torch.bool, device=cuda)
    before = K.LAUNCHES["edges"]
    with pytest.raises(ValueError, match="edges kernel takes"):
        E.construct_edge_indices_batch(st, 0.05, mask, ~mask, shape[1] - 1, topk, 100)
    assert K.LAUNCHES["edges"] == before


@pytest.mark.cuda
def test_kernel_reads_a_strided_history_view_and_radius_forms(cuda):
    """The rollout's input, states[:, -1] of a (B, n_his, N, 3) history, and
    the radius as a number, a 0-d tensor and one a graph."""
    rng = np.random.default_rng(11)
    hist = torch.as_tensor(np.stack([_rope(rng, 40, 100) for _ in range(3)], 1), device=cuda)
    states = hist[:, -1]
    assert not states.is_contiguous()
    mask = torch.ones(40, 101, dtype=torch.bool, device=cuda)
    tool = torch.zeros_like(mask)
    tool[:, -1] = True
    for thresh in (0.08, torch.tensor(0.08, device=cuda), torch.full((40,), 0.08, device=cuda),
                   torch.linspace(0.05, 0.1, 40, device=cuda)):
        r, s = E.construct_edge_indices_batch(states, thresh, mask, tool, 100, 5, 500)
        r_p, s_p = E.construct_edge_indices_batch_plain(states.contiguous(), thresh, mask,
                                                        tool, 100, 5, 500)
        assert torch.equal(r, r_p) and torch.equal(s, s_p)


@pytest.mark.cuda
def test_one_launch_a_push_step_in_a_planning_rollout(cuda):
    gen = torch.Generator().manual_seed(12)
    model = init_params(ModelConfig(), 12, cuda).eval()
    spec = RolloutSpec(max_nobj=40, max_nR=200, topk=5, max_repeat=6, sort_chunks=2)
    acts = _acts(16, 2, gen)
    state = (0.05 * torch.randn(40, 3, generator=gen)).to(cuda)
    before_e, before_g = K.LAUNCHES["edges"], G.LAUNCHES["gnn_forward"]
    with torch.no_grad():
        make_batched_rollout(model, spec)(state, acts.to(cuda))
    torch.cuda.synchronize()
    steps = G.LAUNCHES["gnn_forward"] - before_g
    assert steps > 0 and K.LAUNCHES["edges"] - before_e == steps
