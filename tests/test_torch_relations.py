"""The two forms of the GNN's relations in `gsdx_torch.dynamics`: one-hot
float rows (B, n_rel, N), selected and aggregated by batched products, and
integer node indices (B, n_rel) with -1 on empty slots, selected by a
gather and aggregated by a receiver segment sum (a sparse CSR product).

    python -m pytest tests/test_torch_relations.py          # CPU
    python -m pytest --noconftest -o addopts="" -m cuda \\
        tests/test_torch_relations.py                       # on the card

The selections are exact in both forms. The aggregation adds a receiver's
messages in another order than the dense product does (the sparse product
in slot order, cuBLAS or MKL in their own blocking), so a sum agrees to f32
rounding: within ``TOL`` of its largest entry. Through a whole forward and
backward the card's f32 products drift further: at width 512 the one-hot
form itself lies up to 6e-4 of a gradient's largest entry from the f64
result. So there the index form is held to drift from the f64 one-hot
result no more than the f32 one-hot form does (`assert_as_near`). No JAX here, so the card's
cases run on a machine without it.
"""

import pytest
import torch

from gsdx_torch.dynamics.model import (FORWARDS, DynamicsPredictor, ModelConfig, relations,
                                       reset_forwards)
from gsdx_torch.dynamics.train import TrainConfig, unrolled_loss
from gsdx_torch.dynamics.utils import length_loss
from gsdx_torch.graph.dataset import GraphBatch

torch.set_num_threads(min(2, torch.get_num_threads()))

FAMILIES = {"rope": dict(state_dim=0, motion_dim=0), "cloth": dict(state_dim=1, motion_dim=3)}
# (B, objects, relations, width): small on the CPU; on the card cloth's
# published 150 objects, 1,200 relations and width 512 at a small batch
SIZES = {"cpu": (3, 12, 48, 32), "cuda": (2, 150, 1200, 512)}
# f32 sums in another order, through pstep rounds, the MLPs and the backward
TOL = 1e-5
# steps of the unroll: on the card f32 rounding compounds through each
# step's feedback (after 3 steps at width 512 either form lies up to 3e-3
# of a gradient's largest entry from f64, neither form the nearer; after
# one, under 1e-6), so one step there; on the CPU the forms agree bit for bit
UNROLL = {"cpu": 3, "cuda": 1}
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


def index_lists(g, B, n_obj, E):
    """(recv, send) int32 (B, E): a random count of valid slots a sample,
    receivers repeated, the tool (node n_obj) at both ends somewhere, -1 on
    the slots after the valid ones, as `graph/edges.py` packs them."""
    N = n_obj + 1
    recv = torch.randint(0, N, (B, E), generator=g)
    send = torch.randint(0, N, (B, E), generator=g)
    recv[:, 0], send[:, 1] = n_obj, n_obj
    recv[:, 2:5] = recv[:, 5:6]  # one receiver, four messages
    valid = torch.arange(E)[None] < torch.randint(E // 2, E - 2, (B, 1), generator=g)
    return (torch.where(valid, recv, -1).to(torch.int32),
            torch.where(valid, send, -1).to(torch.int32))


def one_hot(idx, N):
    oh = torch.nn.functional.one_hot(idx.clamp(min=0).long(), N).to(torch.float32)
    return oh * (idx >= 0)[..., None]


def model_and_inputs(family, device, seed=0):
    B, n_obj, E, nf = SIZES[device.type]
    N = n_obj + 1
    g = torch.Generator().manual_seed(seed)
    cfg = ModelConfig(nf_particle=nf, nf_relation=nf, nf_effect=nf, **FAMILIES[family])
    model = DynamicsPredictor(cfg, generator=g)
    with torch.no_grad():  # nonzero biases, as trained: an empty slot's message is not zero
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    model = model.to(device)
    recv, send = index_lists(g, B, n_obj, E)
    attrs = torch.zeros(B, N, 2)
    attrs[:, :n_obj, 0], attrs[:, n_obj:, 1] = 1.0, 1.0
    inputs = {"state": 0.1 * torch.randn(B, cfg.n_his, N, 3, generator=g),
              "attrs": attrs,
              "p_instance": (torch.rand(B, n_obj, 1, generator=g) > 0.2).float(),
              "action": 0.01 * torch.randn(B, N, 3, generator=g)}
    return model, {k: v.to(device) for k, v in inputs.items()}, recv.to(device), send.to(device)


def assert_close(got, want, what):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=TOL * scale, msg=what)


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_selections_exact_and_aggregation_close(device):
    B, n_obj, E, nf = SIZES[device.type]
    N = n_obj + 1
    g = torch.Generator().manual_seed(1)
    recv, _ = index_lists(g, B, n_obj, E)
    recv = recv.to(device)
    x = torch.randn(B, N, nf, generator=g).to(device)
    m = torch.randn(B, E, nf, generator=g).to(device)
    by_index, by_product = relations(recv, N), relations(one_hot(recv, N), N)
    assert torch.equal(by_index.select(x), by_product.select(x))
    assert_close(by_index.aggregate(m), by_product.aggregate(m), "aggregate")


def forward_and_grads(model, inputs, r, s):
    """Both outputs, and the gradient of every weight and input of a
    weighted sum of them."""
    model.zero_grad()
    leaves = {k: v.clone().requires_grad_(True) for k, v in inputs.items()}
    pos, motion = model(leaves["state"], leaves["attrs"], r, s, leaves["p_instance"],
                        leaves["action"])
    w = torch.linspace(-1, 1, pos.numel(), dtype=pos.dtype, device=pos.device).view_as(pos)
    (torch.sum(w * pos) + torch.sum(w.flip(0) * motion)).backward()
    return {"pos": pos.detach(), "motion": motion.detach(),
            **{f"grad {k}": v.grad for k, v in leaves.items()},
            **{f"grad {k}": p.grad.clone() for k, p in model.named_parameters()}}


def assert_as_near(indexed, one_hot, f64):
    """The index form drifts from the f64 result no more than the one-hot
    form does: each tensor within twice the one-hot form's largest drift
    over all tensors (relative to a tensor's largest entry), or TOL where
    that is more."""
    def drift(got, want):
        return float((got.double() - want).abs().max()) / max(float(want.abs().max()), 1e-30)

    worst = max(drift(one_hot[k], want) for k, want in f64.items())
    for k, want in f64.items():
        torch.testing.assert_close(indexed[k].double(), want, rtol=0,
                                   atol=max(2 * worst, TOL) * float(want.abs().max()),
                                   msg=f"{k}: the one-hot form's largest drift {worst:.3g}")


@pytest.mark.parametrize("device", DEVICES, indirect=True)
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_forms_agree(family, device):
    """A forward and its backward in both forms, each counted as its form."""
    model, inputs, recv, send = model_and_inputs(family, device)
    N = inputs["state"].shape[2]
    results = {}
    for form, (r, s) in (("one_hot", (one_hot(recv, N), one_hot(send, N))),
                         ("indexed", (recv, send))):
        reset_forwards()
        results[form] = forward_and_grads(model, inputs, r, s)
        assert FORWARDS[form] == 1 and sum(FORWARDS.values()) == 1
    f64 = forward_and_grads(model.double(), {k: v.double() for k, v in inputs.items()},
                            one_hot(recv, N).double(), one_hot(send, N).double())
    assert_as_near(results["indexed"], results["one_hot"], f64)


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_length_loss_forms_agree(device):
    """Empty slots and tool ends read a zero row in both forms: the same
    loss, and its gradient to f32 rounding."""
    B, n_obj, E, _ = SIZES[device.type]
    N = n_obj + 1
    g = torch.Generator().manual_seed(2)
    recv, send = (x.to(device) for x in index_lists(g, B, n_obj, E))
    state = torch.randn(B, 3, N, 3, generator=g).to(device)
    pred0 = torch.randn(B, n_obj, 3, generator=g).to(device)
    out = {}
    for form, (r, s) in (("one_hot", (one_hot(recv, N), one_hot(send, N))),
                         ("indexed", (recv, send))):
        pred = pred0.clone().requires_grad_(True)
        loss = length_loss(pred, state, r, s)
        loss.backward()
        out[form] = (loss.detach(), pred.grad)
    assert torch.equal(out["indexed"][0], out["one_hot"][0])
    assert_close(out["indexed"][1], out["one_hot"][1], "grad pred")


def unroll(model, fields, cfg, form):
    """The unroll's loss, parts and weight gradients with the relations in
    ``form``."""
    batch = GraphBatch(**fields)
    if form == "one_hot":
        batch.recv, batch.send = batch.Rr, batch.Rs
    model.zero_grad()
    loss, parts = unrolled_loss(model, batch, cfg)
    loss.backward()
    return {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()},
            **{f"grad {k}": p.grad.clone() for k, p in model.named_parameters()}}


@pytest.mark.parametrize("device", DEVICES, indirect=True)
@pytest.mark.parametrize("family", FAMILIES)
def test_unrolled_loss_forms_agree(family, device):
    """The unroll with the length and rigid terms: the loss, its parts and
    the gradient of every weight in both forms."""
    model, inputs, recv, send = model_and_inputs(family, device, seed=3)
    B, n_his, N, _ = inputs["state"].shape
    n_obj, n_future = N - 1, UNROLL[device.type]
    g = torch.Generator().manual_seed(4)
    obj_mask = inputs["p_instance"][..., 0] > 0
    tool = torch.zeros(B, n_future - 1, N, 3)
    tool[:, :, n_obj:] = 0.01 * torch.randn(B, n_future - 1, 1, 3, generator=g)
    fields = dict(
        state=inputs["state"], action=inputs["action"], attrs=inputs["attrs"],
        p_instance=inputs["p_instance"], tool_future=tool.to(device),
        action_future=(0.01 * torch.randn(B, n_future - 1, N, 3, generator=g)).to(device),
        state_future=(0.1 * torch.randn(B, n_future, n_obj, 3, generator=g)).to(device),
        obj_mask=obj_mask, state_mask=torch.cat([obj_mask, obj_mask.new_ones(B, 1)], 1),
        tool_mask=(torch.arange(N, device=device) >= n_obj).expand(B, N),
        Rr=one_hot(recv, N), Rs=one_hot(send, N), recv=recv, send=send)
    cfg = TrainConfig(n_his=n_his, n_future=n_future, length_weight=0.1, rigid_weight=0.05)
    out = {form: unroll(model, fields, cfg, form) for form in ("one_hot", "indexed")}
    f64 = unroll(model.double(), {k: v.double() if v.is_floating_point() else v
                                  for k, v in fields.items()}, cfg, "one_hot")
    assert float(out["indexed"]["rigid"]) > 0
    assert_as_near(out["indexed"], out["one_hot"], f64)
