"""The GNS training cell (`gns_water3d.train`) on the CPU at a tiny size:
it comes out correct through the harness, every new reader reads its
trace, and the check fails with the step broken underneath (the edge
residual dropped, LayerNorm dropped, half of each batch left out of the
loss), with the control (the reference with its products' operands
rounded to TF32) in the program's place, or with the reference's planted
half-batch fault there."""

from __future__ import annotations

import copy
import time
import types

import pytest
import torch
from tinycells import bench_with_staged, harness
from torch.utils._python_dispatch import TorchDispatchMode

from gsdx_torch.dynamics import gns
from gsdx_torch.utils import profiling
from perfbench import control, flops_gns

CELL = "gns_water3d.train"
NEW = {"mfu.gns", "step_ms.gns", "graph_ms.gns", "process_ms.gns", "idle_share.gns"}
# CUDA events and kernels: no reading on the CPU
DEVICE_ONLY = {"step_ms.gns", "graph_ms.gns", "process_ms.gns", "idle_share.gns"}


def tiny() -> dict:
    """Published widths, 3 blocks, a 7-a-side block of 343 particles, 2
    episodes of 12 frames: a few seconds on the CPU."""
    cfg = copy.deepcopy(harness.resolve(bench_with_staged(), CELL)["config"])
    cfg["model_config"]["message_passing_steps"] = 3
    cfg["scene"]["particles_per_side"] = 7
    return {"config": cfg, "mix": {"episodes": 2, "frames": 12}}


def run(seconds: float = 1.0, trace: int = 0, seed: int = 2**31 + 17):
    args = types.SimpleNamespace(workload=CELL, seed=seed, seconds=seconds, trace=trace,
                                 overrides=tiny())
    return harness.run_cell(args, time.perf_counter(), bench=bench_with_staged(),
                            require_card=False)[1]


def test_tiny_cell_is_correct_and_reports_its_end_to_end_metrics():
    res = run()
    assert res["correct"], res["checked"]
    assert res["attempted"] > 0
    assert {"train_samples_per_s", "setup_s"} <= set(res["metrics"])
    assert res["checked"]["edges_differing"]["value"] == 0


def test_every_new_reader_reads_the_traced_cell(monkeypatch):
    """On the CPU the span readers find no device time and the idle share
    no kernel (None, left out of the line); `mfu.gns` reads a number. The
    host's spans are all there."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    profiling.reset()
    try:
        res = run(seconds=1.0, trace=1)
        metrics = res["metrics"]
        assert NEW - DEVICE_ONLY <= set(metrics), metrics
        assert not DEVICE_ONLY & set(metrics), metrics
        assert 0 < metrics["mfu.gns"]["value"] < 100
        roots = profiling.snapshot()["roots"]["train.step"]
        spans = roots[-1]["spans"]
        assert {"gns.graph", "gns.encode", "gns.process", "gns.decode"} <= set(spans)
        assert spans["gns.block"]["count"] == 3
        assert spans["read.gns_edges"]["count"] == 1  # one host read a step
    finally:
        profiling.reset()


def _half_loss(model, batch, cfg=None):
    """`gns.one_step_loss` over the first half of the batch alone."""
    inputs = batch.position[:, :-1] + batch.noise
    predicted = model(inputs, batch.particle_type)
    target = model.normalised_acceleration(batch.position[:, -1] + batch.noise[:, -1], inputs)
    error = ((predicted - target) ** 2)[:predicted.shape[0] // 2]
    loss = error.sum() / (error.shape[0] * error.shape[1])
    return loss, {"mse": loss}


@pytest.mark.parametrize("fault", ["edge_residual", "layer_norm", "half"])
def test_check_catches_a_broken_step(fault, monkeypatch):
    if fault == "half":
        monkeypatch.setattr(gns, "one_step_loss", _half_loss)
    elif fault == "edge_residual":
        orig = gns.InteractionBlock.forward

        def forward(self, nodes, edges, recv, send):
            new_nodes, updated = orig(self, nodes, edges, recv, send)
            return new_nodes, updated - edges  # the block's new edges alone

        monkeypatch.setattr(gns.InteractionBlock, "forward", forward)
    else:
        monkeypatch.setattr(torch.nn.LayerNorm, "forward", lambda self, x: x)
    res = run()
    assert not res["correct"], res["checked"]


def test_the_tf32_control_fails_the_check():
    """The control's numbers pass a limit: it can only be rejected; the
    program's, on the same seed, pass every one."""
    bench = bench_with_staged()
    limits = tiny()["config"]["limits"]["gns_train"]
    rows = {r["side"]: r for r in control.readings(CELL, [2**31 + 5], [2**31 + 5], 0.5,
                                                   require_card=False, bench=bench,
                                                   overrides=tiny())}
    for side, passes in (("program", True), ("control", False)):
        numbers = rows[side]["numbers"]
        assert set(numbers) == set(limits)
        over = [n for n, v in numbers.items() if not v <= limits[n]]
        assert (not over) == passes, (side, numbers)


def test_the_reference_half_batch_fault_fails_the_check():
    """`check(fault="half")`, the fault that `control.py --fault half`
    plants on the card, is rejected."""
    rows = {r["side"]: r for r in control.readings(
        CELL, [], [], 0.5, require_card=False, bench=bench_with_staged(), overrides=tiny(),
        fault_seeds=[2**31 + 9], fault="half")}
    limits = tiny()["config"]["limits"]["gns_train"]
    numbers = rows["fault:half"]["numbers"]
    assert numbers["edges_differing"] == 0  # the forward is whole: only the loss lost half
    assert any(not v <= limits[n] for n, v in numbers.items()), numbers


class _DenseProducts(TorchDispatchMode):
    """2 x m x k x n of every dense (strided) mm / addmm dispatched: the
    receiver sums' sparse CSR products are left out, as the least work
    counts a sum as one add an edge feature."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ops = {torch.ops.aten.mm.default: (0, 1), torch.ops.aten.addmm.default: (1, 2)}
        if func in ops:
            a, b = (args[i] for i in ops[func])
            if a.layout == b.layout == torch.strided:
                self.flops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        return func(*args, **(kwargs or {}))


def test_forward_flops_are_the_modules_products():
    """A GNS forward at the published widths multiplies what
    `flops_gns.products` lists, counted from the graph's real edges;
    `forward_flops` adds a block's three adds an edge feature."""
    model_cfg = tiny()["config"]["model_config"]
    net = gns.GNS(gns.GNSConfig(**{k: v for k, v in model_cfg.items()
                                   if k in gns.GNSConfig._fields and k != "bounds"}))
    g = torch.Generator().manual_seed(0)
    pos = 0.4 + 0.2 * torch.rand(1, 6, 300, 3, generator=g)
    with _DenseProducts() as counter:
        net(pos, torch.full((1, 300), 5))
    edges = net.graph.edges
    assert edges > 300 and net.graph.slots == edges  # one sample: no padding
    products = sum(2 * r * i * o for r, i, o in flops_gns.products(model_cfg, 300, edges))
    assert counter.flops == products
    adds = model_cfg["message_passing_steps"] * 3 * edges * model_cfg["latent_size"]
    assert flops_gns.forward_flops(model_cfg, 300, edges) == products + adds
