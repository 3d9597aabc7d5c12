"""Driver of GNN training mixes: `GraphSampler.sample` then `train_step`
(the port's `make_train_step`: the n_future-step unroll through the
`DynamicsPredictor` module, then Adam), back to back, as `train_dynamics`
runs them.

Set-up makes ``episodes`` seeded recorded pushes of ``frames`` frames of
``points`` particles (`scenes.pushed_episodes`), holds them on the device in
the port's `EpisodeStore` with every window of n_his + n_future consecutive
frames as a frame row, makes the network's starting weights (lecun-normal,
zero biases: a fresh run's start), and builds one sampler, one model and
one optimizer. The first ``check_steps`` steps run in set-up through the
window's own calls; the check keeps their batches, losses, the first
gradient as Adam holds it (its first moment over 1 - beta1) and the weights
after them. The window then runs whole steps until the host clock passes
its length, and synchronises: the rate is batch x steps over that time.
With the trace on, CUDA events around each `sample` and `train_step` give
their device-clock milliseconds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import flops, scenes
from perfbench.drivers.mppi import model_dict
from perfbench.reference import training as ref


class TrainCell:
    def __init__(self, ctx: dict):
        from gsdx_torch.dynamics.model import DynamicsPredictor, ModelConfig
        from gsdx_torch.dynamics.train import TrainConfig, make_train_step
        from gsdx_torch.graph.dataset import EpisodeStore, GraphDatasetConfig, GraphSampler

        config, mix, seed, dev = ctx["config"], ctx["mix"], ctx["seed"], ctx["device"]
        self.config, self.mix, self.seed, self.device = config, mix, seed, dev
        self.t_start, self.first_window, self.trace = ctx["t_start"], True, ctx["trace"]
        self.model = model_dict(config)
        tc, dc = config["train_config"], config["dataset_config"]
        self.data = {**dc, "n_his": tc["n_his"], "n_future": tc["n_future"]}
        self.batch_size = tc["batch_size"]

        pos, tool = scenes.pushed_episodes(scenes.generator(seed, 21, dev), mix["episodes"],
                                           mix["frames"], mix["points"], config["object"],
                                           mix["push"], dev)
        span = tc["n_his"] + tc["n_future"]
        starts = torch.arange(mix["frames"] - span + 1, device=dev)
        pairs = torch.cat([torch.stack([torch.full_like(starts, e)] + [starts + j
                                                                     for j in range(span)], 1)
                           for e in range(mix["episodes"])])
        self.episodes = (pos, tool, pairs)
        self.weights = scenes.gnn_weights(self.model, scenes.generator(seed, 22, dev), dev,
                                          config["assumed"]["train_head_scale"], bias_std=0.0)
        with torch.device(dev):
            net = DynamicsPredictor(ModelConfig(**{k: self.model[k]
                                                   for k in ModelConfig._fields}))
        net.load_state_dict(self.weights)
        gcfg = GraphDatasetConfig(
            n_his=tc["n_his"], n_future=tc["n_future"], max_nobj=dc["max_nobj"],
            max_tool=dc["max_tool"], max_nR=dc["max_nR"],
            fps_radius_range=tuple(dc["fps_radius_range"]),
            adj_radius_range=tuple(dc["adj_radius_range"]),
            state_noise_train=dc["state_noise"]["train"],
            state_noise_valid=dc["state_noise"]["valid"], topk=dc["topk"],
            connect_all=dc["connect_all"])
        self.sampler = GraphSampler(EpisodeStore(pos, tool, pairs), gcfg, "train")
        self.tcfg = TrainConfig(batch_size=tc["batch_size"], n_his=tc["n_his"],
                                n_future=tc["n_future"], lr=tc["lr"],
                                mse_weight=tc["mse_loss"], length_weight=tc["length_loss"])
        self.net = net
        self.step, _, self.optimizer = make_train_step(net, self.tcfg)
        self.gen = scenes.generator(seed, 23, dev)

        # the check's first steps, through the window's own calls
        names = [n for n, _ in net.named_parameters()]
        self.check_gens, self.check_batches, self.check_losses = [], [], []
        for i in range(mix["check_steps"]):
            self.check_gens.append(self.gen.get_state())
            b = self.sampler.sample(self.gen, self.batch_size)
            loss, _ = self.step(b)
            self.check_batches.append(b)
            self.check_losses.append(loss)
            if i == 0:
                # an optimizer that kept no moment holds a zero gradient
                self.first_grad = {
                    n: self.optimizer.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - 0.9)
                    for n, p in net.named_parameters()}
        self.after = {n: p.detach().clone() for n, p in zip(names, net.parameters())}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def window(self, seconds: float) -> dict:
        from gsdx_torch.kernels import fps as FPS

        dev = self.device
        cuda = dev.type == "cuda"
        events = []
        before = dict(FPS.LAUNCHES)
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if self.first_window:
            self.setup_s = t0 - self.t_start
        steps = 0
        while True:
            if self.trace and cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
            b = self.sampler.sample(self.gen, self.batch_size)
            if self.trace and cuda:
                ev[1].record()
            self.step(b)
            if self.trace and cuda:
                ev[2].record()
                events.append(ev)
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
        metrics = {"train_samples_per_s": self.batch_size * steps / elapsed}
        if self.first_window:
            metrics["setup_s"] = self.setup_s
            self.first_window = False
        tc = self.config["train_config"]
        nodes = self.data["max_nobj"] + self.data["max_tool"]
        counters = {
            "steps": steps, "samples": self.batch_size * steps,
            "sample_step_flops": 3 * tc["n_future"] * flops.gnn_step_flops(
                self.model, nodes, self.data["max_nR"], self.data["max_nobj"]),
            "kernel_launches": {r"\bfps_kernel": sum(FPS.LAUNCHES[k] - before[k]
                                                     for k in FPS.LAUNCHES)}}
        if events:
            counters["batch_ms"] = float(np.mean([e[0].elapsed_time(e[1]) for e in events]))
            counters["step_ms"] = float(np.mean([e[1].elapsed_time(e[2]) for e in events]))
        return {"metrics": metrics, "attempted": self.batch_size * steps, "units": steps,
                "wall_s": elapsed, "counters": counters}

    def release(self) -> None:
        self.net = self.step = self.optimizer = self.sampler = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, tf32: bool, half: bool = False):
        """The reference's first steps from the initial weights on the
        replayed draws: (batches, losses, first gradient, weights after).
        ``half`` plants a fault: the loss over the first half of each batch
        alone."""
        pos, tool, pairs = self.episodes
        train = self.config["train_config"]
        params = {k: v.clone() for k, v in self.weights.items()}
        opt, batches, losses, first = {}, [], [], None
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            for state in self.check_gens:
                g = torch.Generator(device=self.device)
                g.set_state(state)
                d = ref.draws(g, pairs.shape[0], pos.shape[2], self.batch_size, self.data,
                              self.data["state_noise"]["train"], self.device)
                b = ref.batch(pos, tool, pairs, d, self.data)
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                used = ({k: v[:self.batch_size // 2] for k, v in b.items()} if half else b)
                loss = ref.unrolled_loss(leaves, self.model, used, train)
                grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
                batches.append(b)
                losses.append(float(loss.detach()))
                first = grads if first is None else first
                with torch.no_grad():
                    params, opt = ref.adam(params, grads, opt, train["lr"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        return batches, losses, first, params

    def check(self, control: bool = False, fault: str | None = None) -> list[tuple]:
        """Against the reference's first steps: the batch (largest gap of a
        history or future coordinate, m, and relations that differ, a
        count; both exact), the first step's loss (relative gap), the first
        gradient as Adam holds it and the weights' change after the steps
        (worst leaf's gap of norms, over the larger of that leaf's reference
        norm and the median leaf's). Leaves whose reference gradient is
        under a thousandth of the median leaf's are left out of the change.
        The later steps' losses are kept in ``self.diagnostics`` and not
        compared: after Adam's first step from a fresh start they swing
        with rounding (PERF.md). ``control`` judges the reference with TF32
        products in the program's place; ``fault`` "half" the reference with
        half of each batch left out."""
        limits = self.config["limits"]["train"]
        batches, losses, first, after = self.reference_steps(tf32=False)
        start = self.weights
        if control or fault:
            got_batches, got_losses, got_first, got_after = self.reference_steps(
                tf32=control, half=fault == "half")
            got = [(b["state"], b["state_future"], b["recv"], b["send"]) for b in got_batches]
        else:
            got_losses = [float(x) for x in self.check_losses]
            got_first, got_after = self.first_grad, self.after
            got = [(b.state, b.state_future) + _indices(b.Rr, b.Rs) for b in self.check_batches]
        batch_gap, edges = 0.0, 0
        for (st, fut, r, s_), b in zip(got, batches):
            batch_gap = max(batch_gap, float((st - b["state"]).abs().max()),
                            float((fut - b["state_future"]).abs().max()))
            edges += int(((r != b["recv"]) | (s_ != b["send"])).sum())
        norms = {k: float(torch.linalg.vector_norm(first[k].double())) for k in first}
        med = float(np.median(list(norms.values())))
        skip = [k for k, n in norms.items() if n < 1e-3 * med]
        step_gaps = [abs(a - b) / abs(b) for a, b in zip(got_losses, losses)]
        grad_gap = _leaf_gap(got_first, first, ())
        change_gap = _leaf_gap({k: got_after[k] - start[k] for k in start},
                               {k: after[k] - start[k] for k in start}, skip)
        self.diagnostics = {"losses": losses, "program_losses": got_losses,
                            "step_loss_gaps": step_gaps, "skipped_leaves": skip}
        return [("batch_gap_m", batch_gap, limits["batch_gap_m"]),
                ("edges_differing", float(edges), limits["edges_differing"]),
                ("first_loss_gap", step_gaps[0], limits["first_loss_gap"]),
                ("grad_gap", grad_gap, limits["grad_gap"]),
                ("change_gap", change_gap, limits["change_gap"])]


def _indices(Rr, Rs):
    """One-hot relation rows (B, E, N) as (receiver, sender) indices, -1 on
    empty slots."""
    r = torch.where(Rr.sum(2) > 0, Rr.argmax(2), torch.full(Rr.shape[:2], -1, device=Rr.device))
    s = torch.where(Rs.sum(2) > 0, Rs.argmax(2), torch.full(Rs.shape[:2], -1, device=Rs.device))
    return r, s


def _leaf_gap(got: dict, want: dict, skip) -> float:
    norms = {k: float(torch.linalg.vector_norm(want[k].double())) for k in want if k not in skip}
    med = float(np.median(list(norms.values())))
    return max(abs(float(torch.linalg.vector_norm(got[k].double())) - n) / max(n, med, 1e-30)
               for k, n in norms.items())


def setup(ctx: dict) -> TrainCell:
    return TrainCell(ctx)
