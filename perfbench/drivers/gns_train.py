"""Driver of GNS training mixes: `WindowSampler.sample` then `train_step`
(the port's `make_train_step` with GNS's one-step loss: the radius graph,
the encoder, the message-passing blocks and the decoder under autograd,
then Adam), back to back, as `train_dynamics` runs them.

Set-up makes the configuration's scene from its own seed (``scene.seed``),
so that its geometry, and with it the edge count and the rate, is the same
for every run seed: ``episodes`` trajectories of ``frames`` frames of a
lattice block of particles carried by a seeded ABC flow (divergence-free,
so the block keeps its density) and gravity, reflected at the box. They
live on the device in the port's `EpisodeStore` with every window of n_his
+ 1 consecutive frames as a frame row; the normalisation statistics come
from them. The run seed draws the windows, the noise and the starting
weights: the reference's draw of Sonnet's initialisation (a fresh run's
start, `reference.gns.init_weights`), loaded into the program's model.

The first ``check_steps`` steps run in set-up through the window's own
calls; the check keeps their graphs, losses and gradients and the weights
after them. The window then runs whole steps until the host clock
passes its length, and synchronises: the rate is batch x steps over that
time. The window's counters hold the graphs' real edges and padded slots
and the forward operations they need (`perfbench/flops_gns.py`).
"""

from __future__ import annotations

import math
import time

import torch

from perfbench import flops_gns, scenes
from perfbench.reference import gns as ref


def water_block(scene: dict, model: dict, episodes: int, frames: int, device):
    """(episodes, frames, k^3, 3) f32 trajectories: a k-a-side lattice
    block at ``spacing_over_radius`` x R, jittered by ``jitter`` of the
    spacing, centred at ``centre`` moved by up to ``centre_jitter``; each
    frame every particle moves by an ABC flow of ``flow_m`` a frame (seeded
    amplitudes in [0.5, 1] and phases, wavelength ``wavelength_m``) plus a
    fall that gains ``gravity_m`` a frame, and is reflected at the box."""
    gen = scenes.generator(scene["seed"], 0, device)
    k, R = scene["particles_per_side"], model["connectivity_radius"]
    a = scene["spacing_over_radius"] * R
    axis = (torch.arange(k, device=device, dtype=torch.float32) - (k - 1) / 2) * a
    grid = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    n = grid.shape[0]
    u = torch.rand(episodes, n + 2, 3, generator=gen, device=device)
    centre = torch.tensor(scene["centre"], device=device) + scene["centre_jitter"] * (
        2 * u[:, n] - 1)
    pos = centre[:, None] + grid + scene["jitter"] * a * (2 * u[:, :n] - 1)
    amp = scene["flow_m"] * (0.5 + 0.5 * u[:, n + 1])[:, None]  # (episodes, 1, 3)
    phase = 2 * math.pi * torch.rand(episodes, 1, 3, generator=gen, device=device)
    wave = 2 * math.pi / scene["wavelength_m"]
    box = torch.tensor(model["bounds"], device=device)
    fall = torch.zeros(episodes, 1, device=device)
    out = []
    for _ in range(frames):
        out.append(pos)
        s = torch.sin(wave * pos + phase)
        c = torch.cos(wave * pos + phase)
        flow = amp * torch.stack([s[..., 2] + c[..., 1], s[..., 0] + c[..., 2],
                                  s[..., 1] + c[..., 0]], -1)
        fall = fall - scene["gravity_m"]
        pos = pos + flow + torch.cat([torch.zeros_like(fall), torch.zeros_like(fall), fall],
                                     -1)[:, None]
        pos = torch.where(pos < box[:, 0], 2 * box[:, 0] - pos, pos)
        pos = torch.where(pos > box[:, 1], 2 * box[:, 1] - pos, pos)
    return torch.stack(out, 1)


class GNSTrainCell:
    def __init__(self, ctx: dict):
        from gsdx_torch.dynamics.gns import (GNS, GNSConfig, learning_rate, one_step_loss,
                                             statistics)
        from gsdx_torch.dynamics.train import TrainConfig, make_train_step
        from gsdx_torch.graph.dataset import EpisodeStore, WindowSampler, window_rows

        config, mix, seed, dev = ctx["config"], ctx["mix"], ctx["seed"], ctx["device"]
        self.config, self.device = config, dev
        self.t_start, self.first_window = ctx["t_start"], True
        model, train, scene = config["model_config"], config["train_config"], config["scene"]
        self.model, self.train = model, train
        self.batch_size = train["batch_size"]
        window = model["n_his"] + 1

        traj = water_block(scene, model, mix["episodes"], mix["frames"], dev)
        rows = window_rows(mix["episodes"], mix["frames"], window, dev)
        self.scene = (traj, rows)
        P = traj.shape[2]
        self.types = torch.full((P,), scene["particle_type"], dtype=torch.int64, device=dev)
        cfg = GNSConfig(**{k: (tuple(map(tuple, v)) if k == "bounds" else v)
                           for k, v in model.items() if k in GNSConfig._fields})
        self.sampler = WindowSampler(EpisodeStore(traj, traj.new_zeros((*traj.shape[:2], 0, 3)),
                                                  rows), self.types, cfg.noise_std,
                                     cfg.kinematic_type)
        self.weights = ref.init_weights(model, scenes.generator(seed, 31, dev), dev)
        with torch.device(dev):
            net = GNS(cfg).set_statistics(statistics(traj, cfg.noise_std))
        net.load_state_dict({**dict(net.named_buffers()), **self.weights})
        tcfg = TrainConfig(batch_size=self.batch_size, lr=train["lr"])
        self.net = net
        self.step, _, self.optimizer = make_train_step(net, tcfg, one_step_loss,
                                                       learning_rate(cfg, train["lr"]))
        self.gen = scenes.generator(seed, 32, dev)

        # the check's first steps, through the window's own calls
        self.check_gens, self.check_losses, self.check_graphs = [], [], []
        self.check_grads = []
        for _ in range(mix["check_steps"]):
            self.check_gens.append(self.gen.get_state())
            loss, _ = self.step(self.sampler.sample(self.gen, self.batch_size))
            self.check_losses.append(loss)
            self.check_graphs.append(net.graph.last)
            # a weight the loss did not reach holds a zero gradient
            self.check_grads.append({n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                                     for n, p in net.named_parameters()})
        self.after = {n: p.detach().clone() for n, p in net.named_parameters()}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def window(self, seconds: float) -> dict:
        dev = self.device
        cuda = dev.type == "cuda"
        graph = self.net.graph
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if self.first_window:
            self.setup_s = t0 - self.t_start
        steps = edges = slots = 0
        while True:
            self.step(self.sampler.sample(self.gen, self.batch_size))
            steps += 1
            edges += graph.edges
            slots += graph.slots
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
        metrics = {"train_samples_per_s": self.batch_size * steps / elapsed}
        if self.first_window:
            metrics["setup_s"] = self.setup_s
            self.first_window = False
        nodes = self.batch_size * steps * self.types.numel()
        counters = {"steps": steps, "samples": self.batch_size * steps, "edges": edges,
                    "slots": slots,
                    "forward_flops": flops_gns.forward_flops(self.model, nodes, edges)}
        return {"metrics": metrics, "attempted": self.batch_size * steps, "units": steps,
                "wall_s": elapsed, "counters": counters}

    def release(self) -> None:
        self.net = self.step = self.optimizer = self.sampler = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, precision: str, half: bool = False):
        """The reference's first steps from the starting weights on the
        replayed draws: (losses, gradients a step, weights after, graphs).
        ``half`` plants a fault: the loss over the first half of each batch
        alone."""
        traj, rows = self.scene
        moving = self.types != self.model["kinematic_type"]
        weights = {**self.weights, **ref.statistics(traj, self.model["noise_std"]),
                   "bounds": torch.tensor(self.model["bounds"], device=self.device)}
        batches = []
        for state in self.check_gens:
            g = torch.Generator(device=self.device)
            g.set_state(state)
            d = ref.draws(g, rows.shape[0], self.batch_size, rows.shape[1] - 1, traj.shape[2],
                          self.model["noise_std"], self.device)
            window, noise = ref.batch(traj, rows, d, moving)
            batches.append((window, noise, self.types.expand(self.batch_size, -1)))
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return ref.train_steps(weights, self.model, self.train, batches, precision,
                                   self.batch_size // 2 if half else None)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    def check(self, control: bool = False, fault: str | None = None) -> list[tuple]:
        """Against the reference's first steps: the graphs (directed edges
        in one and not the other, a count), the first step's loss (relative
        gap), the first gradient (worst leaf's relative L2 gap, over the
        larger of that leaf's reference norm and the median leaf's) and the
        weights' change after the steps (worst leaf's gap of norms, over the
        larger of that leaf's reference norm and the median leaf's, as
        cloth.train measures it). ``self.diagnostics`` keeps each gap's
        worst leaf over its own norm; the three leaves that lead the
        change's gap, with their first gradient's norm over the median
        leaf's, the entries whose gradient at some checked step has the
        other sign than the reference's, and the leaf's change gap over its
        other entries; the gradient's gap at each checked step; and the
        first gradient's entries of the other sign.
        ``control`` judges the reference with TF32 products in the
        program's place; ``fault`` "half" the reference with half of each
        batch left out."""
        limits = self.config["limits"]["gns_train"]
        losses, grads, after, graphs = self.reference_steps("f32")
        first = grads[0]
        P = self.types.numel()
        if control or fault:
            got_losses, got_grads, got_after, got_graphs = self.reference_steps(
                "tf32" if control else "f32", half=fault == "half")
        else:
            got_losses, got_grads, got_after = ([float(x) for x in self.check_losses],
                                                self.check_grads, self.after)
            got_graphs = [_flat_graph(r, s, P) for r, s in self.check_graphs]
        edges = sum(_edges_differing(a, b, P) for a, b in zip(got_graphs, graphs))
        loss_gap = abs(got_losses[0] - losses[0]) / abs(losses[0])
        start = self.weights
        moved = {k: got_after[k] - start[k] for k in first}
        want_moved = {k: after[k] - start[k] for k in first}
        grad = _leaf_gaps(got_grads[0], first, difference=True)
        change = _leaf_gaps(moved, want_moved, difference=False)
        norm = lambda x: float(torch.linalg.vector_norm(x.double()))  # noqa: E731
        grad_norms = {k: norm(first[k]) for k in first}
        med = sorted(grad_norms.values())[len(grad_norms) // 2]
        moves = sorted(norm(x) for x in want_moved.values())
        leaders = []
        for k, v in sorted(change.items(), key=lambda kv: -kv[1][0])[:3]:
            flipped = torch.zeros_like(first[k], dtype=torch.bool)
            for g, w in zip(got_grads, grads):
                flipped |= torch.sign(g[k]) != torch.sign(w[k])
            leaders.append({
                "leaf": k, "gap": v[0], "own": v[1], "grad_norm_over_median": grad_norms[k] / med,
                "entries": first[k].numel(), "sign_flipped": int(flipped.sum()),
                "gap_without_flipped": abs(norm(moved[k][~flipped])
                                           - norm(want_moved[k][~flipped]))
                / max(norm(want_moved[k]), moves[len(moves) // 2])})
        self.diagnostics = {
            "losses": losses, "program_losses": got_losses,
            "grad_gap_own": max((v[1], k) for k, v in grad.items()),
            "change_gap_own": max((v[1], k) for k, v in change.items()),
            "change_leaders": leaders,
            "step_grad_gaps": [max(v[0] for v in _leaf_gaps(g, w, True).values())
                               for g, w in zip(got_grads, grads)],
            "first_grad_sign_flips": sum(int((torch.sign(got_grads[0][k])
                                              != torch.sign(first[k])).sum()) for k in first)}
        return [("edges_differing", float(edges), limits["edges_differing"]),
                ("first_loss_gap", loss_gap, limits["first_loss_gap"]),
                ("grad_gap", max(v[0] for v in grad.values()), limits["grad_gap"]),
                ("change_gap", max(v[0] for v in change.values()), limits["change_gap"])]


def _flat_graph(recv, send, particles: int):
    """(B, E) per-sample receivers and senders, -1 on empty slots, as the
    batch's flat graph (receivers, senders), each sample offset by its
    particle count."""
    base = torch.arange(recv.shape[0], device=recv.device)[:, None] * particles
    keep = recv >= 0
    return (recv.long() + base)[keep], (send.long() + base)[keep]


def _edges_differing(got, want, nodes: int) -> int:
    a, b = ref.edge_key(*got, nodes), ref.edge_key(*want, nodes)
    ua, ub = torch.unique(a), torch.unique(b)
    repeated = (a.numel() - ua.numel()) + (b.numel() - ub.numel())
    return int(ua.numel() + ub.numel() - 2 * torch.isin(ua, ub).sum()) + repeated


def _leaf_gaps(got: dict, want: dict, difference: bool) -> dict:
    """{leaf: (gap over the larger of want's norm and the median leaf's,
    gap over want's norm)}, the gap the norm of got - want
    (``difference``) or the gap of the two norms."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double())) for k in want}
    med = sorted(norms.values())[len(norms) // 2]
    out = {}
    for k, n in norms.items():
        g = got[k].double()
        gap = (float(torch.linalg.vector_norm(g - want[k].double())) if difference
               else abs(float(torch.linalg.vector_norm(g)) - n))
        out[k] = (gap / max(n, med, 1e-30), gap / max(n, 1e-30))
    return out


def setup(ctx: dict) -> GNSTrainCell:
    return GNSTrainCell(ctx)
