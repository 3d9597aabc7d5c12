"""Driver of MPPI planning mixes: the robot's planning of push after push
through the port's `Planner.plan_chunked`, as `apps/plan.py` builds it.

Set-up makes the network's weights, ``n_actions`` start states and a
reachable target for each (the start state pushed by the reference model
along a push of the configuration's ``push_length``), all from the mix's
``scenario_seed``: the work of an MPPI iteration grows with the pushes the
planner converges to, so every seed plans the same actions, in turn. The
run's seed draws the planner's samples and the iterations checked.

Timing: the harness's rollout wrapper notes the host clock at the entry of
every rollout call, one a MPPI iteration, and adds no synchronisation. The
window opens at the first entry and closes at the first entry at or past
its length; each gap between two entries is one MPPI iteration, and the
iteration cut by the close is not counted.

The check follows the planner iteration by iteration and the rollout push
by push. The harness keeps every iteration's samples and rewards, and the
planner's generator state before each of the first ``check_within``
iterations; the references replay those iterations' draws and recompute
each mean from the previous iteration's samples and rewards (sample 0 of an
iteration is the mean it perturbs), and pick each action completed in the
window from its iterations, to compare with what `plan_chunked` returned.
The rollout is followed push by push. A push step's GNN is a call of
`plan.dynamics_rollout.fused_gnn_forward` (its plain twin on the CPU); the
harness wraps that name and, in ``check_iterations`` MPPI iterations drawn
from the seed among the first ``check_within``, keeps every call's inputs
and output (a program that stops calling it once a push step leaves no steps
to judge and reads not correct: fusing push steps needs a benchmark PR
first). The references then judge each step from the program's own
inputs (the GNN's prediction, the radius graph), the chaining of the steps
(each step's input from the previous step's output, the first from the
planned state and the pusher's spawn), every sample's answer (its state
after its own number of pushes) and reward. A rollout judged only at its
end cannot tell bf16 from fp8 products: after a few pushes a pair at the
graph's radius falls on the other side and the two drift apart by the
same millimetres either way.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from perfbench import flops, scenes
from perfbench.reference import gnn as ref
from perfbench.reference import mppi as ref_mppi


class WindowClosed(Exception):
    """Raised from the rollout wrapper at the first entry past the window."""


def model_dict(config: dict) -> dict:
    m = dict(config["model_config"])
    m.setdefault("motion_dim", 0)
    m.update(n_his=config["train_config"]["n_his"], motion_clamp=config["motion_clamp"])
    return m


def graph_dict(config: dict) -> dict:
    d = config["dataset_config"]
    return {"adj_thresh": sum(d["adj_radius_range"]) / 2, "topk": d["topk"],
            "max_nR": d["max_nR"], "connect_all": d["connect_all"],
            "push_length": config["mppi"]["push_length"]}


class MppiCell:
    def __init__(self, ctx: dict):
        from gsdx_torch.dynamics.model import DynamicsPredictor, ModelConfig
        from gsdx_torch.plan.cost import running_cost
        from gsdx_torch.plan.dynamics_rollout import RolloutSpec, make_batched_rollout
        from gsdx_torch.plan.planner import MPPIConfig, Planner

        config, mix, seed, dev = ctx["config"], ctx["mix"], ctx["seed"], ctx["device"]
        self.config, self.mix, self.seed, self.device = config, mix, seed, dev
        self.model = model_dict(config)
        self.graph = graph_dict(config)
        mp, obj = config["mppi"], config["object"]
        n_obj = config["dataset_config"]["max_nobj"]

        # every seed plans the same actions with the same weights: the work of
        # an MPPI iteration follows the pushes the planner converges to, and
        # states of their own moved it by 40% between seeds (PERF.md)
        fixed = mix["scenario_seed"]
        self.weights = scenes.gnn_weights(self.model, scenes.generator(fixed, 1, dev), dev,
                                          config["assumed"]["head_scale"])
        starts = scenes.OBJECTS[obj["kind"]](scenes.generator(fixed, 2, dev),
                                            mix["n_actions"], n_obj, obj, dev)
        pushes = scenes.target_pushes(scenes.generator(fixed, 3, dev), starts, obj)
        with torch.no_grad():
            targets = ref.rollout(self.weights, self.model, self.graph, starts, pushes)
        self.actions = [(s.contiguous(), t.contiguous()) for s, t in zip(starts, targets)]
        self.bbox = torch.tensor(config["workspace_bbox"], device=dev)

        mcfg = ModelConfig(**{k: self.model[k] for k in ModelConfig._fields})
        with torch.device(dev):
            net = DynamicsPredictor(mcfg)
        net.load_state_dict(self.weights)
        net.eval()
        d = config["dataset_config"]
        spec = RolloutSpec(n_his=self.model["n_his"], max_nobj=n_obj, max_nR=d["max_nR"],
                           topk=d["topk"], adj_thresh=self.graph["adj_thresh"],
                           push_length=mp["push_length"], max_repeat=mp["max_repeat"],
                           connect_all=d["connect_all"], sort_chunks=mp["sort_chunks"],
                           # the kernels on the card; their plain twin, what
                           # they compute, stands in on the CPU (the tests)
                           fused="auto" if dev.type == "cuda" else "twin")
        self.program_rollout = make_batched_rollout(net, spec)
        self.running_cost = running_cost
        self.net = net
        self.mcfg = MPPIConfig(n_sample=mp["n_sample"], n_update_iter=mp["n_update_iter"],
                               reward_weight=mp["reward_weight"],
                               noise_level=mp["noise_level"], push_length=mp["push_length"],
                               action_lower_lim=tuple(mp["action_lower_lim"]),
                               action_upper_lim=tuple(mp["action_upper_lim"]))
        self.lower = torch.tensor(mp["action_lower_lim"], device=dev)
        self.upper = torch.tensor(mp["action_upper_lim"], device=dev)
        self.planner = Planner(self.mcfg, self._rollout, self._evaluate, device=dev)
        self.plan_gen = scenes.generator(seed, 4, dev)
        self.init_act = torch.tensor([[0.0, 0.0, 0.0, 10.0]], device=dev)
        rng = np.random.default_rng([seed % 2**63, 5])
        self.keep_at = set(rng.choice(mix["check_within"], mix["check_iterations"],
                                      replace=False).tolist())
        self.kept, self.gen_states, self.results = [], {}, []
        self._record = None
        self._install_probe()
        self.next_action = 0
        self.calls = 0
        self.t_start = ctx["t_start"]
        self.first_window = True
        self.open = False
        self._current = None  # (state, target) being planned
        self._keep_now = None

        # warm-up: an iteration of each kind (uniform draw, then perturbed),
        # with every kernel built and every shape of the window met
        state, target = self.actions[0]
        self._current = (state, target)
        act, best, best_r = self.init_act, self.init_act, torch.tensor(-float("inf"), device=dev)
        warm_gen = scenes.generator(seed, 6, dev)
        for i in range(2):
            act, best, best_r, _ = self.planner.mppi_iteration(warm_gen, state, act, i,
                                                               best, best_r)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # -- the wrappers handed to the Planner ---------------------------------

    def _rollout(self, state, act_seqs, **kw):
        if self.open:
            now = time.perf_counter()
            if self.deadline is None:
                self.deadline = now + self.seconds
            self.entries.append(now)
            if now >= self.deadline:
                raise WindowClosed
        keep = self.open and self.calls in self.keep_at
        if keep:
            self._record = []
        try:
            out = self.program_rollout(state, act_seqs, **kw)
        finally:
            steps, self._record = self._record, None
        if self.open:
            self.window_acts.append(act_seqs)
            self.calls += 1
            if self.calls < self.mix["check_within"]:
                # the draws of the next iteration start here
                self.gen_states[self.calls] = self.plan_gen.get_state()
            self._keep_now = None
            if keep:
                self._keep_now = {"state": state, "target": self._current[1],
                                  "acts": act_seqs, "out": out["state_seqs"], "steps": steps}
                self.kept.append(self._keep_now)
        return out

    def _install_probe(self):
        """Wrap the rollout's GNN call (the kernels on the card, their plain
        twin on the CPU) so that a kept iteration keeps each push step's
        inputs and output. Outside those iterations the wrapper only calls
        through."""
        from gsdx_torch.plan import dynamics_rollout as DR

        self._dr = DR
        self._orig = {n: getattr(DR, n) for n in ("fused_gnn_forward", "gnn_forward_plain")}

        def probe(fn):
            def call(packed, attrs, action, state_t, g, recv, send, *a, **kw):
                out = fn(packed, attrs, action, state_t, g, recv, send, *a, **kw)
                if self._record is not None:
                    self._record.append((attrs, action, state_t, g, recv, send, out))
                return out
            return call

        for n, fn in self._orig.items():
            setattr(DR, n, probe(fn))

    def _evaluate(self, state_seqs, act_seqs, state_cur):
        res = self.running_cost(state_seqs, act_seqs, state_cur, self._current[1], self.bbox)
        if self.open:
            self.window_rewards.append(res["reward_seqs"])
        if self.open and self._keep_now is not None:
            self._keep_now["reward"] = res["reward_seqs"]
            self._keep_now = None
        return res

    # -- the harness's protocol ---------------------------------------------

    def window(self, seconds: float) -> dict:
        from gsdx_torch.kernels import gnn_forward as G

        self.seconds, self.deadline = seconds, None
        self.entries, self.window_acts, self.window_rewards = [], [], []
        first_call = self.calls
        if first_call == 0:
            self.gen_states[0] = self.plan_gen.get_state()
        before = dict(G.LAUNCHES)
        self.open = True
        try:
            while True:
                self._current = self.actions[self.next_action % len(self.actions)]
                self.next_action += 1
                start = self.calls
                res = self.planner.plan_chunked(self.plan_gen, self._current[0], self.init_act,
                                                n_chunks=self.config["mppi"]["n_chunks"])
                if first_call == 0:  # the first window's actions are judged
                    self.results.append((res, start, self.calls))
        except WindowClosed:
            pass
        finally:
            self.open = False
        if first_call == 0:
            self.first_acts = self.window_acts
            self.first_rewards = self.window_rewards
        gaps = np.diff(self.entries)
        n = len(gaps)
        if n < 1:
            raise RuntimeError(f"the window of {seconds} s completed no MPPI iteration")
        acts = self.window_acts[:n]
        needed = int(torch.stack([a[:, :, 3].to(torch.int32).sum() for a in acts]).sum())
        launches = {k: G.LAUNCHES[k] - before[k] for k in G.LAUNCHES}
        metrics = {"mppi_iter_ms": 1e3 * float(gaps.sum()) / n}
        if self.first_window:
            metrics["setup_s"] = self.entries[0] - self.t_start
            self.first_window = False
        if n >= 2:
            metrics["mppi_iter_ms_p90"] = 1e3 * statistics.quantiles(gaps.tolist(), n=10)[8]
        nodes, rel, n_p = flops.plan_shapes(self.config)
        return {"metrics": metrics, "attempted": n, "units": n, "wall_s": float(gaps.sum()),
                "counters": {"iterations": n, "needed_sample_pushes": needed,
                             "step_flops": flops.gnn_step_flops(self.model, nodes, rel, n_p),
                             "step_bytes": flops.gnn_step_bytes(self.model, nodes, rel, n_p),
                             "kernel_launches": {rf"\b{k}_kernel": v for k, v in
                                                 launches.items() if k != "gnn_forward"}}}

    def release(self) -> None:
        for n, fn in self._orig.items():
            setattr(self._dr, n, fn)
        self.planner = self.program_rollout = self.net = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> list[tuple]:
        """The kept iterations against the references, every push step and
        every sample. Numbers: ``gnn_gap_m`` the widest gap of a predicted
        coordinate against the reference network on the step's own inputs;
        ``edges_differing`` relations that differ from the reference's graph
        of the step's input positions (exact); ``chain_gap_m`` the widest
        gap of a step's input from the previous step's output, the first
        step's from the planned state and the pusher's spawn, and of each
        sample's answer from its step at its own repeat count (exact);
        ``reward_gap`` the widest gap of a sample's reward against the
        reference reward of the program's own answer; ``sample_gap`` the
        widest gap of the first ``check_within`` iterations' samples against
        the reference sampler on the replayed draws around the reference
        update of the previous iteration's samples and rewards (each
        component over its range); ``choice_gap`` the widest gap of an
        action `plan_chunked` returned in the window, and of its reward,
        against the reference's pick from its iterations (exact).
        ``control`` judges the control in the program's place: the reference
        network with fp8 products at every step, the reward, the sampler and
        the update in bf16."""
        limits = self.config["limits"]["mppi"]
        kept = [k for k in self.kept if "reward" in k]
        if not kept:
            return [("iterations_checked", 0.0, -1.0)]
        gaps = {"gnn_gap_m": 0.0, "edges_differing": 0.0, "chain_gap_m": 0.0,
                "reward_gap": 0.0}
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for k in kept:
                for name, value in self._check_iteration(k, control).items():
                    gaps[name] = max(gaps[name], value)
            gaps["sample_gap"] = self._check_samples(control)
            gaps["choice_gap"] = self._check_choices()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        return [(n, v, limits[n]) for n, v in gaps.items()]

    def _check_samples(self, control: bool) -> float:
        mp, n_iter = self.config["mppi"], self.config["mppi"]["n_update_iter"]
        acts, rewards = self.first_acts, self.first_rewards

        def draw(c, dtype):
            i = c % n_iter
            mean = (self.init_act if i == 0 else
                    ref_mppi.update(acts[c - 1], rewards[c - 1], self.lower, self.upper, mp,
                                    dtype))
            return ref_mppi.sample(self.gen_states[c], mean, i, acts[c].shape[0], self.lower,
                                   self.upper, mp, dtype)

        gap = 0.0
        for c in range(min(self.mix["check_within"], len(acts), len(rewards) + 1)):
            want = draw(c, torch.float64)
            got = draw(c, torch.bfloat16) if control else acts[c]
            g = ref_mppi.action_gap(got, want, self.lower, self.upper)
            if g > gap:
                gap, worst = g, (c, (got - want).abs().reshape(-1, 4).max(0).values.tolist())
        if gap > 0:
            print(f"perfbench: sample_gap {gap!r} at iteration {worst[0]}; widest gap of "
                  f"x, y, theta, length {worst[1]}", file=sys.stderr)
        return gap

    def _check_choices(self) -> float:
        per = self.config["mppi"]["n_chunks"] * self.config["mppi"]["n_update_iter"]
        gap = 0.0
        for res, start, end in self.results:
            if end - start != per:  # not the configured chunks x iterations
                return float("inf")
            act, best = ref_mppi.choice(self.first_acts[start:end],
                                        self.first_rewards[start:end], self.init_act,
                                        self.config["mppi"]["n_update_iter"])
            gap = max(gap, ref_mppi.action_gap(res["act_seq"], act, self.lower, self.upper),
                      abs(float(res["best_reward"]) - best))
        print(f"perfbench: {len(self.results)} planned actions judged, "
              f"{min(self.mix['check_within'], len(self.first_acts))} iterations' samples",
              file=sys.stderr)
        return gap

    def _check_iteration(self, k: dict, control: bool) -> dict:
        mp, g = self.config["mppi"], self.graph
        n_obj = k["state"].shape[0]
        N, n_his = n_obj + 1, self.model["n_his"]
        acts = k["acts"][:, 0]
        B = acts.shape[0]
        dec, repeats = ref.decode(acts, g["push_length"])
        # the rollout's chunks: samples sorted by repeat count (stable),
        # each chunk pushed to its own largest count
        nc = mp["sort_chunks"]
        if nc > 1 and B % nc == 0 and B >= 2 * nc:
            order = torch.argsort(-repeats, stable=True)
        else:
            order, nc = torch.arange(B, device=acts.device), 1
        chunks = order.view(nc, -1)
        counts = [min(int(repeats[c].max()), mp["max_repeat"]) for c in chunks]
        steps = k["steps"]
        out = {"gnn_gap_m": 0.0, "edges_differing": 0.0, "chain_gap_m": 0.0}
        if len(steps) != sum(counts):
            out["chain_gap_m"] = float("inf")
            return out
        answers = torch.zeros(B, n_obj, 3, device=acts.device)
        at = 0
        for c, n_steps in zip(chunks, counts):
            Bc = c.numel()
            z = k["state"][:, 2].min()
            spawn = torch.stack([dec[c, 0], dec[c, 1], z.expand(Bc)], -1)[:, None]
            delta = torch.stack([dec[c, 2] - dec[c, 0], dec[c, 3] - dec[c, 1],
                                 torch.zeros(Bc, device=acts.device)], -1)[:, None]
            frame = torch.cat([k["state"][None].expand(Bc, -1, -1), spawn], 1)
            want = frame[:, None].expand(Bc, n_his, N, 3)
            final = torch.zeros(Bc, n_obj, 3, device=acts.device)
            for step in range(1, n_steps + 1):
                attrs_pad, action_pad, st_pad, g_pad, recv, send, res = steps[at]
                at += 1
                if st_pad.shape[0] != Bc:  # a step of another batch than its chunk's
                    out["chain_gap_m"] = float("inf")
                    return out
                states = st_pad[:, :N].reshape(Bc, N, n_his, 3).transpose(1, 2)
                out["chain_gap_m"] = max(out["chain_gap_m"], float((states - want).abs().max()),
                                         float((action_pad[:, n_obj:N] - delta).abs().max()))
                r_ref, s_ref = ref.edges(states[:, -1], n_obj, g["adj_thresh"], g["topk"],
                                         g["max_nR"], g["connect_all"])
                r_got, s_got = recv[:, :g["max_nR"]].long(), send[:, :g["max_nR"]].long()
                out["edges_differing"] += float(((r_got != r_ref) | (s_got != s_ref)).sum())
                clamp = self.model["motion_clamp"]
                if control:
                    pred = ref.forward(self.weights, self.model, states, attrs_pad[:, :N],
                                       g_pad[:, :N, 0], action_pad[:, :N], r_got, s_got,
                                       n_obj, "fp8")
                else:
                    pred = states[:, -1, :n_obj] + torch.clamp(res[:, :n_obj, :3], -clamp, clamp)
                pred_ref = ref.forward(self.weights, self.model, states, attrs_pad[:, :N],
                                       g_pad[:, :N, 0], action_pad[:, :N], r_got, s_got, n_obj)
                out["gnn_gap_m"] = max(out["gnn_gap_m"], float((pred - pred_ref).abs().max()))
                final = torch.where((repeats[c] == step)[:, None, None], pred, final)
                tool = states[:, -1, n_obj:] + delta
                tool = torch.cat([tool[:, :, :2], pred[:, :, 2].min(1).values[:, None, None]], 2)
                want = torch.cat([states[:, 1:], torch.cat([pred, tool], 1)[:, None]], 1)
            answers[c] = final
        got = k["out"][:, 0]
        if control:
            got_r = ref.reward(answers, dec, k["state"], k["target"], self.bbox, torch.bfloat16)
        else:
            out["chain_gap_m"] = max(out["chain_gap_m"], float((got - answers).abs().max()))
            got_r = k["reward"]
        want_r = ref.reward(answers, dec, k["state"], k["target"], self.bbox)
        out["reward_gap"] = float((got_r - want_r).abs().max())
        return out


def setup(ctx: dict) -> MppiCell:
    return MppiCell(ctx)
