"""MPPI trajectory optimization (counterpart of `gsdx/plan/planner.py`).

One MPPI update iteration samples actions, rolls them out, scores them and
moves the mean by a softmax over the rewards, tracking the best sample.
`plan_chunked` is the best of several independent optimizations. The GD
planner runs Adam on the sampled action batch through the differentiable
(module) rollout. There is one card, so no mesh: sharding the sample
batch is the `dist/` slice's work.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch

from gsdx_torch.core.device import require_device
from gsdx_torch.plan.actions import optimize_action_mppi, sample_action_seq


class MPPIConfig(NamedTuple):
    n_sample: int = 1000
    n_look_ahead: int = 1
    n_update_iter: int = 10
    reward_weight: float = 500.0
    noise_level: float = 0.3
    push_length: float = 0.01
    action_lower_lim: tuple = (-0.5, -0.5, -math.pi, 5.0)
    action_upper_lim: tuple = (0.5, 0.5, math.pi, 20.0)
    planner_type: str = "MPPI"  # "MPPI" | "GD"
    lr: float = 1e-3  # GD learning rate
    # GD memory control: differentiate through the rollout in chunks of this
    # many samples (0 = the whole batch); the objective is a mean over
    # samples, so the chunks' gradients are independent
    gd_sample_chunk: int = 0


class Planner:
    """MPPI (or GD) planner over a batched rollout.

    model_rollout_fn(state_cur, act_seqs, needs_grad=False) ->
        {"state_seqs", "action_seqs"}; the GD planner passes
        needs_grad=True (`make_batched_rollout` then takes the module path:
        the fused kernels have no backward)
    evaluate_traj_fn(state_seqs, act_seqs_decoded, state_cur) -> {"reward_seqs"}
    """

    def __init__(self, cfg: MPPIConfig, model_rollout_fn: Callable,
                 evaluate_traj_fn: Callable,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = require_device(device)
        self.lower = torch.tensor(cfg.action_lower_lim, dtype=torch.float32,
                                  device=self.device)
        self.upper = torch.tensor(cfg.action_upper_lim, dtype=torch.float32,
                                  device=self.device)
        self._rollout = model_rollout_fn
        self._evaluate = evaluate_traj_fn

    def _sample(self, generator, act_seq, iter_index, draws):
        cfg = self.cfg
        return sample_action_seq(generator, act_seq, self.lower, self.upper,
                                 cfg.n_sample, iter_index=iter_index,
                                 noise_level=cfg.noise_level,
                                 push_length=cfg.push_length, draws=draws)

    @torch.no_grad()
    def mppi_iteration(self, generator, state_cur, act_seq, iter_index: int,
                       best_act, best_reward, draws=None):
        """One update: returns (new mean act_seq, best_act, best_reward,
        rewards of this iteration's samples)."""
        cfg = self.cfg
        act_seqs = self._sample(generator, act_seq, iter_index, draws)
        out = self._rollout(state_cur, act_seqs)
        rewards = self._evaluate(out["state_seqs"], out["action_seqs"],
                                 state_cur)["reward_seqs"]
        new_act_seq = optimize_action_mppi(act_seqs, rewards, self.lower, self.upper,
                                           reward_weight=cfg.reward_weight,
                                           push_length=cfg.push_length)
        idx = torch.argmax(rewards)
        better = rewards[idx] > best_reward
        best_act = torch.where(better, act_seqs[idx], best_act)
        best_reward = torch.where(better, rewards[idx], best_reward)
        return new_act_seq, best_act, best_reward, rewards

    def trajectory_optimization(self, generator: torch.Generator | None,
                                state_cur, act_seq,
                                draws: Sequence | None = None):
        """Returns {"act_seq": best (L, 4), "best_reward": scalar tensor,
        "iter_best": per-iteration best sample reward}. ``draws[i]``, if
        given, replaces the generator's draws of iteration i (see
        `sample_action_seq`)."""
        if self.cfg.planner_type == "GD":
            return self._trajectory_optimization_gd(generator, state_cur, act_seq,
                                                    draws)
        best_act = act_seq
        best_reward = torch.tensor(-math.inf, device=act_seq.device)
        iter_best = []
        for i in range(self.cfg.n_update_iter):
            act_seq, best_act, best_reward, rewards = self.mppi_iteration(
                generator, state_cur, act_seq, i, best_act, best_reward,
                None if draws is None else draws[i])
            iter_best.append(rewards.max())
        return {"act_seq": best_act, "best_reward": best_reward,
                "iter_best": torch.stack(iter_best)}

    def _trajectory_optimization_gd(self, generator, state_cur, act_seq, draws):
        """Gradient-descent planning: Adam (optax's defaults: betas 0.9 and
        0.999, eps 1e-8) on the sampled action batch, maximizing the mean
        reward through the differentiable rollout (the edge structure is
        piecewise constant in the actions). Finishes with the argmax
        sample of the last evaluated rewards."""
        cfg = self.cfg
        with torch.no_grad():
            act_seqs = self._sample(generator, act_seq, 0,
                                    None if draws is None else draws[0])
        chunk = cfg.gd_sample_chunk or cfg.n_sample
        if cfg.n_sample % chunk:
            raise ValueError(f"gd_sample_chunk {chunk} must divide n_sample "
                             f"{cfg.n_sample}")
        out_acts, out_rewards = [], []
        for c0 in range(0, cfg.n_sample, chunk):
            acts_c = act_seqs[c0:c0 + chunk].clone().requires_grad_(True)
            opt = torch.optim.Adam([acts_c], lr=cfg.lr)
            rewards = None
            for _ in range(cfg.n_update_iter):
                out = self._rollout(state_cur, acts_c, needs_grad=True)
                rewards = self._evaluate(out["state_seqs"], out["action_seqs"],
                                         state_cur)["reward_seqs"]
                opt.zero_grad()
                (-rewards.mean()).backward()
                opt.step()
                with torch.no_grad():
                    acts_c.copy_(torch.clamp(acts_c, self.lower, self.upper))
            out_acts.append(acts_c.detach())
            out_rewards.append(rewards.detach())
        act_seqs = torch.cat(out_acts)
        rewards = torch.cat(out_rewards)
        idx = torch.argmax(rewards)
        return {"act_seq": act_seqs[idx], "best_reward": rewards[idx]}

    def plan_chunked(self, generator: torch.Generator | None, state_cur,
                     init_act_seq, n_chunks: int = 10):
        """Best of ``n_chunks`` independent optimizations."""
        results = [self.trajectory_optimization(generator, state_cur, init_act_seq)
                   for _ in range(n_chunks)]
        rewards = [float(r["best_reward"]) for r in results]
        return results[max(range(n_chunks), key=rewards.__getitem__)]
