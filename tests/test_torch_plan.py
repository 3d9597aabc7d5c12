"""The planning slice as a whole against gsdx, on the CPU: actions and cost,
the batched rollout (through the fused forward's plain version and through
the module), one MPPI optimization with gsdx's own draws replayed, the
simulated environment and perception, and `gsdx_torch.apps.plan`.

Real inputs: the trained rope weights and the particle trajectory committed
under benchmarks/out/.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdx.core import pointcloud as jpc
from gsdx.dynamics.model import DynamicsPredictor as JModel
from gsdx.dynamics.model import ModelConfig as JModelConfig
from gsdx.plan import actions as jact
from gsdx.plan import cost as jcost
from gsdx.plan.dynamics_rollout import RolloutSpec as JSpec
from gsdx.plan.dynamics_rollout import make_batched_rollout as j_rollout
from gsdx.plan.planner import MPPIConfig as JMPPI
from gsdx.plan.planner import Planner as JPlanner
from gsdx.realworld.env import FakeEnv as JFakeEnv
from gsdx.realworld.perception import PerceptionModule as JPerception
from gsdx.render.rasterize import RasterizeConfig as JRasterCfg
from gsdx.render.rasterize import rasterize as j_rasterize
from gsdx_torch.core import pointcloud as tpc
from gsdx_torch.dynamics.model import (FORWARDS, DynamicsPredictor, ModelConfig,
                                       load_flax_params, reset_forwards)
from gsdx_torch.kernels.fps import farthest_point_sampling
from gsdx_torch.plan import actions as tact
from gsdx_torch.plan import cost as tcost
from gsdx_torch.plan.dynamics_rollout import RolloutSpec, make_batched_rollout
from gsdx_torch.plan.planner import MPPIConfig, Planner
from gsdx_torch.realworld.env import WORKSPACE_BBOX, FakeEnv
from gsdx_torch.realworld.perception import PerceptionModule
from gsdx_torch.realworld.segmentation import make_segmenter

from test_torch_dynamics import REPO, trained_tree

TRAJ = os.path.join(REPO, "benchmarks/out/pipeline/ckpts/param_downsampled.npy")
LOWER = np.array([-0.5, -0.5, -np.pi, 5.0], np.float32)
UPPER = np.array([0.5, 0.5, np.pi, 20.0], np.float32)


@pytest.fixture(scope="module")
def scene():
    """40 FPS-sampled particles of the committed trajectory's first frame,
    a later frame as the target, the trained weights in both packages."""
    traj = np.load(TRAJ)
    pts = torch.as_tensor(traj[0])
    state = pts[farthest_point_sampling(pts, 40)].numpy()
    target = traj[12][::10].copy()
    tree = trained_tree()
    model = load_flax_params(DynamicsPredictor(ModelConfig()), tree)
    return dict(state=state, target=target, tree=tree, model=model,
                jparams=jax.tree.map(jnp.asarray, tree))


def _acts(rng, state, B, lo=2.0, hi=5.0):
    """Pushes starting near the object, 2..4 unit repeats."""
    start = state[rng.integers(len(state), size=B), :2] + rng.normal(0, 0.02, (B, 2))
    return np.concatenate([start, rng.uniform(-np.pi, np.pi, (B, 1)),
                           rng.uniform(lo, hi, (B, 1))], -1)[:, None].astype(np.float32)


# ---------------------------------------------------------------- actions


def test_actions_with_gsdx_draws_replayed(rng):
    key = jax.random.PRNGKey(3)
    n, L = 64, 2
    act_seq = np.array([[0.1, -0.2, 0.5, 10.0], [0.3, 0.1, -2.5, 7.0]], np.float32)
    lo, hi = jnp.asarray(LOWER), jnp.asarray(UPPER)
    # iteration 0: the uniform block
    u = jax.random.uniform(key, (n, L, 4))
    ref0 = jact.sample_action_seq(key, jnp.asarray(act_seq), lo, hi, n, iter_index=0)
    out0 = tact.sample_action_seq(None, torch.as_tensor(act_seq), torch.as_tensor(LOWER),
                                  torch.as_tensor(UPPER), n, iter_index=0,
                                  draws=torch.as_tensor(np.array(u)))
    # XLA contracts u * (upper - lower) + lower into one FMA: 1 ulp
    np.testing.assert_allclose(out0.numpy(), np.asarray(ref0), rtol=2e-7, atol=1e-7)
    # later iterations: one normal block per look-ahead step, on split keys
    keys = jax.random.split(key, L)
    z = np.stack([np.array(jax.random.normal(k, (n, 4))) for k in keys])
    ref1 = jact.sample_action_seq(key, jnp.asarray(act_seq), lo, hi, n, iter_index=1)
    out1 = tact.sample_action_seq(None, torch.as_tensor(act_seq), torch.as_tensor(LOWER),
                                  torch.as_tensor(UPPER), n, iter_index=1,
                                  draws=torch.as_tensor(z))
    # arctan2 / sqrt / cos of another libm: a few f32 ulps
    np.testing.assert_allclose(out1.numpy(), np.asarray(ref1), rtol=1e-6, atol=2e-6)
    assert np.array_equal(out1[0].numpy(), act_seq)  # sample 0 keeps the incumbent
    # the generator path draws the same shapes
    g = torch.Generator().manual_seed(0)
    assert tact.sample_action_seq(g, torch.as_tensor(act_seq), torch.as_tensor(LOWER),
                                  torch.as_tensor(UPPER), n, 1).shape == (n, L, 4)

    rewards = rng.normal(size=n).astype(np.float32) * 0.01
    ref = jact.optimize_action_mppi(ref1, jnp.asarray(rewards), lo, hi, 500.0)
    out = tact.optimize_action_mppi(torch.as_tensor(np.array(ref1)),
                                    torch.as_tensor(rewards), torch.as_tensor(LOWER),
                                    torch.as_tensor(UPPER), 500.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    wrapped = rng.uniform(-12, 12, size=(200,)).astype(np.float32)
    np.testing.assert_allclose(tact.angle_normalize(torch.as_tensor(wrapped)).numpy(),
                               np.asarray(jact.angle_normalize(jnp.asarray(wrapped))),
                               rtol=0, atol=1e-6)


def test_fps_action_sampling_equals_gsdx():
    # tests/test_plan.py's box and grid: 2 x 2 x 32 x 75 grid points
    lower = (-0.2, -0.2, -np.pi, 5.0)
    upper = (0.2, 0.2, np.pi, 20.0)
    # the same grid points picked by FPS with exact index parity, from
    # tuples (a float64 grid) and from f32 limits (the planner's)
    lo32, hi32 = np.float32(lower), np.float32(upper)
    for j_lim, t_lim in (((lower, upper), (lower, upper)),
                         ((jnp.asarray(lo32), jnp.asarray(hi32)),
                          (torch.as_tensor(lo32), torch.as_tensor(hi32)))):
        ref = jact.sample_action_seq_fps(*j_lim, n_sample=32, n_look_ahead=2,
                                         grid_size=0.2)
        out = tact.sample_action_seq_fps(*t_lim, 32, n_look_ahead=2, grid_size=0.2,
                                         device="cpu")
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_decode_action_repeats_exact(rng):
    a = np.concatenate([rng.uniform(-0.5, 0.5, (50, 3, 2)),
                        rng.uniform(-np.pi, np.pi, (50, 3, 1)),
                        rng.uniform(0, 20, (50, 3, 1))], -1).astype(np.float32)
    a[0, 0, 3] = 5.0
    a[1, 0, 3] = 4.9999995
    dec_j, rep_j = jact.decode_action(jnp.asarray(a))
    dec_t, rep_t = tact.decode_action(torch.as_tensor(a))
    np.testing.assert_array_equal(rep_t.numpy(), np.asarray(rep_j))
    np.testing.assert_array_equal(dec_t[..., :2].numpy(), np.asarray(dec_j[..., :2]))
    # the end points: XLA's cos differs from torch's in the last bit on a
    # few percent of angles, and XLA fuses x0 - 0.01 cos into an FMA
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), rtol=0, atol=1e-7)


def test_running_cost_matches(rng, scene):
    B, L, n = 12, 2, len(scene["state"])
    states = (scene["state"][None, None] + rng.normal(0, 0.01, (B, L, n, 3))).astype(np.float32)
    dec = np.concatenate([rng.uniform(0, 0.5, (B, L, 2)),
                          rng.uniform(0, 0.5, (B, L, 2))], -1).astype(np.float32)
    args = (states, dec, scene["state"], scene["target"], WORKSPACE_BBOX)
    ref = jcost.running_cost(*map(jnp.asarray, args))["reward_seqs"]
    out = tcost.running_cost(*map(torch.as_tensor, args))["reward_seqs"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    box = np.array([[0.1, 0.3], [-0.05, 0.05]], np.float32)
    np.testing.assert_allclose(tcost.box_loss(torch.as_tensor(states[:, 0]),
                                              torch.as_tensor(box)).numpy(),
                               np.asarray(jcost.box_loss(jnp.asarray(states[:, 0]),
                                                         jnp.asarray(box))),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- rollout


SPEC = dict(n_his=3, max_nobj=40, max_nR=200, topk=5, adj_thresh=0.08, max_repeat=6)


@pytest.mark.parametrize("sort_chunks", [1, 8])
def test_rollout_plain_version_matches_gsdx_twin(rng, scene, sort_chunks):
    acts = _acts(rng, scene["state"], 16)
    roll_j = j_rollout(JModel(JModelConfig()), JSpec(**SPEC, sort_chunks=sort_chunks,
                                                     fused="twin"))
    ref = roll_j(scene["jparams"], jnp.asarray(scene["state"]), jnp.asarray(acts))
    roll_t = make_batched_rollout(scene["model"], RolloutSpec(
        **SPEC, sort_chunks=sort_chunks, fused="twin"))
    with torch.no_grad():
        out = roll_t(torch.as_tensor(scene["state"]), torch.as_tensor(acts))
    # bf16 weights in both, f32 products summed in another order, chained
    # over up to 4 pushes of a trained net: 1e-5 m
    np.testing.assert_allclose(out["state_seqs"].numpy(), np.asarray(ref["state_seqs"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out["action_seqs"].numpy(),
                                  np.asarray(ref["action_seqs"]))
    moved = np.abs(out["state_seqs"].numpy() - scene["state"]).max()
    assert moved > 1e-3  # the pushes did something


def test_rollout_bf16_operands_match_gsdx_module_rollout(rng, scene, monkeypatch):
    """The kernels' numerics over chained pushes: the rollout through the
    plain version with bf16 product operands against gsdx's module rollout
    on bf16-rounded weights (tests/test_gnn_fused.py's fused-vs-plain
    setup)."""
    from gsdx_torch.kernels import gnn_forward as tg
    from gsdx_torch.plan import dynamics_rollout

    monkeypatch.setattr(dynamics_rollout, "gnn_forward_plain",
                        functools.partial(tg.gnn_forward_plain, operands="bf16"))
    acts = _acts(rng, scene["state"], 16)
    params_bf = jax.tree.map(lambda x: x.astype(jnp.bfloat16).astype(jnp.float32),
                             scene["jparams"])
    ref = j_rollout(JModel(JModelConfig()), JSpec(**SPEC, sort_chunks=1, fused="off"))(
        params_bf, jnp.asarray(scene["state"]), jnp.asarray(acts))
    roll_t = make_batched_rollout(scene["model"], RolloutSpec(**SPEC, sort_chunks=1,
                                                              fused="twin"))
    with torch.no_grad():
        out = roll_t(torch.as_tensor(scene["state"]), torch.as_tensor(acts))
    # the bound gsdx holds its bf16-class fused rollout to, over up to 4
    # chained pushes
    np.testing.assert_allclose(out["state_seqs"].numpy(), np.asarray(ref["state_seqs"]),
                               rtol=0, atol=2e-3)
    # the operands were rounded: the f32 twin gives another rollout
    with torch.no_grad():
        monkeypatch.undo()
        f32 = make_batched_rollout(scene["model"], RolloutSpec(
            **SPEC, sort_chunks=1, fused="twin"))(torch.as_tensor(scene["state"]),
                                                  torch.as_tensor(acts))
    assert not torch.equal(f32["state_seqs"], out["state_seqs"])


def test_rollout_module_path_matches_gsdx(rng, scene):
    acts = _acts(rng, scene["state"], 6)
    ref = j_rollout(JModel(JModelConfig()), JSpec(**SPEC, sort_chunks=1, fused="off"))(
        scene["jparams"], jnp.asarray(scene["state"]), jnp.asarray(acts))
    roll_t = make_batched_rollout(scene["model"], RolloutSpec(**SPEC, sort_chunks=1,
                                                              fused="off"))
    reset_forwards()
    with torch.no_grad():
        out = roll_t(torch.as_tensor(scene["state"]), torch.as_tensor(acts))
    assert FORWARDS["one_hot"] > 0 and FORWARDS["indexed"] == 0
    # f32 weights and math on both sides: 1e-5 m after the chained pushes
    np.testing.assert_allclose(out["state_seqs"].numpy(), np.asarray(ref["state_seqs"]),
                               rtol=0, atol=1e-5)
    # "auto" on the CPU takes the module path
    with torch.no_grad():
        auto = make_batched_rollout(scene["model"], RolloutSpec(**SPEC, sort_chunks=1))(
            torch.as_tensor(scene["state"]), torch.as_tensor(acts))
    np.testing.assert_array_equal(auto["state_seqs"].numpy(), out["state_seqs"].numpy())
    # gradients flow through the module path for the GD planner
    a = torch.as_tensor(acts).requires_grad_(True)
    res = roll_t(torch.as_tensor(scene["state"]), a, needs_grad=True)
    res["state_seqs"].sum().backward()
    assert torch.isfinite(a.grad).all() and a.grad.abs().sum() > 0


@pytest.mark.parametrize("cfg,max_nobj,field", [
    (ModelConfig(state_dim=1), 100, "motion_dim"),
    (ModelConfig(nf_effect=256), 100, "nf_effect"),
    (ModelConfig(), 300, "max_nobj"),
])
def test_fused_route_refuses_on_cuda_what_the_kernels_do_not_take(cfg, max_nobj, field):
    from gsdx_torch.plan.dynamics_rollout import fused_route

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    spec = RolloutSpec(**dict(SPEC, max_nobj=max_nobj))
    # "auto" on a CUDA device names the field and never takes the module
    with pytest.raises(ValueError, match=field):
        fused_route(spec, cfg, cuda, needs_grad=False)
    with pytest.raises(ValueError, match=field):
        fused_route(spec._replace(fused="twin"), cfg, cpu, needs_grad=False)
    # the module: "auto" on the CPU, "off", and the gradient path
    assert not fused_route(spec, cfg, cpu, needs_grad=False)
    assert not fused_route(spec._replace(fused="off"), cfg, cuda, needs_grad=False)
    assert not fused_route(spec, cfg, cuda, needs_grad=True)
    # a model the kernels take goes to them on CUDA
    assert fused_route(RolloutSpec(**SPEC), ModelConfig(), cuda, needs_grad=False)


def test_mppi_iterations_match_gsdx_with_draws_replayed(scene):
    n, iters = 8, 2
    spec = dict(SPEC, sort_chunks=1)
    state, target = scene["state"], scene["target"]
    bbox = WORKSPACE_BBOX

    roll_j = j_rollout(JModel(JModelConfig()), JSpec(**spec))
    planner_j = JPlanner(
        JMPPI(n_sample=n, n_update_iter=iters),
        lambda s, a: roll_j(scene["jparams"], s, a),
        lambda ss, aa, s: jcost.running_cost(ss, aa, s, jnp.asarray(target),
                                             jnp.asarray(bbox)))
    key = jax.random.PRNGKey(11)
    init = np.array([[0.3, 0.0, 0.0, 10.0]], np.float32)
    ref = planner_j.trajectory_optimization(key, jnp.asarray(state), jnp.asarray(init))

    # gsdx's key schedule: one split per iteration; a uniform block at
    # iteration 0, one normal block per look-ahead step after it
    draws = []
    for i in range(iters):
        key, sub = jax.random.split(key)
        if i == 0:
            draws.append(torch.as_tensor(np.array(jax.random.uniform(sub, (n, 1, 4)))))
        else:
            ks = jax.random.split(sub, 1)
            draws.append(torch.as_tensor(np.stack(
                [np.array(jax.random.normal(k, (n, 4))) for k in ks])))

    roll_t = make_batched_rollout(scene["model"], RolloutSpec(**spec))
    planner_t = Planner(
        MPPIConfig(n_sample=n, n_update_iter=iters), roll_t,
        lambda ss, aa, s: tcost.running_cost(ss, aa, s, torch.as_tensor(target),
                                             torch.as_tensor(bbox)), device="cpu")
    out = planner_t.trajectory_optimization(None, torch.as_tensor(state),
                                            torch.as_tensor(init), draws=draws)
    # f32 rollouts of a trained net in another summation order: 1e-5
    assert float(out["best_reward"]) == pytest.approx(float(ref["best_reward"]),
                                                      abs=1e-5)
    assert out["iter_best"].shape == (iters,)
    assert float(out["best_reward"]) == float(out["iter_best"].max())
    # the best action is the same sample whenever the two best rewards of
    # the run are further apart than that tolerance. Its values: iteration
    # 1 samples around the softmax mean, whose weights scale the rewards'
    # 1e-6 differences by 500, and arctan2 of a 5 cm push vector passes
    # that on to theta: 1e-3
    rewards = []
    act, best_act, best_r = torch.as_tensor(init), torch.as_tensor(init), torch.tensor(-np.inf)
    for i in range(iters):
        act, best_act, best_r, r = planner_t.mppi_iteration(
            None, torch.as_tensor(state), act, i, best_act, best_r, draws[i])
        rewards.append(r)
    top2 = torch.topk(torch.cat(rewards), 2).values
    if float(top2[0] - top2[1]) > 1e-5:
        np.testing.assert_allclose(out["act_seq"].numpy(), np.asarray(ref["act_seq"]),
                                   rtol=0, atol=1e-3)


def test_gd_planner_refuses_uneven_chunks(scene):
    planner = Planner(MPPIConfig(n_sample=10, planner_type="GD", gd_sample_chunk=4),
                      lambda s, a: None, lambda *a: None, device="cpu")
    with pytest.raises(ValueError):
        planner.trajectory_optimization(torch.Generator().manual_seed(0),
                                        torch.as_tensor(scene["state"]),
                                        torch.zeros(1, 4))


def test_gd_planner_improves_reward(scene):
    state, target = torch.as_tensor(scene["state"]), torch.as_tensor(scene["target"])
    model = scene["model"]
    roll = make_batched_rollout(model, RolloutSpec(**dict(SPEC, max_repeat=3),
                                                   sort_chunks=1))
    planner = Planner(MPPIConfig(n_sample=4, n_update_iter=3, planner_type="GD",
                                 gd_sample_chunk=2, lr=1e-2,
                                 action_lower_lim=(-0.5, -0.5, -np.pi, 2.0),
                                 action_upper_lim=(0.5, 0.5, np.pi, 3.0)),
                      roll, lambda ss, aa, s: tcost.running_cost(
                          ss, aa, s, target, torch.as_tensor(WORKSPACE_BBOX)),
                      device="cpu")
    out = planner.trajectory_optimization(torch.Generator().manual_seed(0), state,
                                          torch.zeros(1, 4))
    assert out["act_seq"].shape == (1, 4) and torch.isfinite(out["best_reward"])



def test_gd_planner_matches_gsdx_with_the_draw_replayed(scene):
    """GD planning on the rope's extent (x 0.1-0.5 m, y -0.1-0.15 m), where
    pushes reach the rope and its reward has a gradient: 16 samples of
    gsdx's uniform draw, 10 Adam steps a chunk of 8, lr 1e-2."""
    n, iters, chunk, lr = 16, 10, 8, 1e-2
    lower = (0.1, -0.1, -np.pi, 2.0)
    upper = (0.5, 0.15, np.pi, 3.0)
    spec = dict(SPEC, max_repeat=3, sort_chunks=1)
    state, target = scene["state"], scene["target"]
    bbox = WORKSPACE_BBOX
    init = np.array([[0.3, 0.0, 0.0, 2.5]], np.float32)
    key = jax.random.PRNGKey(5)

    roll_j = j_rollout(JModel(JModelConfig()), JSpec(**spec))
    planner_j = JPlanner(
        JMPPI(n_sample=n, n_update_iter=iters, planner_type="GD", gd_sample_chunk=chunk,
              lr=lr, action_lower_lim=lower, action_upper_lim=upper),
        lambda s, a, needs_grad=False: roll_j(scene["jparams"], s, a,
                                              needs_grad=needs_grad),
        lambda ss, aa, s: jcost.running_cost(ss, aa, s, jnp.asarray(target),
                                             jnp.asarray(bbox)))
    ref = planner_j.trajectory_optimization(key, jnp.asarray(state), jnp.asarray(init))

    # gsdx's GD draws one uniform block from the key itself
    u = torch.as_tensor(np.array(jax.random.uniform(key, (n, 1, 4))))
    planner_t = Planner(
        MPPIConfig(n_sample=n, n_update_iter=iters, planner_type="GD",
                   gd_sample_chunk=chunk, lr=lr, action_lower_lim=lower,
                   action_upper_lim=upper),
        make_batched_rollout(scene["model"], RolloutSpec(**spec)),
        lambda ss, aa, s: tcost.running_cost(ss, aa, s, torch.as_tensor(target),
                                             torch.as_tensor(bbox)), device="cpu")
    out = planner_t.trajectory_optimization(None, torch.as_tensor(state),
                                            torch.as_tensor(init), draws=[u])
    draws = tact.sample_action_seq(None, torch.as_tensor(init), planner_t.lower,
                                   planner_t.upper, n, iter_index=0, draws=u)
    # the best sample moved from its draw (it is far from every draw)
    moved = (draws[:, 0] - out["act_seq"][0]).abs().max(-1).values.min()
    assert float(moved) > 1e-2
    # f32 rollouts, gradients and Adam steps of a trained net in another
    # summation order: 1e-5
    np.testing.assert_allclose(out["act_seq"].detach().numpy(), np.asarray(ref["act_seq"]),
                               rtol=0, atol=1e-5)
    assert float(out["best_reward"]) == pytest.approx(float(ref["best_reward"]), abs=1e-5)


# ---------------------------------------------------------------- environment


def _fake_cloud(seed=43):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(scale=0.03, size=(400, 3)) + [0.3, 0.0, 0.0]).astype(np.float32)
    cols = np.tile(np.array([0.9, 0.2, 0.1], np.float32), (400, 1))
    return pts, cols


def test_fake_env_observation_matches_gsdx():
    pts, cols = _fake_cloud()
    env_j, env_t = JFakeEnv(pts, cols), FakeEnv(pts, cols, device="cpu")
    n = len(pts)
    geo = (jnp.asarray(pts), jnp.tile(jnp.array([[1.0, 0, 0, 0]]), (n, 1)),
           jnp.full((n, 3), 0.008), jnp.full((n, 1), 0.95), jnp.asarray(cols))
    for cam_j, out_t in zip(env_j._cams, env_t.render()):
        out_j = j_rasterize(*geo, cam_j, JRasterCfg(max_per_tile=256))
        # the float image before the uint8 cast, and the depth (the
        # rasterize tests' tolerances: f32 sums in another order)
        np.testing.assert_allclose(out_t.im.numpy(), np.asarray(out_j.im), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(out_t.depth.numpy(), np.asarray(out_j.depth),
                                   rtol=0, atol=1e-4)
    for a, b in zip(env_t.get_extrinsics(), env_j.get_extrinsics()):
        np.testing.assert_allclose(np.stack(a), np.stack(b), atol=1e-6)
    obs = env_t.get_obs(get_depth=True)
    assert obs["color"].shape == (4, 240, 320, 3) and obs["depth"].dtype == np.uint16
    action = np.array([0.25, -0.02, 0.33, 0.03], np.float32)
    env_t.step(action)
    env_j.step(action)
    np.testing.assert_allclose(env_t.get_state_points(), env_j.get_state_points(),
                               atol=1e-7)


def test_tabletop_points_match_gsdx_on_identical_images():
    pts, cols = _fake_cloud()
    env = FakeEnv(pts, cols, device="cpu")
    obs = env.get_obs(get_depth=True)
    R, t = env.get_extrinsics()
    args = (obs["color"], obs["depth"], env.get_intrinsics(), R, t)
    p_j, c_j = JPerception().get_tabletop_points(*args)
    p_t, c_t = PerceptionModule(segmenter=make_segmenter(),
                                device="cpu").get_tabletop_points(*args)
    assert len(p_j) > 50
    assert p_t.shape == p_j.shape
    # voxel means of the same points, summed in another order
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(c_t, c_j)


def test_point_cloud_filters_match(rng):
    pts = rng.normal(0, 0.05, (700, 3)).astype(np.float32)
    pts[:20] += 0.5  # outliers
    valid = np.ones(1024, bool)
    valid[700:] = False
    pad = np.zeros((1024, 3), np.float32)
    pad[:700] = pts
    d_j, m_j = jpc.voxel_downsample(jnp.asarray(pad), 0.02, 300, valid=jnp.asarray(valid))
    d_t, m_t = tpc.voxel_downsample(torch.as_tensor(pad), 0.02, 300,
                                    valid=torch.as_tensor(valid))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1e-7)
    for std in (1.0, 2.0):
        np.testing.assert_array_equal(
            tpc.statistical_outlier_mask(torch.as_tensor(pts), 10, std).numpy(),
            np.asarray(jpc.statistical_outlier_mask(jnp.asarray(pts), 10, std)))
    np.testing.assert_array_equal(
        tpc.radius_outlier_mask(torch.as_tensor(pts), 5, 0.03).numpy(),
        np.asarray(jpc.radius_outlier_mask(jnp.asarray(pts), 5, 0.03)))
    np.testing.assert_array_equal(tpc.iterative_statistical_outliers(pts, 10),
                                  jpc.iterative_statistical_outliers(pts, 10))


# ---------------------------------------------------------------- CLI


def test_plan_cli_on_the_cpu(tmp_path, monkeypatch):
    """`gsdx_torch.apps.plan` end to end on the simulated environment, with
    a narrow rope model written by the port's checkpoint writer (the
    512-wide model would take minutes on the CPU)."""
    from gsdx_torch.apps import plan
    from gsdx_torch.dynamics.model import flax_params
    from gsdx_torch.io.checkpoint import save_checkpoint
    from gsdx_torch.io.config import load_config

    with open(os.path.join(REPO, "configs", "rope.yaml")) as f:
        text = f.read().replace("nf_particle: 512", "nf_particle: 32").replace(
            "nf_relation: 512", "nf_relation: 32").replace("nf_effect: 512", "nf_effect: 32")
    (tmp_path / "small.yaml").write_text(text)
    monkeypatch.chdir(tmp_path)
    train_cfg, model_cfg, _ = load_config("small.yaml")
    model = DynamicsPredictor(model_cfg, generator=torch.Generator().manual_seed(0))
    save_checkpoint(os.path.join(train_cfg.out_dir, "checkpoints", "latest.ckpt"),
                    flax_params(model))
    plan.main(["--config", "small.yaml", "--device", "cpu", "--env", "fake",
               "--n_actions", "1", "--n_chunks", "1", "--n_sample", "16",
               "--out", "out"])
    res = np.load(tmp_path / "out" / "interaction_0.npz")
    assert res["action"].shape == (4,) and np.isfinite(float(res["reward"]))
    assert (tmp_path / "out" / "stats.txt").read_text().startswith("final chamfer:")
    # a real arm needs the xArm SDK (and then a calibration): refused by name
    with pytest.raises(ImportError, match="xarm"):
        plan.main(["--config", "small.yaml", "--device", "cpu", "--env", "real",
                   "--robot_ip", "10.0.0.1"])


def test_plan_cli_real_env_on_fakes(tmp_path, monkeypatch):
    """`--env real` end to end through the hardware stack's code path:
    capture processes of static views of a red patch on the grey table ->
    ring buffers -> `RealEnv.get_obs` -> perception -> MPPI -> `RealEnv.step`
    on a `FakeArm` (tests/test_plan_real_env.py's scene and tiny model: gsdx's
    `init_params` tree, loaded by the port's reader)."""
    from test_plan_real_env import TINY_CFG, _object_scene_sources

    import gsdx_torch.realworld.cameras as cams
    from gsdx.dynamics.model import DynamicsPredictor as JPredictor
    from gsdx.dynamics.train import init_params
    from gsdx.io.checkpoint import save_checkpoint
    from gsdx.io.config import load_config as j_load_config
    from gsdx_torch.apps import plan

    yaml = pytest.importorskip("yaml")
    cfg = dict(TINY_CFG, train_config=dict(TINY_CFG["train_config"], out_dir=str(tmp_path)))
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    train_cfg, model_cfg, data_cfg = j_load_config(str(tmp_path / "tiny.yaml"))
    save_checkpoint(str(tmp_path / "checkpoints" / "latest.ckpt"),
                    init_params(JPredictor(model_cfg), train_cfg, data_cfg,
                                jax.random.PRNGKey(0)))

    j_sources, R_list, t_list = _object_scene_sources()
    sources = [cams.StaticImageSource(s.color, s.depth) for s in j_sources]
    monkeypatch.setattr(cams, "SyntheticSource",
                        lambda seed=0, **kw: sources[seed % len(sources)])
    steps, envs = [], []
    orig_make = plan.make_real_env

    def patched_make(*a, **kw):
        env = orig_make(*a, **kw)
        env.R_cam2world, env.t_cam2world = list(R_list), list(t_list)
        orig_step = env.step
        env.step = lambda action, decoded=True: (steps.append(np.asarray(action)),
                                                 orig_step(action, decoded))
        envs.append(env)
        return env

    monkeypatch.setattr(plan, "make_real_env", patched_make)
    out = tmp_path / "out"
    plan.main(["--config", str(tmp_path / "tiny.yaml"), "--device", "cpu", "--env", "real",
               "--cameras", "synthetic:2", "--robot_ip", "fake", "--out", str(out),
               "--n_actions", "2", "--n_chunks", "1", "--n_sample", "16", "--seed", "1"])
    assert len(steps) == 2
    assert all(a.shape == (4,) and np.isfinite(a).all() for a in steps)
    for f in ("interaction_0.npz", "interaction_1.npz", "stats.txt"):
        assert (out / f).exists()
    rec = np.load(out / "interaction_0.npz")
    assert np.isfinite(rec["chamfer_before"]) and np.isfinite(rec["state"]).all()
    assert rec["state"].any()  # the patch was perceived
    cams_ = envs[0].cameras.cameras
    assert len(cams_) == 2 and not any(c.is_alive() for c in cams_)  # joined at stop
    # the arm ended back at its initial pose after each push's choreography
    from gsdx_torch.realworld.robot import INIT_POSE

    np.testing.assert_array_equal(envs[0].arm.get_position(), INIT_POSE)
