"""gsdx_torch.dist against gsdx.dist and the port's unsharded functions, on
the CPU.

The port's ranks are gloo processes: worlds of 2 and 3 are spawned (each
rank runs `torch_dist_ranks.run` on the inputs this file writes), a world of
one runs in this process. gsdx runs on the 8-device CPU mesh of
`tests/conftest.py`, on the inputs of `tests/test_dist.py` (the compositor's
grid is 40 x 256 with 8 x 128 tiles: T 10, so that 3 ranks pad it to 12).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_ranks
from gsdx.core.gaussians import init_gaussian_params as j_init_gaussians
from gsdx.core.gaussians import init_tracking_variables as j_init_vars
from gsdx.dist.mesh import get_mesh as j_get_mesh
from gsdx.dist.train_dp import make_dp_train_step as j_make_dp_train_step
from gsdx.dist.train_dp import shard_batch as j_shard_batch
from gsdx.dynamics.model import DynamicsPredictor as JModel
from gsdx.dynamics.train import init_params as j_init_params
from gsdx.graph.dataset import GraphSampler as JSampler
from gsdx.kernels.composite import composite_tiles_xla
from gsdx.kernels.knn import knn as j_knn
from gsdx.plan import cost as jcost
from gsdx.plan.planner import MPPIConfig as JMPPI
from gsdx.plan.planner import Planner as JPlanner
from gsdx.track import losses as jloss
from gsdx.track.optimizer import GroupAdam as JAdam
from gsdx.track.trainer import initialize_per_timestep as j_init_step
from gsdx.track.trainer import initialize_post_first_timestep as j_init_post
from gsdx_torch.dist import get_mesh, initialize_distributed
from gsdx_torch.dist.mesh import batch_sharding, gather_rows, replicated, spawn_ranks
from gsdx_torch.dynamics.model import DynamicsPredictor, ModelConfig, load_flax_params
from gsdx_torch.dynamics.train import TrainConfig, make_train_step
from gsdx_torch.graph.dataset import GraphBatch
from gsdx_torch.kernels.composite import composite_tiles_torch
from gsdx_torch.render.rasterize import _Composite

from test_dynamics import DATA_CFG, MODEL_CFG, TRAIN_CFG, synth_episodes
from torch_batches import port_fields
from test_tracking import CFG_RASTER, H, W, make_cams, make_gt_scene, render_targets

torch.set_num_threads(min(2, torch.get_num_threads()))

GRID = (40, 256, 8, 128)  # height, width, tile_h, tile_w: 2 x 5 tiles
T, K, SUB, N_ACCUM = 10, 128, 64, 4
BATCH_FIELDS = [f.name for f in dataclasses.fields(GraphBatch)]
TRACK_FIELDS = ("means3d", "rgb_colors", "seg_colors", "unnorm_rotations",
                "logit_opacities", "log_scales", "cam_m", "cam_c")
CAM_ANGLES = (0.0, 0.4, -0.4, 0.0)  # make_cams' three, the first again
MPPI = dict(n_sample=64, n_update_iter=3, action_lower_lim=(-0.4, -0.4, -np.pi, 5.0),
            action_upper_lim=(0.4, 0.4, np.pi, 20.0))


def as_numpy(x) -> dict:
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def composite_inputs():
    """Tile features whose splats spread over the whole image, so that a
    row placed at another tile composites other pixels."""
    rng = np.random.default_rng(0)
    f = np.zeros((T, 16, K), np.float32)
    f[:, 0] = rng.uniform(0, GRID[1], (T, K))
    f[:, 1] = rng.uniform(0, GRID[0], (T, K))
    f[:, 2] = rng.uniform(0.01, 0.1, (T, K))
    f[:, 3] = rng.uniform(-0.005, 0.005, (T, K))
    f[:, 4] = rng.uniform(0.01, 0.1, (T, K))
    f[:, 5] = rng.uniform(0.1, 0.9, (T, K))
    f[:, 6:9] = rng.uniform(0, 1, (T, 3, K))
    f[:, 9] = rng.uniform(1, 5, (T, K))  # depth: the presort key
    counts = rng.integers(0, K + 1, T).astype(np.int32)
    counts[3] = 0
    P = GRID[2] * GRID[3]
    return {"feats": f, "counts": counts, "grid": GRID, "sub": SUB,
            "g_accum": rng.normal(size=(T, N_ACCUM, P)).astype(np.float32),
            "g_logt": rng.normal(size=(T, 1, P)).astype(np.float32)}


def dp_inputs():
    """tests/test_dist.py's DP batch (the port's fields, its index lists from
    gsdx's one-hot rows) and init, in numpy."""
    sampler = JSampler(synth_episodes(np.random.default_rng(0)), DATA_CFG, phase="train")
    batch = sampler.sample(jax.random.PRNGKey(2), 8)
    params = j_init_params(JModel(MODEL_CFG), TRAIN_CFG, DATA_CFG, jax.random.PRNGKey(0))
    train = {k: getattr(TRAIN_CFG, k)
             for k in ("batch_size", "n_his", "n_future", "lr", "length_weight")}
    return {"batch": port_fields(batch),
            "params": jax.tree.map(np.asarray, jax.device_get(params)),
            "model": MODEL_CFG._asdict(), "train": train, "rigid_weights": (0.0, 0.05)}


def tracking_states():
    """tests/test_dist.py's tracking scene (n 40, capacity 64, 4 cameras)
    at t=0 and t>0: gsdx's params and variables, the stacked cameras and
    the targets."""
    rng = np.random.default_rng(0)
    pt_cld = make_gt_scene(rng, n=40)
    cams3 = make_cams()
    cams = jax.tree.map(
        lambda x: jnp.concatenate([x, x[:1]]) if hasattr(x, "ndim") else x, cams3)
    ims3, segs3 = render_targets(pt_cld, cams3)
    ims = np.concatenate([ims3, ims3[:1]])
    segs = np.concatenate([segs3, segs3[:1]])
    d, _ = j_knn(jnp.asarray(pt_cld[:, :3]), 3)
    params = j_init_gaussians(pt_cld, np.asarray(d).mean(-1), capacity=64)
    variables = j_init_vars(64, num_knn=4, scene_radius=1.0)
    states = {True: (params, variables)}
    v1 = j_init_post(params, variables, num_knn=4)
    p1, v1, _ = j_init_step(params, v1, JAdam().init(params))
    states[False] = (p1, v1)
    return states, cams, ims, segs


def tracking_inputs():
    states, _, ims, segs = tracking_states()
    k = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
    cameras = []
    for i, ang in enumerate(CAM_ANGLES):
        c, s = np.cos(ang), np.sin(ang)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        cameras.append((k, w2c, i % 3))
    raster = dict(tile_h=CFG_RASTER.tile_h, tile_w=CFG_RASTER.tile_w,
                  max_per_tile=CFG_RASTER.max_per_tile)
    return {"states": {t: (as_numpy(p), as_numpy(v)) for t, (p, v) in states.items()},
            "cameras": cameras, "H": H, "W": W, "ims": np.asarray(ims),
            "segs": np.asarray(segs), "raster": raster, "fields": TRACK_FIELDS}


def planner_problem():
    rng = np.random.default_rng(0)
    cluster = rng.normal(scale=0.03, size=(12, 3)).astype(np.float32)
    target = cluster + np.float32([0.1, 0.0, 0.0])
    bbox = np.float32([[-1.0, 1.0], [-1.0, 1.0], [-1.0, 1.0]])
    init = np.zeros((1, 4), np.float32)
    init[0, 3] = 10.0
    return cluster, target, bbox, init


def planner_inputs():
    """The toy problem and gsdx's draws: one key split an iteration, a
    uniform block at iteration 0 and one normal block a look-ahead step
    after it."""
    cluster, target, bbox, init = planner_problem()
    key, draws, n = jax.random.PRNGKey(5), [], MPPI["n_sample"]
    for i in range(MPPI["n_update_iter"]):
        key, sub = jax.random.split(key)
        if i == 0:
            draws.append(np.array(jax.random.uniform(sub, (n, 1, 4))))
        else:
            draws.append(np.stack([np.array(jax.random.normal(k, (n, 4)))
                                   for k in jax.random.split(sub, 1)]))
    return {"cluster": cluster, "target": target, "bbox": bbox, "init": init,
            "cfg": MPPI, "draws": draws}


@pytest.fixture(scope="module")
def inputs():
    return {"composite": composite_inputs(), "dp": dp_inputs(),
            "tracking": tracking_inputs(), "planner": planner_inputs(),
            "refusal": {"rows": 3, "fields": BATCH_FIELDS}, "mesh": {}}


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """Rank outputs by world size: 1 in this process (the compositor and
    the DP step), 2 (every case) and 3 (the compositor) spawned."""
    cache = {}

    def get(world):
        if world not in cache:
            if world == 1:
                initialize_distributed(device="cpu")
                try:
                    mesh = get_mesh()
                    cache[1] = [{name: torch_dist_ranks.CASES[name](inputs[name], mesh)
                                 for name in ("composite", "dp")}]
                finally:
                    dist.destroy_process_group()
            else:
                d = tmp_path_factory.mktemp(f"world{world}")
                names = list(inputs) if world == 2 else ["composite"]
                torch.save({k: inputs[k] for k in names}, d / "inputs.pt")
                spawn_ranks(torch_dist_ranks.run, world,
                            (str(d / "store"), str(d / "inputs.pt"), str(d)), timeout=300)
                cache[world] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                                for r in range(world)]
        return cache[world]

    return get


def port_composite(feats, counts, presort, tile_ids=None, g=None):
    """The port's compositor (`_Composite` on CPU tensors: the plain
    versions) and, with a cotangent ``g``, the gradient of <out, g>."""
    f = torch.tensor(feats, requires_grad=True)
    geo = dict(tiles_x=2, tiles_y=5, tile_h=GRID[2], tile_w=GRID[3], n_accum=N_ACCUM,
               sub_chunk=SUB)
    ids = None if tile_ids is None else torch.tensor(tile_ids, dtype=torch.int32)
    accum, logt = _Composite.apply(f, torch.tensor(counts), geo, presort, True, ids)
    grad = None
    if g is not None:
        (grad,) = torch.autograd.grad(
            (accum * torch.tensor(g[0])).sum() + (logt * torch.tensor(g[1])).sum(), f)
    return accum.detach(), logt.detach(), grad


def gsdx_composite(feats, counts, presort, tile_ids=None, g=None):
    def fn(f):
        return composite_tiles_xla(
            f, jnp.asarray(counts), tiles_x=2, tile_h=GRID[2], tile_w=GRID[3],
            sub_chunk=SUB, presort=presort,
            tile_ids=None if tile_ids is None else jnp.asarray(tile_ids, jnp.int32))

    (accum, logt), vjp = jax.vjp(fn, jnp.asarray(feats))
    grad = None if g is None else np.asarray(vjp(tuple(jnp.asarray(x) for x in g))[0])
    return np.asarray(accum), np.asarray(logt), grad


def assert_grad_close(got, want, rel):
    """Each feature row within ``rel`` of its largest entry (the conic rows
    grow with dx^2 and would swamp the others under one scale)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max(axis=(0, 2), keepdims=True)
    scale = np.where(scale > 0, scale, 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rel)


@pytest.mark.parametrize("presort", [False, True])
@pytest.mark.parametrize("ids", ["permutation", "shard"])
def test_plain_compositor_with_tile_ids_matches_gsdx(inputs, ids, presort):
    c = inputs["composite"]
    if ids == "permutation":
        rows = np.arange(T)
        tile_ids = np.random.default_rng(1).permutation(T).astype(np.int32)
    else:  # the second rank's rows of a 2-rank world
        rows = np.arange(T // 2, T)
        tile_ids = rows.astype(np.int32)
    feats, counts = c["feats"][rows], c["counts"][rows]
    g = (c["g_accum"][rows], c["g_logt"][rows])
    a_t, l_t, g_t = port_composite(feats, counts, presort, tile_ids, g)
    a_j, l_j, g_j = gsdx_composite(feats, counts, presort, tile_ids, g)
    # f32 sums of <= 128 terms in another order: gsdx's own 1e-5
    np.testing.assert_allclose(a_t.numpy(), a_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(l_t.numpy(), l_j, rtol=0, atol=1e-5)
    # reverse-mode sums over 1024 pixels in another order
    assert_grad_close(g_t, g_j, 1e-5)
    # the placement matters: the identity gives another image
    a_id, _, _ = port_composite(feats, counts, presort)
    assert not torch.allclose(a_id, a_t, atol=1e-3)


def test_compositor_refuses_tile_ids_outside_the_grid(inputs):
    c = inputs["composite"]
    for bad in (np.full(T, 10), np.full(T, -1)):
        with pytest.raises(ValueError, match="tile_ids must lie"):
            port_composite(c["feats"], c["counts"], False, bad)
    with pytest.raises(ValueError, match="tiles_y"):
        composite_tiles_torch(torch.tensor(c["feats"]), torch.tensor(c["counts"]), tiles_x=2,
                              tile_h=8, tile_w=128, tile_ids=torch.zeros(T, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        composite_tiles_torch(torch.tensor(c["feats"]), torch.tensor(c["counts"]), tiles_x=2,
                              tile_h=8, tile_w=128, tiles_y=5,
                              tile_ids=torch.zeros(T, dtype=torch.int64))


@pytest.mark.parametrize("world", [1, 2, 3])
def test_sharded_composite_matches_gsdx_and_unsharded(inputs, worlds, world):
    c = inputs["composite"]
    g = (c["g_accum"], c["g_logt"])
    for binning, presort in (("sort", False), ("nosort", True)):
        a_j, l_j, g_j = gsdx_composite(c["feats"], c["counts"], presort, g=g)
        a_u, l_u, g_u = port_composite(c["feats"], c["counts"], presort, g=g)
        for out in worlds(world):
            accum, logt, grad = out["composite"][binning]
            assert accum.shape == (T, N_ACCUM, GRID[2] * GRID[3]) and logt.shape == (T, 1, 1024)
            np.testing.assert_allclose(accum.numpy(), a_j, rtol=0, atol=1e-5)
            np.testing.assert_allclose(logt.numpy(), l_j, rtol=0, atol=1e-5)
            # the same plain arithmetic on other tile batches: within 1e-6
            np.testing.assert_allclose(accum.numpy(), a_u.numpy(), rtol=0, atol=1e-6)
            np.testing.assert_allclose(logt.numpy(), l_u.numpy(), rtol=0, atol=1e-6)
            # every rank gets the whole gradient of the rows it did not own too
            assert_grad_close(grad, g_u, 1e-6)
            assert_grad_close(grad, g_j, 1e-5)


@pytest.fixture(scope="module")
def dp_references(inputs):
    """gsdx's DP step on the 8-device mesh and the port's single-device
    step, per rigid weight: (loss, params after the step as state dicts)."""
    d = inputs["dp"]
    jb = jds_batch(d["batch"])
    model = JModel(MODEL_CFG)
    mesh = j_get_mesh()
    out = {}
    for rw in d["rigid_weights"]:
        step, tx = j_make_dp_train_step(model, TRAIN_CFG._replace(rigid_weight=rw), mesh)
        params = jax.device_put(d["params"])
        p_j, _, loss_j, _ = step(params, tx.init(params), j_shard_batch(jb, mesh))
        tm = load_flax_params(DynamicsPredictor(ModelConfig(**d["model"])), d["params"])
        single, _, _ = make_train_step(tm, TrainConfig(**d["train"], rigid_weight=rw))
        loss_t, _ = single(GraphBatch(**{k: torch.from_numpy(v)
                                         for k, v in d["batch"].items()}))
        out[rw] = {"gsdx": (float(loss_j), jax.device_get(p_j)),
                   "single": (float(loss_t), tm.state_dict())}
    return out


def jds_batch(fields):
    from gsdx.graph.dataset import GraphBatch as JBatch

    return JBatch(**{f.name: jnp.asarray(fields[f.name]) for f in dataclasses.fields(JBatch)})


@pytest.mark.parametrize("rigid_weight", [0.0, 0.05])
@pytest.mark.parametrize("world", [1, 2])
def test_dp_step_matches_gsdx_and_the_single_step(inputs, worlds, dp_references, world,
                                                  rigid_weight):
    from gsdx_torch.dynamics.model import params_from_flax

    ref = dp_references[rigid_weight]
    want_j = params_from_flax(ref["gsdx"][1])
    for out in worlds(world):
        loss, parts, params = out["dp"][rigid_weight]
        if rigid_weight:
            assert float(parts["rigid"]) > 0
        got = params_from_flax(params)
        for name, loss_ref, want in (("gsdx", ref["gsdx"][0], want_j),
                                     ("single", ref["single"][0], ref["single"][1])):
            # f32 means over the batch, summed in halves: 1e-5
            np.testing.assert_allclose(float(loss), loss_ref, rtol=1e-5, err_msg=name)
            for k, v in want.items():
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5,
                                           err_msg=f"{name} {k}")


def port_tracking_mean(case, initial):
    """The mean over cameras of the port's single-camera `tracking_loss`
    and its gradient, in this process."""
    from gsdx_torch.core.cameras import make_camera
    from gsdx_torch.core.gaussians import params_from_numpy, variables_from_numpy
    from gsdx_torch.render.rasterize import RasterizeConfig
    from gsdx_torch.track.losses import LossWeights, tracking_loss

    params, variables = case["states"][initial]
    p = params_from_numpy(params)
    leaves = {f: getattr(p, f).requires_grad_(True) for f in TRACK_FIELDS}
    m2d = torch.zeros(p.capacity, 2, requires_grad=True)
    total = 0.0
    for i, (k, w2c, cid) in enumerate(case["cameras"]):
        cam = make_camera(k, w2c, width=W, height=H, bg=(0, 0, 0), cam_id=cid)
        loss, _ = tracking_loss(p, m2d, cam, torch.tensor(case["ims"][i]),
                                torch.tensor(case["segs"][i]), variables_from_numpy(variables),
                                LossWeights(), initial, RasterizeConfig(**case["raster"]))
        total = total + loss
    n = len(case["cameras"])
    grads = torch.autograd.grad(total, [*leaves.values(), m2d])
    return float(total.detach()) / n, {f: g / n for f, g in zip(leaves, grads[:-1])}, grads[-1] / n


@pytest.mark.parametrize("initial", [True, False])
def test_sharded_tracking_matches_gsdx_mean_over_cameras(inputs, worlds, initial):
    """2 ranks x 2 cameras against the mean of gsdx's per-camera
    `tracking_loss` value and gradient, and of the port's."""
    loss_u, grads_u, g_m2d_u = port_tracking_mean(inputs["tracking"], initial)
    for out in worlds(2):
        loss, grads, g_m2d = out["tracking"][initial]
        # the same arithmetic, summed over the cameras in another order
        np.testing.assert_allclose(float(loss), loss_u, rtol=1e-6)
        for f in TRACK_FIELDS:
            np.testing.assert_allclose(grads[f].numpy(), grads_u[f].numpy(), rtol=0,
                                       atol=2e-5, err_msg=f)
        np.testing.assert_allclose(g_m2d.numpy(), g_m2d_u.numpy(), rtol=0, atol=2e-5)

    states, cams, ims, segs = tracking_states()
    params, variables = states[initial]
    weights = jloss.LossWeights()

    def lf(p, m, cam, im, seg):
        loss, _ = jloss.tracking_loss(p, m, cam, im, seg, variables, weights, initial,
                                      CFG_RASTER)
        return loss

    vg = jax.jit(jax.value_and_grad(lf, argnums=(0, 1)))
    losses, g_p, g_m = [], [], []
    for ci in range(len(CAM_ANGLES)):
        cam = jax.tree.map(lambda x: x[ci] if hasattr(x, "ndim") and x.ndim > 0 else x, cams)
        loss, (gp, gm) = vg(params, jnp.zeros((64, 2)), cam, ims[ci], segs[ci])
        losses.append(float(loss))
        g_p.append(as_numpy(gp))
        g_m.append(np.asarray(gm))
    for out in worlds(2):
        loss, grads, g_m2d = out["tracking"][initial]
        # a mean of f32 image losses in another order: 1e-5
        np.testing.assert_allclose(float(loss), np.mean(losses), rtol=1e-5)
        # the compositor's and SSIM's reverse sums over 2048 pixels in
        # another order than gsdx's: 2e-5, and 1e-5 of an entry as large as
        # the colour correction's (~15)
        for f in TRACK_FIELDS:
            want = np.mean([g[f] for g in g_p], axis=0)
            np.testing.assert_allclose(grads[f].numpy(), want, rtol=1e-5, atol=2e-5,
                                       err_msg=f)
        np.testing.assert_allclose(g_m2d.numpy(), np.mean(g_m, axis=0), rtol=1e-5, atol=2e-5)


def test_sample_sharded_mppi_matches_gsdx(inputs, worlds):
    from gsdx.plan.actions import decode_action

    cluster, target, bbox, init = planner_problem()

    def toy_rollout(state_cur, act_seqs):
        decoded, repeats = decode_action(act_seqs, 0.01)
        unit = jnp.stack([decoded[:, :, 2] - decoded[:, :, 0],
                          decoded[:, :, 3] - decoded[:, :, 1],
                          jnp.zeros_like(decoded[:, :, 0])], axis=-1)
        move = unit * repeats[..., None].astype(jnp.float32)
        return {"state_seqs": state_cur[None, None] + move[:, :, None, :],
                "action_seqs": decoded}

    def evaluate(state_seqs, action_seqs, state_cur):
        return jcost.running_cost(state_seqs, action_seqs, state_cur, jnp.asarray(target),
                                  jnp.asarray(bbox))

    planner = JPlanner(JMPPI(**MPPI), toy_rollout, evaluate, mesh=j_get_mesh())
    ref = planner.trajectory_optimization(jax.random.PRNGKey(5), jnp.asarray(cluster),
                                          jnp.asarray(init))
    for act_seq, best_reward in (out["planner"] for out in worlds(2)):
        np.testing.assert_allclose(act_seq.numpy(), np.asarray(ref["act_seq"]), atol=1e-5)
        np.testing.assert_allclose(float(best_reward), float(ref["best_reward"]), rtol=1e-5)


def test_sizes_that_do_not_divide_are_refused(worlds):
    for out in worlds(2):
        assert "3 rows do not divide over the 2 ranks" in out["refusal"]["shard_batch"]
        assert "3 rows do not divide over the 2 ranks" in out["refusal"]["cameras"]


def test_mesh_axes_and_subsets_over_two_ranks(worlds):
    both = torch.tensor([[0.0, 0.0], [1.0, 1.0]])
    for rank, out in enumerate(worlds(2)):
        row = torch.full((1, 2), float(rank))
        tile = out["mesh"][(("data", 1), ("tile", 2))]
        assert tile["shape"] == {"data": 1, "tile": 2}
        assert tile["index"] == {"data": 0, "tile": rank}
        assert torch.equal(tile["gathered"]["tile"], both)
        assert torch.equal(tile["gathered"]["data"], row)
        data = out["mesh"][(("data", 2), ("tile", 1))]
        assert data["shape"] == {"data": 2, "tile": 1}
        assert data["index"] == {"data": rank, "tile": 0}
        assert torch.equal(data["gathered"]["data"], both)
        assert torch.equal(data["gathered"]["tile"], row)
        sub = out["mesh"]["subset"]
        if rank == 0:
            assert sub is None
        else:
            assert sub["ranks"] == (1,) and sub["shape"] == {"data": 1}
            assert torch.equal(sub["replicated"], torch.ones(2))


def test_mesh_helpers_in_a_world_of_one():
    initialize_distributed(device="cpu")
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            initialize_distributed(device="cpu")
        mesh = get_mesh()
        assert mesh.shape == {"data": 1} and mesh.axis_index("data") == 0
        grid = get_mesh([("data", 1), ("tile", 1)])
        assert grid.shape == {"data": 1, "tile": 1} and grid.axis_index("tile") == 0
        with pytest.raises(AssertionError, match="mesh"):
            get_mesh([("data", 2)])
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(batch_sharding(x, mesh), x)
        assert torch.equal(gather_rows(x, mesh), x)
        assert torch.equal(replicated(x.clone(), mesh), x)
    finally:
        dist.destroy_process_group()
