"""What each rank of `tests/test_torch_dist.py`'s gloo worlds runs.

A rank process starts fresh (spawn), so this module imports only torch and
gsdx_torch: the inputs arrive as a file the test wrote (numpy arrays and
plain values), and each rank writes what it computed to
``<out_dir>/rank<r>.pt`` for the test to hold against gsdx and the port's
unsharded functions.
"""

import torch
import torch.distributed as dist


def run(rank: int, world: int, store: str, inputs_path: str, out_dir: str) -> None:
    from gsdx_torch.dist import get_mesh, initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"file://{store}", world, rank, device="cpu")
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        mesh = get_mesh()
        out = {name: CASES[name](case, mesh) for name, case in inputs.items()}
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def composite_case(case, mesh):
    """sharded_composite forward and the gradient of <out, cotangent>,
    without and with the compositor's depth sort."""
    from gsdx_torch.dist import sharded_composite
    from gsdx_torch.render.binning import TileGrid
    from gsdx_torch.render.rasterize import RasterizeConfig

    grid = TileGrid(*case["grid"])
    out = {}
    for binning in ("sort", "nosort"):
        feats = torch.tensor(case["feats"], requires_grad=True)
        accum, logt = sharded_composite(
            feats, torch.tensor(case["counts"]), grid,
            RasterizeConfig(tile_h=grid.tile_h, sub_chunk=case["sub"], binning=binning),
            mesh)
        loss = ((accum * torch.tensor(case["g_accum"])).sum()
                + (logt * torch.tensor(case["g_logt"])).sum())
        (grad,) = torch.autograd.grad(loss, feats)
        out[binning] = (accum.detach(), logt.detach(), grad)
    return out


def dp_case(case, mesh):
    """One data-parallel step per rigid weight from the given weights and
    global batch: (loss, parts, the weights after the step)."""
    from gsdx_torch.dist import make_dp_train_step, shard_batch
    from gsdx_torch.dynamics.model import (DynamicsPredictor, ModelConfig, flax_params,
                                           load_flax_params)
    from gsdx_torch.dynamics.train import TrainConfig
    from gsdx_torch.graph.dataset import GraphBatch

    batch = GraphBatch(**{k: torch.from_numpy(v) for k, v in case["batch"].items()})
    out = {}
    for rigid_weight in case["rigid_weights"]:
        model = load_flax_params(DynamicsPredictor(ModelConfig(**case["model"])),
                                 case["params"])
        step, _ = make_dp_train_step(
            model, TrainConfig(**case["train"], rigid_weight=rigid_weight), mesh)
        loss, parts = step(shard_batch(batch, mesh))
        out[rigid_weight] = (loss, parts, flax_params(model))
    return out


def tracking_case(case, mesh):
    """make_sharded_tracking_step's loss and gradients at t=0 and t>0."""
    from gsdx_torch.core.cameras import make_camera, stack_cameras
    from gsdx_torch.core.gaussians import params_from_numpy, variables_from_numpy
    from gsdx_torch.dist import make_sharded_tracking_step
    from gsdx_torch.render.rasterize import RasterizeConfig
    from gsdx_torch.track.losses import LossWeights

    cams = stack_cameras([make_camera(k, w2c, width=case["W"], height=case["H"],
                                      bg=(0, 0, 0), cam_id=cid)
                          for k, w2c, cid in case["cameras"]])
    ims, segs = torch.tensor(case["ims"]), torch.tensor(case["segs"])
    cfg = RasterizeConfig(**case["raster"])
    out = {}
    for initial, (params, variables) in case["states"].items():
        step = make_sharded_tracking_step(cfg, mesh, LossWeights(), is_initial=initial)
        p = params_from_numpy(params)
        loss, (g_params, g_m2d) = step(p, torch.zeros(p.capacity, 2), cams, ims, segs,
                                       variables_from_numpy(variables))
        out[initial] = (loss, {f: getattr(g_params, f) for f in case["fields"]}, g_m2d)
    return out


def planner_case(case, mesh):
    """Sample-sharded MPPI on gsdx's toy problem with gsdx's draws."""
    from gsdx_torch.plan.actions import decode_action
    from gsdx_torch.plan.cost import running_cost
    from gsdx_torch.plan.planner import MPPIConfig, Planner

    target = torch.tensor(case["target"])
    bbox = torch.tensor(case["bbox"])

    def toy_rollout(state_cur, act_seqs, needs_grad=False):
        decoded, repeats = decode_action(act_seqs, 0.01)
        unit = torch.stack([decoded[:, :, 2] - decoded[:, :, 0],
                            decoded[:, :, 3] - decoded[:, :, 1],
                            torch.zeros_like(decoded[:, :, 0])], -1)
        move = unit * repeats[..., None].to(torch.float32)
        return {"state_seqs": state_cur[None, None] + move[:, :, None, :],
                "action_seqs": decoded}

    def evaluate(state_seqs, action_seqs, state_cur):
        return running_cost(state_seqs, action_seqs, state_cur, target, bbox)

    planner = Planner(MPPIConfig(**case["cfg"]), toy_rollout, evaluate, device="cpu",
                      mesh=mesh)
    res = planner.trajectory_optimization(
        None, torch.tensor(case["cluster"]), torch.tensor(case["init"]),
        draws=[torch.tensor(d) for d in case["draws"]])
    return res["act_seq"], res["best_reward"]


def refusal_case(case, mesh):
    """The sizes that do not divide over the ranks: (what, message) of each
    refusal."""
    from gsdx_torch.dist import make_sharded_tracking_step, shard_batch
    from gsdx_torch.graph.dataset import GraphBatch
    from gsdx_torch.render.rasterize import RasterizeConfig
    from gsdx_torch.track.losses import LossWeights

    n = case["rows"]
    batch = GraphBatch(**{k: torch.zeros(n, 1) for k in case["fields"]})
    step = make_sharded_tracking_step(RasterizeConfig(), mesh, LossWeights(), True)
    out = {}
    for what, fn in (("shard_batch", lambda: shard_batch(batch, mesh)),
                     ("cameras", lambda: step(None, None, None, torch.zeros(n, 3, 2, 2),
                                              None, None))):
        try:
            fn()
        except ValueError as e:
            out[what] = str(e)
    return out


def mesh_case(case, mesh):
    """Meshes of two named axes (each way round) and of a subset of the
    ranks: each axis's shape, this rank's coordinates, each axis's gather of
    a row holding the rank, and a broadcast within the subset."""
    from gsdx_torch.dist import get_mesh
    from gsdx_torch.dist.mesh import gather_rows, replicated

    rank, world = dist.get_rank(), dist.get_world_size()
    row = torch.full((1, 2), float(rank))
    out = {}
    for axes in ((("data", 1), ("tile", world)), (("data", world), ("tile", 1))):
        m = get_mesh(list(axes))
        out[axes] = {"shape": m.shape, "index": {a: m.axis_index(a) for a in m.names},
                     "gathered": {a: gather_rows(row, m, a) for a in m.names}}
    sub = get_mesh(ranks=[world - 1])
    out["subset"] = None if sub is None else {
        "ranks": sub.ranks, "shape": sub.shape,
        "replicated": replicated(torch.full((2,), float(rank)), sub)}
    return out


CASES = {"composite": composite_case, "dp": dp_case, "tracking": tracking_case,
         "planner": planner_case, "refusal": refusal_case, "mesh": mesh_case}
