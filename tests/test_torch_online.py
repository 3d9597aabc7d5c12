"""gsdx_torch.track.online (the online Gaussian trainer) against gsdx's on
the CPU: `rt_to_w2c`, `update_state` and `init_params`, a 20-iteration
`train` at 3 cameras x 32x64 px (rgb and segmentation fused), and
`rollout_and_render` with the 32-wide demo model's gsdx weights carried
across: trajectories, re-rendered frames and the overwritten scene.

The scene is a 300-point rope seen by the simulated environment's camera
ring; both packages get the same numpy images.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdx.dynamics.model import DynamicsPredictor as JModel
from gsdx.dynamics.model import ModelConfig as JModelConfig
from gsdx.dynamics.train import TrainConfig as JTrainConfig
from gsdx.dynamics.train import init_params as j_init_params
from gsdx.graph.dataset import GraphDatasetConfig as JDataConfig
from gsdx.render.rasterize import RasterizeConfig as JCfg
from gsdx.rollout.dynamics_module import DynamicsModule as JDynamicsModule
from gsdx.rollout.dynamics_module import RolloutConfig as JRolloutConfig
from gsdx.track import online as jon
from gsdx.track.optimizer import tracking_lrs as j_lrs
from gsdx_torch.core.gaussians import params_from_numpy
from gsdx_torch.dynamics.model import DynamicsPredictor, ModelConfig, load_flax_params
from gsdx_torch.realworld.env import FakeEnv, FakeEnvConfig
from gsdx_torch.render.rasterize import RasterizeConfig as TCfg
from gsdx_torch.rollout.dynamics_module import DynamicsModule, RolloutConfig
from gsdx_torch.track import online as ton

from test_torch_fit import _compare_fit
from test_torch_track import np_tree

torch.set_num_threads(min(2, torch.get_num_threads()))

H, W = 32, 64
CFG_J = JCfg(tile_h=8, tile_w=128, max_per_tile=512, backend="xla")
CFG_T = TCfg(tile_h=8, tile_w=128, max_per_tile=512)
# the demo apps' 32-wide test model (gsdx's tests/test_demo_e2e.py TINY_CFG)
MODEL = dict(nf_particle=32, nf_relation=32, nf_effect=32, n_his=2)
DATA = dict(n_his=2, n_future=2, max_nobj=24, max_nR=96, topk=3)
ROLLOUT = dict(n_his=2, dist_thresh=0.005, max_nobj=24, fps_radius=0.03,
               adj_thresh=0.08, topk=3, connect_all=False, max_nR=96)


def rope(seed=0, n=300):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    pts = np.stack([0.25 + 0.25 * t, 0.05 + 0.1 * np.sin(4 * t),
                    np.full_like(t, 0.01)], 1).astype(np.float32)
    pts += rng.normal(scale=0.004, size=pts.shape).astype(np.float32)
    cols = np.stack([0.8 + 0 * t, 0.3 + 0.4 * t, 0.2 + 0 * t], 1).astype(np.float32)
    return pts, cols


def slab(seed=0, n=300):
    """A 12 x 10 x 4 cm block: every bone's neighbours span 3D, so each
    bone's Kabsch rotation is unique (on a rope's nearly colinear
    neighbours it is not, and LAPACK's SVDs may pick others)."""
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(-1, 1, (n, 3)) * [0.06, 0.05, 0.02] + [0.31, 0.05, 0.02])
    cols = rng.uniform(0.2, 0.9, (n, 3))
    return pts.astype(np.float32), cols.astype(np.float32)


def observation(scene=rope, n_cameras=3, width=W, height=H):
    """(points, colours, images, masks, R_list, t_list, intrinsics) of a
    scene as the port's simulated environment renders it."""
    pts, cols = scene()
    env = FakeEnv(pts, cols, FakeEnvConfig(n_cameras=n_cameras, width=width,
                                           height=height), device="cpu")
    color = env.get_obs()["color"]
    masks = [(np.abs(c.astype(np.float32) - 255 * 0.7).max(-1) > 30).astype(np.float32)
             for c in color]
    imgs = [c.astype(np.float32) / 255.0 * m[..., None] for c, m in zip(color, masks)]
    R, t = env.get_extrinsics()
    return pts, cols, imgs, masks, R, t, env.get_intrinsics()


def trainers(num_iters=20, scene=rope):
    obs = observation(scene)
    tr_j = jon.OnlineGSTrainer(jon.OnlineGSConfig(num_iters=num_iters), CFG_J)
    tr_t = ton.OnlineGSTrainer(ton.OnlineGSConfig(num_iters=num_iters), CFG_T,
                               device="cpu")
    tr_j.update_state(*obs)
    tr_t.update_state(*obs)
    return tr_j, tr_t


def test_rt_to_w2c_matches(rng):
    for _ in range(4):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        t = rng.normal(size=3)
        out = ton.rt_to_w2c(R, t)
        assert out.dtype == np.float32
        # the same numpy inverse: equal
        np.testing.assert_array_equal(out, jon.rt_to_w2c(R, t))
        np.testing.assert_allclose(out[:3, :3], R.T, atol=1e-6)


def test_update_state_and_init_params_match_gsdx():
    tr_j, tr_t = trainers()
    np.testing.assert_array_equal(tr_t.init_pt_cld, tr_j.init_pt_cld)
    np.testing.assert_array_equal(tr_t.ims.numpy(), np.asarray(tr_j.ims))
    np.testing.assert_array_equal(tr_t.segs.numpy(), np.asarray(tr_j.segs))
    for f in ("w2c", "fx", "fy", "cx", "cy", "bg", "cam_id"):
        np.testing.assert_array_equal(getattr(tr_t.cams, f).numpy(),
                                      np.asarray(getattr(tr_j.cams, f)), err_msg=f)
    assert (tr_t.cams.width, tr_t.cams.height) == (W, H)
    for a, b in zip(tr_t.metadata["w2c"], tr_j.metadata["w2c"]):
        np.testing.assert_array_equal(a, b)
    p_j, p_t = tr_j.init_params(), tr_t.init_params()
    assert p_t.capacity == p_j.capacity == 1280
    for f in ("means3d", "rgb_colors", "seg_colors", "unnorm_rotations",
              "logit_opacities", "live"):
        np.testing.assert_array_equal(getattr(p_t, f).numpy(),
                                      np.asarray(getattr(p_j, f)), err_msg=f)
    # log sqrt of the mean 3-NN squared distance, each |r|^2 - 2 r.p + |p|^2
    # in f32 with the product summed in another order: the squared
    # distances within 4 ulps of the largest |p|^2
    n = len(tr_j.init_pt_cld)
    ulp = np.spacing(np.float32((tr_j.init_pt_cld[:, :3] ** 2).sum(1).max()))
    np.testing.assert_allclose(np.exp(2 * p_t.log_scales.numpy()[:n]),
                               np.exp(2 * np.asarray(p_j.log_scales)[:n]),
                               rtol=0, atol=4 * ulp)
    np.testing.assert_array_equal(p_t.log_scales.numpy()[n:],
                                  np.asarray(p_j.log_scales)[n:])


def test_train_matches_gsdx(rng):
    """20 iterations of the online fit (below densification's first step at
    500, so no split noise is drawn), under tests/test_torch_fit.py's
    tolerances."""
    tr_j, tr_t = trainers(num_iters=20)
    # Both start from gsdx's Gaussians of the cloud (see the test above),
    # moved off the isotropic start: an isotropic Gaussian's rotation has
    # no derivative, so its gradient's sign is f32 rounding noise, which
    # Adam's first steps turn into full learning-rate steps either way.
    jp = tr_j.init_params()
    p0 = {f.name: np.array(getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    n = len(tr_j.init_pt_cld)
    p0["log_scales"][:n] += rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    p0["unnorm_rotations"][:n] = rng.normal(size=(n, 4)).astype(np.float32)
    start_from(tr_j, {k: jnp.asarray(v) for k, v in p0.items()}, jtypes=True)
    start_from(tr_t, p0)
    logs_j = tr_j.train()
    logs_t = tr_t.train()
    assert logs_t["psnr"][-1] > logs_t["psnr"][0]
    w2c = np.stack(tr_j.metadata["w2c"])
    centers = np.linalg.inv(w2c)[:, :3, 3]
    radius = float(1.1 * np.max(np.linalg.norm(centers - centers.mean(0), axis=-1)))
    assert radius > 0.5  # the ring's cameras are apart: every field moves
    assert tr_t.params.capacity == tr_j.params.capacity  # compacted alike
    _compare_fit(logs_j, logs_t, tr_j.params, tr_t.params, 20, j_lrs(radius))


def start_from(trainer, tree, jtypes=False):
    """Make ``trainer.train`` start from the Gaussians ``tree``."""
    from gsdx.core.gaussians import GaussianParams as JParams

    def init_params():
        trainer.params = JParams(**tree) if jtypes else params_from_numpy(tree)
        return trainer.params

    trainer.init_params = init_params


@pytest.fixture(scope="module")
def rolled():
    """Both trainers rolled under the same 1.6 cm push (two moving steps)
    from the same unfitted block, with the same random-init 32-wide GNN.
    The random model moves the block by metres a step; after a few steps
    it has flattened the block, and the bones' Kabsch fits turn rank-
    deficient, where the two packages' SVDs may pick other rotations."""
    tr_j, tr_t = trainers(scene=slab)
    tr_j.init_params()
    tr_t.params = params_from_numpy(np_tree(tr_j.params))
    jparams = j_init_params(JModel(JModelConfig(**MODEL)), JTrainConfig(n_his=2),
                            JDataConfig(**DATA), jax.random.PRNGKey(0))
    model = load_flax_params(DynamicsPredictor(ModelConfig(**MODEL)),
                             jax.device_get(jparams)).eval()
    dm_j = JDynamicsModule(JModelConfig(**MODEL), jparams, JRolloutConfig(**ROLLOUT))
    dm_t = DynamicsModule(model, RolloutConfig(**ROLLOUT))
    live = np.asarray(tr_j.params.live) > 0
    center = np.asarray(tr_j.params.means3d)[live].mean(0)
    action = np.stack([center + [-0.008, 0, 0], center + [0.008, 0, 0]]).astype(np.float32)
    out_j = tr_j.rollout_and_render(dm_j, action)
    out_t = tr_t.rollout_and_render(dm_t, action)
    return tr_j, tr_t, out_j, out_t


# f32 3x3 SVDs of bone covariances under metre-scale motions: the
# quaternions within 1e-4; every position within 1e-5 m
QUAT_TOL = 1e-4


def test_rollout_and_render_matches_gsdx(rolled):
    tr_j, tr_t, (rv_j, vis_j), (rv_t, vis_t) = rolled
    assert len(rv_t) == len(rv_j) == 3 + 2  # 3 path points, n_his holds
    assert np.abs(rv_t[-1]["means3D"] - rv_t[0]["means3D"]).max() > 1e-2  # it moved
    for a, b in zip(rv_t + vis_t, rv_j + vis_j):
        assert a.keys() == b.keys()
        for key in b:
            np.testing.assert_allclose(a[key], np.asarray(b[key]), rtol=0,
                                       atol=QUAT_TOL if key == "rotations" else 1e-5,
                                       err_msg=key)
    # re-rendered frames (rgb only, black background) of every step from
    # two cameras: 1e-4
    assert float(tr_t.render(rv_t[0], 0, bg=(0, 0, 0))[0].max()) > 0.1  # in view
    for t in range(len(rv_t)):
        for cam in (0, 2):
            im_t, depth_t = tr_t.render(rv_t[t], cam, bg=(0, 0, 0))
            im_j, depth_j = tr_j.render(rv_j[t], cam, bg=(0, 0, 0))
            assert im_t.shape == (3, H, W) and not im_t.requires_grad
            np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j), rtol=0, atol=1e-4)
            np.testing.assert_allclose(depth_t.numpy(), np.asarray(depth_j), rtol=0,
                                       atol=1e-4)


def test_overwrite_params_matches_gsdx(rolled):
    """After the rollout the scene is the last step's Gaussians: positions,
    rotations, opacities and scales of the live rows, gsdx's clamps kept."""
    tr_j, tr_t, (rv_j, _), _ = rolled
    p_j, p_t = tr_j.params, tr_t.params
    n = len(rv_j[-1]["means3D"])
    assert p_t.capacity == p_j.capacity and int(p_t.live.sum()) == n
    for f in ("means3d", "rgb_colors", "seg_colors", "unnorm_rotations",
              "logit_opacities", "log_scales", "live", "cam_m", "cam_c"):
        np.testing.assert_allclose(
            getattr(p_t, f).numpy(), np.asarray(getattr(p_j, f)), rtol=0,
            atol=QUAT_TOL if f == "unnorm_rotations" else 1e-5, err_msg=f)


def test_rollout_and_render_needs_a_scene():
    tr = ton.OnlineGSTrainer(device="cpu")
    with pytest.raises(RuntimeError, match="train"):
        tr.rollout_and_render(None, np.zeros((2, 3)))
    if not torch.cuda.is_available():  # the trainer defaults to the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ton.OnlineGSTrainer()
