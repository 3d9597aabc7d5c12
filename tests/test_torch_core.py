"""gsdx_torch.core against gsdx.core, and the port's isolation from JAX.

Inputs come from a seeded numpy RNG and go through both packages; JAX runs
on the CPU, the port with device="cpu".
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdx.core import cameras as jcam
from gsdx.core import gaussians as jgs
from gsdx.core import transforms as jtf
from gsdx.track.optimizer import GroupAdam as JGroupAdam
from gsdx_torch.core import cameras as tcam
from gsdx_torch.core import gaussians as tgs
from gsdx_torch.core import transforms as ttf
from gsdx_torch.core.device import require_device
from gsdx_torch.track.optimizer import AdamState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quats(rng, n=64):
    return rng.normal(size=(n, 4)).astype(np.float32)


@pytest.mark.parametrize("name", ["quat_normalize", "quat_conjugate",
                                  "quat_to_rotmat"])
def test_unary_quat_ops_match(rng, name):
    # f32 elementwise arithmetic in the same order: a few ulp
    q = _quats(rng)
    got = getattr(ttf, name)(torch.as_tensor(q)).numpy()
    want = np.asarray(getattr(jtf, name)(jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_quat_multiply_and_rotmat_to_quat_match(rng):
    q1, q2 = _quats(rng), _quats(rng)
    got = ttf.quat_multiply(torch.as_tensor(q1), torch.as_tensor(q2)).numpy()
    want = np.asarray(jtf.quat_multiply(jnp.asarray(q1), jnp.asarray(q2)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    rot = np.asarray(jtf.quat_to_rotmat(jnp.asarray(q1)))
    got = ttf.rotmat_to_quat(torch.as_tensor(rot)).numpy()
    want = np.asarray(jtf.rotmat_to_quat(jnp.asarray(rot)))
    # sqrt of a sum of 3x3 entries: a few ulp of 1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_make_camera_and_stacking_match():
    k = np.array([[70.0, 0, 80.0], [0, 65.0, 12.0], [0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.1, -0.2, 0.3]
    jc = jcam.make_camera(k, w2c, width=160, height=24, bg=(0.1, 0.2, 0.3),
                          cam_id=2)
    tc = tcam.make_camera(k, w2c, width=160, height=24, bg=(0.1, 0.2, 0.3),
                          cam_id=2)
    for f in ("w2c", "fx", "fy", "cx", "cy", "bg", "cam_id", "tan_fovx",
              "tan_fovy", "cam_center"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    assert (tc.width, tc.height, tc.near, tc.far) == (
        jc.width, jc.height, jc.near, jc.far)
    other = tcam.make_camera(k * 2, w2c, width=160, height=24, cam_id=5)
    stack = tcam.stack_cameras([tc, other])
    assert len(stack) == 2 and stack.w2c.shape == (2, 4, 4)
    assert float(stack[1].fx) == float(other.fx) and int(stack[1].cam_id) == 5


def test_init_params_and_carry_across_round_trip(rng):
    pts = np.concatenate([rng.uniform(-1, 1, (40, 3)), rng.uniform(0, 1, (40, 3)),
                          (rng.uniform(size=(40, 1)) > 0.5)], 1).astype(np.float32)
    sq = rng.uniform(1e-4, 1e-2, 40).astype(np.float32)
    jp = jgs.init_gaussian_params(pts, sq, capacity=128)
    tp = tgs.init_gaussian_params(pts, sq, capacity=128)
    jp_np = jax.tree.map(np.asarray, jp)
    for f in dataclasses.fields(tgs.GaussianParams):
        np.testing.assert_array_equal(getattr(tp, f.name).numpy(),
                                      getattr(jp_np, f.name), err_msg=f.name)

    # gsdx state -> port -> numpy is exact, for params, variables and Adam
    carried = tgs.params_from_numpy(jp_np)
    for k, v in tgs.to_numpy(carried).items():
        np.testing.assert_array_equal(v, getattr(jp_np, k), err_msg=k)
    jv = jgs.init_tracking_variables(128, 8, 1.5)
    jv = jv.replace(neighbor_indices=jnp.asarray(
        rng.integers(0, 128, (128, 8)), jnp.int32),
        prev_offset=jnp.asarray(rng.normal(size=(128, 8, 3)), jnp.float32))
    jv_np = jax.tree.map(np.asarray, jv)
    tv = tgs.variables_from_numpy(jv_np)
    assert tv.neighbor_indices.dtype == torch.long
    for k, v in tgs.to_numpy(tv).items():
        np.testing.assert_array_equal(v, getattr(jv_np, k), err_msg=k)
    js = JGroupAdam().init(jp)
    js = js.replace(count=jnp.asarray(7, jnp.int32),
                    mu=js.mu.replace(means3d=jnp.asarray(
                        rng.normal(size=(128, 3)), jnp.float32)))
    ts = AdamState.from_numpy(jax.tree.map(np.asarray, js))
    back = tgs.to_numpy(ts)
    assert int(back["count"]) == 7
    np.testing.assert_array_equal(back["mu"]["means3d"], np.asarray(js.mu.means3d))


def test_cuda_entry_points_refuse_without_a_card():
    from gsdx_torch.apps.plan import main as plan_main
    from gsdx_torch.apps.track import main as track_main
    from gsdx_torch.plan.planner import MPPIConfig, Planner
    from gsdx_torch.realworld.env import FakeEnv
    from gsdx_torch.realworld.perception import PerceptionModule
    from gsdx_torch.render.renderer import Renderer
    from gsdx_torch.track.trainer import track_sequence

    assert require_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert require_device("cuda").type == "cuda"
        return
    # the entry points default to the card and never fall back to the CPU
    for call in (lambda: require_device("cuda"), Renderer,
                 lambda: track_sequence(None, None, None, None, 1),
                 lambda: track_main(["--sequence", "s", "--exp_name", "e"]),
                 lambda: plan_main(["--config", "configs/rope.yaml"]),
                 lambda: FakeEnv(np.zeros((4, 3)), np.zeros((4, 3))),
                 PerceptionModule,
                 lambda: Planner(MPPIConfig(), None, None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_flax_or_gsdx():
    """Nor PyYAML or msgpack, which the machine with the card lacks: the
    port reads its configs and checkpoints with its own code."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for top in ("gsdx_torch", "tools"):
        for root, _, names in os.walk(os.path.join(REPO, top)):
            files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "gsdx", "yaml", "msgpack"):
                bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert not bad, bad
