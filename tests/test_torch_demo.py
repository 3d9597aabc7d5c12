"""The demo apps of gsdx_torch (apps/demo.py `DemoSession`, apps/sim_real_app.py
`SimRealSession`, apps/sim_real.py) against gsdx's, piece by piece, on the
CPU at 80x60 px: perception and the online fit (`reset`), the demo-asset
bundle and its offline reload, the clicked push's rollout and frames
(`run_sim`), `run_real`, `switch_view`, `export_splat`; then the three CLIs
end to end with `--device cpu`.

Both packages' sessions get the same observations (each its own copy of
the port's simulated environment) and the same 32-wide GNN: gsdx's random
initialisation, written as the checkpoint both load. The object is a
block, whose bones' Kabsch fits stay unique (see test_torch_online.py).
"""

import os
import re

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gsdx.apps.demo import DemoSession as JDemoSession
from gsdx.apps.demo import click_to_xyz as j_click_to_xyz
from gsdx.apps.sim_real_app import SimRealSession as JSimRealSession
from gsdx.dynamics.model import DynamicsPredictor as JModel
from gsdx.dynamics.train import init_params as j_init_params
from gsdx.io.checkpoint import save_checkpoint as j_save_checkpoint
from gsdx.io.config import load_config as j_load_config
from gsdx.track.optimizer import tracking_lrs as j_lrs
from gsdx_torch.apps import demo, sim_real, sim_real_app
from gsdx_torch.apps.demo import DemoSession, click_to_xyz
from gsdx_torch.apps.sim_real_app import SimRealSession
from gsdx_torch.core.gaussians import params_from_numpy
from gsdx_torch.dynamics.model import flax_params
from gsdx_torch.io.ply import load_ply
from gsdx_torch.io.video import read_png
from gsdx_torch.realworld import env as env_mod
from gsdx_torch.realworld.env import FakeEnv, FakeEnvConfig
from gsdx_torch.utils.viz import project_points

from test_demo_e2e import TINY_CFG
from test_torch_fit import _compare_fit
from test_torch_online import QUAT_TOL, slab
from test_torch_track import np_tree

torch.set_num_threads(min(2, torch.get_num_threads()))

W, H = 80, 60
GS_ITERS = 10


def small_env(points=None, colors=None, cfg=None, device="cpu"):
    """The port's simulated environment at 80x60 (a block by default)."""
    if points is None:
        points, colors = slab()
    return FakeEnv(points, colors, FakeEnvConfig(width=W, height=H), device=device)


def write_config(path, out_dir):
    path.write_text(TINY_CFG.format(out_dir=str(out_dir)))
    return str(path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tiny config, gsdx's random-init weights as its checkpoint, and
    both packages' sim-real sessions after `reset` (perceive + fit)."""
    tmp = tmp_path_factory.mktemp("demo")
    cfg = write_config(tmp / "tiny.yaml", tmp / "log")
    train_cfg, model_cfg, data_cfg = j_load_config(cfg)
    tree = j_init_params(JModel(model_cfg), train_cfg, data_cfg, jax.random.PRNGKey(0))
    j_save_checkpoint(str(tmp / "log" / "checkpoints" / "latest.ckpt"), tree)

    s_j = JSimRealSession(cfg, small_env(), out_dir=str(tmp / "j"), gs_iters=GS_ITERS)
    s_t = SimRealSession(cfg, small_env(), out_dir=str(tmp / "t"), gs_iters=GS_ITERS,
                         save_dir=str(tmp / "assets"), device="cpu")
    logs = {}
    for name, s in (("j", s_j), ("t", s_t)):
        train = s.gs.train

        def keep(progress=False, train=train, name=name):
            logs[name] = train(progress)
            return logs[name]

        s.gs.train = keep
        s.reset(train_gs=True)
    return dict(tmp=tmp, cfg=cfg, tree=jax.device_get(tree), s_j=s_j, s_t=s_t, logs=logs)


def test_click_to_xyz_matches_gsdx(rng):
    for _ in range(5):
        intr = np.array([[rng.uniform(50, 500), 0, rng.uniform(20, 300)],
                         [0, rng.uniform(50, 500), rng.uniform(20, 200)], [0, 0, 1]])
        extr = np.eye(4)
        a = rng.uniform(-0.5, 0.5, 3)
        extr[:3, :3] = [[np.cos(a[0]), 0, np.sin(a[0])], [0, 1, 0],
                        [-np.sin(a[0]), 0, np.cos(a[0])]]
        extr[:3, 3] = rng.normal(size=3) + [0, 0, 2]
        click, z = rng.uniform(0, 300, 2), rng.uniform(-0.1, 0.1)
        # the same float64 numpy: equal
        np.testing.assert_array_equal(click_to_xyz(*click, intr, extr, z=z),
                                      j_click_to_xyz(*click, intr, extr, z=z))
        # the point lies on the plane and projects back onto the click
        p = click_to_xyz(*click, intr, extr, z=z)
        assert p[2] == pytest.approx(z, abs=1e-9)
        np.testing.assert_allclose(project_points(p[None], intr, extr)[0], click,
                                   atol=1e-6)


def test_sessions_load_the_same_weights(world):
    got = flax_params(world["s_t"].dm.model)
    flat = jax.tree_util.tree_leaves_with_path(world["tree"])
    assert flat
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=str(path))
    assert world["s_t"].dm.cfg.max_nobj == world["s_j"].dm.cfg.max_nobj == 24


def test_missing_checkpoint_warns_and_initialises(tmp_path, capsys):
    from gsdx_torch.dynamics.train import init_params

    cfg = write_config(tmp_path / "tiny.yaml", tmp_path / "nolog")
    s = DemoSession(cfg, out_dir=str(tmp_path / "out"), device="cpu")
    assert "missing; using random init" in capsys.readouterr().out
    ref = init_params(s.model_cfg, 0, "cpu").state_dict()
    for k, v in s.dm.model.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0)


def test_sim_real_reset_matches_gsdx(world):
    """Perception (images, masks, fused cloud) and the online fit."""
    s_j, s_t = world["s_j"], world["s_t"]
    for a, b in zip(s_t.imgs, s_j.imgs):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(s_t.masks, s_j.masks):
        np.testing.assert_array_equal(a, b)
    assert s_t.masks[0].dtype == bool and s_t.imgs[0].shape == (H, W, 3)
    # voxel means of the same points summed in another order
    np.testing.assert_allclose(s_t.gs.init_pt_cld, s_j.gs.init_pt_cld, rtol=0, atol=1e-6)
    assert len(s_t.gs.init_pt_cld) > 100
    np.testing.assert_array_equal(s_t.gs.ims.numpy(), np.asarray(s_j.gs.ims))
    np.testing.assert_array_equal(s_t.gs.segs.numpy(), np.asarray(s_j.gs.segs))
    w2c = np.stack(s_j.gs.metadata["w2c"])
    centers = np.linalg.inv(w2c)[:, :3, 3]
    radius = float(1.1 * np.max(np.linalg.norm(centers - centers.mean(0), axis=-1)))
    _compare_fit(world["logs"]["j"], world["logs"]["t"], s_j.gs.params, s_t.gs.params,
                 GS_ITERS, j_lrs(radius))
    assert s_t.mean_z == pytest.approx(s_j.mean_z, abs=1e-5)


def test_demo_bundle_is_written_and_reloads_as_in_gsdx(world, tmp_path):
    """The port's bundle (its own PNG writer) read by the port's demo with
    `read_png` and by gsdx's demo with PIL: the same scene state."""
    s_t = world["s_t"]
    obj = s_t.obj_dir
    for f in ("pcd.ply", "R_list.npy", "t_list.npy", "intr_list.npy", "gs_orig.splat"):
        assert os.path.exists(os.path.join(obj, f)), f
    for v in range(4):
        np.testing.assert_array_equal(read_png(os.path.join(obj, f"img_{v}.png")),
                                      s_t.imgs[v])
        mask = np.asarray(Image.open(os.path.join(obj, f"mask_{v}.png")))
        np.testing.assert_array_equal(mask, s_t.masks[v].astype(np.uint8) * 255)
    pts, cols = load_ply(os.path.join(obj, "pcd.ply"))
    np.testing.assert_array_equal(pts, s_t.gs.init_pt_cld[:, :3])
    np.testing.assert_allclose(cols, s_t.gs.init_pt_cld[:, 3:6], atol=1 / 255)

    off_t = DemoSession(world["cfg"], assets=obj, out_dir=str(tmp_path / "t"), device="cpu")
    off_j = JDemoSession(world["cfg"], assets=obj, out_dir=str(tmp_path / "j"))
    off_t.reset(train_gs=False)
    off_j.reset(train_gs=False)
    np.testing.assert_array_equal(off_t.gs.ims.numpy(), np.asarray(off_j.gs.ims))
    np.testing.assert_array_equal(off_t.gs.segs.numpy(), np.asarray(off_j.gs.segs))
    np.testing.assert_array_equal(off_t.gs.init_pt_cld, off_j.gs.init_pt_cld)
    for a, b in zip(off_t.gs.metadata["w2c"], off_j.gs.metadata["w2c"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(off_t.particle_pos, off_j.particle_pos)
    assert off_t.mean_z == off_j.mean_z


@pytest.fixture(scope="module")
def simulated(world):
    """Both sessions from gsdx's fitted scene, pushed 1.2 cm through the
    block's centre by clicks on camera 0 (one moving step: the random model
    flattens the perceived block's surfaces in a step, after which the
    bones' Kabsch fits are rank-deficient; see test_torch_online.py)."""
    s_j, s_t = world["s_j"], world["s_t"]
    s_t.gs.params = params_from_numpy(np_tree(s_j.gs.params))
    s_t._set_particles()
    assert s_t.mean_z == s_j.mean_z
    c = s_j.particle_pos.mean(0)
    intr, w2c = np.asarray(s_j.gs.metadata["k"][0]), np.asarray(s_j.gs.metadata["w2c"][0])
    world_pts = np.stack([c + [-0.006, 0, 0], c + [0.006, 0, 0]])
    world_pts[:, 2] = s_j.mean_z
    clicks = project_points(world_pts, intr, w2c)
    out_j = s_j.run_sim(tuple(clicks[0]), tuple(clicks[1]))
    out_t = s_t.run_sim(tuple(clicks[0]), tuple(clicks[1]))
    return out_j, out_t


def test_run_sim_matches_gsdx(world, simulated):
    (act_j, rv_j, frames_j), (act_t, rv_t, frames_t) = simulated
    np.testing.assert_array_equal(act_t, act_j)
    assert len(rv_t) == len(rv_j) == len(frames_t) == 2 + 2
    for a, b in zip(rv_t, rv_j):
        for key in b:
            np.testing.assert_allclose(a[key], np.asarray(b[key]), rtol=0,
                                       atol=QUAT_TOL if key == "rotations" else 1e-5,
                                       err_msg=key)
    assert float(frames_t[0].max()) > 0.1  # the block is in view
    for a, b in zip(frames_t, frames_j):
        assert a.shape == (H, W, 3)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
    s_t = world["s_t"]
    frames_dir = os.path.join(s_t.out_dir, "sim_cam0")
    assert sorted(os.listdir(frames_dir)) == [f"frame_{t:04d}.png" for t in range(4)]
    np.testing.assert_allclose(read_png(os.path.join(frames_dir, "frame_0003.png")),
                               np.clip(frames_t[-1], 0, 1) * 255, atol=1)
    # the bundle's capture of the push: every view's frames, the splat, the action
    for v in range(4):
        assert len(os.listdir(os.path.join(s_t.action_dir, f"video_{v}"))) == 4
    assert os.path.exists(os.path.join(s_t.action_dir, "gs_pred.splat"))
    np.testing.assert_array_equal(np.load(os.path.join(s_t.action_dir, "action.npy")), act_t)


def _splat_records(path):
    return np.fromfile(path, dtype=[("pos", "<f4", 3), ("scale", "<f4", 3),
                                    ("rgba", "u1", 4), ("quat", "u1", 4)])


def test_export_splat_matches_gsdx(world, simulated, tmp_path):
    s_j, s_t = world["s_j"], world["s_t"]
    a = _splat_records(s_t.export_splat(str(tmp_path / "t.splat")))
    b = _splat_records(s_j.export_splat(str(tmp_path / "j.splat")))
    assert len(a) == len(b) == int(np.asarray(s_j.gs.params.live).sum())
    # the scene is the rollout's last step: positions within its 1e-5 m
    np.testing.assert_allclose(a["pos"], b["pos"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(a["scale"], b["scale"], rtol=1e-5, atol=1e-7)
    # u8 casts of colour, opacity (a sigmoid of another library) and the
    # rotated quaternion: within one level
    for f in ("rgba", "quat"):
        assert np.abs(a[f].astype(int) - b[f].astype(int)).max() <= 1, f


def test_run_real_and_switch_view_match_gsdx(world, simulated):
    s_j, s_t = world["s_j"], world["s_t"]
    before = [im.copy() for im in s_t.imgs]
    assert s_t.run_real() and s_j.run_real()
    assert any(not np.array_equal(a, b) for a, b in zip(before, s_t.imgs))  # it moved
    for a, b in zip(s_t.imgs, s_j.imgs):
        np.testing.assert_array_equal(a, b)
    # the fitted scene is kept: the rollout's last step
    np.testing.assert_allclose(s_t.particle_pos, s_j.particle_pos, rtol=0, atol=1e-5)
    assert [s_t.switch_view() for _ in range(5)] == [s_j.switch_view() for _ in range(5)] \
        == [1, 2, 3, 0, 1]
    fresh = SimRealSession(world["cfg"], small_env(), out_dir=str(world["tmp"] / "f"),
                           device="cpu")
    assert not fresh.run_real()  # nothing simulated yet


def test_clis_on_the_cpu(tmp_path, monkeypatch, capsys):
    """sim_real_app (fake env, clicks, run real, save for the demo) ->
    demo --assets on the captured bundle -> sim_real, through their mains,
    with the simulated environment at 80x60."""
    cfg = write_config(tmp_path / "tiny.yaml", tmp_path / "log")
    monkeypatch.setattr(env_mod, "FakeEnv", small_env)
    monkeypatch.chdir(tmp_path)
    common = ["--config", cfg, "--gs_iters", "4", "--device", "cpu"]
    sim_real_app.main([*common, "--env", "fake", "--clicks", "38,30,42,30", "--run-real",
                       "--save-for-demo", "--out", "sr"])
    (obj,) = os.listdir(tmp_path / "sr" / "demo_assets")
    bundle = tmp_path / "sr" / "demo_assets" / obj
    assert {f"img_{v}.png" for v in range(4)} <= set(os.listdir(bundle))
    assert len(os.listdir(tmp_path / "sr" / "sim_cam0")) >= 2
    (action,) = [d for d in os.listdir(bundle) if d.startswith("action_")]
    assert os.path.exists(bundle / action / "gs_pred.splat")
    capsys.readouterr()

    demo.main([*common, "--assets", str(bundle), "--clicks", "38,30,42,30", "--out", "dm"])
    out = capsys.readouterr().out
    assert re.search(r"read 8 PNGs of .* with read_png", out)
    assert os.path.getsize(tmp_path / "dm" / "gs.splat") > 0
    assert len(os.listdir(tmp_path / "dm" / "sim_cam0")) >= 2

    sim_real.main([*common, "--trials", "1", "--out", "s"])
    assert "sim_real loop done" in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "s" / "sim_cam0")) >= 2

    # --env real runs on the hardware stack; a real arm needs the xArm SDK
    with pytest.raises(ImportError, match="xarm"):
        sim_real_app.main(["--config", cfg, "--env", "real", "--device", "cpu",
                           "--robot_ip", "10.0.0.1"])
    if not torch.cuda.is_available():  # the apps default to the card
        for main in (demo.main, sim_real.main):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(["--config", cfg])
