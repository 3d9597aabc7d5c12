"""The slice as a whole: gsdx_torch tracking fits against gsdx's, and the
port's tracking CLI end to end on the CPU.

Scenes follow tests/test_tracking.py (3 cameras, 32x64 px, 8x128 tiles):
t=0 for 10 iterations, t>0 with frozen bins refreshed every 4 of 8
iterations (the presorting compositor), `track_sequence` over 2 timesteps,
and `gsdx_torch.apps.track` on a synthetic episode whose params.npz gsdx's
`load_params` reads.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gsdx.core.gaussians import init_gaussian_params as j_init_params
from gsdx.core.gaussians import init_tracking_variables as j_init_vars
from gsdx.io.episodes import load_params
from gsdx.kernels.knn import knn as j_knn
from gsdx.track import trainer as jtr
from gsdx.track.optimizer import GroupAdam as JAdam
from gsdx.track.optimizer import tracking_lrs as j_lrs
from gsdx_torch.core.cameras import stack_cameras
from gsdx_torch.core.gaussians import (
    init_gaussian_params,
    params_from_numpy,
    variables_from_numpy,
)
from gsdx_torch.render.rasterize import rasterize as t_rasterize
from gsdx_torch.track import trainer as ttr
from gsdx_torch.track.optimizer import AdamState, tracking_lrs

from test_torch_track import CFG_J, CFG_T, H, W, np_tree, port_camera
from test_tracking import make_cams, make_gt_scene, render_targets

FIELDS = ("means3d", "rgb_colors", "unnorm_rotations", "logit_opacities",
          "log_scales", "cam_m", "cam_c", "live")


def _scene(rng, capacity, noisy=True):
    pt_cld = make_gt_scene(rng)
    ims, segs = render_targets(pt_cld, make_cams())
    init = pt_cld.copy()
    if noisy:
        init[:, :3] += rng.normal(scale=0.01, size=(len(pt_cld), 3)).astype(
            np.float32)
    d, _ = j_knn(jnp.asarray(init[:, :3]), 3)
    jp = j_init_params(init, np.asarray(d).mean(-1), capacity=capacity)
    return jp, np.asarray(ims), np.asarray(segs)


def _port_cams():
    return stack_cameras([port_camera(i) for i in range(3)])


def _compare_fit(logs_j, logs_t, p_j, p_t, n_iters, lrs):
    # per-iteration loss / PSNR: f32 render + SSIM sums in another order,
    # compounded over the iterations' parameter updates: 1e-4 relative
    np.testing.assert_allclose(logs_t["loss"].numpy(), np.asarray(logs_j["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(logs_t["psnr"].numpy(), np.asarray(logs_j["psnr"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(logs_t["num_pts"].numpy(),
                                  np.asarray(logs_j["num_pts"]))
    for f in FIELDS:
        # Adam moves each entry by at most ~lr per step whatever the
        # gradient's size, so a gradient within rounding of zero can take a
        # different sign: bound by 2 * lr * iterations, on top of f32 noise
        lr = float(getattr(lrs, f))
        np.testing.assert_allclose(getattr(p_t, f).numpy(),
                                   np.asarray(getattr(p_j, f)), rtol=1e-5,
                                   atol=2 * lr * n_iters + 1e-6, err_msg=f)


def test_fit_t0_matches_gsdx(rng):
    jp, ims, segs = _scene(rng, capacity=128)
    cfg_j = jtr.TrackingConfig(iters_first=10, num_knn=8, raster=CFG_J)
    cfg_t = ttr.TrackingConfig(iters_first=10, num_knn=8, raster=CFG_T)
    order = jtr.camera_order(10, 3, np.random.default_rng(0))
    np.testing.assert_array_equal(
        ttr.camera_order(10, 3, np.random.default_rng(0)), np.asarray(order))
    jv = j_init_vars(128, 8, 1.0)
    st = JAdam().init(jp)
    fit_j = jtr.make_fit_timestep(cfg_j, is_initial=True, num_iters=10)
    p_j, _, v_j, logs_j = fit_j(jp, st, jv, j_lrs(1.0), make_cams(), ims, segs,
                                order, jax.random.PRNGKey(0))

    fit_t = ttr.make_fit_timestep(cfg_t, is_initial=True, num_iters=10)
    p_t, _, v_t, logs_t = fit_t(
        params_from_numpy(np_tree(jp)), AdamState.from_numpy(np_tree(st)),
        variables_from_numpy(np_tree(jv)), tracking_lrs(1.0), _port_cams(),
        torch.tensor(ims), torch.tensor(segs), np.asarray(order))
    assert logs_t["psnr"][-1] > logs_t["psnr"][0]
    _compare_fit(logs_j, logs_t, p_j, p_t, 10, j_lrs(1.0))
    # densification statistics accumulated every iteration
    np.testing.assert_array_equal(v_t.denom.numpy(), np.asarray(v_j.denom))
    scale = np.abs(np.asarray(v_j.means2d_grad_accum)).max()
    np.testing.assert_allclose(v_t.means2d_grad_accum.numpy() / scale,
                               np.asarray(v_j.means2d_grad_accum) / scale,
                               atol=1e-3)


def test_fit_frozen_bins_t1_matches_gsdx(rng):
    jp, ims, segs = _scene(rng, capacity=64, noisy=False)
    jv = jtr.initialize_post_first_timestep(jp, j_init_vars(64, 8, 1.0), 8)
    jp, jv, st = jtr.initialize_per_timestep(jp, jv, JAdam().init(jp))
    # move off the reference state: the bg loss |rot - init_bg_rot| has no
    # derivative at 0, where its gradient sign is f32 rounding noise
    jp = jp.replace(
        means3d=jp.means3d + jnp.asarray(
            rng.normal(scale=0.005, size=(64, 3)), jnp.float32),
        unnorm_rotations=jp.unnorm_rotations + jnp.asarray(
            rng.normal(scale=0.05, size=(64, 4)), jnp.float32))
    cfg_j = jtr.TrackingConfig(num_knn=8, raster=CFG_J, bin_refresh=4)
    cfg_t = ttr.TrackingConfig(num_knn=8, raster=CFG_T, bin_refresh=4)
    order = jtr.camera_order(8, 3, np.random.default_rng(1))
    fit_j = jtr.make_fit_timestep(cfg_j, is_initial=False, num_iters=8)
    p_j, _, _, logs_j = fit_j(jp, st, jv, j_lrs(1.0, True), make_cams(), ims,
                              segs, order, jax.random.PRNGKey(0))
    fit_t = ttr.make_fit_timestep(cfg_t, is_initial=False, num_iters=8)
    p_t, _, _, logs_t = fit_t(
        params_from_numpy(np_tree(jp)), AdamState.from_numpy(np_tree(st)),
        variables_from_numpy(np_tree(jv)), tracking_lrs(1.0, True), _port_cams(),
        torch.tensor(ims), torch.tensor(segs), np.asarray(order))
    _compare_fit(logs_j, logs_t, p_j, p_t, 8, j_lrs(1.0, True))
    # frozen fields stay put after the first timestep
    for f in ("logit_opacities", "log_scales", "cam_m"):
        np.testing.assert_array_equal(getattr(p_t, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)


def test_track_sequence_two_timesteps_matches_gsdx(rng):
    jp, ims, segs = _scene(rng, capacity=128)
    seq_ims = np.stack([ims, ims])
    seq_segs = np.stack([segs, segs])
    common = dict(iters_first=6, iters_rest=4, num_knn=4, bin_refresh=2)
    out_j = jtr.track_sequence(jp, make_cams(), seq_ims, seq_segs, 2,
                               jtr.TrackingConfig(raster=CFG_J, **common))
    out_t = ttr.track_sequence(params_from_numpy(np_tree(jp)), _port_cams(), seq_ims, seq_segs, 2,
                               ttr.TrackingConfig(raster=CFG_T, **common),
                               device="cpu")
    assert len(out_t) == 2
    # At t=1 every rotation starts exactly at its bg-loss reference, where
    # |rot - init_bg_rot| has no derivative and the gradient's sign is f32
    # rounding noise in both packages; each Adam step then moves an entry
    # by up to lr either way. Bound: 2 * lr * the 10 iterations, per field.
    lr = {"means3D": 0.00016, "unnorm_rotations": 0.001, "rgb_colors": 0.0,
          "seg_colors": 0.0, "logit_opacities": 0.05, "log_scales": 0.001,
          "cam_m": 1e-4, "cam_c": 1e-4}
    for snap_t, snap_j in zip(out_t, out_j):
        assert snap_t.keys() == snap_j.keys()
        for k in snap_j:
            np.testing.assert_allclose(snap_t[k], snap_j[k], rtol=1e-5,
                                       atol=2 * lr[k] * 10 + 1e-6, err_msg=k)


def test_track_cli_writes_gsdx_params(tmp_path, rng):
    """The port's CLI on a synthetic episode (tests/test_track_app.py's
    layout, targets rendered by the port) writes a params.npz that gsdx's
    load_params reads with the same keys and shapes gsdx writes."""
    from PIL import Image

    from gsdx_torch.apps.track import main as track_main

    pt_cld = make_gt_scene(rng, n=40)
    cams = _port_cams()
    k = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
    fn, ks, w2cs = [], [], []
    for t in range(2):
        moved = pt_cld.copy()
        moved[:, :3] += np.array([0.01, 0, 0], np.float32) * t
        n = len(moved)
        seg_col = np.stack([moved[:, 6], np.zeros(n), 1 - moved[:, 6]], -1)
        row = []
        for c in range(3):
            args = [torch.tensor(moved[:, :3]),
                    torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
                    torch.full((n, 3), 0.05), torch.full((n, 1), 0.95)]
            im = t_rasterize(*args, torch.tensor(moved[:, 3:6]), cams[c], CFG_T).im
            seg = t_rasterize(*args, torch.tensor(seg_col, dtype=torch.float32),
                              cams[c], CFG_T).im
            cam_dir = tmp_path / f"camera_{c}"
            os.makedirs(cam_dir / "seg", exist_ok=True)
            Image.fromarray((np.clip(im.permute(1, 2, 0).numpy(), 0, 1) * 255
                             ).astype(np.uint8)).save(
                cam_dir / f"color_{t:06d}.jpg", quality=98)
            Image.fromarray((seg[0].numpy() > 0.5).astype(np.uint8) * 255).save(
                cam_dir / "seg" / f"seg_{t:06d}.png")
            row.append(f"camera_{c}/color_{t:06d}.jpg")
        fn.append(row)
        ks.append([k.tolist()] * 3)
        w2cs.append([cams.w2c[c].numpy().tolist() for c in range(3)])
    with open(tmp_path / "train_meta.json", "w") as f:
        json.dump({"w": W, "h": H, "k": ks, "w2c": w2cs, "fn": fn,
                   "cam_id": [[0, 1, 2]] * 2}, f)
    np.savez(tmp_path / "init_pt_cld.npz", data=pt_cld)

    out_dir = tmp_path / "out"
    track_main(["--sequence", str(tmp_path), "--exp_name", "test",
                "--output_dir", str(out_dir), "--iters_first", "12",
                "--iters_rest", "6", "--num_knn", "4", "--device", "cpu"])
    params = load_params(str(out_dir / "test" / tmp_path.name / "params.npz"))
    n = len(pt_cld)
    assert set(params) == {"means3D", "rgb_colors", "unnorm_rotations",
                           "seg_colors", "logit_opacities", "log_scales",
                           "cam_m", "cam_c"}
    # moving fields stacked over the 2 timesteps, t=0-only fields once
    assert params["means3D"].shape == (2, n, 3)
    assert params["unnorm_rotations"].shape == (2, n, 4)
    assert params["log_scales"].shape == (n, 3)
    assert params["cam_m"].shape == (50, 3)
    assert np.isfinite(params["means3D"]).all()
    # init_gaussian_params of the same cloud gives the t=0 colours back
    p0 = init_gaussian_params(pt_cld, np.full(n, 1e-3, np.float32))
    np.testing.assert_array_equal(params["rgb_colors"][0],
                                  p0.rgb_colors[:n].numpy())


def test_track_sequence_resumes_to_the_same_parameters(tmp_path, rng):
    """Save mid-sequence, load, continue: the same snapshots as one
    uninterrupted run (the checkpoint carries the split-noise generator's
    and the camera-order RNG's states, so the CPU run repeats exactly)."""
    jp, ims, segs = _scene(rng, capacity=128)
    seq_ims = np.stack([ims, ims * 0.98, ims])
    seq_segs = np.stack([segs, segs, segs])
    cfg = ttr.TrackingConfig(raster=CFG_T, iters_first=6, iters_rest=4, num_knn=4,
                             bin_refresh=2)
    p0 = params_from_numpy(np_tree(jp))
    whole = ttr.track_sequence(p0, _port_cams(), seq_ims, seq_segs, 3, cfg, device="cpu")
    path = str(tmp_path / "state" / "track.ckpt")
    first = ttr.track_sequence(p0, _port_cams(), seq_ims, seq_segs, 2, cfg, device="cpu",
                               state_path=path)
    assert os.path.exists(path) and os.path.exists(path + ".outputs")
    assert (tmp_path / "state" / "num_pts.txt").read_text().startswith("Number of points")
    t, params, opt_state, variables, gen, cam_rng, outputs = ttr.load_tracking_state(path)
    assert t == 1 and len(outputs) == 2 and int(opt_state.count) == 4
    assert params.capacity == 128 and variables.neighbor_indices.dtype == torch.int64
    # the checkpoint is flax msgpack: gsdx's reader takes it
    import flax.serialization
    with open(path, "rb") as f:
        raw = flax.serialization.msgpack_restore(f.read())
    assert int(raw["t"]) == 1 and raw["params"]["means3d"].shape == (128, 3)
    resumed = ttr.track_sequence(p0, _port_cams(), seq_ims, seq_segs, 3, cfg,
                                 device="cpu", state_path=path, resume=True)
    assert len(resumed) == 3
    for snap_r, snap_w, snap_f in zip(resumed, whole, first + [None]):
        for k in snap_w:
            np.testing.assert_array_equal(snap_r[k], snap_w[k], err_msg=k)
            if snap_f is not None:
                np.testing.assert_array_equal(snap_f[k], snap_w[k], err_msg=k)
