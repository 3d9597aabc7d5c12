"""gsdx_torch predict path (apps/predict `collect_scene_data`, the
re-render, io/video) against gsdx on the CPU, and the three CLIs of the
learn-and-predict path (preprocess -> train -> predict) end to end with
`--device cpu` on a small two-episode tree."""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gsdx.apps.predict import collect_scene_data as j_collect
from gsdx.dynamics.model import DynamicsPredictor as JModel
from gsdx.dynamics.model import ModelConfig as JModelConfig
from gsdx.dynamics.train import TrainConfig as JTrainConfig
from gsdx.dynamics.train import init_params as j_init_params
from gsdx.graph.dataset import GraphDatasetConfig as JDataConfig
from gsdx.render.renderer import Renderer as JRenderer
from gsdx_torch.apps.predict import collect_scene_data
from gsdx_torch.dynamics.model import (DynamicsPredictor, ModelConfig, flax_params,
                                       load_flax_params)
from gsdx_torch.dynamics.train import TrainConfig
from gsdx_torch.graph.dataset import GraphDatasetConfig
from gsdx_torch.io.checkpoint import load_checkpoint
from gsdx_torch.io.video import encode_png, write_video
from gsdx_torch.render.renderer import Renderer

torch.set_num_threads(min(2, torch.get_num_threads()))

W, H = 128, 64


def write_episode(data_dir, out_dir, rng, n_gauss, n_frames=10):
    """A tracked episode: a 20 x 10 x 8 cm slab of Gaussians whose left end
    is pushed 6 mm a frame from frame 3 on (frames 0-2 static), two cameras
    at W x H, the action log in the robot's mm / degree poses and an
    identity hand-eye calibration. The slab keeps every bone's neighbours
    off a line: a thin rope's nearly colinear neighbours make the Kabsch
    fit rank-deficient, where LAPACK's SVD may pick another rotation."""
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)
    push = 0.006 * np.clip(np.arange(n_frames) - 2, 0, None)
    lines = [json.dumps({"joint_angles": [0.0] * 7,
                         "pose": [1000 * (-0.06 + p), 0.0, 1000 * 0.17 + 20.0,
                                  180.0, 0.0, 90.0]}) for p in push]
    with open(os.path.join(data_dir, "actions.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(data_dir, "calibration_handeye_result.pkl"), "wb") as f:
        pickle.dump({"R_base2world": np.eye(3), "t_base2world": np.zeros(3)}, f)

    base = rng.uniform(-1, 1, size=(n_gauss, 3)) * [0.1, 0.05, 0.04]
    moving = (base[:, 0] < -0.05)[:, None] * np.array([0.5, 0.0, 0.0])
    means = np.stack([base + p * moving for p in push]).astype(np.float32)
    quats = rng.normal(size=(n_gauss, 4))
    np.savez(os.path.join(out_dir, "params.npz"), means3D=means,
             rgb_colors=np.repeat(rng.uniform(0, 1, (1, n_gauss, 3)), n_frames, 0)
             .astype(np.float32),
             unnorm_rotations=np.repeat(quats[None], n_frames, 0).astype(np.float32),
             logit_opacities=rng.normal(1.0, 1.5, size=(n_gauss, 1)).astype(np.float32),
             log_scales=np.log(rng.uniform(0.003, 0.01, (n_gauss, 3))).astype(np.float32))
    w2c = np.eye(4)
    w2c[2, 3] = 0.4
    w2c2 = w2c.copy()
    w2c2[:3, :3] = [[np.cos(0.3), 0, np.sin(0.3)], [0, 1, 0], [-np.sin(0.3), 0, np.cos(0.3)]]
    k = [[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]]
    meta = {"w": W, "h": H, "k": [[k, k]] * n_frames,
            "w2c": [[w2c.tolist(), w2c2.tolist()]] * n_frames,
            "fn": [[f"camera_0/color_{t:06d}.jpg", f"camera_1/color_{t:06d}.jpg"]
                   for t in range(n_frames)]}
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)


MODEL = dict(nf_particle=32, nf_relation=32, nf_effect=32, n_his=3)
DATA = dict(n_his=3, n_future=3, max_nobj=16, max_nR=96, topk=4)


def test_collect_scene_data_and_render_match_gsdx(rng, tmp_path):
    """The rollout's rendervars within 1e-5 of gsdx's (same weights), and
    one re-rendered frame of each camera within 1e-5 (image and depth)."""
    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    write_episode(data, out, rng, n_gauss=300)
    params = j_init_params(JModel(JModelConfig(**MODEL)), JTrainConfig(n_his=3),
                           JDataConfig(**DATA), jax.random.PRNGKey(0))
    model = load_flax_params(DynamicsPredictor(ModelConfig(**MODEL)),
                             jax.device_get(params)).eval()
    kw = dict(max_steps=8)
    tcfg, dcfg = TrainConfig(n_his=3, dist_thresh=0.005), GraphDatasetConfig(**DATA)
    sd_t, vis_t, meta = collect_scene_data(os.path.join(out, "params.npz"), data, out, model,
                                           tcfg, dcfg, device="cpu", **kw)
    sd_j, vis_j, _ = j_collect(os.path.join(out, "params.npz"), data, out,
                               JModelConfig(**MODEL), JTrainConfig(n_his=3, dist_thresh=0.005),
                               JDataConfig(**DATA), params, **kw)
    assert len(sd_t) == len(sd_j) == 8
    assert not np.array_equal(sd_t[-1]["means3D"], sd_t[0]["means3D"])
    for a, b in zip(sd_t + vis_t, sd_j + vis_j):
        for key in b:
            np.testing.assert_allclose(a[key], np.asarray(b[key]), rtol=0, atol=1e-5,
                                       err_msg=key)

    renderer = Renderer(width=W, height=H, device="cpu")
    w2c = np.asarray(meta["w2c"][0], np.float32)
    k = np.asarray(meta["k"][0], np.float32)
    for c in range(2):
        with torch.inference_mode():
            im, depth = renderer.render(w2c[c], k[c], sd_t[6])
        im_j, depth_j = jax.jit(lambda d: JRenderer(width=W, height=H).render(
            w2c[c], k[c], d))(sd_t[6])
        assert float((im - 0.7).abs().max()) > 0.1  # the rope is in view
        np.testing.assert_allclose(im.numpy(), np.asarray(im_j), rtol=0, atol=1e-5)
        np.testing.assert_allclose(depth.numpy(), np.asarray(depth_j), rtol=0, atol=1e-5)


def test_inference_renders_save_nothing_for_backward(rng, monkeypatch):
    """Under `torch.inference_mode()` a render has no graph, and the tile
    features the compositor's autograd Function would save for its
    backward are freed as the render returns. With gradients on, the same
    render keeps them alive while its output lives."""
    import gc
    import importlib
    import weakref

    trast = importlib.import_module("gsdx_torch.render.rasterize")
    fwd, refs = trast._Composite.forward, []

    def recording_forward(ctx, tile_feats, *args):
        refs.append(weakref.ref(tile_feats))
        return fwd(ctx, tile_feats, *args)

    monkeypatch.setattr(trast._Composite, "forward", staticmethod(recording_forward))
    n = 50
    data = {"means3D": rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32) + [0, 0, 2],
            "rotations": np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
            "scales": np.full((n, 3), 0.03, np.float32),
            "opacities": np.full((n, 1), 0.8, np.float32),
            "colors_precomp": rng.uniform(0, 1, (n, 3)).astype(np.float32)}
    k = np.array([[60.0, 0, 32], [0, 60.0, 20], [0, 0, 1]], np.float32)
    renderer = Renderer(width=64, height=40, device="cpu")

    with torch.inference_mode():
        im, depth = renderer.render(np.eye(4), k, data)
    gc.collect()
    assert torch.isfinite(im).all()
    assert im.grad_fn is None and depth.grad_fn is None
    assert len(refs) == 1 and refs[0]() is None  # nothing outlives the render

    grad_data = dict(data, means3D=torch.tensor(data["means3D"], requires_grad=True))
    im_g, depth_g = renderer.render(np.eye(4), k, grad_data)
    gc.collect()
    assert im_g.grad_fn is not None
    assert len(refs) == 2 and refs[1]() is not None  # saved for the backward
    torch.testing.assert_close(im_g.detach(), im, rtol=0, atol=0)
    del im_g, depth_g
    gc.collect()
    assert refs[1]() is None


def test_png_writer_decodes_to_the_frame(rng, tmp_path):
    frame = rng.uniform(-0.1, 1.1, size=(37, 53, 3)).astype(np.float32)
    path = write_video(str(tmp_path / "camera_0"), [frame, frame[::-1].copy()])
    assert sorted(os.listdir(path)) == ["frame_0000.png", "frame_0001.png"]
    for name, want in (("frame_0000.png", frame), ("frame_0001.png", frame[::-1])):
        got = np.asarray(Image.open(os.path.join(path, name)).convert("RGB"), np.float32)
        assert got.shape == want.shape
        np.testing.assert_allclose(got / 255.0, np.clip(want, 0, 1), rtol=0, atol=1 / 255)
    u8 = rng.integers(0, 256, size=(4, 5, 3), dtype=np.uint8)
    with open(tmp_path / "u8.png", "wb") as f:
        f.write(encode_png(u8))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "u8.png")), u8)
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 5, 2)))


def test_learn_and_predict_clis_on_the_cpu(rng, tmp_path, monkeypatch, capsys):
    """preprocess -> train (1 epoch, 5 train and 2 valid iterations) ->
    predict (4 steps, 1 camera) through the CLIs, on a two-episode tree
    (the 80/20 split needs two), from a working directory of their own;
    then train --dp, a world of one over gloo."""
    from gsdx_torch.apps import predict, preprocess, train

    name = "toy"
    base = tmp_path / "d3dg"
    for idx in (0, 1):
        ep = f"episode_{idx:02d}"
        write_episode(str(base / "data" / name / ep),
                      str(base / "ckpts" / f"exp_{name}" / ep / name / ep), rng,
                      n_gauss=1600)
    cfg = tmp_path / "toy.yaml"
    cfg.write_text(
        "train_config:\n  out_dir: log/toy\n  batch_size: 2\n  n_epochs: 1\n"
        "  n_iters_per_epoch:\n    train: 5\n    valid: 2\n  log_interval: 1\n"
        "  random_seed: 0\n  dist_thresh: 0.005\n  n_his: 3\n  n_future: 3\n"
        "model_config:\n  nf_particle: 32\n  nf_relation: 32\n  nf_effect: 32\n"
        "dataset_config:\n  datasets:\n    - name: toy\n      base_dir: d3dg\n"
        "      max_nobj: 16\n      max_nR: 96\n      topk: 4\n")
    monkeypatch.chdir(tmp_path)
    preprocess.main(["--config", str(cfg), "--device", "cpu"])
    for idx in (0, 1):
        ep = f"episode_{idx:02d}"
        assert (base / "preprocessed" / f"exp_{name}" / ep / "frame_pairs" / f"{idx}.txt").exists()
        down = np.load(base / "ckpts" / f"exp_{name}" / ep / name / ep / "param_downsampled.npy")
        assert down.shape == (10, 1000, 3)

    train.main(["--config", str(cfg), "--device", "cpu"])
    ckpts = sorted(os.listdir(tmp_path / "log" / "toy" / "checkpoints"))
    assert ckpts == ["latest.ckpt", "latest_optim.ckpt", "model_1.ckpt"]

    ep = base / "ckpts" / f"exp_{name}" / "episode_00" / name / "episode_00"
    predict.main(["--config", str(cfg), "--episode", str(base / "data" / name / "episode_00"),
                  "--params", str(ep), "--out", "out/predict", "--max_steps", "4",
                  "--cameras", "1", "--device", "cpu"])
    frames = sorted(os.listdir(tmp_path / "out" / "predict"))
    assert frames == ["camera_0"]
    pngs = sorted(os.listdir(tmp_path / "out" / "predict" / "camera_0"))
    assert pngs == [f"frame_{t:04d}.png" for t in range(4)]
    im = np.asarray(Image.open(tmp_path / "out" / "predict" / "camera_0" / pngs[-1]))
    assert im.shape == (H, W, 3)

    ckpt_dir = tmp_path / "log" / "toy" / "checkpoints"
    for ckpt in os.listdir(ckpt_dir):
        os.remove(ckpt_dir / ckpt)
    capsys.readouterr()
    train.main(["--config", str(cfg), "--dp", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("epoch 0 loss ")
    assert os.listdir(ckpt_dir) == ["latest.ckpt"]
    load_checkpoint(str(ckpt_dir / "latest.ckpt"),
                    flax_params(DynamicsPredictor(ModelConfig(32, 32, 32))))
    # --overlay: the same frames blended by their coverage, with the trail
    predict.main(["--config", str(cfg), "--episode", str(base / "data" / name / "episode_00"),
                  "--params", str(ep), "--out", "out/overlay", "--max_steps", "4",
                  "--cameras", "1", "--overlay", "--device", "cpu"])
    over = np.asarray(Image.open(tmp_path / "out" / "overlay" / "camera_0" / pngs[-1]))
    assert over.shape == (H, W, 3) and not np.array_equal(over, im)
    if not torch.cuda.is_available():  # every CLI defaults to the card
        for main, args in ((preprocess.main, []), (train.main, []), (train.main, ["--dp"]),
                           (predict.main, ["--episode", "x", "--params", "y"])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(["--config", str(cfg), *args])
