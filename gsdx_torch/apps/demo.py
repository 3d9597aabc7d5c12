"""Interactive dynamics demo (counterpart of `gsdx/apps/demo.py`).

Fit a Gaussian scene from demo assets (or a synthetic scene), click a push
start and target in a camera view, roll the GNN forward, and render the
predicted interaction. Runs as a gradio app when gradio is installed and
no clicks are given; otherwise as a scripted CLI (`--clicks x1,y1,x2,y2`).
The rollout is written as PNG frames, `<out>/sim_cam{c}/frame_{t:04d}.png`,
where gsdx writes `sim_cam{c}.mp4` (the port has no video encoder).

    python -m gsdx_torch.apps.demo --config configs/rope.yaml \\
        [--assets <dir with pcd.ply, img_i.png, mask_i.png, R/t/intr .npy>] \\
        [--clicks 320,240,420,260] [--out out/demo] [--device cuda]

The trained model is read from `<train_config.out_dir>/checkpoints`
(relative to the working directory); without it the demo warns and uses
a random initialisation.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def click_to_xyz(click_x, click_y, intr, extr, z=-0.01):
    """Pixel click -> 3D point on the horizontal plane at height ``z``: the
    camera ray through the pixel, intersected with the plane."""
    inv_extr = np.linalg.inv(extr)
    p1 = np.array([0.0, 0.0, 0.0, 1.0]) @ inv_extr.T
    fx, fy = intr[0, 0], intr[1, 1]
    cx, cy = intr[0, 2], intr[1, 2]
    p2 = np.array([(click_x - cx) / fx, (click_y - cy) / fy, 1.0, 1.0]) @ inv_extr.T
    ratio = (z - p1[2]) / (p2[2] - p1[2])
    return (p1 + ratio * (p2 - p1))[:3]


def load_dynamics(config_path: str, epoch: str, device: torch.device):
    """(train_cfg, model_cfg, data_cfg, model): the trained model of
    `<out_dir>/checkpoints/{latest,model_<epoch>}.ckpt` on ``device`` in
    eval mode, or, when that file is missing, a warning and a random
    initialisation."""
    from gsdx_torch.dynamics.model import flax_params, load_flax_params
    from gsdx_torch.dynamics.train import init_params
    from gsdx_torch.io.checkpoint import load_checkpoint
    from gsdx_torch.io.config import load_config

    train_cfg, model_cfg, data_cfg = load_config(config_path)
    model = init_params(model_cfg, 0, "cpu")
    name = "latest.ckpt" if epoch == "latest" else f"model_{epoch}.ckpt"
    ckpt_path = os.path.join(train_cfg.out_dir, "checkpoints", name)
    if os.path.exists(ckpt_path):
        model = load_flax_params(
            model, load_checkpoint(ckpt_path, target=flax_params(model)))
    else:
        print(f"warning: checkpoint {ckpt_path} missing; using random init")
    return train_cfg, model_cfg, data_cfg, model.to(device).eval()


def read_assets(assets: str, n_views: int = 4):
    """A demo-asset bundle: (points, colours or None, images (H, W, 3) in
    [0, 1] times their masks, masks (H, W) in [0, 1], R_list, t_list,
    intr_list). Read without an imaging package."""
    from gsdx_torch.io.ply import load_ply
    from gsdx_torch.io.video import read_png

    pts, cols = load_ply(os.path.join(assets, "pcd.ply"))
    imgs, masks = [], []
    for v in range(n_views):
        img = read_png(os.path.join(assets, f"img_{v}.png")).astype(
            np.float32)[..., :3] / 255.0
        mask = read_png(os.path.join(assets, f"mask_{v}.png")).astype(np.float32)
        if mask.ndim == 3:
            mask = mask[..., 0]
        mask = mask / max(mask.max(), 1e-6)
        imgs.append(img * mask[..., None])
        masks.append(mask)
    R_list = np.load(os.path.join(assets, "R_list.npy"))
    t_list = np.load(os.path.join(assets, "t_list.npy"))
    intr_list = np.load(os.path.join(assets, "intr_list.npy"))
    print(f"read {2 * n_views} PNGs of {assets} with read_png")
    return pts, cols, imgs, masks, list(R_list), list(t_list), list(intr_list)


class DemoSession:
    """The demo's state and steps, independent of any UI: the GNN, the
    online Gaussian trainer and the camera being shown, on ``device``."""

    def __init__(self, config_path: str, epoch: str = "latest",
                 assets: str | None = None, out_dir: str = "out/demo",
                 gs_iters: int | None = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        from gsdx_torch.core.device import require_device
        from gsdx_torch.rollout.dynamics_module import DynamicsModule, RolloutConfig
        from gsdx_torch.track.online import OnlineGSConfig, OnlineGSTrainer

        self.device = require_device(device)
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        train_cfg, model_cfg, data_cfg, model = load_dynamics(
            config_path, epoch, self.device)
        self.train_cfg, self.model_cfg, self.data_cfg = train_cfg, model_cfg, data_cfg
        rcfg = RolloutConfig(
            n_his=train_cfg.n_his,
            dist_thresh=0.005,
            max_nobj=data_cfg.max_nobj,
            fps_radius=sum(data_cfg.fps_radius_range) / 2,
            adj_thresh=sum(data_cfg.adj_radius_range) / 2,
            topk=data_cfg.topk,
            connect_all=data_cfg.connect_all,
            max_nR=data_cfg.max_nR,
        )
        self.dm = DynamicsModule(model, rcfg)
        gs_cfg = OnlineGSConfig()
        if gs_iters is not None:
            gs_cfg = gs_cfg._replace(num_iters=gs_iters)
        self.gs = OnlineGSTrainer(gs_cfg, seed=seed, device=self.device)
        self.assets = assets
        self.vis_cam_id = 0

    def reset(self, train_gs: bool = True):
        """Load the assets (or the synthetic scene) and fit the Gaussians;
        with ``train_gs`` False, show the cloud's Gaussians unfitted."""
        if self.assets:
            pts, cols, imgs, masks, R_list, t_list, intr_list = read_assets(self.assets)
            self.gs.update_state(pts, cols if cols is not None else
                                 np.full_like(pts, 0.5), imgs, masks,
                                 R_list, t_list, intr_list)
        else:
            self._synthetic_scene()
        if train_gs:
            print("fitting Gaussian scene ...")
            self.gs.train(progress=True)
        elif self.gs.params is None:
            self.gs.init_params()
        self._set_particles()

    def _set_particles(self):
        p = self.gs.params
        self.particle_pos = p.means3d[p.live > 0].cpu().numpy()
        self.mean_z = float(self.particle_pos[:, 2].mean())

    def _synthetic_scene(self):
        """A rope-like curve seen by the simulated environment's 4 cameras
        at 320x240, for a demo without assets."""
        from gsdx_torch.realworld.env import FakeEnv, FakeEnvConfig

        rng = np.random.default_rng(0)
        t = np.linspace(0, 1, 300)
        pts = np.stack([
            0.25 + 0.25 * t,
            0.05 + 0.12 * np.sin(4 * t),
            np.full_like(t, 0.01),
        ], axis=1).astype(np.float32)
        pts += rng.normal(scale=0.004, size=pts.shape).astype(np.float32)
        cols = np.stack([0.8 + 0 * t, 0.3 + 0.4 * t, 0.2 + 0 * t], 1).astype(
            np.float32)
        env = FakeEnv(pts, cols, FakeEnvConfig(n_cameras=4, width=320, height=240),
                      device=self.device)
        env.start()
        obs = env.get_obs()
        R_list, t_list = env.get_extrinsics()
        masks = [
            (np.abs(obs["color"][c].astype(np.float32)
                    - 255 * 0.7).max(-1) > 30).astype(np.float32)
            for c in range(4)
        ]
        imgs = [obs["color"][c].astype(np.float32) / 255.0 * masks[c][..., None]
                for c in range(4)]
        self.gs.update_state(pts, cols, imgs, masks, R_list, t_list,
                             env.get_intrinsics())
        env.stop()

    def run_sim(self, start_px, target_px, cam_id: int | None = None):
        """Clicks -> world push -> GNN rollout -> rendered frames. Returns
        (action (2, 3), rendervars, frames)."""
        cam_id = self.vis_cam_id if cam_id is None else cam_id
        intr = np.asarray(self.gs.metadata["k"][cam_id])
        extr = np.asarray(self.gs.metadata["w2c"][cam_id])
        start = click_to_xyz(*start_px, intr, extr, z=self.mean_z)
        end = click_to_xyz(*target_px, intr, extr, z=self.mean_z)
        action = np.stack([start, end])
        rendervars, _ = self.gs.rollout_and_render(self.dm, action)
        frames = self.render_rollout(rendervars, cam_id)
        return action, rendervars, frames

    def render_frames(self, rendervars, cam_id: int) -> list:
        """(H, W, 3) numpy frames of the rendervars from camera ``cam_id``,
        on a black background."""
        from gsdx_torch.io.video import chw_to_hwc

        return [chw_to_hwc(self.gs.render(rv, cam_id, bg=(0, 0, 0))[0].cpu().numpy())
                for rv in rendervars]

    def render_rollout(self, rendervars, cam_id: int) -> list:
        """Render the rollout from ``cam_id`` into `<out>/sim_cam{cam_id}`."""
        from gsdx_torch.io.video import write_video

        frames = self.render_frames(rendervars, cam_id)
        path = write_video(os.path.join(self.out_dir, f"sim_cam{cam_id}"), frames)
        print(f"wrote {path} ({len(frames)} frames)")
        return frames

    def export_splat(self, path: str | None = None) -> str:
        """The current scene's live Gaussians as a .splat file."""
        from gsdx_torch.io.episodes import save_to_splat

        p = self.gs.params
        live = (p.live > 0).cpu().numpy()
        path = path or os.path.join(self.out_dir, "gs.splat")
        save_to_splat(
            p.means3d.cpu().numpy()[live],
            p.rgb_colors.cpu().numpy()[live],
            np.exp(p.log_scales.cpu().numpy())[live],
            p.unnorm_rotations.cpu().numpy()[live],
            torch.sigmoid(p.logit_opacities).cpu().numpy()[live],
            path,
        )
        return path


def current_view(session: DemoSession) -> np.ndarray:
    """The fitted scene from the shown camera, (H, W, 3) in [0, 1]."""
    p = session.gs.params
    live = p.live > 0
    rv = {"means3D": p.means3d[live], "colors_precomp": p.rgb_colors[live],
          "rotations": p.unnorm_rotations[live],
          "opacities": torch.sigmoid(p.logit_opacities[live]),
          "scales": torch.exp(p.log_scales[live])}
    im, _ = session.gs.render(rv, session.vis_cam_id)
    return np.clip(im.cpu().numpy().transpose(1, 2, 0), 0, 1)


def run_gradio(session: DemoSession):
    """Click the push's start, then its target; the rollout's frames show
    in a gallery."""
    import gradio as gr

    state = {"clicks": []}
    session.reset(train_gs=True)

    def on_click(evt: "gr.SelectData"):
        state["clicks"].append((evt.index[0], evt.index[1]))
        if len(state["clicks"]) == 2:
            a, b = state["clicks"]
            state["clicks"] = []
            _, _, frames = session.run_sim(a, b)
            return frames
        return None

    with gr.Blocks() as app:
        img = gr.Image(current_view(session), label="click start then target")
        gallery = gr.Gallery(label="predicted rollout")
        img.select(on_click, outputs=[gallery])
    app.launch()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--epoch", default="latest")
    p.add_argument("--assets", default=None)
    p.add_argument("--clicks", default=None,
                   help="x1,y1,x2,y2 push start/target pixels (headless mode)")
    p.add_argument("--cam", type=int, default=0)
    p.add_argument("--out", default="out/demo")
    p.add_argument("--gs_iters", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    session = DemoSession(args.config, args.epoch, args.assets, args.out,
                          gs_iters=args.gs_iters, device=args.device)
    session.vis_cam_id = args.cam

    try:
        import gradio  # noqa: F401

        has_gradio = args.clicks is None
    except ImportError:
        has_gradio = False

    if has_gradio:
        run_gradio(session)
    else:
        session.reset(train_gs=True)
        if args.clicks:
            x1, y1, x2, y2 = (float(v) for v in args.clicks.split(","))
            session.run_sim((x1, y1), (x2, y2))
        session.export_splat()


if __name__ == "__main__":
    main()
