"""Sim-real app: perceive -> Gaussian fit -> click a push -> simulate ->
run real (counterpart of `gsdx/apps/sim_real_app.py`).

Live perception from the environment's cameras, the online Gaussian fit,
a clicked push (start and target) in a camera view, the GNN rollout
rendered as PNG frames (`<out>/sim_cam{c}/`), then optionally the push
executed on the environment and the scene re-perceived. ``--save-for-demo``
captures the asset bundle `apps.demo --assets` loads: pcd.ply,
img_{v}.png, mask_{v}.png, R/t/intr .npy, gs_orig.splat, and per push
video_{v}/ frame directories (gsdx writes video_{v}.mp4), gs_pred.splat and
action.npy. The PNGs are written by the port's own encoder.

Runs as a gradio app when gradio is importable and no clicks are given;
otherwise headless:

    python -m gsdx_torch.apps.sim_real_app --config configs/rope.yaml \\
        --env fake --clicks x1,y1,x2,y2 [--run-real] [--save-for-demo] \\
        [--device cuda]

``--env real`` needs the port of the hardware stack (cameras, robot,
calibration: the hardware-stack item of ROADMAP.md's first queue) and is
refused.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from gsdx_torch.apps.demo import DemoSession


class SimRealSession(DemoSession):
    """A demo session on an environment: live perception (`reset`), real
    execution (`run_real`) and the demo-asset capture (``save_dir``)."""

    def __init__(self, config_path: str, env, epoch: str = "latest",
                 out_dir: str = "out/sim_real", gs_iters: int | None = None,
                 save_dir: str | None = None, prompt: str = "object",
                 seed: int = 0, segmenter=None, device="cuda"):
        super().__init__(config_path, epoch, assets=None, out_dir=out_dir,
                         gs_iters=gs_iters, seed=seed, device=device)
        from gsdx_torch.realworld.perception import PerceptionModule

        self.env = env
        self.pm = PerceptionModule(segmenter=segmenter, device=self.device)
        self.save_dir = save_dir
        self.prompt = prompt
        self.actions = None  # the last simulated push, (2, 3) world coords
        self.obj_dir = None
        self.action_dir = None

    def reset(self, train_gs: bool = True):
        """Perceive from the environment's cameras and (re)fit the Gaussian
        scene; with ``train_gs`` False keep the fitted scene."""
        pts, cols, imgs, masks = self.pm.get_tabletop_points_env(
            self.env, prompt=self.prompt, return_imgs=True)
        if len(pts) == 0:
            raise RuntimeError("perception returned no object points")
        R_list, t_list = self.env.get_extrinsics()
        intr = self.env.get_intrinsics()
        self.imgs, self.masks = imgs, masks
        imgs_f = [im.astype(np.float32) / 255.0 * m[..., None]
                  for im, m in zip(imgs, masks)]
        masks_f = [m.astype(np.float32) for m in masks]
        self.gs.update_state(pts, cols, imgs_f, masks_f, R_list, t_list, intr)
        if train_gs:
            print("fitting Gaussian scene ...")
            self.gs.train(progress=True)
            self.actions = None
        self._set_particles()
        if train_gs and self.save_dir:
            self.obj_dir = self._save_obj_assets(pts, cols, imgs, masks,
                                                 R_list, t_list, intr)

    def _save_obj_assets(self, pts, cols, imgs, masks, R_list, t_list, intr):
        """Write the demo-asset bundle under ``save_dir``/obj_<time>."""
        from gsdx_torch.io.ply import save_ply
        from gsdx_torch.io.video import write_image

        obj_dir = os.path.join(self.save_dir, f"obj_{time.time():.0f}")
        os.makedirs(obj_dir, exist_ok=True)
        save_ply(os.path.join(obj_dir, "pcd.ply"), pts, cols)
        for v, (im, m) in enumerate(zip(imgs, masks)):
            write_image(os.path.join(obj_dir, f"img_{v}.png"), im.astype(np.uint8))
            write_image(os.path.join(obj_dir, f"mask_{v}.png"),
                        m.astype(np.uint8) * 255)
        np.save(os.path.join(obj_dir, "R_list.npy"), np.stack(R_list))
        np.save(os.path.join(obj_dir, "t_list.npy"), np.stack(t_list))
        np.save(os.path.join(obj_dir, "intr_list.npy"), np.stack(intr))
        self.export_splat(os.path.join(obj_dir, "gs_orig.splat"))
        print(f"saved demo assets to {obj_dir}")
        return obj_dir

    def run_sim(self, start_px, target_px, cam_id: int | None = None):
        """Clicks -> world push -> GNN rollout -> rendered frames; keeps the
        action for `run_real`, and when saving for the demo renders every
        view of the rollout into the bundle."""
        action, rendervars, frames = super().run_sim(start_px, target_px, cam_id)
        self.actions = action
        self.particle_pos = np.asarray(rendervars[-1]["means3D"])
        if self.save_dir and self.obj_dir:
            from gsdx_torch.io.video import write_video

            self.action_dir = os.path.join(self.obj_dir, f"action_{time.time():.0f}")
            os.makedirs(self.action_dir, exist_ok=True)
            for v in range(len(self.gs.metadata["k"])):
                write_video(os.path.join(self.action_dir, f"video_{v}"),
                            self.render_frames(rendervars, v))
            self.export_splat(os.path.join(self.action_dir, "gs_pred.splat"))
            np.save(os.path.join(self.action_dir, "action.npy"), action)
        return action, rendervars, frames

    def run_real(self) -> bool:
        """Execute the last simulated push on the environment and
        re-perceive (fresh images, the fitted scene kept)."""
        if self.actions is None:
            print("no planned action; click/run sim first")
            return False
        a = self.actions
        self.env.step(np.array([a[0, 0], a[0, 1], a[1, 0], a[1, 1]], np.float32))
        self.reset(train_gs=False)
        return True

    def switch_view(self) -> int:
        """Show the next camera."""
        self.vis_cam_id = (self.vis_cam_id + 1) % len(self.gs.metadata["k"])
        return self.vis_cam_id


def run_gradio(session: SimRealSession):
    """Click a push's start and target -> the rollout's frames; Run real;
    Reset; Switch view."""
    import gradio as gr

    state = {"clicks": []}
    session.reset(train_gs=True)

    def camera_image():
        return np.clip(session.imgs[session.vis_cam_id].astype(np.float32) / 255.0, 0, 1)

    def on_click(evt: "gr.SelectData"):
        state["clicks"].append((evt.index[0], evt.index[1]))
        if len(state["clicks"]) == 2:
            a, b = state["clicks"]
            state["clicks"] = []
            return session.run_sim(a, b)[2]
        return None

    def on_run_real():
        session.run_real()
        return camera_image()

    def on_reset():
        session.reset(train_gs=True)
        return camera_image()

    def on_switch():
        session.switch_view()
        return camera_image()

    with gr.Blocks() as app:
        img = gr.Image(camera_image(), label="click push start then target")
        gallery = gr.Gallery(label="predicted rollout")
        with gr.Row():
            real_btn = gr.Button("Run real")
            reset_btn = gr.Button("Reset")
            switch_btn = gr.Button("Switch view")
        img.select(on_click, outputs=[gallery])
        real_btn.click(on_run_real, outputs=[img])
        reset_btn.click(on_reset, outputs=[img])
        switch_btn.click(on_switch, outputs=[img])
    app.launch()


def rope_points(seed: int = 0):
    """(points, colours) of a 300-point rope: a sine curve 25 cm long on
    the table, 4 mm of noise, one colour."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, 300)
    pts = np.stack([0.25 + 0.25 * t, 0.05 + 0.1 * np.sin(4 * t),
                    np.full_like(t, 0.01)], 1).astype(np.float32)
    pts += rng.normal(scale=0.004, size=pts.shape).astype(np.float32)
    cols = np.tile(np.array([0.85, 0.3, 0.15], np.float32), (300, 1))
    return pts, cols


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--epoch", default="latest")
    p.add_argument("--env", default="fake", choices=["fake", "real"])
    p.add_argument("--out", default="out/sim_real")
    p.add_argument("--gs_iters", type=int, default=None)
    p.add_argument("--clicks", default=None,
                   help="x1,y1,x2,y2 push pixels (headless mode)")
    p.add_argument("--cam", type=int, default=0)
    p.add_argument("--run-real", action="store_true",
                   help="execute the simulated push on the env afterwards")
    p.add_argument("--save-for-demo", action="store_true")
    p.add_argument("--prompt", default="object")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from gsdx_torch.core.device import require_device
    from gsdx_torch.realworld.env import FakeEnv

    if args.env == "real":
        raise NotImplementedError(
            "--env real needs the cameras, robot and calibration of realworld/ "
            "(the hardware stack, ROADMAP.md's first queue), which are not "
            "ported yet; use --env fake")
    device = require_device(args.device)
    env = FakeEnv(*rope_points(args.seed), device=device)
    env.start()
    try:
        session = SimRealSession(
            args.config, env, epoch=args.epoch, out_dir=args.out,
            gs_iters=args.gs_iters,
            save_dir=os.path.join(args.out, "demo_assets")
            if args.save_for_demo else None,
            prompt=args.prompt, seed=args.seed, device=device,
        )
        session.vis_cam_id = args.cam

        headless = args.clicks is not None
        if not headless:
            try:
                import gradio  # noqa: F401
            except ImportError:
                print("gradio unavailable; need --clicks for headless mode")
                return
        if headless:
            session.reset(train_gs=True)
            x1, y1, x2, y2 = (float(v) for v in args.clicks.split(","))
            session.run_sim((x1, y1), (x2, y2))
            if args.run_real:
                session.run_real()
        else:
            run_gradio(session)
    finally:
        env.stop()


if __name__ == "__main__":
    main()
