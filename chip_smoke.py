"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. card + build: the card's name and power limit; nvcc builds the
     compositor, GNN, GNN GEMM, probe and FPS kernel libraries from
     gsdx_torch/csrc, in parallel; each kernel's registers and spills (a
     compositor, GEMM, message or FPS kernel that spills fails), and `cuobjdump
     -sass` must find HGMMA (wgmma) instructions in each of the GEMM's three
     instantiations (128 and 256 wide, 128 with residuals), and MUFU
     instructions in the transcendental variant of the hot-loop probe
     (kernel #4) and none in its polynomial variant; the probe's loop body
     counted a pair by pipe (FP32, ALU, MUFU, all: `hot_loop_pipes`).
  2. kernels: each compositor variant (forward, forward with presort,
     backward, backward with presort) against its plain PyTorch version on
     real 720p tile inputs (8192 and 16384 Gaussians, and a saturating
     scene), with the non-empty tiles, the share of (splat, warp patch)
     pairs that `alpha_cut_box` keeps, the cluster size and blocks read back
     from the launch (clusters of >= 2 blocks required), a backward run
     twice that must be bit-equal, a single call's median ms (the launch
     gap included, as PRs 1-3 timed it) and the kernel's device ms a call
     from `torch.profiler`, and the card's bound for the visible pairs'
     work and the bytes the function needs, beside a bound that charges
     every processed pair its falloff; every forward check also holds each
     final log T within LOGT_TOL (1e-3, under one alpha-cut step); the four
     variants on tools/cut_stress.py's inputs (`cut_stress` rows: thousands
     of alphas within a few ulps of the 1/255 cut, at the slice and online
     shapes), with the tiles whose outputs differ; the GNN GEMM at the forward's
     product shapes (`w2r` 63,000 x 512 x 512, `w2p` 16,000 x 512, `wt_rs`
     16,000 x 1024, the head 16,000 x 8, the residual `wp1` 16,000 x 512)
     against its plain version and `torch.matmul` (a call back to back and
     its device ms), its grid read back from the launch (persistent: min(SMs,
     tiles)); the receiver segments and one message round at the rope
     chunk's slots, receiver-major and permuted, equal and bit-equal to
     their plain versions; the fused GNN forward against its plain version at
     rope width (125 samples, 128 node slots, 504 edge slots; trained
     weights, edges of the committed trajectory) and cloth width (256 /
     1200, random init), with its index check on the host, on the device
     (an error word, bit-equal to the host-checked forward) and without it; CUDA-event
     times and the card's lower bound for the same work.
  3. rasterize: fwd+bwd Mpix/s at 5k, 16k and 65k Gaussians, 720p.
  4. slice: `track_sequence` at 4 cameras, 720p, capacity 8192: t=0 with
     clone/split/prune on a shortened schedule, then t=1 with frozen bins
     and the presorting compositor; the launch counters of every compositor
     variant must be > 0 for this run.
  5. plan: one MPPI `trajectory_optimization` at rope width (trained
     weights, 100 particles, max_nR 500, 1000 samples, 8 repeat-sorted
     chunks), cut in depth to 2 update iterations; the GNN kernels' launch
     counters must be > 0 for this run, with 15 GEMMs, 3 node-input layers,
     1 edge layer, 1 segments launch and 3 message rounds a forward; the
     fused rollout against the module rollout on 16 samples; device ms by
     GNN kernel of one MPPI iteration.
  6. learn: in a temporary copy of the committed tracked rope episode
     (benchmarks/out/pipeline), `preprocess_episode` with its settings
     (dist 0.005, n_his 3, n_future 3, 1000 particles): the frame pairs must
     equal the committed ones gsdx wrote, and the downsampled trajectory's
     difference from the committed one is reported; then 20 train steps of
     configs/rope.yaml at full width (nf 512, batch 16, n_future 5, max_nobj
     100, max_nR 500) from a seeded init: finite losses whose last 5 average
     below the first 5; batch assembly and train step ms (CUDA events),
     samples/s. The FPS kernels' launch counters (preprocessing, then the
     sampler's two FPS a batch) must be > 0 for this run, and the
     downsampled trajectory (the kernel's picks) must equal the committed
     one.
  7. predict: `collect_scene_data` on the committed 16-frame episode with
     the trained rope checkpoint, then 4 cameras x 16 frames re-rendered at
     1280x720 under inference mode; the compositor forward's launch counter
     and the FPS kernels' (the rollout's) must be > 0 for this run. Kernel
     #1 against its plain version on camera 0's tile inputs of a frame of
     the push (n_accum 4); one rollout step on
     the card against the same step on the CPU (1e-4 m), the whole
     trajectory's difference reported; rank-deficient Kabsch bones; the
     PSNR of every re-rendered frame against a render of the tracked frame,
     Chamfer distances against the tracked trajectory; rollout step ms,
     frame ms and frames/s.
  8. plan_gd: the GD planner at rope width (trained weights, 100
     particles, max_nR 500) once: 32 samples of a uniform draw in the
     rope's extent, 10 Adam steps on one chunk; its seconds, its best
     reward and its draw's.
  9. online: the demo apps' live loop at the RealSense stream size:
     `FakeEnv` with a 300-point rope at 4 cameras x 640x480 ->
     `PerceptionModule.get_tabletop_points_env(return_imgs=True)` ->
     `OnlineGSTrainer.update_state` -> `train` for 700 iterations
     (densification at 500 and 600; gsdx's 10,000 cut in depth) ->
     `rollout_and_render` under a 12 cm push through the object's centre
     with the trained rope model -> every rollout frame at the 4 cameras.
     The compositor's forward and backward launch counters must be > 0, and
     the FPS kernels' around the rollout, the last 20 iterations' PSNR
     above the first 20's; kernels #1 and #2
     against their plain versions on camera 0's tile inputs of the fitted
     scene (n_accum 7, `online_kernel`); the first rollout step on the card
     within 1e-4 m of the CPU's; fit iterations/s, the projected
     10,000-iteration fit, rollout seconds, rendered frames/s. Kernel #1's
     checks (here and in `predict_kernel`) print where its output differs
     most from the plain version's, and whether that tile walked its whole
     list.
 10. profile: `torch.profiler` breakdown of a 5k rasterize fwd+bwd, of one
     tracking iteration, of one MPPI iteration, of one rope-width train
     iteration, of one predict step (a rollout step and 4 renders) and of
     one online fit iteration: device time by kernel, the compositor
     kernels' device ms, device idle share.
 11. cli: `python -m gsdx_torch.apps.track` on a small synthetic episode,
     `python -m gsdx_torch.apps.plan --env fake` on the committed rope
     checkpoint, and `apps.preprocess`, `apps.train` (1 epoch of 5 train and
     2 valid iterations) and `apps.predict` (4 steps, 1 camera) on a
     temporary two-episode tree from a temporary working directory, and
     `apps.train --dp` under torchrun (one rank, NCCL; 1 epoch of 5
     iterations), whose latest.ckpt must load; then
     `apps.sim_real` (1 trial), `apps.sim_real_app` (clicks, run real, save
     for the demo) and `apps.demo --assets` on the captured bundle, 60 fit
     iterations each: frame directories, the .splat files and the bundle
     must exist, and the demo must have read the bundle's PNGs with the
     port's `read_png`.

 12. probes: kernel #5 (`dynamic_roll`) bit-equal to `torch.roll` at shifts
     0, 3, 130, 511, -1 and 515, its call back to back (allocating its
     output, and into the caller's) against `torch.roll`'s (in turns, 5
     rounds), and its bound: the larger of its bytes'
     time and the launch floor, the device time of a kernel that does
     nothing launched by the same ctypes path; kernel #4
     (`composite_hot_loop`) at the TPU probe's shape (T 128, K 512, sub 64
     and 128), both variants, against its plain version within
     tests/test_torch_probes.py's tolerance; then the probe paths with the
     launch counters at 0: tools/dynamic_roll_probe.py and
     tools/transcendental_probe.py's A/B (us a granule, the transcendental
     share, each variant's bound: the operations a pair its function needs,
     counted from the probe's source pipe by pipe, and its bytes; beside
     it, a diagnostic, the bound of its loop's own SASS by pipe and by
     issue slot).
 13. reference: `rasterize` against the dense `render_reference` on a
     120-Gaussian 40x64 scene (values and gradients).
 14. masks: `python -m gsdx_torch.apps.masks` obtain, merge, initpcd and
     metadata on a synthetic 4-camera 1280x720 3-frame episode (8-bit
     colour, 16-bit depth, written by the port's PNG writer); the card's
     initial cloud must be the CPU's within 1e-6 m.
 15. real_env: `apps/plan.py` `main --env real --cameras synthetic:4
     --robot_ip fake` at rope width (trained weights, 1000 samples, 2
     actions of 1 chunk) on static 640x480 views of a patch on the table:
     capture processes -> ring buffers -> `RealEnv.get_obs` -> perception
     -> MPPI through the fused GNN kernel (launches > 0) -> `RealEnv.step`
     (2 calls) -> `FakeArm`; the camera processes joined after `stop`;
     each action's seconds by stage and each camera's put rate.
 16. dist (after the CLIs): `gsdx_torch.dist` in spawned worlds, each joined
     within DIST_TIMEOUT. A world of one on NCCL: one DP train step at rope
     width (batch 16) against the single-device step from the same init
     (every param within 1e-6), `sharded_composite` against `_Composite`
     bit for bit, and each step's ms (DDP's overhead). Two gloo ranks sharing
     cuda:0 (NCCL refuses two ranks on one device): the DP step (8 a rank)
     against the single step (loss rtol 1e-5, gradients REL_TOL, params 1e-5
     but the entries whose two gradients alone move them further through
     Adam's first step, counted and printed); `sharded_composite` on
     the 8192-Gaussian 720p tile inputs with and without presort, forward
     and backward, bit-equal to the unsharded kernels and, on the rank's
     rows, within REL_TOL of the plain version with the same tile ids;
     `make_sharded_tracking_step` at 4 cameras x 1280x720, capacity 8192,
     t=0 and t=1, within REL_TOL of the mean of the single-device
     per-camera loss and gradient; one sample-sharded MPPI iteration at rope
     width (1000 samples, 500 a rank) on one injected draw against the
     unsharded planner (act_seq 1e-5, best reward rtol 1e-5). Each rank's
     compositor (#1, #1p, #2, #2p) and GNN launches, counted around the
     sharded calls alone (set to 0 just before each, read just after,
     before its unsharded reference), must be > 0; the gloo ranks' times
     are labelled as two ranks sharing one card.
 17. fps (after probes): the FPS kernel (csrc/fps.cu) and its radius-
     stopping form against their plain versions on the same CUDA tensors,
     index for index and keep flag for keep flag, at the rope sampler's
     shapes (16 x 1000 x 3 -> 100 from per-row starts, then 16 x 100 -> 100
     with per-row radii), the cloth sampler's (batch 64, max_nobj 150), a
     rollout step's (1000 -> 100, then the radius FPS), the rollout's proxy
     (predict's Gaussians -> 1000), a row at the largest P (65,536: a
     cluster of 8 blocks, read back from the launch), the 4-D action grid
     at grid_size 0.02 (50,625 points, dense ties; `sample_action_seq_fps`
     on the card equals it) and masked rows with more samples than valid
     points; each shape's call ms, device ms, the plain version's ms, the
     latency floor (the same launch with no distances) and the bytes and
     operations bounds.

Then each phase's seconds; the run fails if it wrote into the checkout.
Before the result, every process the run left (multiprocessing's resource
tracker, which `real_env`'s shared memory and the `dist` phase's spawned
ranks start, a rank left by a failed world, and any orphan, since the script
makes itself their subreaper) is stopped and reaped, and listed in a
`processes` line; after a failure too.
The line before the last holds the kernel table; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero with no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

H, W = 720, 1280
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BF16_FLOP_S = 989e12  # H100 SXM bf16 tensor cores, dense
MUFU_PER_SM_CLK = 16
SMS = 132
REL_TOL = 1e-4  # allclose(rtol, atol) for kernel vs plain, f32 sums in another order
# max |kernel - plain| of a final log T: under one step of the alpha cut,
# log1p(-1/255) = -0.003929, which REL_TOL misses wherever |log T| > 38
LOGT_TOL = 1e-3


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_info() -> dict:
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"nvidia_smi": q, "max_sm_mhz": float(clk)}


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median per-call time of ``fn`` in ms from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_device_ms(fn, pattern: str, calls: int = 30, warmup: int = 3) -> float:
    """Device time a call of ``fn`` in ms, of the kernels whose name matches
    ``pattern``, from `torch.profiler` over ``calls`` calls: the kernel's own
    time, whatever the host's launch work costs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a session may miss some kernels: 1-2 of 30 in every session of the
    # predict phase in some runs, a third of them once (in
    # tools/transcendental_probe.py), all of them once in some 250 sessions
    # of tools/composite_ablation.py. The time a call is the mean of the
    # kernels seen, times the kernels a call; a session that missed more
    # than a fifth is taken again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and re.search(pattern, e.key)]
        n = sum(e.count for e in seen)
        per_call = max(1, round(n / calls))
        if n >= 0.8 * per_call * calls:
            return sum(e.self_device_time_total for e in seen) / 1e3 / n * per_call
    raise AssertionError(f"the profiler saw {n} kernels matching {pattern!r} in "
                         f"{calls} calls in the last of 3 sessions")


def cuda_ms_back_to_back(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls queued back to
    back between two CUDA events: the device's time per call, with the
    host's launch work hidden behind it (for kernels shorter than a launch)."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def scene(rng, n, n_chan=3, device="cuda", scale=(0.005, 0.02)):
    """Random Gaussians in front of an identity camera (bench.py's scene;
    larger ``scale`` makes splats blanket the tiles so the early stop fires)."""
    means = rng.uniform(-0.8, 0.8, size=(n, 3)).astype(np.float32)
    means[:, 2] = means[:, 2] * 0.5 + 3.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(*scale, size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, size=(n, 1)).astype(np.float32)
    colors = rng.uniform(0, 1, size=(n, n_chan)).astype(np.float32)
    return [torch.as_tensor(x, device=device)
            for x in (means, quats, scales, opac, colors)]


def camera(device="cuda", cam_id=0, w2c=None):
    from gsdx_torch.core.cameras import make_camera

    k = np.array([[600.0, 0, W / 2], [0, 600.0, H / 2], [0, 0, 1]], np.float32)
    return make_camera(k, np.eye(4, dtype=np.float32) if w2c is None else w2c,
                       width=W, height=H, bg=(0.7, 0.7, 0.7), cam_id=cam_id,
                       device=device)


def tile_inputs(n: int, original_order: bool, saturating: bool = False,
                tile_h: int = 0):
    """Tile features of an n-Gaussian 720p scene with 6 colour channels,
    projected and binned by the port as `rasterize` does (``tile_h`` 0:
    `rasterize`'s choice for n)."""
    from gsdx_torch.kernels.composite import FEAT_DIM
    from gsdx_torch.render.binning import bin_gaussians
    from gsdx_torch.render.projection import project_gaussians
    from gsdx_torch.render.rasterize import (
        RasterizeConfig, resolve_binning, tile_grid)

    means, quats, scales, opac, colors = scene(
        np.random.default_rng(0), n, n_chan=6,
        scale=(0.05, 0.15) if saturating else (0.005, 0.02))
    cam = camera()
    cfg = resolve_binning(RasterizeConfig(tile_h=tile_h), n)
    grid = tile_grid(cam, cfg)
    proj = project_gaussians(means, quats, scales, cam)
    bins = bin_gaussians(proj.mean2d, proj.radius, proj.depth, proj.mask, grid,
                         cfg.max_per_tile, cfg.max_dup,
                         original_order=original_order)
    feats = torch.cat([proj.mean2d, proj.conic, opac * proj.mask[:, None],
                       colors, proj.depth[:, None],
                       torch.zeros(n, FEAT_DIM - 13, device="cuda")], 1)
    tf = feats[bins.gauss_idx].transpose(1, 2).contiguous()
    geo = dict(tiles_x=grid.tiles_x, tile_h=grid.tile_h, tile_w=grid.tile_w,
               n_accum=7, sub_chunk=cfg.sub_chunk)
    return tf, bins.counts, geo


def pair_counts(tf, counts, nproc, geo) -> dict:
    """(splat, pixel) pairs of the processed prefixes: `processed` = sum over
    tiles of min(count, nproc * sub) * P; `visible` = those whose alpha
    passes the 1/255 cut; `in_box` = those inside the splat's alpha-cut box
    (`alpha_cut_box`); `visible_outside_box` = visible pairs outside it,
    which a conservative box never has. And (splat, warp patch) pairs: `patch_pairs` of the
    processed prefixes, `patch_kept` = those whose box touches the patch,
    the splats the kernels' warps evaluate."""
    from gsdx_torch.kernels.composite import (
        ALPHA_MAX, ALPHA_MIN, KERNEL_PATCH_H, KERNEL_PATCH_W, _pixel_coords,
        alpha_cut_box)

    sub, P = geo["sub_chunk"], geo["tile_h"] * geo["tile_w"]
    tiles_x, tile_h, tile_w = geo["tiles_x"], geo["tile_h"], geo["tile_w"]
    patch_w = KERNEL_PATCH_W
    n_patches = P // (KERNEL_PATCH_H * patch_w)
    ceff = torch.minimum(counts.long(), nproc.long() * sub)
    out = {"processed": int(ceff.sum()) * P, "visible": 0, "in_box": 0,
           "visible_outside_box": 0,
           "patch_pairs": int(ceff.sum()) * n_patches, "patch_kept": 0}
    with torch.no_grad():
        for b0 in range(0, tf.shape[0], 16):
            cf, ce = tf[b0:b0 + 16], ceff[b0:b0 + 16]
            kb = max(1, int(ce.max()))
            cf = cf[:, :, :kb]
            tiles = torch.arange(b0, b0 + cf.shape[0], device=tf.device)
            px, py = _pixel_coords(tiles, tiles_x, tile_h, tile_w)
            dx = px[:, None, :] - cf[:, 0, :, None]
            dy = py[:, None, :] - cf[:, 1, :, None]
            power = (-0.5 * (cf[:, 2, :, None] * dx * dx + cf[:, 4, :, None] * dy * dy)
                     - cf[:, 3, :, None] * dx * dy)
            a = torch.clamp(cf[:, 5, :, None] * torch.exp(power), max=ALPHA_MAX)
            slot = torch.arange(kb, device=tf.device)[None, :, None]
            live = slot < ce[:, None, None]
            visible = (power <= 0) & (a >= ALPHA_MIN) & live
            out["visible"] += int(visible.sum())
            x0, x1, y0, y1 = (b[:, :, None] for b in alpha_cut_box(cf))
            # a NaN edge is inside, as the kernels' test has it
            inside = ~((x1 < px[:, None]) | (x0 > px[:, None])
                       | (y1 < py[:, None]) | (y0 > py[:, None]))
            out["in_box"] += int((inside & live).sum())
            out["visible_outside_box"] += int((visible & ~inside).sum())
            # the patches' origins, row-major
            q = torch.arange(n_patches, device=tf.device)
            per_row = tile_w // patch_w
            ox = ((tiles % tiles_x) * tile_w)[:, None] + (q % per_row) * patch_w
            oy = ((tiles // tiles_x) * tile_h)[:, None] + (q // per_row) * KERNEL_PATCH_H
            ox, oy = ox[:, None].float(), oy[:, None].float()
            hits = ~((x1 < ox) | (x0 > ox + patch_w - 1)
                     | (y1 < oy) | (y0 > oy + KERNEL_PATCH_H - 1))
            out["patch_kept"] += int((hits & live).sum())
    return out


def needed_bytes(counts, nproc, geo, K: int, presort: bool) -> tuple[int, int]:
    """Bytes the forward and the backward must move: each input they need
    read once, each output written once. The forward reads the 6 + n_accum
    rows of its processed prefix's columns (with presort, all 16 x K of a
    non-empty tile, which `sorted_feats` holds) and writes its outputs
    dense; the backward reads the prefix's rows, its rank entries and the
    pixel inputs of the tiles that have a prefix, and writes the dense
    gradient."""
    nacc, sub = geo["n_accum"], geo["sub_chunk"]
    T = counts.shape[0]
    P = geo["tile_h"] * geo["tile_w"]
    ceff = torch.minimum(counts.long(), nproc.long() * sub)
    cols, live = int(ceff.sum()), int((ceff > 0).sum())
    nrow = 6 + nacc
    feats_f = live * 16 * K if presort else nrow * cols
    fwd = 4 * (T + feats_f                              # counts, features
               + T * (nacc + 1) * P + T                 # accum, logt, nproc
               + (T * 17 * K if presort else 0))        # rank, sorted_feats
    bwd = 4 * (2 * T + nrow * cols                      # counts, nproc, features
               + (cols if presort else 0)               # rank
               + live * (nacc + 2) * P                  # logt, g_accum, g_logt
               + T * 16 * K)                            # gradient
    return fwd, bwd


def bound_ms(bytes_moved, flops, mufu, clk_mhz) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_S
    t_ops = max(flops / PEAK_F32_FLOP_S,
                mufu / (SMS * MUFU_PER_SM_CLK * clk_mhz * 1e6))
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# Arithmetic per (splat, pixel) pair, counted from csrc/composite.cu. The
# work the function needs is that of the visible pairs: the falloff (power:
# 8 flops, exp: 1 MUFU), then forward: alpha, w, log T and 2 flops per
# channel plus log1p and exp (2 MUFU); backward: those plus dL/dw, dalpha,
# the six geometry terms and 4 flops per channel, and a division (3 MUFU).
# A bound that also charges the falloff to every processed pair, which a
# culling kernel no longer evaluates, is printed beside it as
# `bound_ms_processed_pairs`.
FLOPS_ALL = 8
FWD_FLOPS_VIS = lambda nacc: 6 + 2 * nacc  # noqa: E731
BWD_FLOPS_VIS = lambda nacc: 30 + 4 * nacc  # noqa: E731


def cuobjdump() -> str:
    """The toolkit's cuobjdump, or the copy Triton's package carries."""
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(found):
        try:
            import triton
            found = os.path.join(os.path.dirname(triton.__file__),
                                 "backends/nvidia/bin/cuobjdump")
        except ImportError:
            pass
    if not os.path.exists(found):
        raise RuntimeError("cuobjdump not found: cannot check the GEMM's SASS")
    return found


def ptxas_report(logs) -> dict:
    """Registers and spill bytes of each kernel, from `nvcc -Xptxas -v`."""
    report, name = {}, None
    for ln in "\n".join(logs).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = next((k for k in ("gnn_gemm", "gnn_linear", "gnn_edge_first",
                                     "gnn_segments", "gnn_message", "fwd", "bwd")
                         if re.search(rf"\d{k}_kernel", m.group(1))), m.group(1))
            gemm = re.search(r"gnn_gemm_kernelILi(\d+)ELb([01])E", m.group(1))
            if gemm:  # one entry per tile width, and the residual epilogue's
                name = f"gnn_gemm_bn{gemm.group(1)}{'_res' if gemm.group(2) == '1' else ''}"
            probe = re.search(r"hot_loop_kernelILb([01])ELi(\d+)E", m.group(1))
            if probe:
                name = f"hot_loop_{'transcend' if probe.group(1) == '1' else 'poly'}_{probe.group(2)}"
            elif "roll_kernel" in m.group(1):
                name = "dynamic_roll"
            fps = re.search(r"fps_kernelILi(\d+)ELi(\d+)E", m.group(1))
            if fps:  # one entry per (coordinates, points a thread)
                name = f"fps_d{fps.group(1)}_ppt{fps.group(2)}"
            edges = re.search(r"edges_kernelILi(\d+)E", m.group(1))
            if edges:  # one entry per 32-column words of a row
                name = f"edges_w{edges.group(1)}"
            if name in ("fwd", "bwd"):  # one entry per n_accum instantiation
                nacc = re.search(rf"{name}_kernelILi(\d+)E", m.group(1))
                name = f"composite_{name}_nacc{nacc.group(1) if nacc else '?'}"
            report.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            report[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            report[name]["registers"] = int(m.group(1))
    return report


def sass_functions(path) -> dict:
    """Each kernel function's SASS in the library at ``path``, by mangled name."""
    sass = subprocess.run([cuobjdump(), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    return {part.splitlines()[0].strip(): part for part in sass.split("Function : ")[1:]}


def mufu_counts(path) -> dict:
    """MUFU instructions (all, EX2, LG2) in each instantiation of the hot-loop
    probe, keyed "transcend_<sub>" / "poly_<sub>". The polynomial variant
    must hold none and the transcendental one some, or the compiler has
    folded one variant into the other."""
    out = {}
    for name, part in sass_functions(path).items():
        m = re.search(r"hot_loop_kernelILb([01])ELi(\d+)E", name)
        if m:
            out[f"{'transcend' if m.group(1) == '1' else 'poly'}_{m.group(2)}"] = {
                "MUFU": part.count("MUFU."), "MUFU.EX2": part.count("MUFU.EX2"),
                "MUFU.LG2": part.count("MUFU.LG2")}
    if sorted(out) != ["poly_128", "poly_64", "transcend_128", "transcend_64"]:
        raise AssertionError(f"hot-loop instantiations in the SASS: {sorted(out)}")
    for k, v in out.items():
        if k.startswith("poly") and v["MUFU"]:
            raise AssertionError(f"the polynomial variant {k} holds MUFU instructions: {v}")
        if k.startswith("transcend") and not v["MUFU.EX2"] + v["MUFU.LG2"]:
            raise AssertionError(f"the transcendental variant {k} holds no MUFU.EX2/LG2: {v}")
    return out


# SASS opcodes by the pipe that runs them, with its lanes an SM a clock on
# Hopper (CUDA C++ Programming Guide, throughput of native arithmetic
# instructions, compute capability 9.0): FP32 add, multiply and
# multiply-add 128; integer, compare, min/max, select, shift and logical 64;
# MUFU (exp2, log2, rcp, ...) and type conversions 16. Every other
# instruction (loads, stores, moves, branches, shuffles) only takes an issue
# slot: 4 warp-instructions a clock, 128 lanes.
PIPE_LANES = {"fp32": 128, "alu": 64, "mufu": 16}
FP32_OPS = {"FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I"}
MUFU_OPS = {"MUFU", "I2F", "F2I", "F2F", "FRND"}
ALU_OPS = {"FSETP", "FSEL", "FMNMX", "FSET", "ISETP", "IADD3", "IMAD", "LOP3", "SHF", "SEL",
           "LEA", "IMNMX", "IABS", "PRMT", "PLOP3", "FCHK", "I2FP", "F2IP", "VIMNMX", "IADD",
           "IMUL", "LOP", "SHL", "SHR", "BMSK", "FLO", "POPC", "BREV"}
ISSUE_LANES = 128


def sass_loop_pipes(part: str) -> dict:
    """Instructions by pipe in the innermost loop of one function's SASS
    (``part``, as `sass_functions` splits it) that holds the most
    instructions: counts for "fp32", "alu", "mufu" (MUFU.EX2 and MUFU.LG2
    also apart), "other", and "issue" (all but NOP)."""
    insts, labels, pending = [], {}, []
    for ln in part.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", ln)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        insts.append((addr, re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())))
    loops = {}
    for addr, text in insts:
        if not text.startswith("BRA"):
            continue
        m = re.search(r"`\((\.L_x_\d+)\)|(0x[0-9a-f]+)", text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is not None and target <= addr:
            loops[target] = max(loops.get(target, addr), addr)
    spans = sorted(loops.items())
    inner = [(a, b) for a, b in spans
             if not any((c, d) != (a, b) and a <= c and d <= b for c, d in spans)]
    if not inner:
        raise AssertionError("no loop in the SASS")
    body = max(([t for addr, t in insts if a <= addr <= b] for a, b in inner), key=len)
    out = {"fp32": 0, "alu": 0, "mufu": 0, "other": 0, "issue": 0,
           "MUFU.EX2": 0, "MUFU.LG2": 0, "FMNMX": 0}
    for text in body:
        op = text.split()[0]
        base = op.split(".")[0]
        if base == "NOP":
            continue
        out["issue"] += 1
        kind = ("fp32" if base in FP32_OPS else "mufu" if base in MUFU_OPS
                else "alu" if base in ALU_OPS else "other")
        out[kind] += 1
        for k in ("MUFU.EX2", "MUFU.LG2", "FMNMX"):
            out[k] += op.startswith(k)
    return out


def hot_loop_pipes(path, dump: str | None = None) -> dict:
    """Kernel #4's loop body a (splat, pixel) pair, by pipe, in each
    instantiation of the library at ``path`` ("transcend_<sub>" /
    "poly_<sub>"), with the clocks a pair costs an SM on each pipe and on
    the issue slots. The pairs a loop iteration are its FMNMX count: the
    alpha's clamp, fminf(0.99, .), is the loop's one float min a pair in
    both variants. With ``dump``, each function's SASS is written to
    ``dump``_<variant>_<sub>.sass."""
    raw = {}
    for name, part in sass_functions(path).items():
        m = re.search(r"hot_loop_kernelILb([01])ELi(\d+)E", name)
        if m:
            key = ("transcend" if m.group(1) == "1" else "poly", int(m.group(2)))
            raw[key] = sass_loop_pipes(part)
            if dump:
                with open(f"{dump}_{key[0]}_{key[1]}.sass", "w") as f:
                    f.write(part)
    out = {}
    for (variant, sub), c in sorted(raw.items()):
        pairs = c["FMNMX"]
        if not pairs:
            raise AssertionError(f"hot loop {variant} sub {sub}: no FMNMX in its loop: {c}")
        row = {k: v / pairs for k, v in c.items()}
        clk = {k: row[k] / lanes for k, lanes in PIPE_LANES.items()}
        row.update(pairs_a_loop=pairs, clk_a_pair=clk,
                   clk_a_pair_issue=row["issue"] / ISSUE_LANES,
                   bound_pipe=max(clk, key=clk.get))
        out[f"{variant}_{sub}"] = row
    return out


def phase_build() -> dict:
    """One nvcc per kernel source, all started together; each of the GEMM's
    three instantiations must hold wgmma (HGMMA) instructions in its SASS,
    the compositor, the GEMM and the message kernel must spill no
    register, and the hot-loop probe's SASS must hold MUFU instructions in
    its transcendental variant only. The FPS kernel's 20 instantiations (1-4
    coordinates x 1-16 points a thread) must spill nothing, nor the radius
    graph's 8 (1-8 words of 32 columns a row)."""
    from gsdx_torch.kernels import composite, edges, fps, gnn_forward, probes

    libs = (composite.LIBRARY, gnn_forward.LIBRARY, gnn_forward.GEMM_LIBRARY,
            probes.LIBRARY, fps.LIBRARY, edges.LIBRARY)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        logs = list(pool.map(lambda lib: lib.build(), libs))
    for lib in libs:
        lib.load()
    hgmma = {name: part.count("HGMMA")
             for name, part in sass_functions(gnn_forward.GEMM_LIBRARY.path()).items()
             if "gnn_gemm_kernel" in name}
    if len(hgmma) != 3 or not all(hgmma.values()):
        raise AssertionError(f"HGMMA instructions in the GEMM's instantiations: {hgmma}")
    ptxas = ptxas_report(logs)
    composite = {k: v for k, v in ptxas.items() if k.startswith("composite_")}
    if len(composite) != 4:
        raise AssertionError(f"ptxas reported {sorted(composite)}: expected the "
                             "forward and backward at n_accum 4 and 7")
    if len([k for k in ptxas if k.startswith("fps_")]) != 20:
        raise AssertionError(f"ptxas reported {sorted(ptxas)}: expected 20 FPS instantiations")
    if len([k for k in ptxas if k.startswith("edges_")]) != 8:
        raise AssertionError(f"ptxas reported {sorted(ptxas)}: expected 8 edges instantiations")
    # the compositor, every GEMM instantiation, the message kernel, FPS and
    # the radius graph spill nothing
    checked = {k: v for k, v in ptxas.items()
               if k.startswith(("composite_", "gnn_gemm", "gnn_message", "fps_", "edges_"))}
    if sorted(k for k in checked if k.startswith("gnn_gemm")) != [
            "gnn_gemm_bn128", "gnn_gemm_bn128_res", "gnn_gemm_bn256"] or "gnn_message" not in checked:
        raise AssertionError(f"ptxas reported {sorted(ptxas)}: expected the GEMM at "
                             "128 (with and without residuals) and 256, and gnn_message")
    spills = {k: v.get("spill_bytes") for k, v in checked.items() if v.get("spill_bytes")}
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")
    return {"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
            "libraries": [lib.path().name for lib in libs],
            "ptxas": ptxas, "gemm_hgmma_instructions": hgmma,
            "probe_mufu": mufu_counts(probes.LIBRARY.path()),
            "probe_pipes": hot_loop_pipes(probes.LIBRARY.path()),
            "kernels": ["composite_fwd", "composite_fwd_presort",
                        "composite_bwd", "composite_bwd_presort",
                        "gnn_linear", "gnn_gemm", "gnn_edge_first", "gnn_segments",
                        "gnn_message", "hot_loop", "hot_loop_poly", "dynamic_roll",
                        "fps", "fps_radius", "edges"]}


def check_forward(tf, counts, geo: dict, presort: bool, what: str):
    """The forward kernel against its plain version on the same inputs:
    `nproc` equal on every tile, the outputs within REL_TOL, every final
    log T within LOGT_TOL, rank and sorted features equal. Returns (kernel
    outputs, max |err|, the launch read back from the library)."""
    from gsdx_torch.kernels import composite as C

    kw = dict(geo, presort=presort)
    out_k = C.composite_fwd(tf, counts, **kw)
    launch = C.last_launch()  # as the C side launched it
    with torch.no_grad():
        out_p = C.composite_tiles_torch(tf, counts, **kw)
    torch.cuda.synchronize()
    flips = int((out_k[2] != out_p[2]).sum())
    if flips:
        raise AssertionError(f"nproc differs on {flips} tiles ({what})")
    lt_diff = (out_k[1] - out_p[1]).abs().flatten(1).amax(1)
    if float(lt_diff.max()) >= LOGT_TOL:
        raise AssertionError(
            f"log T differs by {float(lt_diff.max())} >= {LOGT_TOL} on "
            f"{int((lt_diff >= LOGT_TOL).sum())} tiles ({what}): "
            f"{largest_difference(out_k, out_p, counts, geo['sub_chunk'], geo['tile_w'])}")
    err = 0.0
    for a, b in zip(out_k[:2], out_p[:2]):
        torch.testing.assert_close(a, b, rtol=REL_TOL, atol=REL_TOL)
        err = max(err, float((a - b).abs().max()))
    if presort:
        if not torch.equal(out_k[3], out_p[3]) or not torch.equal(out_k[4], out_p[4]):
            raise AssertionError("presort rank / sorted features differ")
    if launch["cluster"] < 2 or launch["blocks"] != tf.shape[0] * launch["cluster"]:
        raise AssertionError(f"forward launched {launch}: expected clusters of >= 2 "
                             f"blocks, {tf.shape[0]} of them ({what})")
    return out_k, err, launch


def check_backward(feats, counts, nproc, logt, geo: dict, rank=None):
    """The backward kernel against its plain version on random output
    gradients (seed 1): each feature row within REL_TOL of its own largest
    entry (the conic rows grow with dx^2 and would swamp the mean and
    opacity rows under one scale). Returns (the kernel's arguments, the plain
    version's, the kernel's gradient, the plain one, the launch read back,
    each row's scale)."""
    from gsdx_torch.kernels import composite as C

    T, P = feats.shape[0], geo["tile_h"] * geo["tile_w"]
    g = torch.Generator(device="cuda").manual_seed(1)
    g_acc = torch.randn(T, geo["n_accum"], P, device="cuda", generator=g)
    g_lt = torch.randn(T, 1, P, device="cuda", generator=g)
    args_k = (feats, counts, nproc, logt, g_acc, g_lt, rank)
    args_p = (feats, counts, nproc, g_acc, g_lt, rank)
    grad_k = C.composite_bwd(*args_k, **geo)
    launch = C.last_launch()
    grad_p = C.composite_bwd_torch(*args_p, **geo)
    torch.cuda.synchronize()
    scale = grad_p.abs().amax(dim=(0, 2), keepdim=True)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    torch.testing.assert_close(grad_k / scale, grad_p / scale, rtol=0, atol=REL_TOL)
    return args_k, args_p, grad_k, grad_p, launch, scale


def compare_kernels(n: int, presort: bool, clk_mhz: float,
                    saturating: bool = False) -> list[dict]:
    """Kernel vs plain PyTorch for the forward and the backward."""
    from gsdx_torch.kernels import composite as C

    tf, counts, geo = tile_inputs(n, original_order=presort, saturating=saturating)
    T, _, K = tf.shape
    P = geo["tile_h"] * geo["tile_w"]
    nacc = geo["n_accum"]
    kw = dict(geo, presort=presort)
    out_k, err_f, launch_f = check_forward(tf, counts, geo, presort, f"n={n}")
    nproc_k, flips = out_k[2], 0

    feats_b = out_k[4] if presort else tf
    rank = out_k[3] if presort else None
    args_b, args_p, grad_k, grad_p, launch_b, scale = check_backward(
        feats_b, counts, nproc_k, out_k[1], geo, rank)
    err_b = float((grad_k - grad_p).abs().max())
    repeat_equal = bool(torch.equal(C.composite_bwd(*args_b, **geo), grad_k))
    if not repeat_equal:
        raise AssertionError("the backward kernel differs between two runs")
    err_b_rel = float(((grad_k - grad_p).abs() / scale).max())

    # the median single call, with the launch gap in it (PRs 1-3's `ms`),
    # and the kernel's own device time a call
    ms_fk = cuda_ms(lambda: C.composite_fwd(tf, counts, **kw))
    ms_bk = cuda_ms(lambda: C.composite_bwd(*args_b, **geo))
    dev_fk = kernel_device_ms(lambda: C.composite_fwd(tf, counts, **kw), r"\bfwd_kernel<")
    dev_bk = kernel_device_ms(lambda: C.composite_bwd(*args_b, **geo), r"\bbwd_kernel<")
    ms_fp = cuda_ms(lambda: C.composite_tiles_torch(tf, counts, **kw), reps=3, warmup=1)
    ms_bp = cuda_ms(lambda: C.composite_bwd_torch(*args_p, **geo), reps=3, warmup=1)

    pairs = pair_counts(feats_b, counts, nproc_k, geo)
    processed, visible = pairs["processed"], pairs["visible"]
    if pairs["visible_outside_box"]:
        raise AssertionError(f"{pairs['visible_outside_box']} visible pairs lie outside "
                             "their alpha_cut_box")
    bytes_f, bytes_b = needed_bytes(counts, nproc_k, geo, K, presort)
    # the visible pairs' work (the bound), and with every processed pair's
    # falloff
    b_f = bound_ms(bytes_f, (FLOPS_ALL + FWD_FLOPS_VIS(nacc)) * visible,
                   3 * visible, clk_mhz)
    b_b = bound_ms(bytes_b, (FLOPS_ALL + BWD_FLOPS_VIS(nacc)) * visible,
                   4 * visible, clk_mhz)
    b_f_old = bound_ms(bytes_f, FLOPS_ALL * processed + FWD_FLOPS_VIS(nacc) * visible,
                       processed + 2 * visible, clk_mhz)
    b_b_old = bound_ms(bytes_b, FLOPS_ALL * processed + BWD_FLOPS_VIS(nacc) * visible,
                       processed + 3 * visible, clk_mhz)
    suffix = "_presort" if presort else ""
    stopped = int((nproc_k.long() * geo["sub_chunk"] < counts.long()).sum())
    if saturating and not stopped:
        raise AssertionError("the saturating scene never stopped early")
    if launch_b["cluster"] < 2 or launch_b["blocks"] != T * launch_b["cluster"]:
        raise AssertionError(f"backward launched {launch_b}: expected clusters of "
                             f">= 2 blocks, {T} of them")
    common = {"n": n, "saturating": saturating, "T": T, "K": K, "P": P,
              "sub": geo["sub_chunk"], "tile_h": geo["tile_h"],
              "n_accum": nacc, "nonempty_tiles": int((counts > 0).sum()),
              "pairs_processed": processed, "pairs_visible": visible,
              "pairs_in_box": pairs["in_box"],
              "pairs_visible_outside_box": pairs["visible_outside_box"],
              "patch_pairs": pairs["patch_pairs"], "patch_pairs_kept": pairs["patch_kept"],
              "kept_share": pairs["patch_kept"] / max(1, pairs["patch_pairs"]),
              "nproc_flips": flips, "early_stopped_tiles": stopped}
    return [
        dict(common, name="composite_fwd" + suffix, max_abs_err=err_f,
             ms=ms_fk, device_ms=dev_fk, plain_ms=ms_fp, bound_ms=b_f[0],
             bound_by=b_f[1], bound_bytes=bytes_f,
             bound_ms_processed_pairs=b_f_old[0], launch=launch_f),
        dict(common, name="composite_bwd" + suffix, max_abs_err=err_b,
             max_row_rel_err=err_b_rel, ms=ms_bk, device_ms=dev_bk,
             plain_ms=ms_bp, bound_ms=b_b[0], bound_by=b_b[1], bound_bytes=bytes_b,
             bound_ms_processed_pairs=b_b_old[0], launch=launch_b,
             bitwise_repeatable=repeat_equal),
    ]


def check_cut_stress(presort: bool, seed: int = 0) -> dict:
    """#1 and #2 (with ``presort``, #1p and #2p) against their plain versions
    on tools/cut_stress.py's inputs, whose targeted pairs put alpha within a
    few ulps of the 1/255 cut: the forward by `check_forward` (nproc equal,
    REL_TOL, every log T within LOGT_TOL), the backward within REL_TOL of
    each gradient row's largest entry. Returns the targets, the tiles whose
    outputs differ at all and the largest differences."""
    from gsdx_torch.kernels import composite as C

    feats, c, geo, targets = load_tool("cut_stress").cut_stress_inputs(seed, 7, presort)
    tf, counts = torch.from_numpy(feats).cuda(), torch.from_numpy(c).cuda()
    T, _, K = tf.shape
    what = f"cut stress, presort {presort}"
    out_k, err_f, _ = check_forward(tf, counts, geo, presort, what)
    with torch.no_grad():
        out_p = C.composite_tiles_torch(tf, counts, **geo, presort=presort)
    diff = largest_difference(out_k, out_p, counts, geo["sub_chunk"], geo["tile_w"])
    feats_b, rank = (out_k[4], out_k[3]) if presort else (tf, None)
    _, _, grad_k, grad_p, _, scale = check_backward(feats_b, counts, out_k[2], out_k[1],
                                                    geo, rank)
    return {"presort": presort, "T": T, "K": K, "tile_h": geo["tile_h"],
            "sub": geo["sub_chunk"], "n_accum": geo["n_accum"],
            "busy_tiles": int((counts > 0).sum()), "targets": int(len(targets["tile"])),
            "early_stopped_tiles": int((out_k[2].long() * geo["sub_chunk"]
                                        < counts.long()).sum()),
            "tiles_differing": diff["tiles_differing"],
            "max_logt_diff": float((out_k[1] - out_p[1]).abs().max()),
            "fwd_max_abs_err": err_f, "largest_difference": diff,
            "bwd_max_row_rel_err": float(((grad_k - grad_p).abs() / scale).max())}


def phase_kernels(clk_mhz: float) -> list[dict]:
    """Every variant at the main path's shapes (8192 Gaussians: T 230, K 512,
    P 4096, sub 64, 7 channels), at 16k (T 450, P 2048, sub 128), and on a
    saturating 8192-Gaussian scene whose tiles stop early; then the four
    variants on tools/cut_stress.py's inputs at the slice and online shapes."""
    rows = []
    for n, saturating in ((8192, False), (16384, False), (8192, True)):
        for presort in (False, True):
            for r in compare_kernels(n, presort, clk_mhz, saturating):
                emit(dict(r, phase="kernels"))
                rows.append(r)
    for presort in (False, True):
        emit(dict(check_cut_stress(presort), phase="cut_stress"))
    return rows


REPO = os.path.dirname(os.path.abspath(__file__))


def load_tool(name: str):
    """tools/<name>.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def close_to_largest(a, b, share) -> dict:
    """`tests/test_torch_probes.py` `_close_to_largest`: all but ``share``
    of the entries that are non-zero in ``b`` within 1e-5 of the output's
    largest magnitude, every entry within 2e-2 (one f32 rounding can carry
    an alpha across the 1/255 cut; on the probe's data, where the falloff's
    terms of ~1e7 cancel, often). Returns the largest |a - b|, its share of
    the largest entry, the entries off by more than 1e-5 of it and the
    non-zero entries."""
    err = (a.double() - b.double()).abs()
    rel = err / max(float(b.abs().max()), 1.0)
    out = {"max_abs_err": float(err.max()), "max_rel_largest": float(rel.max()),
           "entries_above_1e-5": int((rel > 1e-5).sum()), "entries": rel.numel(),
           "nonzero": int((b != 0).sum())}
    if out["max_rel_largest"] > 2e-2 or out["entries_above_1e-5"] > share * out["nonzero"]:
        raise AssertionError(f"hot loop vs plain: {out}")
    return out


# kernel #4's bounds, as `tools/transcendental_probe.py` `ab` gives them
SUB_BOUND_KEYS = ("bound_ms", "bound_by", "bound_pipe", "bound_bytes", "bound_ms_sass",
                  "bound_pipe_sass", "bound_ms_issue_sass")


def phase_probes(clk_mhz: float) -> tuple[dict, list[dict]]:
    """Kernels #4 and #5 against their plain versions, then their probe
    paths (tools/dynamic_roll_probe.py, the A/B of
    tools/transcendental_probe.py) with the launch counters set to 0 just
    before and read just after."""
    from gsdx_torch.kernels import probes as PR

    # kernel #5: bit-equal to torch.roll at every shift, any sign or size
    x = torch.randn(8, 512, device="cuda")
    for shift in (0, 3, 130, 511, -1, 515):
        s = torch.tensor([shift], dtype=torch.int32, device="cuda")
        if not torch.equal(PR.dynamic_roll(x, s), torch.roll(x, shift, dims=1)):
            raise AssertionError(f"dynamic_roll differs from torch.roll at shift {shift}")
    s = torch.tensor([130], dtype=torch.int32, device="cuda")
    # a call back to back against torch.roll's, in turns, and its pieces
    roll = load_tool("dynamic_roll_probe").call_times()
    roll.update({
        "name": "dynamic_roll", "R": 8, "W": 512, "max_abs_err": 0.0,
        "plain_ms": cuda_ms_back_to_back(lambda: PR.dynamic_roll_plain(x, s), reps=200),
        "device_ms": kernel_device_ms(lambda: PR.dynamic_roll(x, s), r"roll_kernel"),
        "library_device_ms": kernel_device_ms(lambda: torch.roll(x, 130, dims=1), r"roll"),
        # the floor of any launch: a kernel that does nothing, by the same path
        "launch_floor_ms": kernel_device_ms(lambda: PR.empty_launch(0), r"empty_kernel")})
    roll["bytes_bound_ms"] = bound_ms(2 * 8 * 512 * 4 + 4, 0, 0, clk_mhz)[0]
    roll["bound_ms"] = max(roll["bytes_bound_ms"], roll["launch_floor_ms"])
    roll["bound_by"] = "launch" if roll["launch_floor_ms"] > roll["bytes_bound_ms"] else "bytes"

    # kernel #4 at the probe's shape, both variants, sub 64 and 128, on the
    # probe's data and on splats that cover every pixel (the share of
    # non-zero entries that may be off by more than 1e-5: the test's)
    tp = load_tool("transcendental_probe")
    checks = {}
    for sub in tp.SUBS:
        for v in tp.VARIANTS:
            for data, share in (("dense", 1e-3), ("probe", 0.02)):
                feats, counts = (tp.dense_inputs if data == "dense" else tp.probe_inputs)(sub)
                got = PR.composite_hot_loop(feats, counts, sub, v)
                want = PR.composite_hot_loop_plain(feats, counts, sub, v)
                torch.cuda.synchronize()
                diffs = [close_to_largest(a, b, share) for a, b in zip(got, want)]
                emit({"phase": "probes_check", "data": data, "sub": sub, "transcend": v,
                      "accum": diffs[0], "logt": diffs[1]})
            # the kernel line's error and times: the probe's data
            checks[(sub, v)] = {
                "max_abs_err": max(d["max_abs_err"] for d in diffs),
                "ms": cuda_ms(lambda: PR.composite_hot_loop(feats, counts, sub, v)),
                "plain_ms": cuda_ms(lambda: PR.composite_hot_loop_plain(feats, counts, sub, v),
                                    reps=3, warmup=1)}

    # the probe paths, counted
    PR.reset_launches()
    if not load_tool("dynamic_roll_probe").run("cuda"):
        raise AssertionError("tools/dynamic_roll_probe.py: a shift did not match np.roll")
    ab = [tp.ab(sub, clk_mhz) for sub in tp.SUBS]
    launches = dict(PR.LAUNCHES)
    for k, n in launches.items():
        if not n:
            raise AssertionError(f"the probe paths launched no {k} kernel")
    for r in ab:
        emit(dict(r, phase="probes_ab"))
    rows = [dict(roll, launches=launches["dynamic_roll"])]
    for v in tp.VARIANTS:
        name = "transcend" if v else "poly"
        main = ab[0]  # sub 64, kernel #1's granule at 720p
        c = checks[(64, v)]
        # the bound: the function's operations a pair by pipe, counted from
        # its source (or the bytes, were they more); the loop's own SASS by
        # pipe and by issue slot beside it, a diagnostic
        rows.append({
            "name": "probe_transcendental" + ("" if v else "_poly"), "sub": 64,
            "launches": launches["hot_loop" if v else "hot_loop_poly"],
            "max_abs_err": max(checks[(sub, v)]["max_abs_err"] for sub in tp.SUBS),
            "ms": c["ms"], "device_ms": main[f"device_ms_{name}"],
            "plain_ms": c["plain_ms"],
            **{k: main[f"{k}_{name}"] for k in SUB_BOUND_KEYS},
            "function_a_pair": main[f"function_a_pair_{name}"],
            "sass_a_pair": main[f"sass_a_pair_{name}"], "library_ms": None,
            "sub128": {"ms": checks[(128, v)]["ms"], "plain_ms": checks[(128, v)]["plain_ms"],
                       "device_ms": ab[1][f"device_ms_{name}"],
                       **{k: ab[1][f"{k}_{name}"] for k in SUB_BOUND_KEYS}}})
    out = {"phase": "probes", "launches": launches,
           "transcendental_share": {f"sub{r['sub']}": r["transcendental_share"] for r in ab},
           "us_per_granule": {f"sub{r['sub']}": {"transcend": r["us_per_granule_transcend"],
                                                "poly": r["us_per_granule_poly"]} for r in ab},
           "kernels": rows}
    emit(out)
    return out, rows


def fps_case(shape: str, radius_mode: bool, points, n: int, start=0, radius=None,
             valid=None) -> dict:
    """The FPS kernel (plain or radius-stopping) against its plain version
    on the same CUDA tensors, exactly (indices and keep); then its call's
    median ms and device ms, the plain version's ms, the latency floor (the
    same launch with no distances: `fps_latency_floor`) and the bounds of
    the bytes it moves and of the operations this run's points need."""
    from gsdx_torch.kernels import fps as F

    kw = dict(start_idx=start, valid=valid)
    if radius_mode:
        def run():
            return F.fps_rad_idx_batch(points, radius, n, **kw)

        def plain():
            return F.fps_rad_idx_batch_plain(points, radius, n, **kw)
    else:
        def run():
            return F.farthest_point_sampling_batch(points, n, **kw), None

        def plain():
            return F.farthest_point_sampling_batch_plain(points, n, **kw), None
    got = run()
    launch = F.last_launch()
    want = plain()
    torch.cuda.synchronize()
    name = "fps_radius" if radius_mode else "fps"
    idx_diff = int((got[0] != want[0]).sum())
    keep_diff = int((got[1] != want[1]).sum()) if radius_mode else 0
    if idx_diff or keep_diff:
        raise AssertionError(f"{name} kernel differs from its plain version at {shape}: "
                             f"{idx_diff} indices, {keep_diff} keep flags")
    B, P, D = points.shape
    n_valid = B * P if valid is None else int(valid.expand(B, P).sum())
    moved = (B * P * D * 4 + (valid.numel() if valid is not None else 0)
             + (B * 8 if torch.is_tensor(start) else 0)
             + (B * 4 if torch.is_tensor(radius) else 0) + B * n * (9 if radius_mode else 8))
    bytes_ms = moved / PEAK_BYTES_S * 1e3
    # a valid point a step: D subtractions, D FMAs (2 each), a min, a compare
    ops_ms = max(n - 1, 0) * n_valid * (3 * D + 2) / PEAK_F32_FLOP_S * 1e3

    def floor():
        return F.fps_latency_floor(points, n)

    row = {"name": name, "shape": shape, "B": B, "P": P, "D": D, "n": n,
           "valid_points": n_valid, "start": "per row" if torch.is_tensor(start) else start,
           "cluster": launch["cluster"], "threads": launch["threads"],
           "points_a_thread": launch["points_a_thread"], "equal": True, "max_abs_err": 0.0,
           "ms": cuda_ms(run, reps=20), "device_ms": kernel_device_ms(run, r"fps_kernel", calls=10),
           "plain_ms": cuda_ms(plain, reps=2, warmup=1),
           "floor_ms": cuda_ms(floor, reps=20),
           "latency_floor_ms": kernel_device_ms(floor, r"fps_kernel", calls=10),
           "bytes_bound_ms": bytes_ms, "operations_bound_ms": ops_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None}
    if radius_mode:
        row["kept"] = int(got[1].sum())
    emit(dict(row, phase="fps"))
    return row


FPS_GRID = ((-0.15, -0.15, -0.15, 5.0), (0.14, 0.14, 0.14, 5.29))  # 15 steps of 0.02 a side


def phase_fps() -> tuple[dict, list[dict]]:
    """The FPS kernel and its radius-stopping form against their plain
    versions, exactly, at the shapes of every path that runs them: the rope
    sampler (the committed trajectory's 16 frames x 1000 particles -> 100
    from per-row starts, then 16 x 100 -> 100 with per-row radii), the cloth
    sampler (batch 64, max_nobj 150), a rollout step (predict's 1000-point
    proxy -> 100, then the radius FPS), the rollout's proxy (predict's real
    Gaussians -> 1000) and a row at the kernel's largest P (65,536, a
    cluster of 8 blocks), the planner's 4-D action grid at grid_size 0.02
    (a box of 15 steps a side, 50,625 points, dense ties), and masked rows
    with more samples than valid points. Returns (the row of the main path's
    shapes by kernel, every row)."""
    from gsdx_torch.apps.predict import tracked_gaussians
    from gsdx_torch.core.pointcloud import iterative_statistical_outliers
    from gsdx_torch.kernels import fps as F
    from gsdx_torch.plan.actions import sample_action_seq_fps

    rng = np.random.default_rng(0)
    rows = []
    # the rope sampler: one frame of the committed trajectory a row
    traj = torch.as_tensor(np.load(TRAJ), device="cuda")
    B = traj.shape[0]
    start = torch.as_tensor(rng.integers(0, traj.shape[1], B), device="cuda")
    radius = torch.as_tensor(rng.uniform(0.02, 0.04, B).astype(np.float32), device="cuda")
    rows.append(fps_case("rope_sampler", False, traj, 100, start))
    rows_b = torch.arange(B, device="cuda")[:, None]
    down = traj[rows_b, F.farthest_point_sampling_batch(traj, 100, start)]
    rows.append(fps_case("rope_sampler", True, down, 100, 0, radius))
    # the cloth sampler: 64 rows of a crumpled 40 x 25 sheet
    u, v = np.meshgrid(np.linspace(0, 0.3, 40), np.linspace(0, 0.2, 25))
    sheet = np.stack([u.ravel(), v.ravel(), 0.02 * np.sin(8 * u.ravel())], -1)
    cloth = torch.as_tensor((sheet[None] + rng.normal(0, 0.003, (64, 1000, 3)))
                            .astype(np.float32), device="cuda")
    start = torch.as_tensor(rng.integers(0, 1000, 64), device="cuda")
    rows.append(fps_case("cloth_sampler", False, cloth, 150, start))
    rows_b = torch.arange(64, device="cuda")[:, None]
    down = cloth[rows_b, F.farthest_point_sampling_batch(cloth, 150, start)]
    rows.append(fps_case("cloth_sampler", True, down, 150, 0,
                         torch.full((64,), 0.03, device="cuda")))
    # predict's rollout: the proxy of the tracked Gaussians, then a step's
    xyz = torch.as_tensor(tracked_gaussians(os.path.join(PIPELINE, "ckpts/params.npz"), 0,
                                            0.1)["means3D"], device="cuda")
    gauss = xyz[torch.as_tensor(iterative_statistical_outliers(xyz, 50), device="cuda")]
    rows.append(fps_case("rollout_proxy", False, gauss[None].contiguous(), 1000))
    proxy = gauss[F.farthest_point_sampling(gauss, 1000)]
    rows.append(fps_case("rollout_step", False, proxy[None], 100))
    down = proxy[F.farthest_point_sampling(proxy, 100)]
    rows.append(fps_case("rollout_step", True, down[None], 100, 0, 0.03))
    big = torch.as_tensor(rng.normal(0, 0.1, (1, F.MAX_P, 3)).astype(np.float32), device="cuda")
    rows.append(fps_case("largest_p", False, big, 1000))
    if rows[-1]["cluster"] != 8:
        raise AssertionError(f"the largest row ran on a cluster of {rows[-1]['cluster']}")
    # the planner's action grid, built as `sample_action_seq_fps` builds it
    axes = [np.arange(FPS_GRID[0][i], FPS_GRID[1][i], 0.02) for i in range(4)]
    grid = torch.as_tensor(np.stack(np.meshgrid(*axes), -1).reshape(-1, 4).astype(np.float32),
                           device="cuda")
    rows.append(fps_case("action_grid", False, grid[None], 1000))
    acts = sample_action_seq_fps(*FPS_GRID, 1000, grid_size=0.02, device="cuda")
    if not (acts.is_cuda and torch.equal(
            acts[:, 0], grid[F.farthest_point_sampling_batch_plain(grid[None], 1000)[0]])):
        raise AssertionError("sample_action_seq_fps differs from the grid's plain FPS")
    # masked rows, more samples than valid points
    pts = torch.as_tensor(rng.normal(0, 0.1, (8, 1000, 3)).astype(np.float32), device="cuda")
    valid = torch.as_tensor(rng.random((8, 1000)) < 0.05, device="cuda")
    start = torch.as_tensor(rng.integers(0, 1000, 8), device="cuda")
    rows.append(fps_case("masked_rows", False, pts, 100, start, valid=valid))
    rows.append(fps_case("masked_rows", True, pts, 100, start, torch.full(
        (8,), 0.05, device="cuda"), valid=valid))
    shared = torch.as_tensor(rng.random(1000) < 0.03, device="cuda")
    rows.append(fps_case("masked_shared", False, pts, 100, 3, valid=shared))
    main = {r["name"]: r for r in rows if r["shape"] == "rope_sampler"}
    return main, rows


ROPE_CKPT = os.path.join(REPO, "benchmarks/out/generalization/checkpoints/latest.ckpt")
TRAJ = os.path.join(REPO, "benchmarks/out/pipeline/ckpts/param_downsampled.npy")
# The GNN kernels round the same product operands to bf16 as
# `gnn_forward_plain(operands="bf16")` and sum in f32 in another order, so
# an activation within an f32 rounding of a bf16 boundary can round the
# other way (one bf16 ulp, 2^-8 relative), and the layers after it carry
# that on. Of the output's largest entry: the trained rope weights carry it
# little (1.4e-3 measured), a random 512-wide init far (1.24e-2 in
# tests/test_torch_gnn_kernel.py). The plain version summed in f64 instead
# of f32 (`spread`) shows the same effect within the reference itself.
GNN_TOL = {"trained": 5e-3, "random": 3e-2}


def rope_model(device="cuda"):
    from gsdx_torch.dynamics.model import DynamicsPredictor, ModelConfig, flax_params
    from gsdx_torch.dynamics.model import load_flax_params
    from gsdx_torch.io.checkpoint import load_checkpoint

    model = DynamicsPredictor(ModelConfig())
    tree = load_checkpoint(ROPE_CKPT, target=flax_params(model))
    return load_flax_params(model, tree).to(device).eval()


def trajectory_particles(n_obj: int) -> torch.Tensor:
    """(16, n_obj, 3) frames of the committed trajectory at n_obj
    FPS-sampled particles of its first frame."""
    from gsdx_torch.kernels.fps import farthest_point_sampling

    traj = torch.as_tensor(np.load(TRAJ), device="cuda")
    idx = farthest_point_sampling(traj[0], n_obj)
    return traj[:, idx]


def chunk_states(B: int, n_obj: int, g):
    """(B, 3, n_obj + 1, 3) histories of one rollout chunk, mask and tool
    mask: sample b's history is three consecutive frames of the committed
    trajectory starting at b % 14, its pusher a random point near the
    object (from ``g``)."""
    frames = trajectory_particles(n_obj)
    N = n_obj + 1
    starts = torch.arange(B, device="cuda") % 14
    hist = torch.stack([frames[starts + h] for h in range(3)], 1)  # (B, 3, n_obj, 3)
    tool = hist[:, :, :1] + 0.03 * torch.randn(B, 1, 1, 3, device="cuda", generator=g)
    mask = torch.ones(B, N, dtype=torch.bool, device="cuda")
    tool_mask = torch.zeros_like(mask)
    tool_mask[:, n_obj] = True
    return torch.cat([hist, tool], 2), mask, tool_mask


def gnn_inputs(B: int, n_obj: int, n_pad: int, max_nR: int, topk: int,
               adj: float, connect_all: bool):
    """One chunk of the rollout's GNN inputs (`chunk_states`); edges by the
    port's `construct_edge_indices_batch` on the last frame, at the GNN's
    padded width (the edges phase checks that graph against its plain
    version)."""
    from gsdx_torch.graph.edges import construct_edge_indices_batch

    g = torch.Generator(device="cuda").manual_seed(0)
    states, mask, tool_mask = chunk_states(B, n_obj, g)
    N = n_obj + 1
    recv, send = construct_edge_indices_batch(states[:, -1], adj, mask, tool_mask,
                                              n_obj=n_obj, topk=topk, max_nR=max_nR,
                                              connect_all=connect_all,
                                              out_width=-(-max_nR // 8) * 8)
    attrs = torch.zeros(B, n_pad, 2, device="cuda")
    attrs[:, :n_obj, 0] = 1
    attrs[:, n_obj:N, 1] = 1
    action = torch.zeros(B, n_pad, 3, device="cuda")
    action[:, n_obj, :2] = 0.01 * torch.randn(B, 2, device="cuda", generator=g)
    st = torch.zeros(B, n_pad, 9, device="cuda")
    st[:, :N] = states.transpose(1, 2).reshape(B, N, 9)
    gi = torch.zeros(B, n_pad, 1, device="cuda")
    gi[:, :n_obj] = 1
    return [attrs, action, st, gi, recv, send]


def edges_case(shape: str, states, radius, mask, tool_mask, floor_ms: float, **kw) -> dict:
    """The radius-graph kernel against its plain version on the same CUDA
    inputs, slot for slot (one launch a call); then its call's median ms
    and device ms, the plain version's, and the bound: the bytes it must
    move (states, masks, radii, both outputs) or ``floor_ms``, an empty
    kernel's device time, whichever is longer."""
    from gsdx_torch.graph import edges as E
    from gsdx_torch.kernels import edges as K

    def run():
        return E.construct_edge_indices_batch(states, radius, mask, tool_mask, **kw)

    def plain():
        return E.construct_edge_indices_batch_plain(states, radius, mask, tool_mask, **kw)

    before = K.LAUNCHES["edges"]
    got = run()
    if K.LAUNCHES["edges"] != before + 1:
        raise AssertionError(f"edges at {shape}: {K.LAUNCHES['edges'] - before} launches")
    want = plain()
    differ = int(((got[0] != want[0]) | (got[1] != want[1])).sum())
    if differ or got[0].shape != want[0].shape:
        raise AssertionError(f"edges kernel differs from its plain version at {shape}: "
                             f"{differ} slots")
    B, N, _ = states.shape
    width = got[0].shape[1]
    moved = (B * N * 3 * 4 + 2 * B * N + (radius.numel() * 4 if torch.is_tensor(radius) else 0)
             + 2 * B * width * 4)
    bytes_ms = moved / PEAK_BYTES_S * 1e3
    row = {"name": "edges", "shape": shape, "B": B, "N": N, "topk": kw["topk"],
           "max_nR": kw["max_nR"], "width": width,
           "edges_mean": float((got[0] >= 0).sum(1).float().mean()),
           "radius": "per graph" if torch.is_tensor(radius) else radius,
           "equal": True, "slots_differing": 0, "max_abs_err": 0.0,
           "ms": cuda_ms(run, reps=50), "device_ms": kernel_device_ms(run, r"\bedges_kernel"),
           "back_to_back_ms": cuda_ms_back_to_back(run, reps=50),
           "plain_ms": cuda_ms(plain, reps=20), "plain_device_ms": kernel_device_ms(plain, r"."),
           "bytes_bound_ms": bytes_ms, "latency_floor_ms": floor_ms,
           "bound_ms": max(bytes_ms, floor_ms),
           "bound_by": "launch" if floor_ms > bytes_ms else "bytes", "bound_bytes": moved,
           "library_ms": None}
    emit(dict(row, phase="edges"))
    return row


def phase_edges() -> tuple[dict, list[dict]]:
    """The push step's radius graph (`csrc/edges.cu`) against its plain
    version, slot for slot, at its callers' shapes: the rope planning chunk
    (125 graphs of 101 particles, top-5, 500 relations in 504 slots) and the
    cloth one (125 x 151, top-6, 1,200, every object-tool pair), on the
    histories the GNN phase gives kernel #3 (`chunk_states`), and
    cloth.train's batch (64 x 151, a radius a graph, part of each object
    masked out). Returns (the rope chunk's row, every row)."""
    from gsdx_torch.kernels import probes as PR

    rng = np.random.default_rng(0)
    floor_ms = kernel_device_ms(lambda: PR.empty_launch(0), r"empty_kernel")
    rows = []
    for shape, B, n_obj, radius, kw in (
            ("rope_chunk", 125, 100, 0.08, dict(topk=5, max_nR=500, out_width=504)),
            ("cloth_chunk", 125, 150, 0.075, dict(topk=6, max_nR=1200, connect_all=True)),
            ("cloth_train", 64, 150, None, dict(topk=6, max_nR=1200, connect_all=True))):
        states, mask, tool_mask = chunk_states(B, n_obj, torch.Generator(device="cuda")
                                               .manual_seed(0))
        if radius is None:  # the training batch's draws
            radius = torch.as_tensor(rng.uniform(0.07, 0.08, B).astype(np.float32),
                                     device="cuda")
            mask[:, :n_obj] = torch.as_tensor(rng.random((B, n_obj)) < 0.85, device="cuda")
        rows.append(edges_case(shape, states[:, -1], radius, mask, tool_mask, floor_ms,
                               n_obj=n_obj, **kw))
    return rows[0], rows


def forward_kernel_ms(packed, ins, pstep: int, calls: int = 5) -> dict:
    """Device ms of each GNN kernel in one forward (without the index
    check), from `torch.profiler` over ``calls`` forwards."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gsdx_torch.kernels import gnn_forward as G

    G._launch_forward(packed, *ins, pstep)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            G._launch_forward(packed, *ins, pstep)
        torch.cuda.synchronize()
    ms = {k: 0.0 for k in ("gnn_linear", "gnn_gemm", "gnn_edge_first", "gnn_segments",
                           "gnn_message")}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for k in ms:
                if k + "_kernel" in e.key:
                    ms[k] += e.self_device_time_total / 1e3 / calls
    return ms


def compare_gnn(name: str, packed, ins, n_obj: int, weights: str) -> dict:
    """The fused forward's kernels against `gnn_forward_plain`: its bf16
    mode (asserted) and its f32 mode (reported); timed with the index check
    on the host (the public entry point), on the device (an error word: the
    push loop's mode, asserted bit-equal) and without it."""
    from gsdx_torch.kernels import gnn_forward as G

    pstep = 3
    out_k = G.fused_gnn_forward(packed, *ins)
    out_p = G.gnn_forward_plain(packed, *ins, operands="bf16")
    out_f32 = G.gnn_forward_plain(packed, *ins)
    out_64 = G.gnn_forward_plain(
        packed._replace(biases=packed.biases.double(), w1p_st=packed.w1p_st.double()),
        *[t.double() if t.is_floating_point() else t for t in ins], operands="bf16")
    torch.cuda.synchronize()
    scale = float(out_p.abs().max())
    err = float((out_k - out_p).abs().max())
    spread = float((out_p.double() - out_64).abs().max())
    tol = GNN_TOL[weights] * scale
    if not (torch.isfinite(out_k).all() and err <= tol):
        raise AssertionError(f"{name}: GNN kernels vs plain (bf16) max |err| {err} "
                             f"> {GNN_TOL[weights]} x {scale}")
    word = torch.zeros(1, dtype=torch.int32, device="cuda")
    out_d = G.fused_gnn_forward(packed, *ins, errors=word)
    if int(word) or not torch.equal(out_d, out_k):
        raise AssertionError(f"{name}: the device-checked forward differs from the "
                             f"host-checked one (error word {int(word)})")
    ms_k = cuda_ms(lambda: G.fused_gnn_forward(packed, *ins))
    ms_device = cuda_ms(lambda: G.fused_gnn_forward(packed, *ins, errors=word))
    ms_unchecked = cuda_ms(lambda: G._launch_forward(packed, *ins, pstep))
    ms_p = cuda_ms(lambda: G.gnn_forward_plain(packed, *ins, operands="bf16"), reps=5)
    B, n_pad, _ = ins[0].shape
    E = ins[4].shape[1]
    F = packed.w2r.shape[0]
    n_edges = int((ins[4] >= 0).sum())
    # the work this input needs: real node rows and valid edge slots
    flops = G.forward_flops(B * (n_obj + 1), n_edges, F, 9, pstep)
    flops_padded = G.forward_flops(B * n_pad, B * E, F, 9, pstep)
    bytes_moved = (sum(t.numel() * t.element_size() for t in ins)
                   + sum(t.numel() * t.element_size()
                         for t in (getattr(packed, f) for f in G.GSDX_FIELDS))
                   + out_k.numel() * 4)
    t_bytes = bytes_moved / PEAK_BYTES_S
    t_bf16 = flops / PEAK_BF16_FLOP_S
    unfused = G.forward_bytes(B * n_pad, B * E, F, 9, pstep, n_samples=B,
                              **G.message_counts(ins[4], ins[5], n_pad))
    breakdown = {k: {"device_ms": ms, "bytes_floor_ms": 1e3 * unfused[k] / PEAK_BYTES_S}
                 for k, ms in forward_kernel_ms(packed, ins, pstep).items()}
    return {"name": name, "B": B, "n_pad": n_pad, "E": E, "n_obj": n_obj,
            "valid_edges": n_edges, "gflop_needed": flops / 1e9,
            "gflop_padded": flops_padded / 1e9, "max_abs_err": err,
            "max_abs_err_vs_plain_f32": float((out_k - out_f32).abs().max()),
            "plain_bf16_f64_spread": spread, "tolerance": tol,
            "tolerance_reason": f"{GNN_TOL[weights]} of the output's largest entry, "
                                f"{weights} weights: bf16 rounding flips",
            "max_abs_out": scale, "ms": ms_k, "device_checked_ms": ms_device,
            "unchecked_ms": ms_unchecked,
            "check_share": 1 - ms_unchecked / ms_k, "plain_ms": ms_p,
            "bound_ms": 1e3 * max(t_bytes, t_bf16),
            "bound_by": "bytes" if t_bytes >= t_bf16 else "operations",
            "bound_rate": "bf16 tensor cores, 989 TFLOP/s",
            "unfused_bytes_gb": sum(unfused.values()) / 1e9,
            "unfused_bytes_floor_ms": 1e3 * sum(unfused.values()) / PEAK_BYTES_S,
            "by_kernel": breakdown,
            "achieved_tflop_s": flops / (ms_k * 1e-3) / 1e12}


# The GEMM at the fused forward's products of a 125-sample rope chunk:
# (name, rows, weight copy, N, bias row or None, residuals, relu, outputs)
GEMM_SHAPES = (("w2r", 125 * 504, "wt_2r", 512, 1, 0, True, "bf16"),
               ("w2p", 125 * 128, "wt_2p", 512, 5, 0, True, "bf16"),
               ("wt_rs", 125 * 128, "wt_rs", 1024, None, 0, False, "f32"),
               ("wh3", 125 * 128, "wt_h3", 8, 10, 0, False, "f32"),
               ("wp1", 125 * 128, "wt_p1", 512, None, 2, True, "both"))


def compare_gemm(packed) -> list[dict]:
    """The tensor-core GEMM at each product shape of the forward (the edge
    rows' `w2r`, the node rows' `w2p`, a round's `wt_rs` and its residual
    `wp1`, the head's `wh3`, each with its epilogue) against its plain
    version, with `torch.matmul` of the same bf16 operands (bf16 out) as
    the yardstick: each a call's mean back to back and its device ms from
    `torch.profiler`. The launch must be persistent: min(SMs, tiles)
    blocks, as the C side reports them."""
    from gsdx_torch.kernels import gnn_forward as G

    F = packed.w2r.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for name, M, field, N, bias_row, n_res, relu, outs in GEMM_SHAPES:
        x = torch.relu(torch.randn(M, F, device="cuda", generator=g)).to(torch.bfloat16)
        wt = getattr(packed, field)
        bias = None if bias_row is None else packed.biases[bias_row, :N].contiguous()
        res = [torch.randn(M, N, device="cuda", generator=g) for _ in range(n_res)]
        r1, r2 = (res + [None, None])[:2]
        kw = dict(bias=bias, r1=r1, r2=r2, relu=relu, f32=outs != "bf16", bf16=outs != "f32")
        out_k = G.gnn_gemm(x, wt, N, **kw)
        launch = G.gemm_last_launch()
        out_p = G.gnn_gemm_plain(x, wt, N, **kw)
        torch.cuda.synchronize()
        tiles = -(-M // launch["block_m"]) * -(-N // launch["block_n"])
        if launch["tiles"] != tiles or launch["grid"] != min(sms, tiles):
            raise AssertionError(f"gnn_gemm {name}: launch {launch}, expected a persistent "
                                 f"grid of min({sms} SMs, {tiles} tiles)")
        # A bf16 output without residuals: f32 sums in another order differ
        # by one bf16 ulp (2^-7 of the value at most) where the sum lands on
        # a rounding boundary. An f32 output, or one with residuals, takes
        # tests/test_torch_gnn_kernel.py's bound for two results: an f32 sum
        # in any order is within (K + 3) 2^-23 of the terms' magnitudes of
        # the exact value, twice over for kernel and plain; a bf16 output
        # adds each side's rounding, half a bf16 ulp (2^-8 of the value).
        # Near zero after the ReLU a bf16 value keeps the f32 difference,
        # which residuals of order 1 make larger than 1e-6.
        mag = x.float().abs() @ wt[:N].float().abs().t()
        for extra in (bias, r1, r2):
            if extra is not None:
                mag = mag + extra.abs()
        f32_bound = 2 * (F + 3) * 2.0 ** -23 * mag
        err = 0.0
        for k_out, p_out, bf in ((out_k[0], out_p[0], False), (out_k[1], out_p[1], True)):
            if k_out is None:
                continue
            diff = (k_out.float() - p_out.float()).abs()
            if bf and not n_res:
                bound = 2.0 ** -7 * p_out.float().abs() + 1e-6
            elif bf:
                bound = (f32_bound * (1 + 2.0 ** -8)
                         + 2.0 ** -8 * (k_out.float().abs() + p_out.float().abs()))
            else:
                bound = f32_bound
            if not (torch.isfinite(k_out).all() and (diff <= bound).all()):
                raise AssertionError(f"gnn_gemm {name} vs plain: max |err| {float(diff.max())}")
            err = max(err, float(diff.max()))
        w_kn = wt[:N].t()  # (K, N) view of the same weights
        flops = 2 * M * N * F
        bytes_moved = (2 * M * F + 2 * N * F + (4 * N if bias is not None else 0)
                       + 4 * M * N * n_res + {"bf16": 2, "f32": 4, "both": 6}[outs] * M * N)
        t_bytes, t_ops = bytes_moved / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S
        ms = cuda_ms_back_to_back(lambda: G.gnn_gemm(x, wt, N, **kw))
        device_ms = kernel_device_ms(lambda: G.gnn_gemm(x, wt, N, **kw), r"gnn_gemm_kernel")
        rows.append({
            "name": "gnn_gemm", "shape": name, "M": M, "N": N, "K": F,
            "epilogue": {"bias": bias is not None, "residuals": n_res, "relu": relu,
                         "out": outs},
            "launch": launch, "max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": cuda_ms_back_to_back(lambda: G.gnn_gemm_plain(x, wt, N, **kw), reps=5),
            "library_ms": cuda_ms_back_to_back(lambda: torch.matmul(x, w_kn)),
            "library_device_ms": kernel_device_ms(lambda: torch.matmul(x, w_kn), "."),
            "library_call": "torch.matmul, bf16 operands and out",
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "achieved_tflop_s": flops / (device_ms * 1e-3) / 1e12})
    return rows


def compare_message(ins) -> list[dict]:
    """The message round's kernels at the rope chunk's edge slots: the
    receiver segments equal to `receiver_segments_plain` on the slots as
    `construct_edge_indices_batch` packs them (receiver-major) and
    permuted; one round's aggregation bit-equal to `gnn_message_plain` and
    to itself on a second run, on both. Random f32 rel_pre and ewr | ews;
    each kernel a call's mean back to back and its device ms, beside the
    bytes of the slots that reach an aggregation and of their receivers'
    and senders' rows."""
    from gsdx_torch.kernels import gnn_forward as G

    recv, send = ins[4], ins[5]
    B, E = recv.shape
    n_pad, F = ins[0].shape[1], 512
    g = torch.Generator(device="cuda").manual_seed(6)
    rel_pre = torch.randn(B * E, F, device="cuda", generator=g)
    ew = torch.randn(B * n_pad, 2 * F, device="cuda", generator=g)
    perm = torch.randperm(E, device="cuda", generator=g)
    cases = {"receiver_major": (recv, send),
             "permuted": (recv[:, perm].contiguous(), send[:, perm].contiguous())}
    for case, (rv, sd) in cases.items():
        seg = G.gnn_segments(rv, n_pad)
        ref = G.receiver_segments_plain(rv, n_pad)
        agg = G.gnn_message(rel_pre, ew, *seg, sd, n_pad)
        again = G.gnn_message(rel_pre, ew, *seg, sd, n_pad)
        plain = G.gnn_message_plain(rel_pre, ew, *seg, sd, n_pad)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(seg, ref)):
            raise AssertionError(f"gnn_segments differs from its plain version ({case} slots)")
        if not (torch.equal(agg, plain) and torch.equal(agg, again)):
            raise AssertionError(f"gnn_message is not bit-equal to its plain version and to "
                                 f"itself ({case} slots)")
    seg = G.gnn_segments(recv, n_pad)
    counts = G.message_counts(recv, send, n_pad)
    n_msg = counts["n_messages"]
    need = G.forward_bytes(B * n_pad, B * E, F, 9, 1, n_samples=B, **counts)
    common = {"route": "cuda", "source": "gsdx_torch/csrc/gnn_forward.cu", "B": B, "E": E,
              "n_pad": n_pad, "messages": n_msg, "receivers": counts["n_receivers"],
              "senders": counts["n_senders"], "max_abs_err": 0.0,
              "equal_to_plain": True, "bound_by": "bytes", "library_ms": None,
              "library_call": "none: no single PyTorch call computes it"}
    return [
        dict(common, name="gnn_segments",
             ms=cuda_ms_back_to_back(lambda: G.gnn_segments(recv, n_pad)),
             device_ms=kernel_device_ms(lambda: G.gnn_segments(recv, n_pad),
                                        r"gnn_segments_kernel"),
             plain_ms=cuda_ms_back_to_back(lambda: G.receiver_segments_plain(recv, n_pad),
                                           reps=5),
             bound_ms=1e3 * need["gnn_segments"] / PEAK_BYTES_S),
        dict(common, name="gnn_message",
             ms=cuda_ms_back_to_back(lambda: G.gnn_message(rel_pre, ew, *seg, send, n_pad)),
             device_ms=kernel_device_ms(lambda: G.gnn_message(rel_pre, ew, *seg, send, n_pad),
                                        r"gnn_message_kernel"),
             plain_ms=cuda_ms_back_to_back(
                 lambda: G.gnn_message_plain(rel_pre, ew, *seg, send, n_pad), reps=5),
             bound_ms=1e3 * need["gnn_message"] / PEAK_BYTES_S)]


def phase_gnn_kernels() -> dict:
    """Kernel #3 at the rope shapes the plan phase gives it (one 125-sample
    chunk of 1000), its GEMM at that chunk's product shapes, its segments
    and message kernels at that chunk's edge slots, and the forward at the
    cloth family's 256 / 1200 shapes."""
    from gsdx_torch.dynamics.model import DynamicsPredictor, ModelConfig, flax_params
    from gsdx_torch.kernels import gnn_forward as G

    rope = G.pack_gnn_params(flax_params(rope_model(), as_numpy=False), device="cuda")
    rope_ins = gnn_inputs(125, 100, 128, 500, 5, 0.08, False)
    out = {"rope": compare_gnn("gnn_forward_rope", rope, rope_ins, 100, "trained"),
           "gemm": compare_gemm(rope), "round": compare_message(rope_ins)}
    cloth = DynamicsPredictor(ModelConfig(state_dim=1, motion_dim=3),
                              generator=torch.Generator().manual_seed(0))
    packed = G.pack_gnn_params(flax_params(cloth, as_numpy=False), device="cuda")
    out["cloth"] = compare_gnn("gnn_forward_cloth", packed,
                               gnn_inputs(125, 150, 256, 1200, 6, 0.075, True), 150, "random")
    for r in [out["rope"], *out["gemm"], *out["round"], out["cloth"]]:
        emit(dict(r, phase="kernels"))
    return out


def edges_table_row(main: dict, rows: list[dict], plan_row: dict) -> dict:
    """The kernel table's row of the radius-graph kernel: the rope chunk's
    numbers, the plan phase's launches, and every shape's."""
    shape_keys = ("B", "N", "topk", "max_nR", "width", "edges_mean", "ms", "device_ms",
                  "plain_ms", "plain_device_ms", "bound_ms", "bound_by")
    return {"name": "edges", "route": "cuda", "source": "gsdx_torch/csrc/edges.cu",
            "replaces": "gsdx/graph/edges.py:130", "launches": plan_row["launches"]["edges"],
            **{k: main[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "latency_floor_ms")},
            "shapes": {r["shape"]: {k: r[k] for k in shape_keys} for r in rows}}


def phase_rasterize(card: str) -> list[dict]:
    """fwd+bwd of `rasterize` at 720p (3 colour channels, binning included)."""
    from gsdx_torch.render.rasterize import RasterizeConfig, rasterize, resolve_binning

    rows = []
    cam = camera()
    target = torch.zeros(3, H, W, device="cuda")
    for n in (5000, 16384, 65536):
        args = scene(np.random.default_rng(0), n)
        for a in args:
            a.requires_grad_(True)

        def step():
            out = rasterize(*args, cam, RasterizeConfig())
            loss = torch.abs(out.im - target).mean()
            return torch.autograd.grad(loss, args)

        grads = step()
        if not all(torch.isfinite(g).all() for g in grads):
            raise AssertionError(f"non-finite rasterize gradient at n={n}")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(step, reps=20, warmup=3)
        cfg = resolve_binning(RasterizeConfig(), n)
        row = {"phase": "rasterize", "card": card, "n": n, "binning": cfg.binning,
               "tile_h": cfg.tile_h, "sub_chunk": cfg.sub_chunk,
               "fwd_bwd_ms": ms, "mpix_s": H * W / (ms * 1e3),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        emit(row)
        rows.append(row)
    return rows


N_PTS, CAPACITY, N_CAMS = 6144, 8192, 4


def slice_inputs():
    """A 4-camera 720p rope-scale scene: a 6144-point coloured cloud (seg
    0/1), targets for t=0 and t=1 (moved 1 cm) rendered by the port from
    four poses around the cloud, and the noisy cloud the fit starts from."""
    from gsdx_torch.core.cameras import stack_cameras
    from gsdx_torch.render.rasterize import RasterizeConfig, rasterize

    rng = np.random.default_rng(1)
    pts = np.concatenate([
        rng.uniform(-0.4, 0.4, size=(N_PTS, 3)) + np.array([0, 0, 2.5]),
        rng.uniform(0.2, 0.8, size=(N_PTS, 3)),
        (rng.uniform(size=(N_PTS, 1)) > 0.3)], 1).astype(np.float32)
    cams = []
    for c, ang in enumerate((0.0, 0.25, -0.25, 0.12)):
        w2c = np.eye(4, dtype=np.float32)
        co, si = np.cos(ang), np.sin(ang)
        w2c[:3, :3] = np.array([[co, 0, si], [0, 1, 0], [-si, 0, co]])
        w2c[:3, 3] = w2c[:3, :3] @ np.array([0, 0, -2.5]) + np.array([0, 0, 2.5])
        cams.append(camera(cam_id=c, w2c=w2c))
    cams = stack_cameras(cams)
    ims, segs = [], []
    for t in range(2):
        moved = torch.as_tensor(pts, device="cuda")
        moved[:, 0] += 0.01 * t
        n = len(moved)
        geo = [moved[:, :3], torch.tensor([[1.0, 0, 0, 0]], device="cuda").repeat(n, 1),
               torch.full((n, 3), 0.012, device="cuda"),
               torch.full((n, 1), 0.9, device="cuda")]
        seg_col = torch.stack([moved[:, 6], torch.zeros(n, device="cuda"),
                               1 - moved[:, 6]], -1)
        with torch.no_grad():
            ims.append(torch.stack([rasterize(*geo, moved[:, 3:6], cams[c],
                                              RasterizeConfig()).im
                                    for c in range(N_CAMS)]))
            # seg targets are (seg, 0, 1-seg) over a zero background, the
            # background the fused render gives its seg channels
            segs.append(torch.stack([rasterize(*geo, seg_col, cams[c],
                                               RasterizeConfig(),
                                               bg=torch.zeros(3, device="cuda")).im
                                     for c in range(N_CAMS)]))
    noisy = pts.copy()
    noisy[:, :3] += rng.normal(scale=0.01, size=(N_PTS, 3)).astype(np.float32)
    return cams, torch.stack(ims), torch.stack(segs), noisy


def phase_slice(card: str) -> dict:
    """`track_sequence` over two timesteps: t=0 with densification at
    iterations 20 and 40, t=1 with one 40-iteration frozen-bin block."""
    from gsdx_torch.core.gaussians import init_gaussian_params
    from gsdx_torch.kernels import composite as C
    from gsdx_torch.kernels.knn import knn
    from gsdx_torch.track.densify import DensifyConfig
    from gsdx_torch.track.trainer import TrackingConfig, track_sequence

    cams, ims, segs, noisy = slice_inputs()
    sq, _ = knn(torch.as_tensor(noisy[:, :3], device="cuda"), 3)
    params = init_gaussian_params(noisy, sq.mean(-1).cpu().numpy(),
                                  capacity=CAPACITY, device="cuda")
    cfg = TrackingConfig(iters_first=60, iters_rest=40,
                         densify=DensifyConfig(start=20, interval=20, end=40))
    per_t = {}

    def on_timestep(t, seconds, logs):
        per_t[t] = {"seconds": seconds, "iters": len(logs["loss"]),
                    "loss": logs["loss"].cpu().numpy(),
                    "psnr": logs["psnr"].cpu().numpy(),
                    "num_pts": logs["num_pts"].cpu().numpy()}

    C.reset_launches()
    out = track_sequence(params, cams, ims, segs, 2, cfg, on_timestep=on_timestep,
                         device="cuda")
    torch.cuda.synchronize()
    launches = dict(C.LAUNCHES)
    t0, t1 = per_t[0], per_t[1]
    row = {"phase": "slice", "card": card, "cameras": N_CAMS, "height": H, "width": W,
           "capacity": CAPACITY, "launches": launches,
           "t0_iters_s": t0["iters"] / t0["seconds"],
           "t1_iters_s": t1["iters"] / t1["seconds"],
           "t0_psnr_first10": float(t0["psnr"][:10].mean()),
           "t0_psnr_last10": float(t0["psnr"][-10:].mean()),
           "t1_psnr_last": float(t1["psnr"][-1]),
           "num_pts": [int(t0["num_pts"][0]), int(t0["num_pts"][20]),
                       int(t0["num_pts"][40]), int(t0["num_pts"][-1])],
           "t0_loss_last": float(t0["loss"][-1]),
           "t1_loss_last": float(t1["loss"][-1]),
           "snapshot_points": int(out[-1]["means3D"].shape[0])}
    emit(row)
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel variant {k} never launched in the slice")
    for t in (t0, t1):
        if not (np.isfinite(t["loss"]).all() and np.isfinite(t["psnr"]).all()):
            raise AssertionError("non-finite loss or PSNR in the slice")
    if not row["t0_psnr_last10"] > row["t0_psnr_first10"]:
        raise AssertionError("PSNR did not rise at t=0")
    if row["num_pts"][1] == row["num_pts"][0]:
        raise AssertionError("densification changed nothing at t=0")
    return row


PLAN_SPEC = dict(n_his=3, max_nobj=100, max_nR=500, topk=5, adj_thresh=0.08,
                 sort_chunks=8)


def plan_setup(n_sample: int, n_update_iter: int, model=None):
    """The plan CLI's planner at rope width on the committed trajectory:
    the current state is frame 0 at 100 particles, the target frame 12.
    The rollout passed to the planner sums each batch's repeat counts."""
    from gsdx_torch.plan.actions import decode_action
    from gsdx_torch.plan.cost import running_cost
    from gsdx_torch.plan.dynamics_rollout import RolloutSpec, make_batched_rollout
    from gsdx_torch.plan.planner import MPPIConfig, Planner
    from gsdx_torch.realworld.env import WORKSPACE_BBOX

    model = model or rope_model()
    frames = trajectory_particles(100)
    state, target = frames[0].contiguous(), frames[12].contiguous()
    rollout = make_batched_rollout(model, RolloutSpec(**PLAN_SPEC))
    bbox = torch.as_tensor(WORKSPACE_BBOX, device="cuda")
    record = {"needed": 0}

    def counting_rollout(s, acts, **kw):
        # the unit pushes the samples need (the action limits keep each
        # repeat count within max_repeat)
        record["needed"] += int(decode_action(acts)[1].sum())
        return rollout(s, acts, **kw)

    planner = Planner(MPPIConfig(n_sample=n_sample, n_update_iter=n_update_iter),
                      counting_rollout,
                      lambda ss, aa, s: running_cost(ss, aa, s, target, bbox),
                      device="cuda")
    init = torch.tensor([[0.3, 0.0, 0.0, 10.0]], device="cuda")
    return planner, state, init, record


def phase_plan(card: str) -> dict:
    """One `trajectory_optimization` at rope width, 1000 samples, 2 update
    iterations (the path `apps/plan.py` runs, cut in depth only)."""
    from gsdx_torch.kernels import gnn_forward as G
    from gsdx_torch.plan.actions import sample_action_seq
    from gsdx_torch.plan.dynamics_rollout import RolloutSpec, make_batched_rollout

    model = rope_model()
    planner, state, init, record = plan_setup(1000, 2, model)
    gen = torch.Generator(device="cuda").manual_seed(43)
    torch.cuda.synchronize()
    G.reset_launches()
    t0 = time.perf_counter()
    out = planner.trajectory_optimization(gen, state, init)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(G.LAUNCHES)
    # each fused forward evaluates one push of every sample in a chunk
    evaluated = launches["gnn_forward"] * (1000 // PLAN_SPEC["sort_chunks"])
    iter_best = out["iter_best"].cpu().numpy()
    row = {"phase": "plan", "card": card, "n_sample": 1000, "n_obj": 100,
           "max_nR": 500, "sort_chunks": 8, "n_update_iter": 2,
           "launches": launches, "seconds": seconds,
           "seconds_per_iter": seconds / 2,
           "push_steps": launches["gnn_forward"],
           "sample_pushes_needed": record["needed"],
           "sample_pushes_evaluated": evaluated,
           "sample_pushes_per_s": record["needed"] / seconds,
           "evaluated_sample_pushes_per_s": evaluated / seconds,
           "iter_best": iter_best.tolist(),
           "best_reward": float(out["best_reward"]),
           "best_act": out["act_seq"].cpu().numpy().tolist()}
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"GNN kernel {k} never launched in the plan phase")
    # every product of depth F on the tensor-core GEMM, the three node-input
    # layers on gnn_linear, the receiver segments once and a message a round;
    # the push step's radius graph in one launch
    forwards = launches["gnn_forward"]
    per_forward = {"gnn_gemm": 15, "gnn_linear": 3, "gnn_edge_first": 1, "gnn_segments": 1,
                   "gnn_message": 3, "edges": 1}
    if any(launches[k] != n * forwards for k, n in per_forward.items()):
        raise AssertionError(f"plan phase launches {launches}: expected {per_forward} "
                             "a forward")
    if not (np.isfinite(iter_best).all() and np.isfinite(row["best_reward"])):
        raise AssertionError("non-finite rewards in the plan phase")
    if not row["best_reward"] >= iter_best[0]:
        raise AssertionError("the best reward fell below iteration 0's best")

    # the fused rollout against the module rollout on 16 samples, the
    # module's weights rounded to bf16 and back as the kernels store them
    model_bf = rope_model()
    with torch.no_grad():
        for p in model_bf.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    acts = sample_action_seq(torch.Generator(device="cuda").manual_seed(1), init,
                             planner.lower, planner.upper, 16)
    spec = dict(PLAN_SPEC, sort_chunks=1)
    with torch.no_grad():
        fused = make_batched_rollout(model, RolloutSpec(**spec))(state, acts)
        module = make_batched_rollout(model_bf, RolloutSpec(**spec, fused="off"))(state, acts)
    err = float((fused["state_seqs"] - module["state_seqs"]).abs().max())
    row["fused_vs_module_max_abs_err"] = err
    # device ms by kernel of one MPPI iteration of the same planner
    planner1, state1, init1, _ = plan_setup(1000, 1, model)
    gen1 = torch.Generator(device="cuda").manual_seed(43)
    prof = device_profile(lambda: planner1.trajectory_optimization(gen1, state1, init1),
                          "MPPI iteration, rope, 1000 samples, 100 particles, 8 chunks",
                          steps=1, groups=GNN_KERNELS)
    row["mppi_iteration"] = {k: prof[k] for k in (
        "wall_ms_per_call", "device_busy_ms_per_call", "device_idle_share",
        "launches_per_call", "device_ms_by_group")}
    emit(row)
    # tests/test_gnn_fused.py's bf16-class tolerance for chained pushes
    if not err <= 2e-3:
        raise AssertionError(f"fused rollout vs module rollout: {err} > 2e-3")
    return row


GNN_KERNELS = ("gnn_gemm", "gnn_message", "gnn_linear", "gnn_edge_first", "gnn_segments")


def device_profile(fn, what: str, steps: int = 5, top: int = 12,
                   groups: tuple[str, ...] = ()) -> dict:
    """Where one call of ``fn`` spends its time: the wall time of ``steps``
    calls after a warm-up, then `torch.profiler` over as many calls for the
    device time summed by kernel name (and by each of ``groups``: the
    kernels named <group>_kernel). The idle share compares the device time
    with the wall time taken without the profiler, which slows the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def wall(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    fn()
    wall_ms = wall(fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = wall(fn)
    # device-side events only: a host op's self device time repeats its kernels'
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    composite_ms = sum(k[1] for k in kernels if re.search(r"\b(fwd|bwd)_kernel<", k[0]))
    by_group = {g: sum(k[1] for k in kernels if f"{g}_kernel" in k[0]) for g in groups}
    by_group["other"] = busy_ms - sum(by_group.values())
    return {"phase": "profile", "what": what, "wall_ms_per_call": wall_ms,
            "device_ms_by_group": by_group,
            "profiled_wall_ms_per_call": profiled_wall_ms,
            "device_busy_ms_per_call": busy_ms,
            "compositor_device_ms_per_call": composite_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
            "launches_per_call": sum(k[2] for k in kernels),
            "top_kernels": [{"name": n[:80], "ms": ms, "calls": c}
                            for n, ms, c in kernels[:top]]}


def tracking_iteration():
    """One t=0 tracking iteration of the slice's scene (densification off),
    as a function of no arguments."""
    from gsdx_torch.core.gaussians import init_gaussian_params, init_tracking_variables
    from gsdx_torch.kernels.knn import knn
    from gsdx_torch.track.densify import DensifyConfig
    from gsdx_torch.track.optimizer import GroupAdam, tracking_lrs
    from gsdx_torch.track.trainer import TrackingConfig, make_fit_timestep

    cams, ims, segs, noisy = slice_inputs()
    sq, _ = knn(torch.as_tensor(noisy[:, :3], device="cuda"), 3)
    params = init_gaussian_params(noisy, sq.mean(-1).cpu().numpy(),
                                  capacity=CAPACITY, device="cuda")
    cfg = TrackingConfig(densify=DensifyConfig(start=10**9))
    fit = make_fit_timestep(cfg, is_initial=True, num_iters=1)
    adam = GroupAdam()
    state = (adam.init(params), init_tracking_variables(CAPACITY, cfg.num_knn, 1.0,
                                                        device="cuda"))
    lrs = tracking_lrs(1.0)

    def track_iter():
        fit(params, *state, lrs, cams, ims[0], segs[0], np.zeros(1, np.int32))

    return track_iter


def phase_profile(train_iteration, predict_step, online_iteration) -> list[dict]:
    """Device breakdown of a 5k-Gaussian 720p rasterize fwd+bwd, of one t=0
    tracking iteration of the slice's scene (densification off), of one
    MPPI iteration of the plan phase, of one rope-width train iteration
    (batch assembly and step), of one predict step (a rollout step and 4
    renders at 720p) and of one online fit iteration (4 cameras at
    640x480, fused rgb + seg)."""
    from gsdx_torch.render.rasterize import RasterizeConfig, rasterize

    cam = camera()
    target = torch.zeros(3, H, W, device="cuda")
    args = scene(np.random.default_rng(0), 5000)
    for a in args:
        a.requires_grad_(True)

    def raster_step():
        out = rasterize(*args, cam, RasterizeConfig())
        torch.autograd.grad(torch.abs(out.im - target).mean(), args)

    rows = [device_profile(raster_step, "rasterize fwd+bwd, 5000 Gaussians, 720p")]
    rows.append(device_profile(
        tracking_iteration(), "tracking iteration t=0, 4 cameras, 720p, capacity 8192"))

    planner, state, init, _ = plan_setup(1000, 1)
    gen = torch.Generator(device="cuda").manual_seed(43)
    rows.append(device_profile(
        lambda: planner.trajectory_optimization(gen, state, init),
        "MPPI iteration, rope, 1000 samples, 100 particles, 8 chunks", steps=2,
        groups=GNN_KERNELS))
    rows.append(device_profile(
        train_iteration, "train iteration, rope width, batch 16, n_future 5 "
        "(batch assembly and step)"))
    rows.append(device_profile(
        predict_step, "predict step: a rollout step and 4 renders at 720p"))
    rows.append(device_profile(
        online_iteration, "online fit iteration, rope, 4 cameras, 640x480, fitted scene"))
    for r in rows:
        emit(r)
    return rows


def phase_cli() -> dict:
    """The tracking CLI on a small synthetic 2-timestep, 3-camera episode."""
    from PIL import Image

    from gsdx_torch.core.cameras import make_camera
    from gsdx_torch.render.rasterize import RasterizeConfig, rasterize

    h, w = 96, 160
    rng = np.random.default_rng(2)
    n = 300
    pts = np.concatenate([rng.uniform(-0.3, 0.3, (n, 3)) + [0, 0, 3.0],
                          rng.uniform(0.1, 0.9, (n, 3)),
                          rng.uniform(size=(n, 1)) > 0.3], 1).astype(np.float32)
    k = np.array([[120.0, 0, w / 2], [0, 120.0, h / 2], [0, 0, 1]], np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        fn, ks, w2cs = [], [], []
        for t in range(2):
            moved = torch.as_tensor(pts, device="cuda")
            moved[:, 0] += 0.01 * t
            geo = [moved[:, :3], torch.tensor([[1.0, 0, 0, 0]], device="cuda").repeat(n, 1),
                   torch.full((n, 3), 0.03, device="cuda"),
                   torch.full((n, 1), 0.9, device="cuda")]
            seg_col = torch.stack([moved[:, 6], torch.zeros(n, device="cuda"),
                                   1 - moved[:, 6]], -1)
            row, w2c_row = [], []
            for c, ang in enumerate((0.0, 0.3, -0.3)):
                w2c = np.eye(4, dtype=np.float32)
                w2c[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                               [-np.sin(ang), 0, np.cos(ang)]]
                cam = make_camera(k, w2c, width=w, height=h, device="cuda")
                with torch.no_grad():
                    im = rasterize(*geo, moved[:, 3:6], cam, RasterizeConfig()).im
                    seg = rasterize(*geo, seg_col, cam, RasterizeConfig()).im
                d = os.path.join(tmp, f"camera_{c}")
                os.makedirs(os.path.join(d, "seg"), exist_ok=True)
                Image.fromarray((im.clamp(0, 1).permute(1, 2, 0).cpu().numpy() * 255
                                 ).astype(np.uint8)).save(
                    os.path.join(d, f"color_{t:06d}.jpg"), quality=98)
                Image.fromarray(((seg[0] > 0.5).cpu().numpy() * 255).astype(np.uint8)
                                ).save(os.path.join(d, "seg", f"seg_{t:06d}.png"))
                row.append(f"camera_{c}/color_{t:06d}.jpg")
                w2c_row.append(w2c.tolist())
            fn.append(row)
            ks.append([k.tolist()] * 3)
            w2cs.append(w2c_row)
        with open(os.path.join(tmp, "train_meta.json"), "w") as f:
            json.dump({"w": w, "h": h, "k": ks, "w2c": w2cs, "fn": fn,
                       "cam_id": [[0, 1, 2]] * 2}, f)
        np.savez(os.path.join(tmp, "init_pt_cld.npz"), data=pts)
        out_dir = os.path.join(tmp, "out")
        t_start = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "gsdx_torch.apps.track", "--sequence", tmp,
             "--exp_name", "smoke", "--output_dir", out_dir, "--device", "cuda",
             "--iters_first", "30", "--iters_rest", "10", "--num_knn", "4"],
            check=True, cwd=os.path.dirname(os.path.abspath(__file__)))
        params = np.load(os.path.join(out_dir, "smoke", os.path.basename(tmp),
                                      "params.npz"))
        means = params["means3D"]
        if means.shape[0] != 2 or not np.isfinite(means).all():
            raise AssertionError(f"bad params.npz means3D {means.shape}")
        row = {"phase": "cli", "seconds": time.perf_counter() - t_start,
               "means3D": list(means.shape), "keys": sorted(params.files)}
    emit(row)
    return row


def phase_plan_cli() -> dict:
    """The planning CLI on the simulated environment, from a scratch
    working directory whose log/rope/checkpoints/latest.ckpt links to the
    committed rope checkpoint (the CLI reads `<out_dir>/checkpoints`)."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "log", "rope", "checkpoints")
        os.makedirs(ckpt_dir)
        os.symlink(ROPE_CKPT, os.path.join(ckpt_dir, "latest.ckpt"))
        out = os.path.join(tmp, "out")
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t_start = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "gsdx_torch.apps.plan", "--config",
             os.path.join(REPO, "configs", "rope.yaml"), "--env", "fake",
             "--n_actions", "1", "--n_chunks", "1", "--n_sample", "200",
             "--out", out], check=True, cwd=tmp, env=env)
        res = np.load(os.path.join(out, "interaction_0.npz"))
        with open(os.path.join(out, "stats.txt")) as f:
            stats = f.read().strip()
        if res["action"].shape != (4,) or not np.isfinite(float(res["reward"])):
            raise AssertionError("bad interaction_0.npz from the plan CLI")
        row = {"phase": "cli_plan", "seconds": time.perf_counter() - t_start,
               "action": res["action"].tolist(), "reward": float(res["reward"]),
               "chamfer_before": float(res["chamfer_before"]),
               "chamfer_after": float(res["chamfer_after"]), "stats": stats}
    emit(row)
    return row


PIPELINE = os.path.join(REPO, "benchmarks/out/pipeline")
ROPE_YAML = os.path.join(REPO, "configs/rope.yaml")
LEARN_STEPS = 20


def episode_copy(tmp: str) -> tuple[str, str]:
    """The committed tracked rope episode copied under ``tmp`` (the path
    writes beside it): (raw data dir, tracking output dir)."""
    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    shutil.copytree(os.path.join(PIPELINE, "data"), data)
    shutil.copytree(os.path.join(PIPELINE, "ckpts"), out)
    return data, out


def events_ms(fn):
    """(fn's result, its ms between two CUDA events)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def phase_learn(card: str):
    """Preprocess the committed episode (its own settings: dist 0.005,
    n_his 3, n_future 3, 1000 particles), then take LEARN_STEPS train steps
    of configs/rope.yaml at full width from a seeded init. Returns (row, a
    function of no arguments running one train iteration)."""
    from gsdx_torch.dynamics.train import init_params, make_train_step
    from gsdx_torch.graph.dataset import EpisodeStore, GraphSampler
    from gsdx_torch.io.config import load_config
    from gsdx_torch.io.episodes import eef_world_positions, load_metadata
    from gsdx_torch.io.preprocess import preprocess_episode
    from gsdx_torch.kernels import fps as F

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    F.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        data, out = episode_copy(tmp)
        prep = os.path.join(tmp, "prep")
        t0 = time.perf_counter()
        rows = preprocess_episode(data, out, prep, dist_thresh=0.005, n_his=3, n_future=3,
                                  episode_idx=0, n_downsample=1000, device="cuda")
        prep_s = time.perf_counter() - t0
        committed = np.loadtxt(os.path.join(PIPELINE, "prep/frame_pairs/0.txt")).astype(np.int64)
        written = np.loadtxt(os.path.join(prep, "frame_pairs/0.txt")).astype(np.int64)
        if not (np.array_equal(rows, committed) and np.array_equal(written, committed)):
            raise AssertionError("the frame pairs differ from the committed "
                                 "prep/frame_pairs/0.txt")
        down = np.load(os.path.join(out, "param_downsampled.npy"))
        # the trajectories keep the FPS order: the first differing column is
        # the first differing pick
        per_pick = np.abs(down - np.load(TRAJ)).max(axis=(0, 2))
        differ = np.nonzero(per_pick > 0)[0]
        eef = eef_world_positions(data, load_metadata(os.path.join(out, "metadata.json")))

    train_cfg, model_cfg, data_cfg = load_config(ROPE_YAML)
    pairs = written[written.max(1) < len(down)]
    pairs = np.concatenate([np.zeros((len(pairs), 1), np.int64), pairs], 1)
    sampler = GraphSampler(EpisodeStore.from_numpy([down], [eef], [pairs], device="cuda"),
                           data_cfg, "train")
    model = init_params(model_cfg, 0, "cuda")
    train_step, _, _ = make_train_step(model, train_cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    losses, ms_batch, ms_step = [], [], []
    for _ in range(LEARN_STEPS):
        batch, mb = events_ms(lambda: sampler.sample(g, train_cfg.batch_size))
        (loss, _), ms = events_ms(lambda: train_step(batch))
        losses.append(float(loss))
        ms_batch.append(mb)
        ms_step.append(ms)
    fps_launches = dict(F.LAUNCHES)
    B = train_cfg.batch_size
    row = {"phase": "learn", "card": card, "preprocess_s": prep_s,
           "frame_pairs_equal_committed": True, "pairs": int(len(rows)),
           "downsampled_max_abs_diff": float(per_pick.max()),
           "first_differing_fps_pick": int(differ[0]) if len(differ) else None,
           "config": "configs/rope.yaml", "nf": model_cfg.nf_effect, "batch_size": B,
           "n_his": train_cfg.n_his, "n_future": train_cfg.n_future,
           "max_nobj": data_cfg.max_nobj, "max_nR": data_cfg.max_nR,
           "particles": int(down.shape[1]), "steps": LEARN_STEPS,
           "batch_ms": float(np.median(ms_batch)), "train_step_ms": float(np.median(ms_step)),
           "samples_per_s": B / (float(np.median(ms_batch)) + float(np.median(ms_step))) * 1e3,
           "first_step_ms": ms_batch[0] + ms_step[0], "losses": losses,
           "fps_launches": fps_launches, "seconds": time.perf_counter() - t_phase}
    emit(row)
    if not all(fps_launches.values()):
        raise AssertionError(f"the FPS kernels did not launch in learn: {fps_launches}")
    # the preprocessing's FPS picks (now the kernel's) equal the committed ones
    if row["first_differing_fps_pick"] is not None or row["downsampled_max_abs_diff"] != 0:
        raise AssertionError("the downsampled trajectory differs from the committed one from "
                             f"FPS pick {row['first_differing_fps_pick']}")
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite training loss")
    # The first Adam steps from a random init spike the loss, which inflates
    # the mean of the first 5: the last 5 must also sit below step 0's loss.
    if not np.mean(losses[-5:]) < min(np.mean(losses[:5]), losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")

    def train_iteration():
        train_step(sampler.sample(g, B))

    return row, train_iteration


def record_calls(module, name: str):
    """Replace ``module.name`` by a wrapper that records each call's
    arguments; returns (the list of calls, a function restoring it)."""
    orig, calls = getattr(module, name), []

    def wrapper(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    setattr(module, name, wrapper)
    return calls, lambda: setattr(module, name, orig)


def rank_deficient(calls) -> tuple[int, int]:
    """(bones whose Kabsch covariance has sigma_2 / sigma_1 < 1e-3, bones
    with a neighbour) over the recorded `bone_rotations` calls."""
    from gsdx_torch.rollout.skinning import bone_covariance

    low = total = 0
    for args, kw in calls:
        F, n_adj = bone_covariance(*args, **kw)
        s = torch.linalg.svdvals(F[n_adj > 0])
        low += int((s[:, 1] < 1e-3 * s[:, 0]).sum())
        total += int(s.shape[0])
    return low, total


def largest_difference(out_k, out_p, counts, sub: int, tile_w: int) -> dict:
    """Where the forward kernel's outputs differ most from the plain
    version's: the tile, the output row (accum channel, or "logT"), the
    pixel (x, y in the tile), the two values, and whether that tile walked
    its whole list with no early stop."""
    acc = (out_k[0] - out_p[0]).abs()
    lt = (out_k[1] - out_p[1]).abs()
    use_lt = float(lt.max()) > float(acc.max())
    d = lt if use_lt else acc
    t, ch, px = np.unravel_index(int(torch.argmax(d)), tuple(d.shape))
    src = 1 if use_lt else 0
    return {"tile": int(t), "row": "logT" if use_lt else int(ch),
            "pixel": [int(px % tile_w), int(px // tile_w)],
            "kernel": float(out_k[src][t, ch, px]), "plain": float(out_p[src][t, ch, px]),
            "abs_diff": float(d[t, ch, px]), "count": int(counts[t]),
            "nproc": int(out_k[2][t]),
            "walked_whole_list": bool(int(out_k[2][t]) * sub >= int(counts[t])),
            "tiles_differing": int((acc.flatten(1).amax(1) + lt.flatten(1).amax(1)
                                    > 0).sum())}


def compare_fwd_at(tf, counts, geo: dict, clk_mhz: float, what: str,
                   presort: bool = False) -> dict:
    """Kernel #1's forward (with ``presort``, its presorting variant)
    against its plain version on one frame's tile inputs, timed and bounded
    as the `kernels` phase does, with the place of the largest difference."""
    from gsdx_torch.kernels import composite as C

    kw = dict(geo, presort=presort)
    out_k, err, launch = check_forward(tf, counts, geo, presort, what)
    with torch.no_grad():
        out_p = C.composite_tiles_torch(tf, counts, **kw)
    nproc = out_k[2]
    pairs = pair_counts(out_k[4] if presort else tf, counts, nproc, geo)
    if pairs["visible_outside_box"]:
        raise AssertionError("a visible pair lies outside its alpha_cut_box")
    nacc, visible = geo["n_accum"], pairs["visible"]
    bytes_f = needed_bytes(counts, nproc, geo, tf.shape[2], presort)[0]
    bound = bound_ms(bytes_f, (FLOPS_ALL + FWD_FLOPS_VIS(nacc)) * visible, 3 * visible,
                     clk_mhz)
    return {"name": "composite_fwd" + ("_presort" if presort else ""), "T": tf.shape[0],
            "K": tf.shape[2], "tile_h": geo["tile_h"], "sub": geo["sub_chunk"],
            "n_accum": nacc, "nonempty_tiles": int((counts > 0).sum()), "nproc_flips": 0,
            "early_stopped_tiles": int((nproc.long() * geo["sub_chunk"] < counts.long()).sum()),
            "pairs_processed": pairs["processed"], "pairs_visible": visible,
            "kept_share": pairs["patch_kept"] / max(1, pairs["patch_pairs"]),
            "max_abs_err": err, "launch": launch,
            "max_logt_diff": float((out_k[1] - out_p[1]).abs().max()),
            "largest_difference": largest_difference(out_k, out_p, counts, geo["sub_chunk"],
                                                     geo["tile_w"]),
            "ms": cuda_ms(lambda: C.composite_fwd(tf, counts, **kw)),
            "device_ms": kernel_device_ms(lambda: C.composite_fwd(tf, counts, **kw),
                                          r"\bfwd_kernel<"),
            "plain_ms": cuda_ms(lambda: C.composite_tiles_torch(tf, counts, **kw), reps=3,
                                warmup=1),
            "bound_ms": bound[0], "bound_by": bound[1], "bound_bytes": bytes_f}


def compare_bwd_at(tf, counts, geo: dict, clk_mhz: float, presort: bool = False) -> dict:
    """Kernel #2's backward (with ``presort``, on the forward's sorted copy
    and rank) against its plain version on one frame's tile inputs (random
    output gradients), timed and bounded as the `kernels` phase does."""
    from gsdx_torch.kernels import composite as C

    T, _, K = tf.shape
    nacc = geo["n_accum"]
    out_k = C.composite_fwd(tf, counts, **geo, presort=presort)
    nproc = out_k[2]
    feats, rank = (out_k[4], out_k[3]) if presort else (tf, None)
    args, args_p, grad_k, grad_p, launch, scale = check_backward(
        feats, counts, nproc, out_k[1], geo, rank)
    if launch["cluster"] < 2 or launch["blocks"] != T * launch["cluster"]:
        raise AssertionError(f"backward launched {launch}: expected clusters of >= 2 "
                             f"blocks, {T} of them")
    visible = pair_counts(feats, counts, nproc, geo)["visible"]
    bytes_b = needed_bytes(counts, nproc, geo, K, presort)[1]
    bound = bound_ms(bytes_b, (FLOPS_ALL + BWD_FLOPS_VIS(nacc)) * visible, 4 * visible,
                     clk_mhz)
    return {"name": "composite_bwd" + ("_presort" if presort else ""), "T": T, "K": K,
            "tile_h": geo["tile_h"], "sub": geo["sub_chunk"], "n_accum": nacc,
            "max_abs_err": float((grad_k - grad_p).abs().max()),
            "max_row_rel_err": float(((grad_k - grad_p).abs() / scale).max()),
            "launch": launch,
            "ms": cuda_ms(lambda: C.composite_bwd(*args, **geo)),
            "device_ms": kernel_device_ms(lambda: C.composite_bwd(*args, **geo),
                                          r"\bbwd_kernel<"),
            "plain_ms": cuda_ms(lambda: C.composite_bwd_torch(*args_p, **geo), reps=3,
                                warmup=1),
            "bound_ms": bound[0], "bound_by": bound[1], "bound_bytes": bytes_b}


def phase_predict(card: str, clk_mhz: float):
    """`collect_scene_data` on the committed 16-frame episode with the
    trained rope checkpoint, then all 4 cameras re-rendered at 1280x720 (64
    frames); kernel #1 at a predict frame's shape; one rollout step on the
    card against the same step on the CPU. Returns (row, kernel row, a
    function of no arguments running one predict step: a rollout step and
    4 renders)."""
    import copy
    import importlib

    from gsdx_torch.apps.predict import collect_scene_data, tracked_gaussians
    from gsdx_torch.core.pointcloud import iterative_statistical_outliers
    from gsdx_torch.dynamics.losses import chamfer_distance
    from gsdx_torch.io.config import load_config
    from gsdx_torch.io.episodes import eef_world_positions, load_metadata
    from gsdx_torch.kernels import composite as C
    from gsdx_torch.kernels import fps as F
    from gsdx_torch.kernels.fps import farthest_point_sampling
    from gsdx_torch.render.renderer import Renderer
    from gsdx_torch.rollout import skinning
    from gsdx_torch.rollout.dynamics_module import DynamicsModule, RolloutConfig
    from gsdx_torch.track.losses import calc_psnr

    t_phase = time.perf_counter()
    train_cfg, _, data_cfg = load_config(ROPE_YAML)
    model = rope_model()
    tmp = tempfile.mkdtemp()
    try:
        data, out = episode_copy(tmp)
        params_path = os.path.join(out, "params.npz")
        meta = load_metadata(os.path.join(out, "metadata.json"))
        eef = eef_world_positions(data, meta)
        # the first step the end effector moves (the rollout's skip rule)
        i1 = next(i for i in range(1, len(eef))
                  if np.linalg.norm(eef[i] - eef[0]) >= train_cfg.dist_thresh)
        renderer = Renderer(width=meta["w"], height=meta["h"], device="cuda")
        w2c = np.asarray(meta["w2c"][0], np.float32)
        k = np.asarray(meta["k"][0], np.float32)

        # the path, counted: rollout, then 4 cameras x 16 frames
        calls, restore = record_calls(skinning, "bone_rotations")
        torch.cuda.synchronize()
        C.reset_launches()
        F.reset_launches()
        t0 = time.perf_counter()
        try:
            scene, vis, _ = collect_scene_data(params_path, data, out, model, train_cfg,
                                               data_cfg, device="cuda")
        finally:
            restore()
        torch.cuda.synchronize()
        rollout_s = time.perf_counter() - t0
        fps_launches = dict(F.LAUNCHES)
        t0 = time.perf_counter()
        with torch.inference_mode():
            ims = [[renderer.render(w2c[c], k[c], sd)[0] for sd in scene] for c in range(4)]
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        launches = dict(C.LAUNCHES)
        if launches["fwd"] <= 0:
            raise AssertionError(f"the compositor forward never launched in predict: {launches}")
        if not all(fps_launches.values()):
            raise AssertionError(f"the FPS kernels never launched in predict: {fps_launches}")
        low_traj, bones_traj = rank_deficient(calls)

        with torch.inference_mode():
            psnr = [[float(calc_psnr(ims[c][t].clamp(0, 1), renderer.render(
                w2c[c], k[c], tracked_gaussians(params_path, t))[0].clamp(0, 1)))
                for t in range(len(scene))] for c in range(4)]
        del ims
        # the bones (slots the radius FPS kept) against the tracked
        # downsampled trajectory, from the first step on; and the skinned
        # Gaussians against the tracked ones
        tracked = torch.as_tensor(np.load(TRAJ), device="cuda")
        chamfer, chamfer_gs = {}, {}
        for t in range(i1, len(scene)):
            kp = torch.as_tensor(vis[t]["kp"], device="cuda")
            kp = kp[kp.abs().sum(1) > 0]
            chamfer[t] = float(chamfer_distance(kp[None], tracked[t][None]))
            gs = torch.as_tensor(scene[t]["means3D"], device="cuda")
            ref = torch.as_tensor(tracked_gaussians(params_path, t, 0.1)["means3D"],
                                  device="cuda")
            chamfer_gs[t] = float(chamfer_distance(gs[None], ref[None]))

        # the whole rollout on the CPU, and one step on both devices from the
        # same inputs (the first step)
        model_cpu = copy.deepcopy(model).cpu()
        scene_cpu, _, _ = collect_scene_data(params_path, data, out, model_cpu, train_cfg,
                                             data_cfg, device="cpu")
        traj_err = max(float(np.abs(a["means3D"] - b["means3D"]).max())
                       for a, b in zip(scene, scene_cpu))
        cfg = RolloutConfig(n_his=train_cfg.n_his, dist_thresh=train_cfg.dist_thresh,
                            max_nobj=data_cfg.max_nobj,
                            fps_radius=sum(data_cfg.fps_radius_range) / 2,
                            adj_thresh=sum(data_cfg.adj_radius_range) / 2, topk=data_cfg.topk,
                            connect_all=data_cfg.connect_all, max_nR=data_cfg.max_nR)
        g0 = tracked_gaussians(params_path, 0, min_opacity=0.1)
        xyz = torch.as_tensor(g0["means3D"], device="cuda")
        quat = torch.as_tensor(g0["rotations"], device="cuda")
        inl = torch.as_tensor(iterative_statistical_outliers(xyz, 50), device="cuda")
        proxy = xyz[inl][farthest_point_sampling(xyz[inl], cfg.n_fps_proxy)]
        step_in = (proxy[None].repeat(cfg.n_his, 1, 1),
                   torch.as_tensor(eef[0], device="cuda")[None].repeat(cfg.n_his, 1, 1),
                   torch.as_tensor(eef[i1] - eef[0], device="cuda"), xyz, quat)
        dm = DynamicsModule(model, cfg)
        calls, restore = record_calls(skinning, "bone_rotations")
        try:
            step_gpu = dm.step(*step_in)
            step_cpu = DynamicsModule(model_cpu, cfg).step(*[a.cpu() for a in step_in])
        finally:
            restore()
        low_step = rank_deficient(calls[:1])
        step_err = float((step_gpu[0].cpu() - step_cpu[0]).abs().max())
        step_ms = cuda_ms(lambda: dm.step(*step_in), reps=10)

        # kernel #1 on the tile inputs of camera 0 at a frame of the push
        t_k = min(len(scene) - 1, i1 + 4)
        R = importlib.import_module("gsdx_torch.render.rasterize")
        fwd_calls, restore = record_calls(R, "composite_fwd")
        try:
            with torch.inference_mode():
                renderer.render(w2c[0], k[0], scene[t_k])
        finally:
            restore()
        (tf, counts), kw = fwd_calls[0]
        geo = {key: kw[key] for key in ("tiles_x", "tile_h", "tile_w", "n_accum", "sub_chunk")}
        kernel = dict(compare_fwd_at(tf.clone(), counts.clone(), geo, clk_mhz,
                                     "predict frame"), frame=t_k,
                      camera=0, gaussians=int(len(g0["means3D"])))
        with torch.inference_mode():
            frame_ms = cuda_ms(lambda: renderer.render(w2c[0], k[0], scene[t_k]), reps=10)
    finally:
        shutil.rmtree(tmp)
    n_frames = 4 * len(scene)
    row = {"phase": "predict", "card": card, "frames": n_frames, "cameras": 4,
           "height": meta["h"], "width": meta["w"], "gaussians": int(len(g0["means3D"])),
           "launches": launches, "fps_launches": fps_launches, "rollout_s": rollout_s,
           "render_s": render_s,
           "rollout_step_ms": step_ms, "render_frame_ms": frame_ms,
           "render_frames_per_s": n_frames / render_s,
           "frames_per_s": n_frames / (rollout_s + render_s),
           "first_moving_step": int(i1), "step_card_vs_cpu_max_abs_m": step_err,
           "trajectory_card_vs_cpu_max_abs_m": traj_err,
           "rank_deficient_bones_step": low_step[0], "bones_step": low_step[1],
           "rank_deficient_bones_rollout": low_traj, "bones_rollout": bones_traj,
           "psnr_vs_tracked": psnr, "bone_chamfer_vs_tracked": chamfer,
           "gaussian_chamfer_vs_tracked": chamfer_gs,
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    emit(dict(kernel, phase="predict_kernel"))
    if not all(np.isfinite(s["means3D"]).all() for s in scene):
        raise AssertionError("non-finite rollout")
    if not step_err <= 1e-4:
        raise AssertionError(f"rollout step card vs CPU: {step_err} m > 1e-4")

    def predict_step():
        dm.step(*step_in)
        with torch.inference_mode():
            for c in range(4):
                renderer.render(w2c[c], k[c], scene[t_k])

    return row, kernel, predict_step


ONLINE_ITERS, ONLINE_W, ONLINE_H = 700, 640, 480


def rope_rollout_config():
    """The demo apps' rollout settings for configs/rope.yaml."""
    from gsdx_torch.io.config import load_config
    from gsdx_torch.rollout.dynamics_module import RolloutConfig

    train_cfg, _, data_cfg = load_config(ROPE_YAML)
    return RolloutConfig(n_his=train_cfg.n_his, dist_thresh=0.005,
                         max_nobj=data_cfg.max_nobj,
                         fps_radius=sum(data_cfg.fps_radius_range) / 2,
                         adj_thresh=sum(data_cfg.adj_radius_range) / 2, topk=data_cfg.topk,
                         connect_all=data_cfg.connect_all, max_nR=data_cfg.max_nR)


def first_step_inputs(params, action, n_his: int, n_proxy: int):
    """The rollout's first step inputs, as `rollout_and_render` and
    `DynamicsModule.rollout` build them from the fitted scene and a push."""
    from gsdx_torch.core.transforms import quat_normalize
    from gsdx_torch.kernels.fps import farthest_point_sampling

    live = params.live > 0
    keep = torch.sigmoid(params.logit_opacities[live])[:, 0] >= 0.1
    xyz = params.means3d[live][keep].contiguous()
    quat = quat_normalize(params.unnorm_rotations)[live][keep].contiguous()
    start, end = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in action)
    n_steps = max(int(np.linalg.norm(action[1] - action[0]) / 0.005), 2)
    delta = (end - start) / (n_steps - 1)
    proxy = xyz[farthest_point_sampling(xyz, min(n_proxy, xyz.shape[0]), start_idx=0)]
    return (proxy[None].repeat(n_his, 1, 1), start[None, None].repeat(n_his, 1, 1),
            delta[None], xyz, quat)


def phase_online(card: str, clk_mhz: float):
    """The demo apps' live loop at the RealSense stream size: `FakeEnv` with
    gsdx sim_real_app's 300-point rope at 4 cameras x 640x480 ->
    `PerceptionModule.get_tabletop_points_env(return_imgs=True)` ->
    `OnlineGSTrainer.update_state` -> `train` (ONLINE_ITERS iterations,
    densification at 500 and 600) -> `rollout_and_render` under a 12 cm push
    through the object's centre with the trained rope model -> every
    rollout frame rendered at the 4 cameras. Kernels #1 and #2 against
    their plain versions on camera 0's tile inputs of the fitted scene
    (n_accum 7); the first rollout step on the card against the CPU.
    Returns (row, forward kernel row, backward kernel row, a function of no
    arguments running one online fit iteration)."""
    import collections
    import copy
    import importlib

    from gsdx_torch.apps.sim_real import push_through_centre
    from gsdx_torch.apps.sim_real_app import rope_points
    from gsdx_torch.core.gaussians import init_tracking_variables
    from gsdx_torch.kernels import composite as C
    from gsdx_torch.kernels import fps as F
    from gsdx_torch.realworld.env import FakeEnv, FakeEnvConfig
    from gsdx_torch.realworld.perception import PerceptionModule
    from gsdx_torch.rollout.dynamics_module import DynamicsModule
    from gsdx_torch.track.densify import DensifyConfig
    from gsdx_torch.track.losses import LossWeights
    from gsdx_torch.track.online import OnlineGSConfig, OnlineGSTrainer
    from gsdx_torch.track.optimizer import GroupAdam, tracking_lrs
    from gsdx_torch.track.trainer import (TrackingConfig, camera_order, compact_params,
                                          make_fit_timestep)

    t_phase = time.perf_counter()
    env = FakeEnv(*rope_points(0), FakeEnvConfig(n_cameras=4, width=ONLINE_W,
                                                 height=ONLINE_H), device="cuda")
    pm = PerceptionModule(device="cuda")
    t0 = time.perf_counter()
    pts, cols, imgs, masks = pm.get_tabletop_points_env(env, return_imgs=True)
    perceive_s = time.perf_counter() - t0
    R_list, t_list = env.get_extrinsics()
    gs = OnlineGSTrainer(OnlineGSConfig(num_iters=ONLINE_ITERS), device="cuda")
    gs.update_state(pts, cols, [im.astype(np.float32) / 255.0 * m[..., None]
                                for im, m in zip(imgs, masks)],
                    [m.astype(np.float32) for m in masks], R_list, t_list,
                    env.get_intrinsics())

    # the fit, keeping the last 4 compositor forwards' inputs: its last 4
    # iterations, one a camera (700 = 175 permutations of the 4)
    R = importlib.import_module("gsdx_torch.render.rasterize")
    orig_fwd, last_fwd = R.composite_fwd, collections.deque(maxlen=4)

    def keep_last(*args, **kw):
        last_fwd.append((args, kw))
        return orig_fwd(*args, **kw)

    R.composite_fwd = keep_last
    torch.cuda.synchronize()
    C.reset_launches()
    t0 = time.perf_counter()
    try:
        logs = gs.train()
        torch.cuda.synchronize()
    finally:
        R.composite_fwd = orig_fwd
    fit_s = time.perf_counter() - t0
    fit_launches = dict(C.LAUNCHES)
    live_after_fit = int(gs.params.num_live)
    psnr = logs["psnr"].cpu().numpy()
    num_pts = logs["num_pts"].cpu().numpy()

    # kernels #1 and #2 on camera 0's tile inputs of the fit's last visit to
    # it, in the variant the fit ran (fused rgb + seg: n_accum 7)
    order = camera_order(ONLINE_ITERS, 4, np.random.default_rng(gs.seed))[-4:]
    (tf, counts), kw = last_fwd[int(np.nonzero(order == 0)[0][0])]
    geo = {key: kw[key] for key in ("tiles_x", "tile_h", "tile_w", "n_accum", "sub_chunk")}
    if geo["n_accum"] != 7:
        raise AssertionError(f"the online fit renders n_accum {geo['n_accum']}, not 7")
    tf, counts, presort = tf.clone(), counts.clone(), kw["presort"]
    last_fwd.clear()
    kernel_f = dict(compare_fwd_at(tf, counts, geo, clk_mhz, "online fit", presort),
                    camera=0, iteration=ONLINE_ITERS - 4 + int(np.nonzero(order == 0)[0][0]))
    kernel_b = dict(compare_bwd_at(tf, counts, geo, clk_mhz, presort), camera=0)
    del tf, counts

    # the rollout, then every frame at the 4 cameras
    fitted = gs.params
    model = rope_model()
    dm = DynamicsModule(model, rope_rollout_config())
    live = gs.params.live > 0
    particles = gs.params.means3d[live].cpu().numpy()
    start, end = push_through_centre(particles, float(particles[:, 2].mean()))
    action = np.stack([start, end])
    step_in = first_step_inputs(gs.params, action, dm.cfg.n_his, dm.cfg.n_fps_proxy)
    torch.cuda.synchronize()
    C.reset_launches()
    F.reset_launches()
    t0 = time.perf_counter()
    rendervars, _ = gs.rollout_and_render(dm, action)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    fps_launches = dict(F.LAUNCHES)
    t0 = time.perf_counter()
    frames = [[gs.render(rv, c, bg=(0, 0, 0))[0] for rv in rendervars] for c in range(4)]
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    render_launches = dict(C.LAUNCHES)
    n_frames = 4 * len(rendervars)
    finite = all(bool(torch.isfinite(f).all()) for cam in frames for f in cam)
    del frames

    # the first rollout step on the card and on the CPU, from the same inputs
    step_gpu = dm.step(*step_in)
    step_cpu = DynamicsModule(copy.deepcopy(model).cpu(), dm.cfg).step(
        *[a.cpu() for a in step_in])
    step_err = float((step_gpu[0].cpu() - step_cpu[0]).abs().max())
    step_ms = cuda_ms(lambda: dm.step(*step_in), reps=5)

    row = {"phase": "online", "card": card, "cameras": 4, "width": ONLINE_W,
           "height": ONLINE_H, "perceived_points": int(len(pts)), "perceive_s": perceive_s,
           "fit_iters": ONLINE_ITERS, "fit_s": fit_s,
           "fit_iters_per_s": ONLINE_ITERS / fit_s,
           "projected_10000_iter_fit_s": 10000 * fit_s / ONLINE_ITERS,
           "fit_launches": fit_launches, "render_launches": render_launches,
           "rollout_fps_launches": fps_launches,
           "psnr_first20": float(psnr[:20].mean()), "psnr_last20": float(psnr[-20:].mean()),
           "num_pts": {str(i): int(num_pts[i]) for i in (0, 499, 500, 599, 600,
                                                          ONLINE_ITERS - 1)},
           "live_after_fit": live_after_fit,
           "rollout_steps": len(rendervars), "rollout_s": rollout_s,
           "rollout_step_ms": step_ms, "render_s": render_s,
           "rendered_frames": n_frames, "rendered_frames_per_s": n_frames / render_s,
           "step_card_vs_cpu_max_abs_m": step_err,
           "push": action.tolist(), "seconds": time.perf_counter() - t_phase}
    emit(row)
    emit(dict(kernel_f, phase="online_kernel"))
    emit(dict(kernel_b, phase="online_kernel"))
    if (fit_launches["fwd"] + fit_launches["fwd_presort"] <= 0
            or fit_launches["bwd"] + fit_launches["bwd_presort"] <= 0):
        raise AssertionError(f"the compositor did not launch in the online fit: {fit_launches}")
    if render_launches["fwd"] <= 0:
        raise AssertionError(f"the compositor did not launch in the renders: {render_launches}")
    if not all(fps_launches.values()):
        raise AssertionError(f"the FPS kernels did not launch in the rollout: {fps_launches}")
    if not (np.isfinite(psnr).all() and row["psnr_last20"] > row["psnr_first20"]):
        raise AssertionError("the online fit's PSNR did not rise")
    if not (np.isfinite(num_pts).all() and num_pts[-1] > 0):
        raise AssertionError("no live Gaussian after the densify steps")
    if num_pts[500] == num_pts[499] and num_pts[600] == num_pts[599]:
        raise AssertionError("densification changed nothing at 500 and 600")
    if not finite or not all(np.isfinite(rv["means3D"]).all() for rv in rendervars):
        raise AssertionError("non-finite rollout or frames")
    if not step_err <= 1e-4:
        raise AssertionError(f"online rollout step card vs CPU: {step_err} m > 1e-4")

    # one fit iteration of the fitted scene at the fit's capacity (the
    # compositor variant it ran), densification off
    w2c = np.stack(gs.metadata["w2c"])
    centers = np.linalg.inv(w2c)[:, :3, 3]
    radius = float(1.1 * np.max(np.linalg.norm(centers - centers.mean(0), axis=-1)))
    capacity = int(np.ceil(4 * len(gs.init_pt_cld) / 256.0) * 256)
    params, variables = compact_params(
        fitted, init_tracking_variables(fitted.capacity, 20, radius, device="cuda"),
        pad_to=capacity)
    fit1 = make_fit_timestep(TrackingConfig(weights=LossWeights(im=1.0, seg=3.0),
                                            densify=DensifyConfig(start=10**9)),
                             is_initial=True, num_iters=1)
    state = (GroupAdam().init(params), variables)
    lrs = tracking_lrs(radius)

    def online_iteration():
        fit1(params, *state, lrs, gs.cams, gs.ims, gs.segs, np.zeros(1, np.int32))

    return row, kernel_f, kernel_b, online_iteration


GD_BOX = ((0.1, -0.1, -np.pi, 5.0), (0.5, 0.15, np.pi, 20.0))  # the rope's extent


def phase_plan_gd(card: str) -> dict:
    """The GD planner at rope width (trained weights, 100 particles, max_nR
    500) once on the card: 32 samples of a uniform draw in the rope's
    extent, 10 Adam steps (lr 1e-2) on one chunk, gradients through the
    GNN module; its seconds, and its best reward against the best reward
    of the draw it started from."""
    from gsdx_torch.plan.actions import sample_action_seq
    from gsdx_torch.plan.cost import running_cost
    from gsdx_torch.plan.dynamics_rollout import RolloutSpec, make_batched_rollout
    from gsdx_torch.plan.planner import MPPIConfig, Planner
    from gsdx_torch.realworld.env import WORKSPACE_BBOX

    n, chunk, iters = 32, 32, 10
    frames = trajectory_particles(100)
    state, target = frames[0].contiguous(), frames[12].contiguous()
    bbox = torch.as_tensor(WORKSPACE_BBOX, device="cuda")
    rollout = make_batched_rollout(rope_model(), RolloutSpec(**PLAN_SPEC))
    planner = Planner(MPPIConfig(n_sample=n, n_update_iter=iters, planner_type="GD",
                                 gd_sample_chunk=chunk, lr=1e-2,
                                 action_lower_lim=GD_BOX[0], action_upper_lim=GD_BOX[1]),
                      rollout, lambda ss, aa, s: running_cost(ss, aa, s, target, bbox),
                      device="cuda")
    init = torch.tensor([[0.3, 0.0, 0.0, 10.0]], device="cuda")
    u = torch.rand((n, 1, 4), generator=torch.Generator(device="cuda").manual_seed(43),
                   device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = planner.trajectory_optimization(None, state, init, draws=[u])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        acts = sample_action_seq(None, init, planner.lower, planner.upper, n, 0, draws=u)
        res = rollout(state, acts)
        drawn = running_cost(res["state_seqs"], res["action_seqs"], state, target,
                             bbox)["reward_seqs"]
    row = {"phase": "plan_gd", "card": card, "n_sample": n, "gd_sample_chunk": chunk,
           "adam_steps": iters, "lr": 1e-2, "n_obj": 100, "max_nR": 500,
           "seconds": seconds, "best_reward": float(out["best_reward"]),
           "draw_best_reward": float(drawn.max()), "draw_mean_reward": float(drawn.mean()),
           "best_act": out["act_seq"].detach().cpu().numpy().tolist()}
    emit(row)
    if not (np.isfinite(row["best_reward"]) and np.isfinite(row["draw_best_reward"])):
        raise AssertionError("non-finite rewards in the GD plan")
    return row


def phase_online_cli() -> dict:
    """`apps.sim_real` (1 trial), `apps.sim_real_app` (fake env, clicks, run
    real, save for the demo) and `apps.demo --assets` on the bundle it
    captured, 60 fit iterations each, from a temporary working directory
    whose log/rope/checkpoints/latest.ckpt is the committed rope checkpoint."""
    import importlib.util

    from gsdx_torch.apps.sim_real_app import rope_points
    from gsdx_torch.realworld.env import FakeEnv
    from gsdx_torch.track.online import rt_to_w2c
    from gsdx_torch.utils.viz import project_points

    # clicks 6 cm either side of the rope's centre, seen from camera 0 of
    # the apps' 320x240 environment
    env = FakeEnv(*rope_points(0), device="cuda")
    c = env.get_state_points().mean(0)
    R, t = env.get_extrinsics()
    px = project_points(np.stack([c - [0.06, 0, 0], c + [0.06, 0, 0]]),
                        env.get_intrinsics()[0], rt_to_w2c(R[0], t[0]))
    clicks = ",".join(f"{v:.1f}" for v in px.reshape(-1))
    env_vars = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "log", "rope", "checkpoints")
        os.makedirs(ckpt_dir)
        os.symlink(ROPE_CKPT, os.path.join(ckpt_dir, "latest.ckpt"))

        def run(app, *extra):
            t0 = time.perf_counter()
            done = subprocess.run(
                [sys.executable, "-m", f"gsdx_torch.apps.{app}", "--config", ROPE_YAML,
                 "--device", "cuda", "--gs_iters", "60", *extra],
                check=True, cwd=tmp, env=env_vars, capture_output=True, text=True)
            seconds[app] = time.perf_counter() - t0
            return done.stdout

        run("sim_real", "--trials", "1", "--out", "out/sim_real")
        run("sim_real_app", "--env", "fake", "--clicks", clicks, "--run-real",
            "--save-for-demo", "--out", "out/sim_real_app")
        assets = os.path.join(tmp, "out", "sim_real_app", "demo_assets")
        (obj,) = os.listdir(assets)
        bundle = os.path.join(assets, obj)
        demo_out = run("demo", "--assets", bundle, "--clicks", clicks, "--out", "out/demo")

        found = {}
        for name in ("sim_real", "sim_real_app", "demo"):
            found[name] = sorted(os.listdir(os.path.join(tmp, "out", name, "sim_cam0")))
            if len(found[name]) < 2:
                raise AssertionError(f"{name} wrote {found[name]} under sim_cam0")
        bundle_files = sorted(os.listdir(bundle))
        need = ["R_list.npy", "gs_orig.splat", "intr_list.npy", "pcd.ply", "t_list.npy",
                *[f"img_{v}.png" for v in range(4)], *[f"mask_{v}.png" for v in range(4)]]
        missing = [f for f in need if f not in bundle_files]
        (action,) = [f for f in bundle_files if f.startswith("action_")]
        action_files = sorted(os.listdir(os.path.join(bundle, action)))
        views = [len(os.listdir(os.path.join(bundle, action, f"video_{v}")))
                 for v in range(4)]
        splats = {p: os.path.getsize(os.path.join(tmp, p)) for p in (
            os.path.join("out", "sim_real_app", "demo_assets", obj, "gs_orig.splat"),
            os.path.join("out", "sim_real_app", "demo_assets", obj, action, "gs_pred.splat"),
            os.path.join("out", "demo", "gs.splat"))}
        read = re.search(r"read 8 PNGs of .* with read_png", demo_out)
    row = {"phase": "cli_online", "seconds": seconds, "clicks": clicks,
           "frames": {k: len(v) for k, v in found.items()}, "bundle": bundle_files,
           "action_files": action_files, "action_view_frames": views,
           "splat_bytes": {os.path.basename(k): v for k, v in splats.items()},
           "demo_read_pngs_with_read_png": bool(read),
           "pil_installed": importlib.util.find_spec("PIL") is not None}
    emit(row)
    if missing or "gs_pred.splat" not in action_files or min(views) < 2:
        raise AssertionError(f"the bundle lacks {missing} or its push's files: {action_files}")
    if not all(v > 0 for v in splats.values()):
        raise AssertionError(f"empty .splat files: {splats}")
    if not read:
        raise AssertionError("the demo did not read the bundle's PNGs with read_png")
    return row


def rope_cli_yaml(text: str) -> str:
    """configs/rope.yaml cut in depth for the CLIs: 1 epoch of 5 train and
    2 valid iterations, the dataset under ./d3dg."""
    for key, value in (("n_epochs", "1"), ("train", "5"), ("valid", "2"),
                       ("base_dir", '"d3dg"')):
        text, n = re.subn(rf"^(\s*{key}:).*$", rf"\1 {value}", text, count=1, flags=re.M)
        if n != 1:
            raise AssertionError(f"configs/rope.yaml has no {key}")
    return text


def phase_learn_cli() -> dict:
    """`apps.preprocess`, `apps.train` and `apps.predict` (4 steps, 1
    camera) on a two-episode tree of the committed episode, from a
    temporary working directory; then `apps.train --dp` under torchrun (one
    rank, NCCL), whose latest.ckpt must load."""
    from gsdx_torch.dynamics.model import DynamicsPredictor, flax_params
    from gsdx_torch.io.checkpoint import load_checkpoint
    from gsdx_torch.io.config import load_config, parse_yaml

    with open(ROPE_YAML) as f:
        text = rope_cli_yaml(f.read())
    name = parse_yaml(text)["dataset_config"]["datasets"][0]["name"]
    out_dir = parse_yaml(text)["train_config"]["out_dir"]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "rope.yaml"), "w") as f:
            f.write(text)
        for idx in (0, 1):
            ep = f"episode_{idx:02d}"
            shutil.copytree(os.path.join(PIPELINE, "data"),
                            os.path.join(tmp, "d3dg", "data", name, ep))
            shutil.copytree(os.path.join(PIPELINE, "ckpts"),
                            os.path.join(tmp, "d3dg", "ckpts", f"exp_{name}", ep, name, ep))
        ep0 = os.path.join(tmp, "d3dg", "ckpts", f"exp_{name}", "episode_00", name,
                           "episode_00")
        for app, extra in (
                ("preprocess", []), ("train", []),
                ("predict", ["--episode", os.path.join(tmp, "d3dg", "data", name, "episode_00"),
                             "--params", ep0, "--out", "out/predict", "--max_steps", "4",
                             "--cameras", "1"])):
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-m", f"gsdx_torch.apps.{app}", "--config",
                            "rope.yaml", "--device", "cuda", *extra],
                           check=True, cwd=tmp, env=env)
            seconds[app] = time.perf_counter() - t0
        prep = [os.path.join(tmp, "d3dg", "preprocessed", f"exp_{name}", f"episode_{i:02d}",
                             "frame_pairs", f"{i}.txt") for i in (0, 1)]
        ckpts = sorted(os.listdir(os.path.join(tmp, out_dir, "checkpoints")))
        pngs = sorted(os.listdir(os.path.join(tmp, "out", "predict", "camera_0")))
        if not all(os.path.exists(p) for p in prep):
            raise AssertionError("the preprocess CLI left no frame pairs")
        if ckpts != ["latest.ckpt", "latest_optim.ckpt", "model_1.ckpt"]:
            raise AssertionError(f"the train CLI left {ckpts}")
        if pngs != [f"frame_{t:04d}.png" for t in range(4)]:
            raise AssertionError(f"the predict CLI left {pngs}")
        latest = os.path.join(tmp, out_dir, "checkpoints", "latest.ckpt")
        os.remove(latest)
        t0 = time.perf_counter()
        dp = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc-per-node=1", "-m", "gsdx_torch.apps.train",
                             "--config", "rope.yaml", "--dp"],
                            check=True, cwd=tmp, env=env, stdout=subprocess.PIPE, text=True,
                            timeout=600)
        seconds["train_dp"] = time.perf_counter() - t0
        _, model_cfg, _ = load_config(os.path.join(tmp, "rope.yaml"))
        load_checkpoint(latest, target=flax_params(DynamicsPredictor(model_cfg)))
        dp_out = dp.stdout.strip().splitlines()
    row = {"phase": "cli_learn", "seconds": seconds, "checkpoints": ckpts, "frames": pngs,
           "train_dp_stdout": dp_out, "train_dp_checkpoint_loads": True}
    emit(row)
    return row


# --------------------------------------------------------------------------
# dist: gsdx_torch.dist on one card
# --------------------------------------------------------------------------

DIST_TIMEOUT = 300.0  # seconds a spawned world may take
COMPOSITOR_VARIANTS = ("fwd", "fwd_presort", "bwd", "bwd_presort")  # #1, #1p, #2, #2p


def rope_train_setup():
    """configs/rope.yaml at full width and a sampler over the committed
    tracked rope episode (its trajectory and frame pairs) on the card."""
    from gsdx_torch.graph.dataset import EpisodeStore, GraphSampler
    from gsdx_torch.io.config import load_config
    from gsdx_torch.io.episodes import eef_world_positions, load_metadata

    train_cfg, model_cfg, data_cfg = load_config(ROPE_YAML)
    traj = np.load(TRAJ)
    eef = eef_world_positions(os.path.join(PIPELINE, "data"),
                              load_metadata(os.path.join(PIPELINE, "ckpts/metadata.json")))
    pairs = np.loadtxt(os.path.join(PIPELINE, "prep/frame_pairs/0.txt")).astype(np.int64)
    pairs = pairs[pairs.max(1) < len(traj)]
    pairs = np.concatenate([np.zeros((len(pairs), 1), np.int64), pairs], 1)
    store = EpisodeStore.from_numpy([traj], [eef], [pairs], device="cuda")
    return train_cfg, model_cfg, GraphSampler(store, data_cfg, "train")


def dist_dp_check(mesh, steps: int = 5, profile: bool = False) -> tuple[dict, list]:
    """One DP step at rope width against the single-device step from the
    same init on the same global batch (batch 16): the loss within rtol
    1e-5, each gradient tensor within REL_TOL of its largest entry, and the
    params. At a world of one (the all-reduce copies) every param is held
    to 1e-6. At two ranks every param is held to 1e-5 but those that the
    two gradients alone move over 5e-6 apart: Adam's first step moves an
    entry by lr g / (|g| + eps), so a gradient near zero whose two values
    differ (in sign, or by a share of themselves) moves it by up to 2 lr.
    The others keep half the tolerance for rounding. The count of the
    exempt entries, and how many of them changed sign, are printed. Then each step's median
    ms over ``steps`` more steps and, with ``profile``, where each step's
    device time goes."""
    from gsdx_torch.dist import make_dp_train_step, shard_batch
    from gsdx_torch.dynamics.train import init_params, make_train_step

    train_cfg, model_cfg, sampler = rope_train_setup()
    batch = sampler.sample(torch.Generator(device="cuda").manual_seed(0),
                           train_cfg.batch_size)
    single_model = init_params(model_cfg, 0, "cuda")
    dp_model = init_params(model_cfg, 0, "cuda")
    single, _, single_opt = make_train_step(single_model, train_cfg)
    dp_step, _ = make_dp_train_step(dp_model, train_cfg, mesh)
    local = shard_batch(batch, mesh)
    loss_s, _ = single(batch)
    loss_d, _ = dp_step(local)
    # the reference optimizer's settings
    lr, eps = single_opt.param_groups[0]["lr"], single_opt.param_groups[0]["eps"]
    two_ranks = mesh.shape["data"] > 1
    tol = 1e-5 if two_ranks else 1e-6
    diff, held, grad_err, exempt, flips = 0.0, 0.0, 0.0, 0, 0
    for a, b in zip(single_model.parameters(), dp_model.parameters()):
        d = (a.detach() - b.detach()).abs()
        g_max = a.grad.abs().max().clamp_min(1e-30)
        diff = max(diff, float(d.max()))
        grad_err = max(grad_err, float((a.grad - b.grad).abs().max() / g_max))
        if two_ranks:  # the first Adam steps of the two gradients lie over tol / 2 apart
            loose = lr * (a.grad / (a.grad.abs() + eps)
                          - b.grad / (b.grad.abs() + eps)).abs() > tol / 2
        else:
            loose = torch.zeros_like(d, dtype=torch.bool)
        exempt += int(loose.sum())
        flips += int((loose & (a.grad.sign() != b.grad.sign())).sum())
        held = max(held, float(d[~loose].max()) if (~loose).any() else 0.0)
    ms_single = [events_ms(lambda: single(batch))[1] for _ in range(steps)]
    ms_dp = [events_ms(lambda: dp_step(local))[1] for _ in range(steps)]
    row = {"batch": train_cfg.batch_size, "local_batch": int(local.state.shape[0]),
           "nf": model_cfg.nf_effect, "loss_single": float(loss_s), "loss_dp": float(loss_d),
           "params_tol": tol, "params_max_abs_diff_held": held,
           "params_exempt": exempt, "params_exempt_sign_flips": flips,
           "params_max_abs_diff": diff, "grad_rel_err": grad_err, "lr": lr,
           "single_step_ms": float(np.median(ms_single)),
           "dp_step_ms": float(np.median(ms_dp))}
    if profile:
        for name, fn in (("single", lambda: single(batch)), ("dp", lambda: dp_step(local))):
            prof = device_profile(fn, f"{name} train step, rope width, batch 16", top=8)
            row[f"profile_{name}"] = {k: prof[k] for k in (
                "wall_ms_per_call", "device_busy_ms_per_call", "device_idle_share",
                "launches_per_call", "top_kernels")}
    failures = []
    if not abs(row["loss_dp"] - row["loss_single"]) <= 1e-5 * abs(row["loss_single"]):
        failures.append(f"DP loss {row['loss_dp']} against {row['loss_single']}")
    if not grad_err <= REL_TOL:
        failures.append(f"DP gradients differ from the single step's by {grad_err} of "
                        "their largest entry")
    if not (held <= tol and diff <= 2 * lr * (1 + 1e-3)):
        failures.append(f"DP params differ from the single step's by {held} > {tol} "
                        f"({exempt} entries exempt; all entries {diff})")
    return row, failures


def sharded_launches(fn, launches: dict):
    """Run ``fn`` (a sharded call) with the compositor's counts set to 0
    just before it, add the counts read just after into ``launches``, and
    return fn's result: the reference runs around it are not counted."""
    from gsdx_torch.kernels import composite as C

    C.reset_launches()
    out = fn()
    for k, v in C.LAUNCHES.items():
        launches[k] = launches.get(k, 0) + v
    return out


def dist_composite_check(mesh, launches: dict) -> tuple[dict, list]:
    """`sharded_composite` on the 8192-Gaussian 720p tile inputs (n_accum 7),
    without and with presort, forward and backward, against the unsharded
    kernels (bit-equal) and, on this rank's rows, against the plain
    version with the same tile ids (REL_TOL). The sharded calls' compositor
    launches are added into ``launches``."""
    from gsdx_torch.dist import sharded_composite
    from gsdx_torch.dist.mesh import shard_rows
    from gsdx_torch.kernels.composite import composite_bwd_torch, composite_tiles_torch
    from gsdx_torch.render.binning import TileGrid
    from gsdx_torch.render.rasterize import RasterizeConfig, _Composite

    row, failures = {}, []
    for presort in (False, True):
        tf, counts, geo = tile_inputs(CAPACITY, original_order=presort)
        T, tile_h, sub = tf.shape[0], geo["tile_h"], geo["sub_chunk"]
        grid = TileGrid(H, W, tile_h, geo["tile_w"])
        cfg = RasterizeConfig(tile_h=tile_h, sub_chunk=sub,
                              binning="nosort" if presort else "sort")
        gen = torch.Generator(device="cuda").manual_seed(3)
        g_acc = torch.randn((T, 7, tile_h * 128), device="cuda", generator=gen)
        g_lt = torch.randn((T, 1, tile_h * 128), device="cuda", generator=gen)

        def run(fn):
            f = tf.clone().requires_grad_(True)
            accum, logt = fn(f)
            (grad,) = torch.autograd.grad((accum * g_acc).sum() + (logt * g_lt).sum(), f)
            return accum.detach(), logt.detach(), grad

        sharded = sharded_launches(
            lambda: run(lambda f: sharded_composite(f, counts, grid, cfg, mesh, n_accum=7)),
            launches)
        whole = run(lambda f: _Composite.apply(f, counts, geo, presort, True))
        equal = [bool(torch.equal(a, b)) for a, b in zip(sharded, whole)]
        rows = shard_rows(T, mesh)  # no padding at 230 tiles over 1 or 2 ranks
        ids = torch.arange(T, dtype=torch.int32, device="cuda")[rows].contiguous()
        plain = dict(tiles_x=grid.tiles_x, tiles_y=grid.tiles_y, tile_h=tile_h,
                     tile_w=128, n_accum=7, sub_chunk=sub, tile_ids=ids)
        with torch.no_grad():
            out_p = composite_tiles_torch(tf[rows], counts[rows], presort=presort, **plain)
        grad_p = composite_bwd_torch(out_p[4] if presort else tf[rows], counts[rows],
                                     out_p[2], g_acc[rows], g_lt[rows],
                                     out_p[3] if presort else None, **plain)
        err = [float((sharded[0][rows] - out_p[0]).abs().max()),
               float((sharded[1][rows] - out_p[1]).abs().max())]
        # the backward's reverse sums in another order: REL_TOL of each
        # feature row's largest entry
        scale = grad_p.abs().amax(dim=(0, 2), keepdim=True).clamp_min(1e-30)
        grad_err = float(((sharded[2][rows] - grad_p) / scale).abs().max())
        name = "presort" if presort else "sorted"
        row[name] = {"T": T, "rows": [rows.start, rows.stop], "equal_unsharded": equal,
                     "plain_max_abs_err": err, "plain_grad_rel_err": grad_err}
        if not all(equal):
            failures.append(f"sharded composite ({name}) differs from the unsharded "
                            f"kernels: accum, logt, grad equal {equal}")
        close = all(torch.allclose(a, b, rtol=REL_TOL, atol=REL_TOL)
                    for a, b in ((sharded[0][rows], out_p[0]), (sharded[1][rows], out_p[1])))
        if not (close and grad_err <= REL_TOL):
            failures.append(f"sharded composite ({name}) vs the plain version with tile "
                            f"ids: {err}, grad {grad_err}")
    return row, failures


def dist_tracking_check(mesh, launches: dict) -> tuple[dict, list]:
    """`make_sharded_tracking_step` at 4 cameras x 1280x720, capacity 8192,
    t=0 and t=1, against the mean over the cameras of the single-device
    loss and gradient (REL_TOL of each field's largest entry). The sharded
    steps' compositor launches are added into ``launches``."""
    from gsdx_torch.core.gaussians import init_gaussian_params, init_tracking_variables
    from gsdx_torch.dist import make_sharded_tracking_step
    from gsdx_torch.track.trainer import GRAD_FIELDS
    from gsdx_torch.kernels.knn import knn
    from gsdx_torch.render.rasterize import RasterizeConfig
    from gsdx_torch.track.losses import LossWeights, tracking_loss
    from gsdx_torch.track.optimizer import GroupAdam
    from gsdx_torch.track.trainer import (TrackingConfig, initialize_per_timestep,
                                          initialize_post_first_timestep)

    cams, ims, segs, noisy = slice_inputs()
    sq, _ = knn(torch.as_tensor(noisy[:, :3], device="cuda"), 3)
    params = init_gaussian_params(noisy, sq.mean(-1).cpu().numpy(), capacity=CAPACITY,
                                  device="cuda")
    # random rotations and anisotropic scales: with identity quaternions and
    # isotropic scales the rotation gradient is rounding noise
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = dataclasses.replace(
        params, unnorm_rotations=torch.randn(CAPACITY, 4, device="cuda", generator=gen),
        log_scales=params.log_scales + torch.rand(CAPACITY, 3, device="cuda",
                                                  generator=gen) - 0.5)
    num_knn = TrackingConfig().num_knn
    variables = init_tracking_variables(CAPACITY, num_knn, 1.0, device="cuda")
    v1 = initialize_post_first_timestep(params, variables, num_knn)
    p1, v1, _ = initialize_per_timestep(params, v1, GroupAdam().init(params))
    cfg, weights = RasterizeConfig(), LossWeights()
    row, failures = {}, []
    for t, (p, v) in enumerate(((params, variables), (p1, v1))):
        step = make_sharded_tracking_step(cfg, mesh, weights, is_initial=t == 0)
        m2d = torch.zeros(CAPACITY, 2, device="cuda")
        (loss, (g_params, g_m2d)), ms = sharded_launches(
            lambda: events_ms(lambda: step(p, m2d, cams, ims[t], segs[t], v)), launches)
        leaves = {f: getattr(p, f).detach().requires_grad_(True) for f in GRAD_FIELDS}
        pl = dataclasses.replace(p, **leaves)
        m = m2d.clone().requires_grad_(True)
        total = sum(tracking_loss(pl, m, cams[c], ims[t][c], segs[t][c], v, weights,
                                  is_initial_timestep=t == 0, raster_cfg=cfg)[0]
                    for c in range(N_CAMS)) / N_CAMS
        grads = torch.autograd.grad(total, [*leaves.values(), m])
        errs = {}
        for name, got, want in [*((f, getattr(g_params, f), g)
                                   for f, g in zip(GRAD_FIELDS, grads)),
                                ("m2d", g_m2d, grads[-1])]:
            errs[name] = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
        loss_err = abs(float(loss) - float(total.detach())) / abs(float(total.detach()))
        row[f"t{t}"] = {"loss": float(loss), "loss_single": float(total.detach()),
                        "loss_rel_err": loss_err, "grad_rel_err": errs, "step_ms": ms}
        if not (loss_err <= REL_TOL and max(errs.values()) <= REL_TOL):
            failures.append(f"sharded tracking t={t}: loss {loss_err}, grads {errs}")
    return row, failures


def dist_mppi_check(mesh) -> tuple[dict, list]:
    """One sample-sharded MPPI iteration at rope width (trained weights, 100
    particles, 1000 samples, each rank's share in repeat-sorted chunks of
    125, the main path's chunk) on one injected draw, against the
    unsharded planner on that draw."""
    from gsdx_torch.kernels import gnn_forward as G
    from gsdx_torch.plan.cost import running_cost
    from gsdx_torch.plan.dynamics_rollout import RolloutSpec, make_batched_rollout
    from gsdx_torch.plan.planner import MPPIConfig, Planner
    from gsdx_torch.realworld.env import WORKSPACE_BBOX

    model = rope_model()
    frames = trajectory_particles(100)
    state, target = frames[0].contiguous(), frames[12].contiguous()
    bbox = torch.as_tensor(WORKSPACE_BBOX, device="cuda")

    def evaluate(ss, aa, s):
        return running_cost(ss, aa, s, target, bbox)

    cfg = MPPIConfig(n_sample=1000, n_update_iter=1)
    n = mesh.shape["data"]
    sharded = Planner(cfg, make_batched_rollout(
        model, RolloutSpec(**dict(PLAN_SPEC, sort_chunks=cfg.n_sample // n // 125))),
        evaluate, device="cuda", mesh=mesh)
    single = Planner(cfg, make_batched_rollout(model, RolloutSpec(**PLAN_SPEC)), evaluate,
                     device="cuda")
    init = torch.tensor([[0.3, 0.0, 0.0, 10.0]], device="cuda")
    draw = torch.rand((cfg.n_sample, 1, 4), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(7))
    G.reset_launches()
    out_s = sharded.trajectory_optimization(None, state, init, draws=[draw])
    launches = dict(G.LAUNCHES)
    out_u = single.trajectory_optimization(None, state, init, draws=[draw])
    # each again, warm
    _, ms_s = events_ms(lambda: sharded.trajectory_optimization(None, state, init,
                                                                 draws=[draw]))
    _, ms_u = events_ms(lambda: single.trajectory_optimization(None, state, init,
                                                                draws=[draw]))
    act_err = float((out_s["act_seq"] - out_u["act_seq"]).abs().max())
    rew = (float(out_s["best_reward"]), float(out_u["best_reward"]))
    row = {"n_sample": cfg.n_sample, "local_samples": cfg.n_sample // n,
           "launches": launches, "act_seq_max_abs_err": act_err, "best_reward": rew,
           "sharded_iteration_ms": ms_s, "unsharded_iteration_ms": ms_u}
    failures = []
    if not (act_err <= 1e-5 and abs(rew[0] - rew[1]) <= 1e-5 * abs(rew[1])):
        failures.append(f"sharded MPPI: act_seq {act_err}, best reward {rew}")
    if any(v <= 0 for v in launches.values()):
        failures.append(f"a GNN kernel never launched in the sharded MPPI: {launches}")
    return row, failures


def dist_result(out_dir: str, rank: int, row: dict, failures: list) -> None:
    """Write a rank's row, then fail the rank if a check failed."""
    row["failures"] = failures
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(row, f)
    if failures:
        raise AssertionError("; ".join(failures))


def dist_nccl_rank(rank: int, world: int, out_dir: str) -> None:
    """A world of one on NCCL: the DP step against the single step (1e-6),
    and `sharded_composite` against `_Composite` bit for bit, with the
    sharded calls' compositor launches."""
    import torch.distributed as dist

    from gsdx_torch.dist import get_mesh, initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed()
    try:
        mesh = get_mesh()
        row = {"backend": dist.get_backend(), "world": dist.get_world_size()}
        row["dp"], failures = dist_dp_check(mesh, profile=True)
        launches = {}
        row["composite"], more = dist_composite_check(mesh, launches)
        row["compositor_launches"] = launches
        if not all(launches.get(k, 0) > 0 for k in COMPOSITOR_VARIANTS):
            more.append(f"a compositor variant never launched in the sharded calls: {launches}")
        dist_result(out_dir, rank, row, failures + more)
    finally:
        dist.destroy_process_group()


def dist_gloo_rank(rank: int, world: int, out_dir: str) -> None:
    """One of two gloo ranks sharing cuda:0: the DP step, the sharded
    compositor, camera-sharded tracking and sample-sharded MPPI, each
    against its unsharded run; the compositor's launches of this rank's
    sharded calls (the unsharded references not counted)."""
    import torch.distributed as dist

    from gsdx_torch.dist import get_mesh, initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = initialize_distributed(f"file://{out_dir}/store", world, rank,
                                    backend="gloo", device="cuda:0")
    try:
        mesh = get_mesh()
        row = {"rank": rank, "world": world, "backend": dist.get_backend(),
               "device": str(device), "pid": os.getpid()}
        row["dp"], failures = dist_dp_check(mesh)
        launches = {}
        row["composite"], more = dist_composite_check(mesh, launches)
        failures += more
        row["tracking"], more = dist_tracking_check(mesh, launches)
        failures += more
        row["compositor_launches"] = launches
        if not all(launches.get(k, 0) > 0 for k in COMPOSITOR_VARIANTS):
            failures.append(f"a compositor variant never launched in the sharded calls: "
                            f"{launches}")
        row["mppi"], more = dist_mppi_check(mesh)
        dist_result(out_dir, rank, row, failures + more)
    finally:
        dist.destroy_process_group()


def phase_dist(card: str) -> dict:
    """`gsdx_torch.dist` on the card: a world of one on NCCL, then two gloo
    ranks sharing cuda:0 (NCCL refuses two ranks on one device), each world
    spawned and joined within DIST_TIMEOUT. Each rank's row is printed,
    after a failure too."""
    from gsdx_torch.dist.mesh import spawn_ranks

    t0 = time.perf_counter()
    row = {"phase": "dist", "card": card,
           "note": "the gloo ranks share one card: their times are no scaling number"}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for name, fn, world in (("nccl", dist_nccl_rank, 1),
                                    ("gloo", dist_gloo_rank, 2)):
                d = os.path.join(tmp, name)
                os.makedirs(d)
                t1 = time.perf_counter()
                spawn_ranks(fn, world, (d,), timeout=DIST_TIMEOUT)
                row[f"{name}_seconds"] = time.perf_counter() - t1
        finally:
            for name in ("nccl", "gloo"):
                d = os.path.join(tmp, name)
                for r in range(2):
                    path = os.path.join(d, f"rank{r}.json")
                    if os.path.exists(path):
                        with open(path) as f:
                            row.setdefault(name, []).append(json.load(f))
            row["seconds"] = time.perf_counter() - t0
            emit(row)
    return row


# --------------------------------------------------------------------------
# the real-robot path: reference check, masks app, plan --env real
# --------------------------------------------------------------------------


def phase_reference() -> dict:
    """The port's `rasterize` (kernels #1 and #2) against the dense
    `render_reference` on tests/test_rasterize.py's 120-Gaussian 40x64 scene:
    values within its tolerances (:50-53), gradients within 5e-4 of each
    input's largest (:95)."""
    from gsdx_torch.core.cameras import make_camera
    from gsdx_torch.kernels import composite as C
    from gsdx_torch.render.rasterize import RasterizeConfig, rasterize
    from gsdx_torch.render.reference import render_reference

    h, w = 40, 64
    rng = np.random.default_rng(0)
    means = rng.uniform(-0.5, 0.5, size=(120, 3)).astype(np.float32)
    means[:, 2] += 3.0
    arrays = (means, rng.normal(size=(120, 4)), rng.uniform(0.02, 0.08, size=(120, 3)),
              rng.uniform(0.2, 0.95, size=(120, 1)), rng.uniform(0, 1, size=(120, 3)),
              np.zeros((120, 2)))
    k = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]], np.float32)
    cam = make_camera(k, np.eye(4, dtype=np.float32), width=w, height=h,
                      bg=(0.3, 0.1, 0.6), device="cuda")
    target = torch.as_tensor(rng.uniform(0, 1, size=(3, h, w)).astype(np.float32), device="cuda")
    cfg = RasterizeConfig(tile_h=8, tile_w=128, max_per_tile=256, max_dup=32)
    outs, grads = [], []
    C.reset_launches()
    for fn in ("rasterize", "reference"):
        args = [torch.tensor(np.asarray(a, np.float32), device="cuda", requires_grad=True)
                for a in arrays]
        if fn == "rasterize":
            o = rasterize(*args[:5], cam, cfg, mean2d_offset=args[5])
            im, depth, final_t, radius = o.im, o.depth, o.final_t, o.radius
        else:
            im, radius, depth, final_t = render_reference(*args[:5], cam, mean2d_offset=args[5],
                                                          strict_t_stop=False)
        loss = (im - target).abs().mean() + 0.1 * depth.abs().mean()
        grads.append(torch.autograd.grad(loss, args))
        outs.append((im.detach(), depth.detach(), final_t.detach(), radius.detach()))
    if not (C.LAUNCHES["fwd"] and C.LAUNCHES["bwd"]):
        raise AssertionError(f"rasterize ran no compositor kernel: {C.LAUNCHES}")
    row = {"phase": "reference", "n": 120, "h": h, "w": w}
    for name, a, b, tol in zip(("im", "depth", "final_t"), outs[0], outs[1], (2e-5, 1e-4, 2e-5)):
        torch.testing.assert_close(a, b, rtol=0, atol=tol)
        row[f"{name}_max_abs_err"] = float((a - b).abs().max())
    if not torch.equal(outs[0][3], outs[1][3]):
        raise AssertionError("rasterize and the reference disagree on the radii")
    for name, gp, gr in zip(("means3d", "quats", "scales", "opacities", "colors", "mean2d"),
                            *grads):
        scale = float(gr.abs().max()) + 1e-8
        torch.testing.assert_close(gp / scale, gr / scale, rtol=0, atol=5e-4)
        row[f"grad_{name}_max_rel_err"] = float((gp - gr).abs().max()) / scale
    emit(row)
    return row


MASK_CAMS, MASK_FRAMES, MASK_W, MASK_H = 4, 3, 1280, 720


def write_mask_episode(root: str):
    """A synthetic recording in the layout `apps/masks.py` reads, written by
    the port's PNG writer: per camera 8-bit colour frames of a red rope-like
    patch on the grey table (the threshold segmenter's background) and
    16-bit depth in mm of the table 0.8 m below cameras looking straight
    down, spread 5 cm apart in x; a calibration pickle. Returns its path."""
    import pickle

    from gsdx_torch.io.video import write_image

    n_cams, n_frames, width, height = MASK_CAMS, MASK_FRAMES, MASK_W, MASK_H
    f = 0.75 * width
    k = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(0)
    for c in range(n_cams):
        for t in range(n_frames):
            img = np.full((height, width, 3), 178, np.uint8)
            x0 = width // 2 - width // 8 + 4 * t - 40 * c
            img[height // 2 - height // 30:height // 2 + height // 30, x0:x0 + width // 4] = \
                (200, 30, 30)
            depth = (800 + rng.integers(-2, 3, size=(height, width))).astype(np.uint16)
            write_image(os.path.join(root, f"camera_{c}", f"color_{t:06d}.png"), img)
            write_image(os.path.join(root, f"camera_{c}", "depth", f"depth_{t:06d}.png"), depth)
    R = np.diag([1.0, -1.0, -1.0])
    calib = {"intrinsics": np.stack([k] * n_cams), "R_cam2world": np.stack([R] * n_cams),
             "t_cam2world": np.stack([[0.3 + 0.05 * c, 0.05, 0.8] for c in range(n_cams)])}
    path = os.path.join(root, "calib.pkl")
    with open(path, "wb") as fh:
        pickle.dump(calib, fh)
    return path


def phase_masks() -> dict:
    """The masks app on a synthetic 4-camera 1280x720 3-frame episode in a
    temporary directory: `python -m gsdx_torch.apps.masks obtain` on the
    card in a process of its own, then merge, initpcd (on the card) and
    metadata through the same `main` in this process (a fresh interpreter
    took 8-14 s a subcommand on the H100's host, most of the phase); then
    `build_init_pcd` on the CPU: the two initial clouds must be the same
    point set within 1e-6 m."""
    from scipy.spatial import cKDTree

    from gsdx_torch.apps import masks
    from gsdx_torch.io.video import read_png

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        calib = write_mask_episode(root)
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        seconds = {"write": time.perf_counter() - t_start}
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "gsdx_torch.apps.masks", "obtain",
                        "--data_path", root, "--device", "cuda"], check=True, cwd=root, env=env)
        seconds["obtain_process"] = time.perf_counter() - t0
        for argv in (["merge"], ["initpcd", "--calib", calib, "--device", "cuda"],
                     ["metadata", "--calib", calib]):
            t0 = time.perf_counter()
            masks.main(argv + ["--data_path", root])
            torch.cuda.synchronize()
            seconds[argv[0]] = time.perf_counter() - t0
        seg = read_png(os.path.join(root, "camera_0", "seg", "seg_000002.png"))
        fg = read_png(os.path.join(root, "camera_0", "foreground", "fg_000002.png"))
        if seg.shape != (MASK_H, MASK_W) or not seg.any() or seg[0, 0]:
            raise AssertionError("the masks app's object mask is empty or covers the table")
        if fg[0, 0].any() or fg.shape != (MASK_H, MASK_W, 3):
            raise AssertionError("the masks app's foreground keeps the table")
        with open(os.path.join(root, "train_meta.json")) as fh:
            meta = json.load(fh)
        if (meta["w"], meta["h"], len(meta["fn"]), len(meta["fn"][0])) != \
                (MASK_W, MASK_H, MASK_FRAMES, MASK_CAMS):
            raise AssertionError(f"train_meta.json: {meta['w']}x{meta['h']}, {len(meta['fn'])} "
                                 "frames")
        card = np.load(os.path.join(root, "init_pt_cld.npz"))["data"]
        t0 = time.perf_counter()
        cpu = masks.build_init_pcd(root, calib, device="cpu")
        seconds["initpcd_cpu"] = time.perf_counter() - t0
    if card.shape != cpu.shape or not np.isfinite(card).all() or len(card) == 0:
        raise AssertionError(f"init clouds: card {card.shape}, CPU {cpu.shape}")
    d_card, _ = cKDTree(cpu[:, :3]).query(card[:, :3], k=1)
    d_cpu, _ = cKDTree(card[:, :3]).query(cpu[:, :3], k=1)
    gap = float(max(d_card.max(), d_cpu.max()))
    if gap > 1e-6:
        raise AssertionError(f"the card's init cloud lies {gap} m from the CPU's")
    row = {"phase": "masks", "width": MASK_W, "height": MASK_H, "cameras": MASK_CAMS,
           "frames": MASK_FRAMES, "init_points": len(card),
           "object_points": int((card[:, 6] > 0.5).sum()), "card_vs_cpu_m": gap,
           "seconds": seconds}
    emit(row)
    return row


REAL_CAMS, REAL_W, REAL_H, REAL_SAMPLES = 4, 640, 480, 1000


def static_table_views():
    """`StaticImageSource` views of a red patch on the grey table from 1 m
    above (tests/test_plan_real_env.py's scene at the RealSense stream
    size): with R = diag(1, -1, -1), t = (0.3, 0.05, 1.0) the camera's
    (x, y, 1) lands on the table at world (0.3 + x, 0.05 - y, 0), inside
    `WORKSPACE_BBOX`. The patch is 24 x 7.5 cm."""
    from gsdx_torch.realworld.cameras import StaticImageSource

    n, width, height = REAL_CAMS, REAL_W, REAL_H
    color = np.full((height, width, 3), int(0.7 * 255), np.uint8)
    color[height // 2 - 18:height // 2 + 18, width // 2 - 58:width // 2 + 58] = (220, 40, 30)
    depth = np.full((height, width), 1000, np.uint16)
    R, t = np.diag([1.0, -1.0, -1.0]), np.array([0.3, 0.05, 1.0])
    return [StaticImageSource(color, depth, fps=30) for _ in range(n)], [R] * n, [t] * n


def phase_real_env() -> dict:
    """`apps/plan.py` `main --env real --cameras synthetic:4 --robot_ip fake
    --n_actions 2 --n_chunks 1` at rope width with the trained checkpoint,
    in a temporary working directory, its cameras `static_table_views`. The
    fused GNN kernel must launch, `RealEnv.step` run twice with finite
    (4,) actions, the interaction files be written and every camera
    process be joined after `env.stop()`. Prints each robot action's
    seconds split into get_obs, perception, planning and step, and each
    camera's put rate while the planner ran."""
    import gsdx_torch.realworld.cameras as cams
    from gsdx_torch.apps import plan
    from gsdx_torch.kernels import gnn_forward as G
    from gsdx_torch.plan.planner import Planner
    from gsdx_torch.realworld.perception import PerceptionModule

    sources, R_list, t_list = static_table_views()
    events = {"get_obs": [], "perception": [], "planning": [], "step": []}
    rates, steps, envs = [], [], []

    def timed_call(kind, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            events[kind].append(time.perf_counter() - t0)
            return out
        return wrapper

    orig_make, orig_source = plan.make_real_env, cams.SyntheticSource
    orig_plan, orig_perceive = Planner.plan_chunked, PerceptionModule.get_tabletop_points

    def make(*a, **kw):
        env = orig_make(*a, **kw)
        env.R_cam2world, env.t_cam2world = list(R_list), list(t_list)
        env.get_obs = timed_call("get_obs", env.get_obs)
        step = timed_call("step", env.step)

        def counting_step(action, decoded=True):
            steps.append(np.asarray(action))
            return step(action, decoded)

        env.step = counting_step
        envs.append(env)
        return env

    def plan_chunked(self, *a, **kw):
        rings = [c.ring_buffer for c in envs[0].cameras.cameras]
        n0, t0 = [r.count for r in rings], time.perf_counter()
        out = timed_call("planning", orig_plan)(self, *a, **kw)
        dt = time.perf_counter() - t0
        rates.append([(r.count - n) / dt for r, n in zip(rings, n0)])
        return out

    t_start = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "log", "rope", "checkpoints")
        os.makedirs(ckpt_dir)
        os.symlink(ROPE_CKPT, os.path.join(ckpt_dir, "latest.ckpt"))
        plan.make_real_env, cams.SyntheticSource = make, lambda seed=0, **kw: sources[seed]
        Planner.plan_chunked = plan_chunked
        PerceptionModule.get_tabletop_points = timed_call("perception", orig_perceive)
        G.reset_launches()
        try:
            os.chdir(tmp)
            plan.main(["--config", os.path.join(REPO, "configs", "rope.yaml"),
                       "--env", "real", "--cameras", f"synthetic:{REAL_CAMS}",
                       "--robot_ip", "fake", "--n_actions", "2", "--n_chunks", "1",
                       "--n_sample", str(REAL_SAMPLES), "--out", "out", "--device", "cuda"])
        finally:
            os.chdir(cwd)
            plan.make_real_env, cams.SyntheticSource = orig_make, orig_source
            Planner.plan_chunked, PerceptionModule.get_tabletop_points = orig_plan, orig_perceive
        launches = dict(G.LAUNCHES)
        out = os.path.join(tmp, "out")
        written = sorted(os.listdir(out))
        recs = [np.load(os.path.join(out, f"interaction_{i}.npz")) for i in range(2)]
        recs = [{k: r[k].tolist() for k in ("action", "reward", "chamfer_before",
                                             "chamfer_after")} for r in recs]
    if not launches["gnn_forward"]:
        raise AssertionError(f"plan --env real launched no fused GNN forward: {launches}")
    if len(steps) != 2 or not all(a.shape == (4,) and np.isfinite(a).all() for a in steps):
        raise AssertionError(f"RealEnv.step calls: {steps}")
    if not {"interaction_0.npz", "interaction_1.npz", "stats.txt"} <= set(written):
        raise AssertionError(f"plan --env real wrote {written}")
    alive = [c.name for c in envs[0].cameras.cameras if c.is_alive() or c.exitcode != 0]
    if alive:
        raise AssertionError(f"camera processes not joined cleanly after env.stop(): {alive}")
    # events: one get_obs + perception to set up, then per action one
    # before the plan and one after the push
    actions = []
    for i in range(2):
        a = {"get_obs": sum(events["get_obs"][1 + 2 * i:3 + 2 * i]),
             "perception": sum(events["perception"][1 + 2 * i:3 + 2 * i]),
             "planning": events["planning"][i], "step": events["step"][i]}
        a["total"] = sum(a.values())
        actions.append(a)
    row = {"phase": "real_env", "cameras": REAL_CAMS, "width": REAL_W, "height": REAL_H,
           "n_sample": REAL_SAMPLES, "n_chunks": 1, "n_actions": 2,
           "launches": launches, "actions_s": actions,
           "setup_get_obs_s": events["get_obs"][0], "setup_perception_s": events["perception"][0],
           "put_hz_while_planning": rates, "interactions": recs,
           "seconds": time.perf_counter() - t_start}
    emit(row)
    return row


def tree_state() -> dict:
    """(size, mtime) of every file of the checkout that git would see: all
    but `.git` and what `.gitignore` lists (the kernel build among it)."""
    import fnmatch

    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = [ln.strip().strip("/") for ln in f if ln.strip() and not ln.startswith("#")]

    def skip(rel: str) -> bool:
        return any(fnmatch.fnmatch(rel, pat) or fnmatch.fnmatch(os.path.basename(rel), pat)
                   for pat in ignored)

    out = {}
    for root, dirs, files in os.walk(REPO):
        rel_root = os.path.relpath(root, REPO)
        dirs[:] = [d for d in dirs
                   if d != ".git" and not skip(os.path.normpath(os.path.join(rel_root, d)))]
        for f in files:
            rel = os.path.normpath(os.path.join(rel_root, f))
            if not skip(rel):
                st = os.stat(os.path.join(REPO, rel))
                out[rel] = (st.st_size, st.st_mtime_ns)
    return out


def become_subreaper() -> None:
    """Make this process the reaper of its orphaned descendants (Linux
    `prctl(PR_SET_CHILD_SUBREAPER)`): a process whose parent exits before
    it, such as the resource tracker of the shared-memory server that
    `real_env`'s cameras use, is then re-parented here, where
    `stop_children` finds it, and not to init."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:  # 36: PR_SET_CHILD_SUBREAPER
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER) failed")


def children() -> list[tuple[int, str]]:
    """(pid, command name) of this process's children, zombies included,
    from /proc."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:  # gone meanwhile
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:  # state, ppid, ...
            out.append((int(d), stat[stat.index("(") + 1:stat.rindex(")")]))
    return out


def stop_children(timeout: float = 10.0) -> list[str]:
    """Stop and reap every process this run left, before it exits.

    Any multiprocessing child still alive is terminated first. Shared
    memory made by this process starts multiprocessing's resource tracker,
    which lives until its parent exits and a moment longer: its pipe is
    closed here, as multiprocessing's own `_stop` does, and the tracker
    exits on that end of file. Every child (orphans included, see
    `become_subreaper`) is then waited for, and sent SIGTERM and, after
    ``timeout`` seconds, SIGKILL until it is reaped. Returns "pid name" of
    each process stopped; raises if one is left."""
    import multiprocessing as mp
    import signal
    from multiprocessing import resource_tracker

    for p in mp.active_children():
        p.terminate()
        p.join(timeout)
    tracker = resource_tracker._resource_tracker
    with tracker._lock:
        if tracker._fd is not None:
            os.close(tracker._fd)
            tracker._fd = tracker._pid = None
    stopped = {}
    for sig, wait in ((None, 2.0), (signal.SIGTERM, timeout), (signal.SIGKILL, timeout)):
        t_end = time.monotonic() + wait
        while (left := children()) and time.monotonic() < t_end:
            for pid, name in left:
                stopped.setdefault(pid, name)
                try:
                    if sig is not None:
                        os.kill(pid, sig)
                    os.waitpid(pid, os.WNOHANG)
                except (ProcessLookupError, ChildProcessError):
                    pass
            time.sleep(0.02)
    if left := children():
        raise AssertionError(f"processes left running: {left}")
    return [f"{pid} {name}" for pid, name in stopped.items()]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import gsdx_torch  # noqa: F401  (fails here, before any output, outside the repo)

    become_subreaper()
    try:
        return run()
    finally:
        stop_children()  # after a failure too: leave no process behind


def run() -> int:
    """Every phase, then the kernel table and the result line."""
    # the plain versions are references: full f32 everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = card_info()
    emit({"phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
          **info})
    before = tree_state()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    card = info["nvidia_smi"]
    emit(timed("build", phase_build))
    rows = timed("kernels", phase_kernels, info["max_sm_mhz"])
    edges_main, edges_rows = timed("edges", phase_edges)
    gnn_rows = timed("gnn_kernels", phase_gnn_kernels)
    _, probe_rows = timed("probes", phase_probes, info["max_sm_mhz"])
    fps_main, _ = timed("fps", phase_fps)
    timed("rasterize", phase_rasterize, card)
    slice_row = timed("slice", phase_slice, card)
    plan_row = timed("plan", phase_plan, card)
    learn_row, train_iteration = timed("learn", phase_learn, card)
    predict_row, predict_kernel, predict_step = timed("predict", phase_predict, card,
                                                      info["max_sm_mhz"])
    timed("plan_gd", phase_plan_gd, card)
    online_row, online_fwd, online_bwd, online_iteration = timed(
        "online", phase_online, card, info["max_sm_mhz"])
    timed("profile", phase_profile, train_iteration, predict_step, online_iteration)
    timed("cli", phase_cli)
    timed("cli_plan", phase_plan_cli)
    timed("cli_learn", phase_learn_cli)
    timed("cli_online", phase_online_cli)
    dist_row = timed("dist", phase_dist, card)
    timed("reference", phase_reference)
    timed("masks", phase_masks)
    timed("real_env", phase_real_env)
    emit({"phase": "seconds", **seconds})
    after = tree_state()
    changed = sorted(p for p in set(before) | set(after) if before.get(p) != after.get(p))
    if changed:
        raise AssertionError(f"the run wrote into the checkout: {changed[:10]}")

    table = []
    for r in rows:
        if r["n"] != CAPACITY or r["saturating"]:  # the main path's shapes
            continue
        variant = r["name"].replace("composite_", "")
        table.append({
            "name": r["name"], "route": "cuda",
            "source": "gsdx_torch/csrc/composite.cu",
            "replaces": ("gsdx/kernels/composite.py:200" if "fwd" in variant
                         else "gsdx/kernels/composite.py:299"),
            "launches": slice_row["launches"][variant],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
        shape_keys = ("T", "K", "tile_h", "sub", "n_accum", "max_abs_err", "ms",
                      "device_ms", "plain_ms", "bound_ms", "bound_by")
        if variant == "fwd":  # the predict path's launches and shape
            table[-1]["launches_predict"] = predict_row["launches"]["fwd"]
            table[-1]["predict_shape"] = {key: predict_kernel[key] for key in shape_keys}
        # the dist phase's launches, each gloo rank's (sharded compositor and
        # camera-sharded tracking)
        table[-1]["launches_dist"] = [r["compositor_launches"][variant]
                                      for r in dist_row["gloo"]]
        # the online path's launches (fit and renders), and the shape of the
        # variant its fit ran
        table[-1]["launches_online"] = (online_row["fit_launches"][variant]
                                        + online_row["render_launches"][variant])
        for k in (online_fwd, online_bwd):
            if k["name"] == r["name"]:
                table[-1]["online_shape"] = {key: k[key] for key in shape_keys}
    rope, gemm = gnn_rows["rope"], gnn_rows["gemm"][0]  # the plan path's shapes
    table.append({
        "name": "gnn_forward", "route": "cuda",
        "source": "gsdx_torch/csrc/gnn_forward.cu",
        "replaces": "gsdx/kernels/gnn_forward.py:180",
        "launches": plan_row["launches"]["gnn_forward"],
        "launches_dist": [r["mppi"]["launches"]["gnn_forward"] for r in dist_row["gloo"]],
        "max_abs_err": rope["max_abs_err"], "ms": rope["ms"],
        "plain_ms": rope["plain_ms"], "bound_ms": rope["bound_ms"],
        "bound_by": rope["bound_by"], "library_ms": None})
    shape_keys = ("M", "N", "K", "epilogue", "ms", "device_ms", "library_ms",
                  "library_device_ms", "bound_ms", "max_abs_err")
    table.append({
        "name": "gnn_gemm", "route": "cuda",
        "source": "gsdx_torch/csrc/gnn_gemm.cu",
        "replaces": "gsdx/kernels/gnn_forward.py:180",
        "launches": plan_row["launches"]["gnn_gemm"],
        "launches_dist": [r["mppi"]["launches"]["gnn_gemm"] for r in dist_row["gloo"]],
        "max_abs_err": gemm["max_abs_err"], "ms": gemm["ms"],
        "plain_ms": gemm["plain_ms"], "bound_ms": gemm["bound_ms"],
        "bound_by": gemm["bound_by"], "library_ms": gemm["library_ms"],
        "device_ms": gemm["device_ms"], "library_device_ms": gemm["library_device_ms"],
        "shapes": {r["shape"]: {k: r[k] for k in shape_keys} for r in gnn_rows["gemm"]}})
    for r in gnn_rows["round"]:
        table.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": "gsdx/kernels/gnn_forward.py:180",
            "launches": plan_row["launches"][r["name"]],
            "launches_dist": [d["mppi"]["launches"][r["name"]] for d in dist_row["gloo"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "device_ms": r["device_ms"]})
    for r in probe_rows:
        roll = r["name"] == "dynamic_roll"
        table.append(dict(
            r, route="cuda", source="gsdx_torch/csrc/probes.cu",
            replaces=("benchmarks/probe_dynamic_roll.py:10" if roll
                      else "benchmarks/probe_transcendental.py:48")))
    for name, line in (("fps", 25), ("fps_radius", 59)):  # a jit fori_loop there, not Pallas
        r = fps_main[name]
        table.append({
            "name": name, "route": "cuda", "source": "gsdx_torch/csrc/fps.cu",
            "replaces": f"gsdx/kernels/fps.py:{line}", "launches": learn_row["fps_launches"][name],
            "launches_predict": predict_row["fps_launches"][name],
            "launches_online": online_row["rollout_fps_launches"][name],
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "device_ms", "latency_floor_ms", "B", "P", "D",
                                 "n")}})
    table.append(edges_table_row(edges_main, edges_rows, plan_row))
    emit({"phase": "processes", "stopped": stop_children()})
    print(info["nvidia_smi"], flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
