"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. card + build: the card's name and power limit; nvcc builds the
     compositor and GNN kernel libraries from gsdx_torch/csrc, in parallel.
  2. kernels: each compositor variant (forward, forward with presort,
     backward, backward with presort) against its plain PyTorch version on
     real 720p tile inputs (8192 and 16384 Gaussians), and the fused GNN
     forward against its plain version at rope width (125 samples, 128
     node slots, 504 edge slots; trained weights, edges of the committed
     trajectory) and cloth width (256 / 1200, random init), with CUDA-event
     times and the card's lower bound for the same work.
  3. rasterize: fwd+bwd Mpix/s at 5k, 16k and 65k Gaussians, 720p.
  4. slice: `track_sequence` at 4 cameras, 720p, capacity 8192: t=0 with
     clone/split/prune on a shortened schedule, then t=1 with frozen bins
     and the presorting compositor; the launch counters of every compositor
     variant must be > 0 for this run.
  5. plan: one MPPI `trajectory_optimization` at rope width (trained
     weights, 100 particles, max_nR 500, 1000 samples, 8 repeat-sorted
     chunks), cut in depth to 2 update iterations; the GNN kernels' launch
     counters must be > 0 for this run; the fused rollout against the
     module rollout on 16 samples.
  6. profile: `torch.profiler` breakdown of a 5k rasterize fwd+bwd, of one
     tracking iteration and of one MPPI iteration: device time by kernel,
     device idle share.
  7. cli: `python -m gsdx_torch.apps.track` on a small synthetic episode,
     and `python -m gsdx_torch.apps.plan --env fake` on the committed
     rope checkpoint.

The line before the last holds the kernel table; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero with no result.
"""

from __future__ import annotations

import json
import os
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


def tile_inputs(n: int, original_order: bool, saturating: bool = False):
    """Tile features of an n-Gaussian 720p scene with 6 colour channels,
    projected and binned by the port as `rasterize` does."""
    from gsdx_torch.kernels.composite import FEAT_DIM
    from gsdx_torch.render.binning import bin_gaussians
    from gsdx_torch.render.projection import project_gaussians
    from gsdx_torch.render.rasterize import (
        RasterizeConfig, resolve_binning, tile_grid)

    means, quats, scales, opac, colors = scene(
        np.random.default_rng(0), n, n_chan=6,
        scale=(0.05, 0.15) if saturating else (0.005, 0.02))
    cam = camera()
    cfg = resolve_binning(RasterizeConfig(), n)
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


def pair_counts(tf, counts, nproc, geo) -> tuple[int, int]:
    """(processed, visible) (splat, pixel) pairs of the processed prefixes:
    processed = sum over tiles of min(count, nproc * sub) * P; visible =
    those pairs whose alpha passes the 1/255 cut."""
    from gsdx_torch.kernels.composite import ALPHA_MAX, ALPHA_MIN, _pixel_coords

    sub, P = geo["sub_chunk"], geo["tile_h"] * geo["tile_w"]
    ceff = torch.minimum(counts.long(), nproc.long() * sub)
    processed = int(ceff.sum()) * P
    visible = 0
    with torch.no_grad():
        for b0 in range(0, tf.shape[0], 16):
            cf, ce = tf[b0:b0 + 16], ceff[b0:b0 + 16]
            kb = max(1, int(ce.max()))
            cf = cf[:, :, :kb]
            px, py = _pixel_coords(torch.arange(b0, b0 + cf.shape[0],
                                                device=tf.device),
                                   geo["tiles_x"], geo["tile_h"], geo["tile_w"])
            dx = px[:, None, :] - cf[:, 0, :, None]
            dy = py[:, None, :] - cf[:, 1, :, None]
            power = (-0.5 * (cf[:, 2, :, None] * dx * dx + cf[:, 4, :, None] * dy * dy)
                     - cf[:, 3, :, None] * dx * dy)
            a = torch.clamp(cf[:, 5, :, None] * torch.exp(power), max=ALPHA_MAX)
            slot = torch.arange(kb, device=tf.device)[None, :, None]
            vis = (power <= 0) & (a >= ALPHA_MIN) & (slot < ce[:, None, None])
            visible += int(vis.sum())
    return processed, visible


def bound_ms(bytes_moved, flops, mufu, clk_mhz) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_S
    t_ops = max(flops / PEAK_F32_FLOP_S,
                mufu / (SMS * MUFU_PER_SM_CLK * clk_mhz * 1e6))
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# Arithmetic per (splat, pixel) pair, counted from csrc/composite.cu: every
# processed pair evaluates the falloff (power: 8 flops, exp: 1 MUFU); a
# visible pair adds, forward: alpha, w, log T and 2 flops per channel plus
# log1p and exp (2 MUFU); backward: those plus dL/dw, dalpha, the six
# geometry terms and 4 flops per channel, and a division (3 MUFU).
FLOPS_ALL = 8
FWD_FLOPS_VIS = lambda nacc: 6 + 2 * nacc  # noqa: E731
BWD_FLOPS_VIS = lambda nacc: 30 + 4 * nacc  # noqa: E731


def phase_build() -> dict:
    """One nvcc per kernel source, all started together."""
    from gsdx_torch.kernels import composite, gnn_forward

    libs = (composite.LIBRARY, gnn_forward.LIBRARY)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        logs = list(pool.map(lambda lib: lib.build(), libs))
    for lib in libs:
        lib.load()
    return {"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
            "libraries": [lib.path().name for lib in libs],
            "ptxas": [ln.strip() for log in logs for ln in log.splitlines()
                      if "Compiling entry" in ln or "registers" in ln
                      or "spill" in ln],
            "kernels": ["composite_fwd", "composite_fwd_presort",
                        "composite_bwd", "composite_bwd_presort",
                        "gnn_linear", "gnn_edge_first", "gnn_message"]}


def compare_kernels(n: int, presort: bool, clk_mhz: float,
                    saturating: bool = False) -> list[dict]:
    """Kernel vs plain PyTorch for the forward and the backward."""
    from gsdx_torch.kernels import composite as C

    tf, counts, geo = tile_inputs(n, original_order=presort, saturating=saturating)
    T, _, K = tf.shape
    P = geo["tile_h"] * geo["tile_w"]
    nacc = geo["n_accum"]
    kw = dict(geo, presort=presort)
    out_k = C.composite_fwd(tf, counts, **kw)
    with torch.no_grad():
        out_p = C.composite_tiles_torch(tf, counts, **kw)
    torch.cuda.synchronize()
    nproc_k, nproc_p = out_k[2], out_p[2]
    flips = int((nproc_k != nproc_p).sum())
    if flips:
        raise AssertionError(f"nproc differs on {flips} tiles (n={n})")
    err_f = 0.0
    for a, b in zip(out_k[:2], out_p[:2]):
        torch.testing.assert_close(a, b, rtol=REL_TOL, atol=REL_TOL)
        err_f = max(err_f, float((a - b).abs().max()))
    if presort:
        if not torch.equal(out_k[3], out_p[3]) or not torch.equal(out_k[4], out_p[4]):
            raise AssertionError("presort rank / sorted features differ")

    g = torch.Generator(device="cuda").manual_seed(1)
    g_acc = torch.randn(T, nacc, P, device="cuda", generator=g)
    g_lt = torch.randn(T, 1, P, device="cuda", generator=g)
    feats_b = out_k[4] if presort else tf
    rank = out_k[3] if presort else None
    args_b = (feats_b, counts, nproc_k, out_k[1], g_acc, g_lt, rank)
    grad_k = C.composite_bwd(*args_b, **geo)
    args_p = (feats_b, counts, nproc_k, g_acc, g_lt, rank)
    grad_p = C.composite_bwd_torch(*args_p, **geo)
    torch.cuda.synchronize()
    # each feature row against its own largest entry: the conic rows grow
    # with dx^2 and would swamp the mean and opacity rows under one scale
    scale = grad_p.abs().amax(dim=(0, 2), keepdim=True)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    torch.testing.assert_close(grad_k / scale, grad_p / scale, rtol=0,
                               atol=REL_TOL)
    err_b = float((grad_k - grad_p).abs().max())
    err_b_rel = float(((grad_k - grad_p).abs() / scale).max())

    ms_fk = cuda_ms(lambda: C.composite_fwd(tf, counts, **kw))
    ms_fp = cuda_ms(lambda: C.composite_tiles_torch(tf, counts, **kw), reps=3, warmup=1)
    ms_bk = cuda_ms(lambda: C.composite_bwd(*args_b, **geo))
    ms_bp = cuda_ms(lambda: C.composite_bwd_torch(*args_p, **geo), reps=3, warmup=1)

    processed, visible = pair_counts(feats_b, counts, nproc_k, geo)
    in_b = T * (16 * K + 1) * 4
    out_f = T * (nacc + 1) * P * 4 + T * 4 + (T * 17 * K * 4 if presort else 0)
    b_f = bound_ms(in_b + out_f, FLOPS_ALL * processed + FWD_FLOPS_VIS(nacc) * visible,
                   processed + 2 * visible, clk_mhz)
    in_bwd = in_b + T * 4 + T * (2 * P + nacc * P) * 4 + (T * K * 4 if presort else 0)
    b_b = bound_ms(in_bwd + T * 16 * K * 4,
                   FLOPS_ALL * processed + BWD_FLOPS_VIS(nacc) * visible,
                   processed + 3 * visible, clk_mhz)
    suffix = "_presort" if presort else ""
    stopped = int((nproc_k.long() * geo["sub_chunk"] < counts.long()).sum())
    if saturating and not stopped:
        raise AssertionError("the saturating scene never stopped early")
    common = {"n": n, "saturating": saturating, "T": T, "K": K, "P": P,
              "sub": geo["sub_chunk"],
              "n_accum": nacc, "pairs_processed": processed,
              "pairs_visible": visible, "nproc_flips": flips,
              "early_stopped_tiles": stopped}
    return [
        dict(common, name="composite_fwd" + suffix, max_abs_err=err_f,
             ms=ms_fk, plain_ms=ms_fp, bound_ms=b_f[0], bound_by=b_f[1]),
        dict(common, name="composite_bwd" + suffix, max_abs_err=err_b,
             max_row_rel_err=err_b_rel, ms=ms_bk, plain_ms=ms_bp, bound_ms=b_b[0], bound_by=b_b[1]),
    ]


def phase_kernels(clk_mhz: float) -> list[dict]:
    """Every variant at the main path's shapes (8192 Gaussians: T 230, K 512,
    P 4096, sub 64, 7 channels), at 16k (T 450, P 2048, sub 128), and on a
    saturating 8192-Gaussian scene whose tiles stop early."""
    rows = []
    for n, saturating in ((8192, False), (16384, False), (8192, True)):
        for presort in (False, True):
            for r in compare_kernels(n, presort, clk_mhz, saturating):
                emit(dict(r, phase="kernels"))
                rows.append(r)
    return rows


REPO = os.path.dirname(os.path.abspath(__file__))
ROPE_CKPT = os.path.join(REPO, "benchmarks/out/generalization/checkpoints/latest.ckpt")
TRAJ = os.path.join(REPO, "benchmarks/out/pipeline/ckpts/param_downsampled.npy")
GNN_TOL = 1e-4  # of the output's largest entry: f32 sums in another order


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


def gnn_inputs(B: int, n_obj: int, n_pad: int, max_nR: int, topk: int,
               adj: float, connect_all: bool):
    """One chunk of the rollout's GNN inputs: sample b's history is three
    consecutive frames of the committed trajectory starting at b % 14, its
    pusher a random point near the object; edges by the port's
    `construct_edge_indices_batch` on the last frame."""
    from gsdx_torch.graph.edges import construct_edge_indices_batch

    frames = trajectory_particles(n_obj)
    g = torch.Generator(device="cuda").manual_seed(0)
    N = n_obj + 1
    starts = torch.arange(B, device="cuda") % 14
    hist = torch.stack([frames[starts + h] for h in range(3)], 1)  # (B, 3, n_obj, 3)
    tool = hist[:, :, :1] + 0.03 * torch.randn(B, 1, 1, 3, device="cuda", generator=g)
    states = torch.cat([hist, tool], 2)  # (B, 3, N, 3)
    mask = torch.ones(B, N, dtype=torch.bool, device="cuda")
    tool_mask = torch.zeros_like(mask)
    tool_mask[:, n_obj] = True
    recv, send = construct_edge_indices_batch(states[:, -1], adj, mask, tool_mask,
                                              n_obj=n_obj, topk=topk, max_nR=max_nR,
                                              connect_all=connect_all)
    e_pad = -(-max_nR // 8) * 8
    fill = torch.full((B, e_pad - max_nR), -1, dtype=torch.int32, device="cuda")
    recv, send = torch.cat([recv, fill], 1), torch.cat([send, fill], 1)
    attrs = torch.zeros(B, n_pad, 2, device="cuda")
    attrs[:, :n_obj, 0] = 1
    attrs[:, n_obj:N, 1] = 1
    action = torch.zeros(B, n_pad, 3, device="cuda")
    action[:, n_obj, :2] = 0.01 * torch.randn(B, 2, device="cuda", generator=g)
    st = torch.zeros(B, n_pad, 9, device="cuda")
    st[:, :N] = states.transpose(1, 2).reshape(B, N, 9)
    gi = torch.zeros(B, n_pad, 1, device="cuda")
    gi[:, :n_obj] = 1
    return [attrs, action, st, gi, recv.contiguous(), send.contiguous()]


def compare_gnn(name: str, packed, ins, n_obj: int) -> dict:
    """The fused forward's kernels against `gnn_forward_plain`."""
    from gsdx_torch.kernels import gnn_forward as G

    out_k = G.fused_gnn_forward(packed, *ins)
    out_p = G.gnn_forward_plain(packed, *ins)
    torch.cuda.synchronize()
    scale = float(out_p.abs().max())
    err = float((out_k - out_p).abs().max())
    if not (torch.isfinite(out_k).all() and err <= GNN_TOL * scale):
        raise AssertionError(f"{name}: GNN kernel vs plain max |err| {err} "
                             f"> {GNN_TOL} * {scale}")
    ms_k = cuda_ms(lambda: G.fused_gnn_forward(packed, *ins))
    ms_p = cuda_ms(lambda: G.gnn_forward_plain(packed, *ins), reps=5)
    B, n_pad, _ = ins[0].shape
    E = ins[4].shape[1]
    F = packed.w2r.shape[0]
    n_edges = int((ins[4] >= 0).sum())
    # the work this input needs: real node rows and valid edge slots
    flops = G.forward_flops(B * (n_obj + 1), n_edges, F, 9, 3)
    flops_padded = G.forward_flops(B * n_pad, B * E, F, 9, 3)
    bytes_moved = (sum(t.numel() * t.element_size() for t in ins)
                   + sum(t.numel() * t.element_size()
                         for t in (getattr(packed, f) for f in G.GSDX_FIELDS))
                   + out_k.numel() * 4)
    t_bytes = bytes_moved / PEAK_BYTES_S
    t_bf16 = flops / PEAK_BF16_FLOP_S
    return {"name": name, "B": B, "n_pad": n_pad, "E": E, "n_obj": n_obj,
            "valid_edges": n_edges, "gflop_needed": flops / 1e9,
            "gflop_padded": flops_padded / 1e9, "max_abs_err": err,
            "max_abs_out": scale, "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": 1e3 * max(t_bytes, t_bf16),
            "bound_by": "bytes" if t_bytes >= t_bf16 else "operations",
            "bound_rate": "bf16 tensor cores, 989 TFLOP/s",
            "bound_ms_f32": 1e3 * max(t_bytes, flops / PEAK_F32_FLOP_S),
            "achieved_tflop_s": flops / (ms_k * 1e-3) / 1e12}


def phase_gnn_kernels() -> list[dict]:
    """Kernel #3 at the rope shapes the plan phase gives it (one 125-sample
    chunk of 1000) and at the cloth family's 256 / 1200 shapes."""
    from gsdx_torch.dynamics.model import DynamicsPredictor, ModelConfig, flax_params
    from gsdx_torch.kernels import gnn_forward as G

    rope = G.pack_gnn_params(flax_params(rope_model(), as_numpy=False), device="cuda")
    rows = [compare_gnn("gnn_forward_rope", rope,
                        gnn_inputs(125, 100, 128, 500, 5, 0.08, False), 100)]
    cloth = DynamicsPredictor(ModelConfig(state_dim=1, motion_dim=3),
                              generator=torch.Generator().manual_seed(0))
    packed = G.pack_gnn_params(flax_params(cloth, as_numpy=False), device="cuda")
    rows.append(compare_gnn("gnn_forward_cloth", packed,
                            gnn_inputs(125, 150, 256, 1200, 6, 0.075, True), 150))
    for r in rows:
        emit(dict(r, phase="kernels"))
    return rows


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
    emit(row)
    # tests/test_gnn_fused.py's bf16-class tolerance for chained pushes
    if not err <= 2e-3:
        raise AssertionError(f"fused rollout vs module rollout: {err} > 2e-3")
    return row


def device_profile(fn, what: str, steps: int = 5, top: int = 12) -> dict:
    """Where one call of ``fn`` spends its time: the wall time of ``steps``
    calls after a warm-up, then `torch.profiler` over as many calls for the
    device time summed by kernel name. The idle share compares the device
    time with the wall time taken without the profiler, which slows the
    host."""
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
    return {"phase": "profile", "what": what, "wall_ms_per_call": wall_ms,
            "profiled_wall_ms_per_call": profiled_wall_ms,
            "device_busy_ms_per_call": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
            "launches_per_call": sum(k[2] for k in kernels),
            "top_kernels": [{"name": n[:80], "ms": ms, "calls": c}
                            for n, ms, c in kernels[:top]]}


def phase_profile() -> list[dict]:
    """Device breakdown of a 5k-Gaussian 720p rasterize fwd+bwd, of one t=0
    tracking iteration of the slice's scene (densification off) and of one
    MPPI iteration of the plan phase."""
    from gsdx_torch.core.gaussians import init_gaussian_params, init_tracking_variables
    from gsdx_torch.kernels.knn import knn
    from gsdx_torch.render.rasterize import RasterizeConfig, rasterize
    from gsdx_torch.track.densify import DensifyConfig
    from gsdx_torch.track.optimizer import GroupAdam, tracking_lrs
    from gsdx_torch.track.trainer import TrackingConfig, make_fit_timestep

    cam = camera()
    target = torch.zeros(3, H, W, device="cuda")
    args = scene(np.random.default_rng(0), 5000)
    for a in args:
        a.requires_grad_(True)

    def raster_step():
        out = rasterize(*args, cam, RasterizeConfig())
        torch.autograd.grad(torch.abs(out.im - target).mean(), args)

    rows = [device_profile(raster_step, "rasterize fwd+bwd, 5000 Gaussians, 720p")]

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

    rows.append(device_profile(
        track_iter, "tracking iteration t=0, 4 cameras, 720p, capacity 8192"))

    planner, state, init, _ = plan_setup(1000, 1)
    gen = torch.Generator(device="cuda").manual_seed(43)
    rows.append(device_profile(
        lambda: planner.trajectory_optimization(gen, state, init),
        "MPPI iteration, rope, 1000 samples, 100 particles, 8 chunks", steps=2))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import gsdx_torch  # noqa: F401  (fails here, before any output, outside the repo)

    # the plain versions are references: full f32 everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = card_info()
    emit({"phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
          **info})
    emit(phase_build())
    rows = phase_kernels(info["max_sm_mhz"])
    gnn_rows = phase_gnn_kernels()
    phase_rasterize(info["nvidia_smi"])
    slice_row = phase_slice(info["nvidia_smi"])
    plan_row = phase_plan(info["nvidia_smi"])
    phase_profile()
    phase_cli()
    phase_plan_cli()

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
    rope = gnn_rows[0]  # the plan path's shapes
    table.append({
        "name": "gnn_forward", "route": "cuda",
        "source": "gsdx_torch/csrc/gnn_forward.cu",
        "replaces": "gsdx/kernels/gnn_forward.py:180",
        "launches": plan_row["launches"]["gnn_forward"],
        "max_abs_err": rope["max_abs_err"], "ms": rope["ms"],
        "plain_ms": rope["plain_ms"], "bound_ms": rope["bound_ms"],
        "bound_by": rope["bound_by"], "library_ms": None})
    print(info["nvidia_smi"], flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
