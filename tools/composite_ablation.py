"""Where the tile compositor's time goes (gsdx_torch/csrc/composite.cu) on an
NVIDIA GPU: its forward and backward against the cluster size a tile is
split over (1, 2, 4, 8), with the alpha-cut culling off and on, and with 2
and 4 pixels a thread.

    python3 tools/composite_ablation.py

Each variant is the committed source with its compile-time constants
changed (`CLUSTER_BY_TILE_H`, `CULL`, `PPT_FWD`, `PPT_BWD`, and
`MAX_THREADS` as the block's size needs), built by nvcc into
build/composite_ablation/ and run by the wrappers (`LIBRARY.using`). The
shapes are `chip_smoke.py`'s 720p tile inputs (n_accum 7): 8192 Gaussians
at tile_h 32 (K 512, sub 64; with and without presort), at tile_h 24 and at
tile_h 8; 16384 Gaussians at tile_h 16 (sub 128, presort, as `rasterize`
runs them); and camera 0 of one tracking iteration of its slice scene
(6144 points, capacity 8192, rgb + seg, tile_h 32). A variant whose block
is sized for shorter tiles than a shape's is refused there and reported
so. The forward must give the same bits in every variant, the
backward the same gradient within 1e-4 of each row's largest entry (the
cluster sums in another order). Every time is the kernel's device time a
call from `torch.profiler` over 30 calls, taken in the order variants,
variants reversed. Prints the card's name and power limit, each variant's
registers and spills, then one JSON line per shape.
"""

from __future__ import annotations

import importlib
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as S  # noqa: E402
from gsdx_torch.kernels import _build  # noqa: E402
from gsdx_torch.kernels import composite as C  # noqa: E402

# name: (cluster size for every tile_h or None for the shipped table, cull,
# pixels a thread in the forward, in the backward, the tallest tile_h the
# block is sized for). `MAX_THREADS` follows from the last, and caps the
# registers (64 at 1024 threads). At the shipped 2 pixels a thread, clusters
# of 2 and 1 would need 1024 and 2048 threads at tile_h 32, so they are
# sized for tile_h 16 and refused above it; the 4-pixel variants compare
# every cluster size at tile_h 32.
VARIANTS = {
    "shipped": (None, True, 2, 2, 32),
    "no cull": (None, False, 2, 2, 32),
    "cluster 8": (8, True, 2, 2, 32),
    "cluster 4": (4, True, 2, 2, 32),
    "cluster 2": (2, True, 2, 2, 16),
    "cluster 1": (1, True, 2, 2, 16),
    "4 pixels a thread": (None, True, 4, 4, 32),
    "cluster 4, 4 pixels a thread": (4, True, 4, 4, 32),
    "cluster 2, 4 pixels a thread": (2, True, 4, 4, 32),
    "cluster 1, 4 pixels a thread": (1, True, 4, 4, 32),
    "cluster 1, no cull, 4 pixels a thread": (1, False, 4, 4, 32),
}

CONSTANTS = {  # what this script sets, as the committed source writes it
    "cluster": r"constexpr int CLUSTER_BY_TILE_H\[4\] = \{[^}]*\};",
    "threads": r"constexpr int MAX_THREADS = \d+;",
    "cull": r"constexpr bool CULL = \w+;",
    "ppt_fwd": r"constexpr int PPT_FWD = \d+;",
    "ppt_bwd": r"constexpr int PPT_BWD = \d+;",
}


def variant_source(cluster: int | None, cull: bool, ppt_fwd: int, ppt_bwd: int,
                   rows: int) -> str:
    src = (_build.CSRC / "composite.cu").read_text()
    # a block covers 128 / cluster columns of up to `rows` rows, 16 x 2 ppt a warp
    warps = (rows // (2 * min(ppt_fwd, ppt_bwd))) * (8 // (cluster or 8))
    if 32 * warps > 1024:
        raise ValueError(f"a block of {32 * warps} threads: more than the card takes")
    values = {
        "cluster": None if cluster is None else
        f"constexpr int CLUSTER_BY_TILE_H[4] = {{{', '.join([str(cluster)] * 4)}}};",
        "threads": f"constexpr int MAX_THREADS = {max(256, 32 * warps)};",
        "cull": f"constexpr bool CULL = {'true' if cull else 'false'};",
        "ppt_fwd": f"constexpr int PPT_FWD = {ppt_fwd};",
        "ppt_bwd": f"constexpr int PPT_BWD = {ppt_bwd};",
    }
    out = src
    for key, pattern in CONSTANTS.items():
        if len(re.findall(pattern, src)) != 1:
            raise RuntimeError(f"composite.cu no longer has one `{pattern}`, which this "
                               "script varies")
        if values[key] is not None:
            out = re.sub(pattern, values[key], out)
    return out


def slice_camera_inputs():
    """The compositor's inputs in one t=0 tracking iteration of
    `chip_smoke.py`'s slice scene (camera 0), captured at the wrapper."""
    R = importlib.import_module("gsdx_torch.render.rasterize")
    track_iter = S.tracking_iteration()
    seen = []
    fwd = R.composite_fwd

    def fwd_hook(tile_feats, counts, **kw):
        seen.append((tile_feats.detach().clone(), counts.clone(), kw))
        return fwd(tile_feats, counts, **kw)

    R.composite_fwd = fwd_hook
    try:
        track_iter()
        torch.cuda.synchronize()
    finally:
        R.composite_fwd = fwd
    tf, counts, kw = seen[0]
    geo = {k: v for k, v in kw.items() if k not in ("presort", "early_stop")}
    return tf, counts, geo, kw["presort"]


def shape_inputs():
    """(name, tile features, counts, geometry, presort) of each shape."""
    shapes = []
    for name, n, presort, tile_h in (("8192 Gaussians", 8192, False, 0),
                                     ("8192 Gaussians, presort", 8192, True, 0),
                                     ("16384 Gaussians, presort", 16384, True, 0),
                                     ("8192 Gaussians, tile_h 24", 8192, False, 24),
                                     ("8192 Gaussians, tile_h 8", 8192, False, 8)):
        tf, counts, geo = S.tile_inputs(n, original_order=presort, tile_h=tile_h)
        shapes.append((name, tf, counts, geo, presort))
    shapes.append(("slice scene, camera 0", *slice_camera_inputs()))
    return shapes


def main() -> int:
    if not torch.cuda.is_available():
        print("composite_ablation: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    out_dir = REPO / "build" / "composite_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, (name, spec) in enumerate(VARIANTS.items()):
        path = out_dir / f"composite_{i}.cu"
        path.write_text(variant_source(*spec))
        libs[name] = _build.CudaLibrary(f"composite_ablation_{i}", str(path),
                                        C.LIBRARY.functions, C.LIBRARY.error_string)
    with ThreadPoolExecutor(len(libs)) as pool:
        logs = dict(zip(libs, pool.map(lambda lib: lib.build(), libs.values())))
    for name, log in logs.items():
        print(json.dumps({"variant": name, "ptxas": S.ptxas_report([log])}), flush=True)

    order = list(libs) + list(reversed(list(libs)))
    for shape, tf, counts, geo, presort in shape_inputs():
        g = torch.Generator(device="cuda").manual_seed(1)
        T, _, K = tf.shape
        P = geo["tile_h"] * geo["tile_w"]
        g_acc = torch.randn(T, geo["n_accum"], P, device="cuda", generator=g)
        g_lt = torch.randn(T, 1, P, device="cuda", generator=g)
        ref, row = None, {}
        for name in order:
            with C.LIBRARY.using(libs[name]):
                r = row.setdefault(name, {"fwd_ms": [], "bwd_ms": []})
                # a variant may not fit a shape: a tile taller than its block
                # is sized for, or more shared memory than the card has
                try:
                    out = C.composite_fwd(tf, counts, **geo, presort=presort)
                except RuntimeError as e:
                    r["refused"] = str(e)
                    continue
                r["launch"] = C.last_launch()
                feats_b = out[4] if presort else tf
                args_b = (feats_b, counts, out[2], out[1], g_acc, g_lt, out[3])
                try:
                    grad = C.composite_bwd(*args_b, **geo)
                except RuntimeError as e:
                    r["bwd_refused"] = str(e)
                    grad = None
                torch.cuda.synchronize()
                if ref is None:  # the shipped kernels, which run at every shape
                    ref = (out, grad)
                else:
                    for a, b in zip(out, ref[0]):
                        if a is not None and not torch.equal(a, b):
                            raise AssertionError(f"{name}: forward differs from the "
                                                 "shipped kernel")
                    if grad is not None:
                        scale = ref[1].abs().amax(dim=(0, 2), keepdim=True).clamp_min(1e-30)
                        err = float(((grad - ref[1]).abs() / scale).max())
                        if err > 1e-4:
                            raise AssertionError(f"{name}: backward differs by {err} of "
                                                 "a row's largest entry")
                r["fwd_ms"].append(S.kernel_device_ms(
                    lambda: C.composite_fwd(tf, counts, **geo, presort=presort),
                    r"\bfwd_kernel<"))
                if grad is not None:
                    r["bwd_ms"].append(S.kernel_device_ms(
                        lambda: C.composite_bwd(*args_b, **geo), r"\bbwd_kernel<"))
        print(json.dumps({"shape": shape, "T": T, "K": K, "P": P,
                          "tile_h": geo["tile_h"],
                          "sub": geo["sub_chunk"], "n_accum": geo["n_accum"],
                          "nonempty_tiles": int((counts > 0).sum()),
                          "variants": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
