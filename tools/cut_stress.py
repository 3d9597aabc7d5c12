"""Tile inputs that put alphas within a few ulps of the 1/255 cut, for
holding the compositor kernels (#1, #1p, #2, #2p; gsdx_torch/csrc/composite.cu)
to their plain version where one rounding decides whether a pair counts.

    python3 tools/cut_stress.py [--against PATH/composite.cu]

`cut_stress_inputs(seed, n_accum, presort)` builds, with numpy alone, the
tile features of busy tiles whose every splat has one target pixel where
opacity * exp(power) lands within CUT_ULPS f32 ulps of 1/255, the power
taken in the plain version's order and rounding (each product and sum
rounded on its own; `kernels/composite.py` `_composite_batch`). An order
that contracts the falloff into fused multiply-adds moves such a power by
an ulp in about a quarter of the pairs, which carries the alpha across the
cut: the pair's log(1 - alpha), -0.0039, is then added or dropped.
``presort`` picks the shape: the online fit's (presorting compositor,
640x480, 16-row tiles, 128-wide granules, columns in random depth order)
or the 8192-Gaussian slice's (720p, 32-row tiles, 64-wide granules,
columns in depth order). `chip_smoke.py` holds the kernels to their plain
versions on these inputs (phase `kernels`, `cut_stress` rows).

Run as a script on an NVIDIA GPU, it runs that check on the tree's
compositor and, with ``--against``, on a second copy of composite.cu (the
parent's, say) built beside it, and times #1, #1p, #2 and #2p of both on
real tile inputs of three shapes: the slice's (`chip_smoke.py`'s
8192-Gaussian 720p inputs), a predict frame's (n_accum 4) and the online
fit's (n_accum 7, 640x480), the last two those that `chip_smoke.py`'s
`predict` and `online` phases, run here in full, hand to `compare_fwd_at`.
Each time is the kernel's device time a call from `torch.profiler`, in the
order other, tree, tree, other. Prints the card's name and power limit,
one JSON line per check and per shape (and the two phases' own lines),
then CUT STRESS OK; exits 1 if the tree's kernels fail the check.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

FEAT_DIM, K, TILE_W = 16, 512, 128
ALPHA_MIN = np.float32(1.0 / 255.0)
CUT_ULPS = 3  # targets land within this many f32 ulps of ALPHA_MIN
# (width, height, tile_h, sub_chunk) of the two shapes
SHAPES = {True: (640, 480, 16, 128), False: (1280, 720, 32, 64)}
BUSY_TILES = 24
MIN_SPLATS = 320  # splats a busy tile, at least (at most K)


def falloff(ca, cb, cc, dx, dy):
    """The plain version's power in f32, every operation rounded."""
    f = np.float32
    t = (ca * dx).astype(f) * dx
    u = (cc * dy).astype(f) * dy
    s = f(-0.5) * (t + u).astype(f)
    return (s - ((cb * dx).astype(f) * dy).astype(f)).astype(f)


def falloff_contracted(ca, cb, cc, dx, dy):
    """The same power with its sums contracted into fused multiply-adds, as
    nvcc compiles the plain expression: fma(ca dx, dx, cc dy dy) and
    fma(-(cb dx), dy, -0.5 s), each emulated in float64 (the f32 product is
    exact there) and rounded once to f32."""
    f, d = np.float32, np.float64
    t = (ca * dx).astype(f)
    u = ((cc * dy).astype(f) * dy).astype(f)
    s = (f(-0.5) * (t.astype(d) * dx + u).astype(f)).astype(f)
    v = (cb * dx).astype(f)
    return (s.astype(d) - v.astype(d) * dy).astype(f)


def _nudge(op, e, target):
    """The opacity among op's 32 f32 neighbours whose alpha op * e (f32)
    comes closest to ``target``."""
    steps = np.arange(-16, 17)
    cand = op[:, None].copy()
    bits = cand.view(np.int32) + steps[None, :].astype(np.int32)
    cand = bits.view(np.float32)
    alpha = (cand * e[:, None]).astype(np.float32)
    best = np.argmin(np.abs(alpha.astype(np.float64) - target[:, None]), axis=1)
    return cand[np.arange(len(op)), best]


def cut_stress_inputs(seed: int, n_accum: int, presort: bool):
    """Tile features (T, 16, K) f32, counts (T,) int32, the geometry (the
    keyword arguments of `composite_tiles_torch` and the kernels: tiles_x,
    tile_h, tile_w, n_accum, sub_chunk) and the targets (``tile``,
    ``column`` and ``pixel`` index in the tile, one a splat), all numpy.

    BUSY_TILES tiles hold MIN_SPLATS..K splats each, the other tiles none.
    Each splat is a Gaussian 1.5-6 px wide at a random angle, centred so
    that its target pixel lies at a power of -5.3 to -2.5 (taken by
    `falloff` from the f32 inputs), with the opacity that puts alpha there
    within CUT_ULPS ulps of 1/255 (np.exp of the f32 power). Colours lie in
    [0, 1], depths in [1, 5]; with ``presort`` the columns come in random
    depth order, else in depth order."""
    if n_accum < 2 or 6 + n_accum > FEAT_DIM:
        raise ValueError(f"n_accum {n_accum} does not fit {FEAT_DIM} feature rows")
    rng = np.random.default_rng(seed)
    width, height, tile_h, sub = SHAPES[presort]
    tiles_x, tiles_y = -(-width // TILE_W), -(-height // tile_h)
    T = tiles_x * tiles_y
    feats = np.zeros((T, FEAT_DIM, K), np.float32)
    counts = np.zeros(T, np.int32)
    busy = np.sort(rng.choice(T, size=BUSY_TILES, replace=False))
    tgt_tile, tgt_col, tgt_pix = [], [], []
    for t in busy:
        n = int(rng.integers(MIN_SPLATS, K + 1))
        counts[t] = n
        ox, oy = (t % tiles_x) * TILE_W, (t // tiles_x) * tile_h
        pix = rng.integers(0, tile_h * TILE_W, size=n)
        px = (ox + pix % TILE_W).astype(np.float32)
        py = (oy + pix // TILE_W).astype(np.float32)
        # covariance from two widths and an angle; its inverse is the conic
        s1, s2 = rng.uniform(1.5, 6.0, size=(2, n))
        th = rng.uniform(0, np.pi, size=n)
        c, s = np.cos(th), np.sin(th)
        cov = np.stack([[c * c * s1**2 + s * s * s2**2, c * s * (s1**2 - s2**2)],
                        [c * s * (s1**2 - s2**2), s * s * s1**2 + c * c * s2**2]])
        det = cov[0, 0] * cov[1, 1] - cov[0, 1] ** 2
        ca = (cov[1, 1] / det).astype(np.float32)
        cb = (-cov[0, 1] / det).astype(np.float32)
        cc = (cov[0, 0] / det).astype(np.float32)
        # an offset of the target from the mean at the chosen power
        p_want = rng.uniform(-5.3, -2.5, size=n)
        phi = rng.uniform(0, 2 * np.pi, size=n)
        ux, uy = np.cos(phi), np.sin(phi)
        q = ca * ux * ux + 2 * cb * ux * uy + cc * uy * uy
        r = np.sqrt(-2 * p_want / q)
        mx = (px - r * ux).astype(np.float32)
        my = (py - r * uy).astype(np.float32)
        dx, dy = (px - mx).astype(np.float32), (py - my).astype(np.float32)
        power = falloff(ca, cb, cc, dx, dy)
        e = np.exp(power).astype(np.float32)
        # alpha within CUT_ULPS ulps of the cut, on either side
        k = rng.integers(-CUT_ULPS, CUT_ULPS + 1, size=n).astype(np.int32)
        target = (np.full(n, ALPHA_MIN).view(np.int32) + k).view(np.float32).astype(np.float64)
        op = _nudge((ALPHA_MIN / e).astype(np.float32), e, target)
        depth = rng.uniform(1.0, 5.0, size=n).astype(np.float32)
        order = rng.permutation(n) if presort else np.argsort(depth, kind="stable")
        rows = [mx, my, ca, cb, cc, op]
        rows += [rng.uniform(0, 1, size=n).astype(np.float32) for _ in range(n_accum - 1)]
        rows.append(depth)
        for f, row in enumerate(rows):
            feats[t, f, :n] = row[order]
        tgt_tile.append(np.full(n, t))
        tgt_col.append(np.argsort(order))  # splat i sits in column argsort(order)[i]
        tgt_pix.append(pix)
    geo = dict(tiles_x=tiles_x, tile_h=tile_h, tile_w=TILE_W, n_accum=n_accum,
               sub_chunk=sub)
    targets = {"tile": np.concatenate(tgt_tile), "column": np.concatenate(tgt_col),
               "pixel": np.concatenate(tgt_pix)}
    return feats, counts, geo, targets


# --------------------------------------------------------------------------
# on the card: the check, the tree's kernels against another composite.cu
# --------------------------------------------------------------------------


def _captured_inputs(card: str, clk_mhz: float) -> dict:
    """The tile inputs, counts and geometry that `chip_smoke.py`'s `predict`
    and `online` phases hand to `compare_fwd_at` (a predict frame's, the
    online fit's last visit to camera 0), keyed "predict" and "online", with
    the online fit's compositor variant: the two phases run in full, with
    `compare_fwd_at` wrapped to keep a copy of its inputs."""
    import chip_smoke as S

    kept, compare = {}, S.compare_fwd_at

    def keep(tf, counts, geo, clk, what, presort=False):
        kept["online" if "online" in what else "predict"] = (
            tf.clone(), counts.clone(), dict(geo), presort)
        return compare(tf, counts, geo, clk, what, presort)

    S.compare_fwd_at = keep
    try:
        S.phase_predict(card, clk_mhz)
        S.phase_online(card, clk_mhz)
    finally:
        S.compare_fwd_at = compare
    if sorted(kept) != ["online", "predict"]:
        raise AssertionError(f"captured the inputs of {sorted(kept)}, not predict and online")
    return kept


def _time_shapes(libs: dict, card: str, clk_mhz: float) -> list[dict]:
    import torch

    import chip_smoke as S
    from gsdx_torch.kernels import composite as C

    shapes = []
    for presort in (False, True):
        tf, counts, geo = S.tile_inputs(8192, original_order=presort)
        shapes.append(("slice", tf, counts, geo, presort))
    for name, (tf, counts, geo, ran) in _captured_inputs(card, clk_mhz).items():
        for presort in (False, True):
            shapes.append((name + (" (its variant)" if presort == ran else ""), tf, counts,
                           geo, presort))
    rows = []
    order = list(libs) + list(reversed(list(libs)))
    for name, tf, counts, geo, presort in shapes:
        T, _, Kt = tf.shape
        P = geo["tile_h"] * geo["tile_w"]
        g = torch.Generator(device="cuda").manual_seed(1)
        g_acc = torch.randn(T, geo["n_accum"], P, device="cuda", generator=g)
        g_lt = torch.randn(T, 1, P, device="cuda", generator=g)
        times = {k: {"fwd_ms": [], "bwd_ms": []} for k in libs}
        for k in order:
            with C.LIBRARY.using(libs[k]):
                out = C.composite_fwd(tf, counts, **geo, presort=presort)
                args_b = (out[4] if presort else tf, counts, out[2], out[1], g_acc, g_lt,
                          out[3])
                times[k]["fwd_ms"].append(S.kernel_device_ms(
                    lambda: C.composite_fwd(tf, counts, **geo, presort=presort),
                    r"\bfwd_kernel<"))
                times[k]["bwd_ms"].append(S.kernel_device_ms(
                    lambda: C.composite_bwd(*args_b, **geo), r"\bbwd_kernel<"))
        row = {"shape": name, "presort": presort, "T": T, "K": Kt,
               "tile_h": geo["tile_h"], "sub": geo["sub_chunk"],
               "n_accum": geo["n_accum"], "nonempty_tiles": int((counts > 0).sum()),
               "device_ms": times}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another composite.cu to check and time beside the tree's")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("cut_stress: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as S
    from gsdx_torch.kernels import _build
    from gsdx_torch.kernels import composite as C

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    libs = {"tree": C.LIBRARY}
    if args.against:
        src = Path(args.against).resolve()
        libs = {"other": _build.CudaLibrary("gsdx_composite_other", str(src),
                                            C.LIBRARY.functions, C.LIBRARY.error_string),
                **libs}
    for lib in libs.values():
        lib.build()
    ok = True
    for name, lib in libs.items():
        for presort in (False, True):
            try:
                with C.LIBRARY.using(lib):
                    row = S.check_cut_stress(presort, args.seed)
                row["passed"] = True
            except AssertionError as e:
                row = {"presort": presort, "passed": False, "failure": str(e)[:2000]}
                ok &= name != "tree"
            print(json.dumps(dict(row, source=name)), flush=True)
    info = S.card_info()
    _time_shapes(libs, info["nvidia_smi"], info["max_sm_mhz"])
    if not ok:
        return 1
    print("CUT STRESS OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
