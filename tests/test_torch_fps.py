"""gsdx_torch.kernels.fps against gsdx.kernels.fps on the CPU, the
wrappers' refusals, and on the card the CUDA kernel against its plain
version.

    python -m pytest tests/test_torch_fps.py               # CPU
    python -m pytest --noconftest -o addopts="" -m cuda \\
        tests/test_torch_fps.py                            # on the card

Every comparison is exact (tolerance 0): indices and keep masks are equal
element for element. The inputs are made with numpy from a seed and given
to both packages. JAX is imported inside the tests that use it, so the
card's tests run on a machine without JAX.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from gsdx_torch.kernels import fps

# ---------------------------------------------------------------- inputs


def _grid(axes):
    return np.stack(np.meshgrid(*axes), axis=-1).reshape(-1, len(axes)).astype(np.float32)


def _case(name):
    """(points (B, P, D) f32, n, start (B,) int64, radius (B,) f32, valid
    None / (P,) / (B, P) bool) of one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    B, P, D, n, valid = 3, 200, 3, 60, None
    if name == "d4":
        D = 4
    pts = rng.normal(0, 0.1, (B, P, D)).astype(np.float32)
    if name == "duplicates":
        pts[:, 40:80] = pts[:, 3:4]
        pts[:, 150:160] = pts[:, 120:121]
    elif name == "grid3":  # every distance ties with many others
        pts = np.repeat(_grid([np.arange(6) * 0.1] * 3)[None], B, 0)
    elif name == "grid4":  # the action sampler's 4-D grid, at 4 steps a side
        pts = np.repeat(_grid([np.arange(-0.2, 0.2, 0.1), np.arange(-0.2, 0.2, 0.1),
                               np.arange(-np.pi, np.pi, 1.6), np.arange(5.0, 20.0, 4.0)])[None],
                        B, 0)
    elif name == "valid_p":
        valid = rng.random(P) < 0.7
    elif name == "valid_bp":
        valid = rng.random((B, P)) < np.array([0.2, 0.5, 0.9])[:, None]
    elif name == "n_above_valid":  # fewer valid points than samples: indices repeat
        P, n = 50, 30
        pts = pts[:, :P]
        valid = np.zeros((B, P), bool)
        for b, k in enumerate((1, 10, 29)):
            valid[b, rng.choice(P, k, replace=False)] = True
    P = pts.shape[1]
    start = rng.integers(0, P, size=B).astype(np.int64)
    if valid is not None:  # a masked start is taken all the same, as in gsdx
        start[0] = int(np.flatnonzero(valid if valid.ndim == 1 else valid[0])[0])
    radius = rng.uniform(0.05, 0.2, size=B).astype(np.float32)
    return pts, n, start, radius, valid


CASES = ("d3", "d4", "duplicates", "grid3", "grid4", "valid_p", "valid_bp", "n_above_valid")


def _gsdx_rows(pts, n, start, radius, valid):
    """gsdx's indices and (radius) indices and keep, row by row."""
    import jax.numpy as jnp

    from gsdx.kernels import fps as jfps

    idx, ridx, rkeep = [], [], []
    for b in range(pts.shape[0]):
        kw = {} if valid is None else {
            "valid": jnp.asarray(valid if valid.ndim == 1 else valid[b])}
        idx.append(np.asarray(jfps.farthest_point_sampling(
            jnp.asarray(pts[b]), n, start_idx=int(start[b]), **kw)))
        i, k = jfps.fps_rad_idx(jnp.asarray(pts[b]), jnp.float32(radius[b]), n,
                                start_idx=int(start[b]), **kw)
        ridx.append(np.asarray(i))
        rkeep.append(np.asarray(k))
    return np.stack(idx), np.stack(ridx), np.stack(rkeep)


# ------------------------------------------------- plain version vs gsdx


@pytest.mark.parametrize("name", CASES)
def test_plain_fps_equals_gsdx(name):
    pts, n, start, radius, valid = _case(name)
    ref_idx, ref_ridx, ref_keep = _gsdx_rows(pts, n, start, radius, valid)
    t_valid = None if valid is None else torch.from_numpy(valid)
    args = (torch.from_numpy(pts),)
    idx = fps.farthest_point_sampling_batch(*args, n, torch.from_numpy(start), t_valid)
    ridx, keep = fps.fps_rad_idx_batch(*args, torch.from_numpy(radius), n,
                                       torch.from_numpy(start), t_valid)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_array_equal(ridx.numpy(), ref_ridx)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    # the CPU wrappers are the plain version
    np.testing.assert_array_equal(fps.farthest_point_sampling_batch_plain(
        *args, n, torch.from_numpy(start), t_valid).numpy(), ref_idx)


@pytest.mark.parametrize("name", ("d3", "grid4"))
def test_single_row_fps_equals_gsdx(name):
    import jax.numpy as jnp

    from gsdx.kernels import fps as jfps

    pts, n, start, _, _ = _case(name)
    p = pts[1]
    np.testing.assert_array_equal(
        fps.farthest_point_sampling(torch.from_numpy(p), n, int(start[1])).numpy(),
        np.asarray(jfps.farthest_point_sampling(jnp.asarray(p), n, start_idx=int(start[1]))))
    ri, rk = jfps.fps_rad_idx(jnp.asarray(p), 0.1, n, start_idx=int(start[1]))
    # a float and an int, or one-value tensors of them
    for r, s in ((0.1, int(start[1])), (torch.tensor(0.1), torch.tensor(int(start[1])))):
        i, k = fps.fps_rad_idx(torch.from_numpy(p), r, n, start_idx=s)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(k.numpy(), np.asarray(rk))


# A pair (t0, t1) whose f64 sum fl(t0^2) + t1^2 lands exactly on an f32
# rounding midpoint while the exact sum lies above it: rounding the f64 sum
# to f32 ties to the even neighbour (up, here), one fused multiply-add
# rounds to the nearer one. (w0, w1) is a point at exactly the upper
# neighbour's distance, later in the list: single rounding leaves (t0, t1)
# below it, so FPS picks index 2; double rounding ties them and picks 1.
T0, T1 = np.float32(2.0287343e-06), np.float32(0.10001124)
W0, W1 = np.float32(0.09001012), np.float32(0.043593876)


def _round_f32(x: Fraction) -> np.float32:
    """x rounded once to f32, to nearest, ties to even."""
    near = np.float32(float(x))
    cands = (np.nextafter(near, np.float32(-1)), near, np.nextafter(near, np.float32(1)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.array(v).view(np.int32)) & 1))


def test_double_rounding_case_is_a_midpoint():
    acc = np.float32(T0 * T0)
    exact = Fraction(float(acc)) + Fraction(float(T1)) ** 2
    f64 = np.float64(acc) + np.float64(T1) * np.float64(T1)
    lo = np.float32(f64)
    lo, hi = (np.nextafter(lo, np.float32(-1)), lo) if Fraction(float(lo)) > Fraction(float(f64)) \
        else (lo, np.nextafter(lo, np.float32(1)))
    assert Fraction(float(f64)) == (Fraction(float(lo)) + Fraction(float(hi))) / 2  # a midpoint
    assert exact != Fraction(float(f64))
    single = _round_f32(exact)
    assert single != np.float32(f64)  # double rounding is off here
    t = torch.tensor([T1])
    assert fps._fma_square(t, torch.tensor([acc])).item() == single
    assert fps._sq_dist(torch.tensor([[T0, T1]]), torch.zeros(1, 2)).item() == single
    # the other point's distance is exact either way, and equals f64's tie
    d_w = _round_f32(Fraction(float(np.float32(W0 * W0))) + Fraction(float(W1)) ** 2)
    assert d_w == np.float32(f64)


def test_fps_single_rounding_equals_gsdx():
    import jax.numpy as jnp

    from gsdx.kernels import fps as jfps

    pts = np.array([[0, 0], [T0, T1], [W0, W1]], np.float32)
    ref = np.asarray(jfps.farthest_point_sampling(jnp.asarray(pts), 2))
    assert ref.tolist() == [0, 2]  # gsdx rounds the FMA once
    np.testing.assert_array_equal(fps.farthest_point_sampling(torch.from_numpy(pts), 2).numpy(),
                                  ref)
    ri, rk = jfps.fps_rad_idx(jnp.asarray(pts), 0.01, 3)
    i, k = fps.fps_rad_idx(torch.from_numpy(pts), 0.01, 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(k.numpy(), np.asarray(rk))


# more (t0, t1) pairs of the same kind
CRAFTED = ((T0, T1), (np.float32(1.8102917e-06), np.float32(0.100011274)),
           (np.float32(1.2615923e-06), np.float32(0.10001135)))


@pytest.mark.parametrize("seed", range(3))
def test_fma_square_is_one_rounding(seed):
    """`_fma_square` against the exact sum rounded once, on random pairs
    and on the crafted midpoint pairs."""
    rng = np.random.default_rng(seed)
    t = rng.normal(0, 1, 200).astype(np.float32)
    acc = np.abs(rng.normal(0, 1, 200)).astype(np.float32)
    for j, (t0, t1) in enumerate(CRAFTED):
        t[j], acc[j] = t1, np.float32(t0 * t0)
    got = fps._fma_square(torch.from_numpy(t), torch.from_numpy(acc)).numpy()
    want = [_round_f32(Fraction(float(a)) + Fraction(float(x)) ** 2) for x, a in zip(t, acc)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))


# ------------------------------------------------------------ refusals


def _refusals():
    P = 10
    pts = torch.zeros(2, P, 3)
    return [
        ("points", dict(points=torch.zeros(2, P, 3, dtype=torch.float64))),
        ("points", dict(points=torch.zeros(2, P, 5))),
        ("points", dict(points=torch.zeros(2, P, 0))),
        ("points", dict(points=torch.zeros(1, fps.MAX_P + 1, 1))),
        ("points", dict(points=torch.zeros(2, 0, 3))),
        ("points", dict(points=torch.zeros(P, 3))),
        ("points", dict(points=torch.zeros(2, P, 3, device="meta"))),
        ("start_idx", dict(points=pts, start_idx=P)),
        ("start_idx", dict(points=pts, start_idx=-1)),
        ("start_idx", dict(points=pts, start_idx=torch.zeros(2, dtype=torch.int32))),
        ("start_idx", dict(points=pts, start_idx=torch.zeros(3, dtype=torch.int64))),
        ("start_idx", dict(points=pts, start_idx=torch.tensor(0))),
        ("start_idx", dict(points=pts, start_idx=torch.zeros(2, dtype=torch.int64,
                                                              device="meta"))),
        ("start_idx", dict(points=pts, start_idx=1.5)),
        ("valid", dict(points=pts, valid=torch.ones(P, dtype=torch.uint8))),
        ("valid", dict(points=pts, valid=torch.ones(P + 1, dtype=torch.bool))),
        ("valid", dict(points=pts, valid=torch.ones(3, P, dtype=torch.bool))),
        ("n_samples", dict(points=pts, n=-1)),
        ("radius", dict(points=pts, radius=torch.ones(2, dtype=torch.float64))),
        ("radius", dict(points=pts, radius=torch.ones(3))),
        ("radius", dict(points=pts, radius="wide")),
    ]


@pytest.mark.parametrize("arg,kw", _refusals(),
                         ids=[f"{a}-{i}" for i, (a, _) in enumerate(_refusals())])
def test_wrapper_refusals_name_the_argument(arg, kw):
    points, n = kw["points"], kw.get("n", 4)
    start, valid = kw.get("start_idx", 0), kw.get("valid")
    if arg == "radius":
        with pytest.raises(ValueError, match="radius"):
            fps.fps_rad_idx_batch(points, kw["radius"], n, start, valid)
        return
    with pytest.raises(ValueError, match=arg):
        fps.farthest_point_sampling_batch(points, n, start, valid)
    if points.dim() == 3:
        with pytest.raises(ValueError, match="max_samples" if arg == "n_samples" else arg):
            fps.fps_rad_idx_batch(points, 0.1, n, start, valid)


def test_floor_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="points"):
        fps.fps_latency_floor(torch.zeros(1, 10, 3), 4)


def test_empty_outputs():
    pts = torch.zeros(2, 10, 3)
    assert fps.farthest_point_sampling_batch(pts, 0).shape == (2, 0)
    i, k = fps.fps_rad_idx_batch(pts, 0.1, 0)
    assert i.shape == k.shape == (2, 0)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


CARD_SHAPES = [  # (B, P, D, n, valid) at the slice's shapes and the cluster's
    (16, 1000, 3, 100, None), (16, 100, 3, 100, None), (64, 1000, 3, 150, None),
    (1, 6558, 3, 1000, None), (1, 20000, 3, 100, None), (1, fps.MAX_P, 3, 50, None),
    (1, 15 ** 4, 4, 60, "grid"), (4, 500, 3, 100, "bp"), (4, 500, 2, 100, "p"),
    (2, 9000, 1, 40, "bp"), (3, 1, 3, 5, None), (2, 300, 3, 1, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,P,D,n,mask", CARD_SHAPES)
def test_fps_kernel_equals_plain(cuda, B, P, D, n, mask):
    rng = np.random.default_rng(P + D)
    if mask == "grid":
        pts = np.repeat(_grid([np.arange(15) * 0.02] * 4)[None], B, 0)
    else:
        pts = rng.normal(0, 0.1, (B, P, D)).astype(np.float32)
    valid = None
    if mask == "bp":
        valid = torch.from_numpy(rng.random((B, P)) < 0.05).to(cuda)
    elif mask == "p":
        valid = torch.from_numpy(rng.random(P) < 0.1).to(cuda)
    x = torch.from_numpy(pts).to(cuda)
    start = torch.from_numpy(rng.integers(0, P, B)).to(cuda)
    radius = torch.from_numpy(rng.uniform(0.01, 0.05, B).astype(np.float32)).to(cuda)
    got = fps.farthest_point_sampling_batch(x, n, start, valid)
    want = fps.farthest_point_sampling_batch_plain(x, n, start, valid)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    gi, gk = fps.fps_rad_idx_batch(x, radius, n, start, valid)
    wi, wk = fps.fps_rad_idx_batch_plain(x, radius, n, start, valid)
    torch.testing.assert_close(gi, wi, rtol=0, atol=0)
    torch.testing.assert_close(gk, wk, rtol=0, atol=0)
    assert fps.last_launch()["cluster"] == -(-P // 8192)
