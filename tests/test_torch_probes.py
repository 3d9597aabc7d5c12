"""The probe kernels (#4, #5): their plain versions against the Pallas TPU
kernels run in interpret mode on the CPU, the wrappers' CPU route, and on
the card each CUDA kernel against its plain version.

    python -m pytest tests/test_torch_probes.py            # CPU
    python -m pytest --noconftest -o addopts="" -m cuda \\
        tests/test_torch_probes.py                         # on the card

JAX is imported inside the tests that use it, so the card's tests run on a
machine without JAX.
"""

import contextlib
import functools
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gsdx_torch.kernels import probes

REPO = Path(__file__).resolve().parents[1]
T_SMALL, F, K = 4, 16, 512
SUBS = (64, 128)


def _load_transcendental_probe():
    """benchmarks/probe_transcendental.py by file path. Its import sets two
    jax.config options (the compilation cache); they are put back."""
    import jax

    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "probe_transcendental", REPO / "benchmarks" / "probe_transcendental.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@functools.lru_cache(maxsize=None)
def _pallas_hot_loop(sub, transcend):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    mod = _load_transcendental_probe()
    kern = functools.partial(mod._kernel, sub=sub, transcend=transcend)
    return pl.pallas_call(
        kern, grid=(T_SMALL,),
        in_specs=[pl.BlockSpec((1, F, K), lambda t: (t, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=[pl.BlockSpec((1, mod.N_ACCUM, mod.P), lambda t: (t, 0, 0),
                                memory_space=pltpu.VMEM),
                   pl.BlockSpec((1, 1, mod.P), lambda t: (t, 0, 0),
                                memory_space=pltpu.VMEM)],
        out_shape=[jax.ShapeDtypeStruct((T_SMALL, mod.N_ACCUM, mod.P), jnp.float32),
                   jax.ShapeDtypeStruct((T_SMALL, 1, mod.P), jnp.float32)],
        interpret=True)


def _probe_inputs(sub, T=T_SMALL, seed=0):
    """The probe's own data (`build`): normal features, counts in [sub, K]."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(T, F, K)).astype(np.float32)
    counts = rng.integers(sub, K + 1, size=(T,)).astype(np.int32)
    return feats, counts


def _dense_inputs(sub, T=T_SMALL, seed=0):
    """Splats that cover the probe's pixels: means spread over its px in
    [0, 2048) and py in [0, 12.8), positive-definite conics a few hundred
    pixels wide, opacities in [0.05, 0.5]. Every (splat, pixel) pair is
    kept, with no cancellation in the falloff, so every output entry
    depends on exp(power), log1p(-alpha) and exp(log T) (or their
    stand-ins)."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(T, F, K)).astype(np.float32)
    ca = rng.uniform(2e-6, 2e-5, size=(T, K))
    cc = rng.uniform(5e-3, 5e-2, size=(T, K))
    feats[:, 0] = rng.uniform(0, 2048, size=(T, K))
    feats[:, 1] = rng.uniform(0, 12.8, size=(T, K))
    feats[:, 2], feats[:, 4] = ca, cc
    feats[:, 3] = rng.uniform(-0.9, 0.9, size=(T, K)) * np.sqrt(ca * cc)
    feats[:, 5] = rng.uniform(0.05, 0.5, size=(T, K))
    counts = rng.integers(sub, K + 1, size=(T,)).astype(np.int32)
    return feats, counts


INPUTS = {"probe": _probe_inputs, "dense": _dense_inputs}


def _close_to_largest(a, b, share):
    """``a`` against ``b`` relative to the output's largest magnitude: all
    but ``share`` of the entries that are non-zero in ``b`` within 1e-5 of
    it, and every entry within 2e-2.

    Why the scale is the largest entry: the polynomial variant's w is a
    quadratic in a log T that falls by about 1.5 a kept splat, so its
    entries reach ~1e5, and an f32 rounding in a large entry is absolute.
    Why the count is of the non-zero entries: on the probe's own data
    exp(power) is 0 for nearly every pair, and with the transcendentals
    only ~2% of the entries carry a kept splat.
    Why some entries may be off by more: one f32 rounding (another order, a
    fused multiply-add, an exp an ulp apart) can carry an alpha across the
    1/255 cut. That adds or drops up to 1/255 of a channel (|channel| up to
    ~5), scales the pixel's later splats by up to e^(1/255), and moves its
    log T by log1p(-1/255) = -0.0039. On the probe's data such crossings
    are frequent: its coordinates run to px = 2047 while the means are
    N(0, 1), so the falloff's terms reach ~1e7 and cancel to a power near
    0 wherever a splat is kept, and one rounding moves a power by ~0.1.
    They part 0.7% of the transcendental variant's non-zero entries (4 of
    540 at T 4 against the Pallas kernel; 161 of 22,620 on the card at
    T 128) and 0.02% of the polynomial one's: ``share`` 2%. On
    `_dense_inputs` no falloff cancels and a crossing needs an alpha
    within an ulp of 1/255: 1 of 8,192 log T entries at T 4, none of the
    accumulators: ``share`` 0.1%."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b) / max(np.abs(b).max(), 1.0)
    assert err.max() <= 2e-2, err.max()
    assert (err > 1e-5).sum() <= share * (b != 0).sum(), ((err > 1e-5).sum(), (b != 0).sum())


# the share of non-zero entries that may be off by more than 1e-5
SHARE = {"probe": 0.02, "dense": 1e-3}


@contextlib.contextmanager
def _saved_on_failure(case, **arrays):
    """Where ``GSDX_PARITY_DUMP`` names a directory (`tools/parity_loop.py`
    sets it a run), a failed check saves the case's inputs and both sides'
    outputs there, ``<case>-pid<pid>.npz`` (``*_j`` the Pallas kernel's,
    ``*_t`` the port's), with what the process was: its xdist worker, torch's
    thread count, the CPUs it may use and the inputs' addresses mod 64."""
    try:
        yield
    except AssertionError:
        out = os.environ.get("GSDX_PARITY_DUMP")
        if out:
            os.makedirs(out, exist_ok=True)
            np.savez(os.path.join(out, f"{case}-pid{os.getpid()}.npz"),
                     **{k: np.asarray(v) for k, v in arrays.items()})
            info = {"worker": os.environ.get("PYTEST_XDIST_WORKER"),
                    "torch_threads": torch.get_num_threads(),
                    "cpus": len(os.sched_getaffinity(0)),
                    "address_mod_64": {k: v.ctypes.data % 64 for k, v in arrays.items()
                                       if isinstance(v, np.ndarray)}}
            with open(os.path.join(out, f"{case}-pid{os.getpid()}.json"), "w") as f:
                json.dump(info, f)
        raise


@pytest.mark.parametrize("sub", SUBS)
@pytest.mark.parametrize("transcend", [True, False])
@pytest.mark.parametrize("data", ["probe", "dense"])
def test_hot_loop_plain_matches_pallas_interpret(data, sub, transcend):
    import jax.numpy as jnp

    feats, counts = INPUTS[data](sub)
    acc_j, lt_j = _pallas_hot_loop(sub, transcend)(jnp.asarray(feats), jnp.asarray(counts))
    acc_t, lt_t = probes.composite_hot_loop_plain(torch.from_numpy(feats),
                                                  torch.from_numpy(counts), sub, transcend)
    with _saved_on_failure(f"hot_loop-{data}-{transcend}-{sub}", feats=feats, counts=counts,
                           acc_j=acc_j, lt_j=lt_j, acc_t=acc_t, lt_t=lt_t):
        if data == "dense":
            assert (np.asarray(acc_j) != 0).mean() > 0.99
        _close_to_largest(acc_t.numpy(), acc_j, SHARE[data])
        _close_to_largest(lt_t.numpy(), lt_j, SHARE[data])
    assert np.isfinite(acc_t.numpy()).all() and np.abs(lt_t.numpy()).max() > 0


_PLAIN_IN_A_CHILD = """
import sys
import numpy as np, torch
from gsdx_torch.kernels import probes
z = np.load(sys.argv[1])
out = {}
for data in ("probe", "dense"):
    for transcend in (True, False):
        acc, lt = probes.composite_hot_loop_plain(
            torch.from_numpy(z[data + "_feats"]), torch.from_numpy(z[data + "_counts"]), 64, transcend)
        out[f"{data}-{transcend}-acc"], out[f"{data}-{transcend}-lt"] = acc.numpy(), lt.numpy()
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def plain_in_a_child(tmp_path_factory):
    """Runs the plain version on `INPUTS` at sub 64 in a child process whose
    environment has no MKL settings but ``setting`` ("NAME=value"), once a
    setting; returns its outputs."""
    tmp = tmp_path_factory.mktemp("mkl")
    inputs = {}
    for data in ("probe", "dense"):
        inputs[data + "_feats"], inputs[data + "_counts"] = INPUTS[data](64)
    np.savez(tmp / "in.npz", **inputs)
    env = {k: v for k, v in os.environ.items() if not k.startswith("MKL_")}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])

    @functools.lru_cache(maxsize=None)
    def run(setting=None):
        out = tmp / f"{setting or 'default'}.npz"
        subprocess.run([sys.executable, "-c", _PLAIN_IN_A_CHILD, str(tmp / "in.npz"), str(out)],
                       env=dict(env, **dict([setting.split("=")])) if setting else env,
                       cwd=REPO, check=True, timeout=300)
        return dict(np.load(out))

    return run


@pytest.mark.parametrize("mkl", ["MKL_CBWR=COMPATIBLE", "MKL_ENABLE_INSTRUCTIONS=AVX2"])
def test_hot_loop_plain_is_the_same_on_every_mkl_code_path(plain_in_a_child, mkl):
    """MKL picks its code path at run time, and on the CPU `torch.exp` and
    `torch.bmm` run MKL. In a fresh pytest worker the plain version's first
    call has come out other than usual in one tile (log T up to 0.0018
    apart; once 29 of 540 accumulator entries over the parity check's 1e-5)
    while the Pallas side stayed put. A child process forced onto another
    MKL path by its environment must get the same bits as one left to MKL's
    own choice."""
    want, got = plain_in_a_child(), plain_in_a_child(mkl)
    for k in want:
        np.testing.assert_array_equal(got[k].view(np.uint32), want[k].view(np.uint32),
                                      err_msg=f"{k} under {mkl}")


def test_hot_loop_plain_clamps_counts():
    """A count above K walks the tile's K splats, a negative one none."""
    feats, counts = _probe_inputs(64, T=3, seed=2)
    ft = torch.from_numpy(feats)
    bad = torch.tensor([K + 100, -5, 70], dtype=torch.int32)
    good = torch.tensor([K, 0, 70], dtype=torch.int32)
    for transcend in (True, False):
        got = probes.composite_hot_loop_plain(ft, bad, 64, transcend)
        want = probes.composite_hot_loop_plain(ft, good, 64, transcend)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert not got[1][1].any()


def _pallas_roll(x, shift):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    # the kernel of benchmarks/probe_dynamic_roll.py:10-12 (`kern`), copied
    # because that script runs its probe and imports gsdx when imported
    def kern(shift_ref, x_ref, o_ref):
        s = shift_ref[0]
        o_ref[...] = pltpu.roll(x_ref[...], shift=s, axis=1)

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        interpret=True)(shift, x)


@pytest.mark.parametrize("shift", [0, 3, 130, 511, -1, 515])
def test_dynamic_roll_plain_bit_equal_to_pallas_interpret(shift):
    import jax.numpy as jnp

    x = np.arange(8 * 512, dtype=np.float32).reshape(8, 512)
    s = np.asarray([shift], np.int32)
    out_j = np.asarray(_pallas_roll(jnp.asarray(x), jnp.asarray(s)))
    out_t = probes.dynamic_roll_plain(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(out_t, np.roll(x, shift, axis=1))


def test_wrappers_take_the_plain_route_for_cpu_tensors():
    probes.reset_launches()
    feats, counts = _probe_inputs(64, T=2, seed=3)
    ft, ct = torch.from_numpy(feats), torch.from_numpy(counts)
    for transcend in (True, False):
        got = probes.composite_hot_loop(ft, ct, 64, transcend)
        want = probes.composite_hot_loop_plain(ft, ct, 64, transcend)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    x = torch.randn(8, 512)
    s = torch.tensor([7], dtype=torch.int32)
    assert torch.equal(probes.dynamic_roll(x, s), torch.roll(x, 7, dims=1))
    assert all(v == 0 for v in probes.LAUNCHES.values())


def test_roll_refusals_name_what_failed():
    """`dynamic_roll` checks CUDA inputs in one expression; `_refuse_roll`
    raises the error of the check that failed."""
    x, s = torch.zeros(8, 512), torch.zeros(1, dtype=torch.int32)
    for bad_x, bad_s, msg in ((torch.zeros(8, 512, 1), s, "2-D float32"),
                              (x.double(), s, "2-D float32"),
                              (x, torch.zeros(2, dtype=torch.int32), r"\(1,\) int32"),
                              (x, s.long(), r"\(1,\) int32"),
                              (x, s, "CUDA tensor")):
        with pytest.raises(ValueError, match=msg):
            probes._refuse_roll(bad_x, bad_s)
    for bad_out, msg in ((torch.zeros(8, 511), "of x's shape"),
                         (torch.zeros(8, 512, dtype=torch.float64), "of x's shape"),
                         (torch.zeros(512, 8).t(), "must not overlap"),
                         (x, "must not overlap")):
        with pytest.raises(ValueError, match=msg):
            probes._refuse_roll(x, s, bad_out, cuda=False)


def test_roll_writes_into_the_callers_output():
    """With ``out``, `dynamic_roll` returns that tensor holding the roll, and
    refuses one that overlaps x."""
    x = torch.randn(8, 512)
    s = torch.tensor([-3], dtype=torch.int32)
    out = torch.empty(8, 512)
    assert probes.dynamic_roll(x, s, out=out) is out
    assert torch.equal(out, torch.roll(x, -3, dims=1))
    with pytest.raises(ValueError, match="must not overlap"):
        probes.dynamic_roll(x, s, out=x)


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sub", SUBS)
@pytest.mark.parametrize("transcend", [True, False])
@pytest.mark.parametrize("data", ["probe", "dense"])
def test_hot_loop_kernel_matches_plain(cuda, data, sub, transcend):
    # T 128: more units (16 a tile) than the persistent warps take at once
    feats, counts = INPUTS[data](sub, T=128, seed=1)
    counts[:2] = (K + 100, -5)  # clamped to [0, K] by both
    ft, ct = torch.from_numpy(feats).to(cuda), torch.from_numpy(counts).to(cuda)
    before = probes.LAUNCHES["hot_loop" if transcend else "hot_loop_poly"]
    got = probes.composite_hot_loop(ft, ct, sub, transcend)
    want = probes.composite_hot_loop_plain(ft, ct, sub, transcend)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["hot_loop" if transcend else "hot_loop_poly"] == before + 1
    for a, b in zip(got, want):
        _close_to_largest(a.cpu().numpy(), b.cpu().numpy(), SHARE[data])


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 3, 130, 511, -1, 515])
def test_dynamic_roll_kernel_bit_equal(cuda, shift):
    x = torch.randn(8, 512, device=cuda)
    s = torch.tensor([shift], dtype=torch.int32, device=cuda)
    assert torch.equal(probes.dynamic_roll(x, s), torch.roll(x, shift, dims=1))
    out = torch.empty_like(x)
    assert probes.dynamic_roll(x, s, out=out) is out
    assert torch.equal(out, torch.roll(x, shift, dims=1))
