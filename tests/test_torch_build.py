"""The launch seam of the port's CUDA kernels (`gsdx_torch/kernels/_build.py`)
on the CPU: `Launcher`, `CudaLibrary.using` and `CudaLibrary.record`, driven
through a stand-in library whose "build" is a namespace of Python functions,
so that neither nvcc nor a card is needed. The raw-stream getter, which the
CPU build of torch lacks, is replaced by one that names the device.

    python -m pytest tests/test_torch_build.py
"""

import ctypes
from types import SimpleNamespace

import pytest
import torch

from gsdx_torch.kernels import _build, composite, edges, fps, gnn_forward, probes
from gsdx_torch.kernels._build import CudaLibrary, Launcher


class StandIn(CudaLibrary):
    """A `CudaLibrary` whose loaded build is ``fns``; counts its loads."""

    def __init__(self, tag: str, **fns):
        super().__init__(f"stand_in_{tag}", "stand_in.cu", {}, "error_string")
        self.built = SimpleNamespace(error_string=lambda err: f"{tag} error {err}".encode(),
                                     **fns)
        self.loads = 0

    def load(self):
        self.loads += 1
        if self._lib is None:
            self._lib = self.built
        return self._lib


def _stream(device_index: int) -> int:
    return 1000 + device_index


@pytest.fixture(autouse=True)
def raw_stream(monkeypatch):
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", _stream, raising=False)


def _recorder(calls: list, tag: str, err: int = 0):
    def fn(*args):
        calls.append((tag, args))
        return err
    return fn


def test_launcher_resolves_its_function_once_and_passes_the_stream_last():
    calls = []
    lib = StandIn("shipped", kernel=_recorder(calls, "shipped"))
    launch = Launcher(lib, "kernel", "kernel")
    for i in range(3):
        launch(3, 11, None, i)
    assert lib.loads == 1
    assert calls == [("shipped", (11, None, i, 1003)) for i in range(3)]


def test_launcher_counts_its_key_after_an_accepted_launch_only():
    counts = {"a": 0, "b": 0}
    err = {"code": 0}
    lib = StandIn("shipped", kernel=lambda *args: err["code"])
    launch_a = Launcher(lib, "kernel", "kernel", counts, "a")
    Launcher(lib, "kernel", "kernel", counts, "b")
    launch_a(0)
    launch_a(0)
    assert counts == {"a": 2, "b": 0}
    err["code"] = 7
    with pytest.raises(RuntimeError):
        launch_a(0)
    assert counts == {"a": 2, "b": 0}
    err["code"] = 0
    Launcher(lib, "kernel", "uncounted")(0)
    assert counts == {"a": 2, "b": 0}


def test_launcher_raises_with_the_library_error_text():
    lib = StandIn("shipped", kernel=lambda *args: 7)
    with pytest.raises(RuntimeError, match=r"^my_kernel kernel launch failed: shipped "
                                           r"error 7 \(7\)$"):
        Launcher(lib, "kernel", "my_kernel")(0, 1, 2)


def test_using_redirects_every_launcher_and_restores_after_an_exception():
    calls, counts = [], {"f": 0, "g": 0}
    shipped = StandIn("shipped", f=_recorder(calls, "shipped f"),
                      g=_recorder(calls, "shipped g"))
    variant = StandIn("variant", f=_recorder(calls, "variant f"),
                      g=_recorder(calls, "variant g", err=5))
    launch_f = Launcher(shipped, "f", "f", counts, "f")
    launch_g = Launcher(shipped, "g", "g", counts, "g")
    launch_f(0)  # resolved on the shipped build before the block
    with pytest.raises(RuntimeError, match="g kernel launch failed: variant error 5"):
        with shipped.using(variant):
            launch_f(1)
            launch_g(2)
    launch_f(0)
    assert [tag for tag, _ in calls] == ["shipped f", "variant f", "variant g", "shipped f"]
    assert counts == {"f": 3, "g": 0}
    with shipped.using(variant):
        pass
    launch_g(4)
    assert calls[-1] == ("shipped g", (1004,))


def test_using_restores_the_shipped_build_when_the_variant_fails_to_load():
    calls = []
    shipped = StandIn("shipped", f=_recorder(calls, "shipped"))
    broken = StandIn("broken")

    def nvcc_fails():
        raise RuntimeError("nvcc failed")

    broken.load = nvcc_fails
    launch = Launcher(shipped, "f", "f")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        with shipped.using(broken):
            pass
    launch(0)
    assert calls == [("shipped", (1000,))]


def _writes(values):
    def last_launch(out):
        (ctypes.c_int * len(values)).from_address(out.value)[:] = values
    return last_launch


def test_record_maps_fields_to_ints_and_follows_using():
    shipped = StandIn("shipped", last=_writes([4, 2, 256]))
    variant = StandIn("variant", last=_writes([8, 1, 512]))
    fields = ("cluster", "blocks", "threads")
    got = shipped.record("last", fields)
    assert got == {"cluster": 4, "blocks": 2, "threads": 256}
    assert all(type(v) is int for v in got.values())
    with shipped.using(variant):
        assert shipped.record("last", fields) == {"cluster": 8, "blocks": 1, "threads": 512}
    assert shipped.record("last", fields)["cluster"] == 4


def test_ptr_is_the_data_pointer_or_null():
    t = torch.zeros(3)
    assert _build.ptr(t) == t.data_ptr()
    assert _build.ptr(None) is None


# (module's counters, its libraries): every key but "gnn_forward", which
# counts whole forwards, is counted by exactly the launchers that name it
COUNTERS = {"composite": (composite.LAUNCHES, [composite.LIBRARY]),
            "fps": (fps.LAUNCHES, [fps.LIBRARY]),
            "probes": (probes.LAUNCHES, [probes.LIBRARY]),
            "gnn_forward": (gnn_forward.LAUNCHES,
                            [gnn_forward.LIBRARY, gnn_forward.GEMM_LIBRARY, edges.LIBRARY])}


@pytest.mark.parametrize("module", sorted(COUNTERS))
def test_every_counted_kernel_is_counted_by_its_launcher(module):
    launches, libraries = COUNTERS[module]
    keys = [launcher.key for lib in libraries for launcher in lib.launchers
            if launcher.launches is launches]
    assert sorted(keys) == sorted(k for k in launches if k != "gnn_forward")
    for lib in libraries:
        for launcher in lib.launchers:
            assert launcher.name in lib.functions
            assert launcher.launches is None or launcher.launches is launches
