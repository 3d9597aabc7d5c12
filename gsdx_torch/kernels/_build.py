"""Lazy build of the port's CUDA kernel libraries.

Each source under `gsdx_torch/csrc/` is compiled by `nvcc` into its own
shared library with a plain C interface, at first use, into the gitignored
`build/torch_kernels/`, and loaded with ctypes. The library's file name
carries a digest of the source and the flags, so an edited source is built
anew. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PTR, I32, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


class CudaLibrary:
    """One `csrc/<source>` compiled into `lib<name>_<digest>.so`.

    ``functions`` maps each exported C function to its ctypes argument
    types; every one returns a cudaError_t code (0 when the launch was
    accepted). ``error_string`` names the exported function that turns such
    a code into text."""

    def __init__(self, name: str, source: str,
                 functions: dict[str, list], error_string: str):
        self.name = name
        self.source = CSRC / source
        self.functions = functions
        self.error_string = error_string
        self._lib = None

    def path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes()
                              + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}_{digest}.so"

    def build(self) -> str:
        """Run `nvcc` unless the library for this exact source is built.
        Returns the compiler's output (register and spill report), kept
        beside the library for a later call that finds it built. Raises if
        the compile failed."""
        out = self.path()
        log_path = out.with_suffix(".log")
        if out.exists():
            return log_path.read_text() if log_path.exists() else ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                             capture_output=True, text=True, check=False)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({res.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, out)
        return log

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library, once per process."""
        if self._lib is None:
            self.build()
            lib = ctypes.CDLL(str(self.path()))
            for fn, argtypes in self.functions.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = I32
            getattr(lib, self.error_string).argtypes = [I32]
            getattr(lib, self.error_string).restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error code."""
        if err != 0:
            msg = getattr(self.load(), self.error_string)(err).decode()
            raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


class Launcher:
    """One exported C function of a `CudaLibrary`, called with as little
    host work as ctypes allows: the function is resolved once, at the first
    call, and the stream argument is the raw handle of PyTorch's current
    stream on the device (`torch._C._cuda_getCurrentRawStream`), taken
    without building a `torch.cuda.Stream`. The caller checks the tensors
    and calls the instance with the device index, then the pointers and
    sizes; the handle goes last. Raises if the launch returned a CUDA error."""

    __slots__ = ("library", "name", "what", "fn", "stream")

    def __init__(self, library: CudaLibrary, name: str, what: str):
        self.library, self.name, self.what = library, name, what
        self.fn = self.stream = None

    def __call__(self, device_index: int, *args) -> None:
        if self.fn is None:  # the CPU build of torch has no raw-stream getter
            self.stream = torch._C._cuda_getCurrentRawStream
            self.fn = getattr(self.library.load(), self.name)
        err = self.fn(*args, self.stream(device_index))
        if err:
            self.library.check(err, self.what)
