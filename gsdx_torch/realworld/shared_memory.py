"""Lock-free shared-memory IPC: atomic counter, ndarray, ring buffer, queue
(the port's own copy of `gsdx/realworld/shared_memory.py`).

Re-implements the reference camera IPC stack
(`src/real_world/camera/shared_memory/*`) with the C `atomics` dependency
replaced by a C++ module of the port's own (`gsdx_torch/csrc/atomics.cpp`,
std::atomic with explicit orderings over the shared mapping), built by g++
at first use into the gitignored `build/host/`.

Concurrency contract (identical to the reference):
  * ring buffer (FILO): writers `put` at monotonically increasing counter
    positions; the last `get_max_k` slots are guaranteed untouched for
    `get_time_budget` seconds after writing, enforced by a timestamp check
    that raises TimeoutError on overrun (`shared_memory_ring_buffer.py:124-147`);
  * queue (FIFO): separate read/write counters, Full/Empty exceptions.

Host code only (numpy and ctypes): the camera processes run it, and they
must never touch torch or CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import numbers
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from multiprocessing.managers import SharedMemoryManager
from pathlib import Path
from queue import Empty, Full
from typing import Dict, List, Tuple, Union

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "atomics.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
_CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib = None


def _library_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes() + " ".join(_CXX_FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"libgsdx_torch_atomics_{digest}.so"


def _load_native():
    """Build (once, by any process: the library is written under a
    temporary name and renamed) and load the atomics library."""
    global _lib
    if _lib is not None:
        return _lib
    path = _library_path()
    if not path.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++) found: cannot build "
                               f"{_SRC.name} for the shared-memory counters")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                             capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {_SRC.name}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.gsdx_atomic_load_acquire.restype = ctypes.c_uint64
    lib.gsdx_atomic_load_acquire.argtypes = [ctypes.c_void_p]
    lib.gsdx_atomic_store_release.restype = None
    lib.gsdx_atomic_store_release.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.gsdx_atomic_fetch_add_acq_rel.restype = ctypes.c_uint64
    lib.gsdx_atomic_fetch_add_acq_rel.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    _lib = lib
    return lib


@dataclass
class ArraySpec:
    name: str
    shape: Tuple[int, ...]
    dtype: np.dtype


class SharedAtomicCounter:
    """64-bit atomic counter over a SharedMemory block
    (`shared_memory_util.py:14-39`)."""

    def __init__(self, shm_manager: SharedMemoryManager, size: int = 8):
        self.shm = shm_manager.SharedMemory(size=size)
        self.size = size
        _load_native()
        self.store(0)

    def _addr(self) -> int:
        return ctypes.addressof(
            (ctypes.c_uint64 * 1).from_buffer(self.shm.buf)
        )

    def load(self) -> int:
        return int(_load_native().gsdx_atomic_load_acquire(self._addr()))

    def store(self, value: int) -> None:
        _load_native().gsdx_atomic_store_release(self._addr(), value)

    def add(self, value: int) -> int:
        return int(
            _load_native().gsdx_atomic_fetch_add_acq_rel(self._addr(), value)
        )


class SharedNDArray:
    """Typed ndarray view over a SharedMemory block
    (`shared_ndarray.py:17-166`)."""

    def __init__(self, shm, shape, dtype):
        self.shm = shm
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)

    @classmethod
    def create_from_shape(cls, mem_mgr: SharedMemoryManager, shape, dtype):
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        shm = mem_mgr.SharedMemory(size=max(nbytes, 1))
        return cls(shm, shape, dtype)

    def get(self) -> np.ndarray:
        return np.ndarray(self.shape, dtype=self.dtype, buffer=self.shm.buf)


def _specs_from_examples(examples: Dict[str, Union[np.ndarray, numbers.Number]]):
    specs = []
    for key, value in examples.items():
        if isinstance(value, np.ndarray):
            assert value.dtype != np.dtype("O")
            specs.append(ArraySpec(key, value.shape, value.dtype))
        elif isinstance(value, numbers.Number):
            specs.append(ArraySpec(key, (), np.dtype(type(value))))
        else:
            raise TypeError(f"unsupported type {type(value)}")
    return specs


class SharedMemoryRingBuffer:
    """Lock-free FILO buffer of dict-of-arrays slots
    (`shared_memory_ring_buffer.py:12-221`)."""

    def __init__(self, shm_manager: SharedMemoryManager,
                 array_specs: List[ArraySpec], get_max_k: int,
                 get_time_budget: float, put_desired_frequency: float,
                 safety_margin: float = 1.5):
        self.counter = SharedAtomicCounter(shm_manager)
        buffer_size = int(np.ceil(
            put_desired_frequency * get_time_budget * safety_margin
        )) + get_max_k
        self.buffer_size = buffer_size
        self.array_specs = array_specs
        self.shared_arrays = {
            spec.name: SharedNDArray.create_from_shape(
                shm_manager, (buffer_size,) + tuple(spec.shape), spec.dtype
            )
            for spec in array_specs
        }
        self.timestamp_array = SharedNDArray.create_from_shape(
            shm_manager, (buffer_size,), np.float64
        )
        self.timestamp_array.get()[:] = -np.inf
        self.get_time_budget = get_time_budget
        self.get_max_k = get_max_k
        self.put_desired_frequency = put_desired_frequency
        self.ready_for_get = False

    @classmethod
    def create_from_examples(cls, shm_manager, examples, get_max_k: int = 32,
                             get_time_budget: float = 0.01,
                             put_desired_frequency: float = 60):
        return cls(shm_manager, _specs_from_examples(examples), get_max_k,
                   get_time_budget, put_desired_frequency)

    @property
    def count(self) -> int:
        return self.counter.load()

    def clear(self):
        self.counter.store(0)

    def put(self, data: Dict[str, Union[np.ndarray, numbers.Number]],
            wait: bool = True, serial_number: str = "unknown"):
        count = self.counter.load()
        next_idx = count % self.buffer_size
        # The next get_max_k slots must stay untouched for get_time_budget
        # after writing (`shared_memory_ring_buffer.py:125-146`).
        lookahead = (next_idx + self.get_max_k - 1) % self.buffer_size
        old_ts = self.timestamp_array.get()[lookahead]
        t = time.monotonic()
        if (t - old_ts) < self.get_time_budget:
            if wait:
                time.sleep(self.get_time_budget - (t - old_ts))
            elif self.ready_for_get:
                past = self.buffer_size - self.get_max_k
                raise TimeoutError(
                    f"[{serial_number}] put executed too fast: "
                    f"{past} items / {t - old_ts:.4f}s"
                )
        for key, value in data.items():
            arr = self.shared_arrays[key].get()
            arr[next_idx] = value
        self.timestamp_array.get()[next_idx] = time.monotonic()
        self.counter.add(1)

    def _allocate_empty(self, k=None):
        out = {}
        for spec in self.array_specs:
            shape = spec.shape if k is None else (k,) + tuple(spec.shape)
            out[spec.name] = np.empty(shape, dtype=spec.dtype)
        return out

    def get(self, out=None) -> Dict[str, np.ndarray]:
        if out is None:
            out = self._allocate_empty()
        start = time.monotonic()
        count = self.counter.load()
        curr = (count - 1) % self.buffer_size
        for key, value in self.shared_arrays.items():
            np.copyto(out[key], value.get()[curr])
        if time.monotonic() - start > self.get_time_budget:
            raise TimeoutError("get exceeded time budget")
        return out

    def get_last_k(self, k: int, out=None) -> Dict[str, np.ndarray]:
        assert k <= self.get_max_k
        if out is None:
            out = self._allocate_empty(k)
        start = time.monotonic()
        count = self.counter.load()
        assert k <= count
        curr = (count - 1) % self.buffer_size
        for key, value in self.shared_arrays.items():
            arr = value.get()
            target = out[key]
            end = curr + 1
            lo = max(0, end - k)
            t_end = k
            t_start = t_end - (end - lo)
            target[t_start:t_end] = arr[lo:end]
            remainder = k - (end - lo)
            if remainder > 0:  # wrap around
                target[:remainder] = arr[self.buffer_size - remainder:]
        if time.monotonic() - start > self.get_time_budget:
            raise TimeoutError("get_last_k exceeded time budget")
        return out

    def get_all(self) -> Dict[str, np.ndarray]:
        return self.get_last_k(min(self.count, self.get_max_k))


class SharedMemoryQueue:
    """Lock-free FIFO with read/write counters
    (`shared_memory_queue.py:10-187`)."""

    def __init__(self, shm_manager: SharedMemoryManager,
                 array_specs: List[ArraySpec], buffer_size: int):
        self.buffer_size = buffer_size
        self.array_specs = array_specs
        self.write_counter = SharedAtomicCounter(shm_manager)
        self.read_counter = SharedAtomicCounter(shm_manager)
        self.shared_arrays = {
            spec.name: SharedNDArray.create_from_shape(
                shm_manager, (buffer_size,) + tuple(spec.shape), spec.dtype
            )
            for spec in array_specs
        }

    @classmethod
    def create_from_examples(cls, shm_manager, examples, buffer_size: int = 128):
        return cls(shm_manager, _specs_from_examples(examples), buffer_size)

    def qsize(self) -> int:
        return self.write_counter.load() - self.read_counter.load()

    def empty(self) -> bool:
        return self.qsize() <= 0

    def clear(self):
        self.read_counter.store(self.write_counter.load())

    def put(self, data: Dict[str, Union[np.ndarray, numbers.Number]]):
        count = self.write_counter.load()
        if count - self.read_counter.load() >= self.buffer_size:
            raise Full()
        idx = count % self.buffer_size
        for key, value in data.items():
            self.shared_arrays[key].get()[idx] = value
        self.write_counter.add(1)

    def get(self) -> Dict[str, np.ndarray]:
        read = self.read_counter.load()
        if self.write_counter.load() == read:
            raise Empty()
        idx = read % self.buffer_size
        out = {
            spec.name: np.copy(self.shared_arrays[spec.name].get()[idx])
            for spec in self.array_specs
        }
        self.read_counter.add(1)
        return out

    def get_k(self, k: int) -> Dict[str, np.ndarray]:
        read = self.read_counter.load()
        avail = self.write_counter.load() - read
        if avail < k:
            raise Empty()
        out = {}
        idxs = [(read + i) % self.buffer_size for i in range(k)]
        for spec in self.array_specs:
            arr = self.shared_arrays[spec.name].get()
            out[spec.name] = np.stack([arr[i] for i in idxs])
        self.read_counter.add(k)
        return out

    def get_all(self) -> Dict[str, np.ndarray]:
        n = self.qsize()
        if n == 0:
            raise Empty()
        return self.get_k(n)
