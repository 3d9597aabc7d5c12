"""Checkpoints in flax's msgpack format (counterpart of
`gsdx/io/checkpoint.py`), read and written by the port's own code.

flax writes a state dict (nested maps with string keys) as msgpack, with
every ndarray as extension type 1, whose payload is itself msgpack of
(shape, dtype name, raw C-order bytes) (`flax.serialization
._ndarray_to_bytes`); a numpy scalar is extension type 3 with the same
payload. This module decodes every msgpack type and those two extensions,
and encodes the subset it needs, so `flax.serialization.msgpack_restore`
reads what `save_checkpoint` writes. Trees come back as nested dicts of
numpy arrays.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# --------------------------------------------------------------------------
# decoding
# --------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", self._bin), 0xC5: (">H", self._bin),
                 0xC6: (">I", self._bin), 0xD9: (">B", self._str),
                 0xDA: (">H", self._str), 0xDB: (">I", self._str),
                 0xDC: (">H", self._array), 0xDD: (">I", self._array),
                 0xDE: (">H", self._map), 0xDF: (">I", self._map)}
        if b in sized:
            fmt, fn = sized[b]
            return fn(self.unpack(fmt))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            return self._ext(self.unpack(ext[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _bin(self, n):
        return bytes(self.take(n))

    def _str(self, n):
        return bytes(self.take(n)).decode("utf-8")

    def _array(self, n):
        return [self.read() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray_from_bytes(payload)
            return arr if code == _EXT_NDARRAY else arr[()]
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(payload).read()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported by this reader")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def msgpack_restore(data: bytes):
    """Decode flax msgpack bytes into nested dicts / lists of numpy arrays
    and Python scalars."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


# --------------------------------------------------------------------------
# encoding
# --------------------------------------------------------------------------


def _head(n: int, fix: int, fix_max: int, codes: tuple) -> bytes:
    if n <= fix_max and fix is not None:
        return bytes([fix | n])
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object too large ({n})")


def _pack_int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    for code, fmt, lo, hi in ((0xCC, ">B", 0, 1 << 8), (0xCD, ">H", 0, 1 << 16),
                              (0xCE, ">I", 0, 1 << 32), (0xCF, ">Q", 0, 1 << 64),
                              (0xD0, ">b", -(1 << 7), 1 << 7),
                              (0xD1, ">h", -(1 << 15), 1 << 15),
                              (0xD2, ">i", -(1 << 31), 1 << 31),
                              (0xD3, ">q", -(1 << 63), 1 << 63)):
        if lo <= v < hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        head = bytes([fixext[n]])
    else:
        head = _head(n, None, -1, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + payload


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return _pack([list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes("C")])


def _pack(x) -> bytes:
    if x is None:
        return b"\xc0"
    if x is True:
        return b"\xc3"
    if x is False:
        return b"\xc2"
    if isinstance(x, np.ndarray):
        return _pack_ext(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    if isinstance(x, int):
        return _pack_int(x)
    if isinstance(x, float):
        return b"\xcb" + struct.pack(">d", x)
    if isinstance(x, str):
        raw = x.encode("utf-8")
        return _head(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(x, (bytes, bytearray)):
        return _head(len(x), None, -1, (0xC4, 0xC5, 0xC6)) + bytes(x)
    if isinstance(x, (list, tuple)):
        return _head(len(x), 0x90, 15, (None, 0xDC, 0xDD)) + b"".join(_pack(v) for v in x)
    if isinstance(x, dict):
        return _head(len(x), 0x80, 15, (None, 0xDE, 0xDF)) + b"".join(
            _pack(k) + _pack(v) for k, v in x.items())
    raise TypeError(f"cannot serialize {type(x).__name__}")


def _state_dict(tree):
    """Nested dicts with tensor leaves as numpy."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):  # a torch.Tensor
        return tree.detach().cpu().numpy()
    return tree


def msgpack_serialize(tree) -> bytes:
    return _pack(_state_dict(tree))


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def save_checkpoint(path: str, tree) -> None:
    """Write ``tree`` (nested dicts of arrays, tensors or scalars) to
    ``path`` atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = msgpack_serialize(tree)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _lift_dense0(state, tgt):
    """Migrate pre-r3 GNN checkpoints: the propagators used to hold their
    parameters in a `Dense_0` submodule ({'Dense_0': {kernel, bias}}); they
    are now top-level ({kernel, bias}). Lift each such subtree wherever the
    target expects flat kernel/bias."""
    if not isinstance(state, dict):
        return state
    if ("Dense_0" in state and isinstance(tgt, dict)
            and "Dense_0" not in tgt and "kernel" in tgt):
        inner = state["Dense_0"]
        state = {**{k: v for k, v in state.items() if k != "Dense_0"}, **inner}
    return {k: _lift_dense0(v, tgt.get(k) if isinstance(tgt, dict) else None)
            for k, v in state.items()}


def _check_structure(state, target, where="") -> None:
    if isinstance(target, dict):
        if not isinstance(state, dict) or set(state) != set(target):
            raise ValueError(f"checkpoint structure differs from the target at "
                             f"'{where or '/'}': {sorted(state) if isinstance(state, dict) else type(state).__name__}"
                             f" vs {sorted(target)}")
        for k in target:
            _check_structure(state[k], target[k], f"{where}/{k}")
    elif hasattr(target, "shape") and np.shape(state) != tuple(target.shape):
        raise ValueError(f"checkpoint leaf {where} has shape {np.shape(state)}, "
                         f"the target {tuple(target.shape)}")


def load_checkpoint(path: str, target=None):
    """Read a checkpoint into nested dicts of numpy arrays. With ``target``
    (a tree of the expected structure: dicts with array or tensor leaves)
    pre-r3 propagator subtrees are migrated (`_lift_dense0`), and a
    checkpoint whose keys or shapes differ from the target raises."""
    with open(path, "rb") as f:
        state = msgpack_restore(f.read())
    if target is not None:
        tgt = _state_dict(target)
        state = _lift_dense0(state, tgt)
        _check_structure(state, tgt)
    return state


def load_trained_model(config: str, epoch: str, device):
    """(train_cfg, data_cfg, model): the configs of the YAML ``config`` and
    its trained `DynamicsPredictor` from
    `<train_config.out_dir>/checkpoints/{latest,model_<epoch>}.ckpt`
    (relative to the working directory), on ``device`` in eval mode."""
    from gsdx_torch.dynamics.model import DynamicsPredictor, flax_params, load_flax_params
    from gsdx_torch.io.config import load_config

    train_cfg, model_cfg, data_cfg = load_config(config)
    model = DynamicsPredictor(model_cfg)
    name = "latest.ckpt" if epoch == "latest" else f"model_{epoch}.ckpt"
    tree = load_checkpoint(os.path.join(train_cfg.out_dir, "checkpoints", name),
                           target=flax_params(model))
    return train_cfg, data_cfg, load_flax_params(model, tree).to(device).eval()


# --------------------------------------------------------------------------
# optimizer state
# --------------------------------------------------------------------------


def adam_state_tree(model, optimizer: "torch.optim.Adam") -> dict:
    """The Adam state of ``model``'s weights in optax's layout, as gsdx's
    trainer writes `latest_optim.ckpt`: {"0": {"count": int32 scalar, "mu":
    <flax param tree>, "nu": <flax param tree>}, "1": {}} (optax's adam is a
    chain of scale_by_adam and a learning-rate scale with no state). The
    moments map to the flax tree as the weights do: torch's exp_avg is mu,
    exp_avg_sq is nu, and the step count is optax's count."""
    import torch

    from gsdx_torch.dynamics.model import flax_tree

    mu, nu, count = {}, {}, 0
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
        count = int(st["step"]) if "step" in st else count
    return {"0": {"count": np.asarray(count, np.int32), "mu": flax_tree(mu),
                  "nu": flax_tree(nu)}, "1": {}}


def load_adam_state(model, optimizer: "torch.optim.Adam", tree: dict) -> None:
    """Set ``optimizer``'s state for ``model``'s weights from an optax-layout
    tree (`adam_state_tree`; what `load_checkpoint` reads from a
    `latest_optim.ckpt` of either package)."""
    import torch

    from gsdx_torch.dynamics.model import params_from_flax

    state = tree["0"]
    mu, nu = params_from_flax(state["mu"]), params_from_flax(state["nu"])
    step = float(np.asarray(state["count"]))
    for name, p in model.named_parameters():
        optimizer.state[p] = {"step": torch.tensor(step),
                              "exp_avg": mu[name].to(p.device).clone(),
                              "exp_avg_sq": nu[name].to(p.device).clone()}
