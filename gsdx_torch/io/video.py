"""Frame writing (counterpart of `gsdx/io/video.py`).

gsdx encodes mp4 or GIF through imageio. The port writes each frame as a
PNG with its own encoder (`zlib` and `struct` of the standard library):
8-bit RGB, one filter-0 scanline a row, so it needs no imaging package.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _to_uint8(im) -> np.ndarray:
    im = np.asarray(im)
    if im.dtype != np.uint8:
        im = (np.clip(im, 0, 1) * 255).astype(np.uint8)
    return im


def encode_png(im) -> bytes:
    """PNG bytes of an (H, W, 3) image, float in [0, 1] or uint8."""
    im = _to_uint8(im)
    if im.ndim != 3 or im.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {im.shape}")
    h, w, _ = im.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), im.reshape(h, w * 3)], 1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(np.ascontiguousarray(rows).tobytes(), 6))
            + chunk(b"IEND", b""))


def write_image(path: str, im) -> None:
    """Write an (H, W, 3) image as a PNG at ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(im))


def write_video(directory: str, frames) -> str:
    """Write ``frames`` ((H, W, 3) each) as ``directory``/frame_{t:04d}.png;
    returns ``directory``."""
    for t, frame in enumerate(frames):
        write_image(os.path.join(directory, f"frame_{t:04d}.png"), frame)
    return directory


def chw_to_hwc(im) -> np.ndarray:
    return np.asarray(im).transpose(1, 2, 0)
