"""Frame and image IO (counterpart of `gsdx/io/video.py`).

gsdx encodes mp4 or GIF through imageio and reads images through PIL. The
port writes each frame as a PNG with its own encoder and reads PNGs with
its own decoder (`zlib` and `struct` of the standard library), so it needs
no imaging package. Both handle 8-bit gray, RGB and RGBA and 16-bit gray
(big-endian samples: how RealSense depth in millimetres is stored) without
interlacing; the encoder writes one filter-0 scanline a row, the decoder
undoes all five scanline filters.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (8-bit samples)
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _to_uint8(im) -> np.ndarray:
    im = np.asarray(im)
    if im.dtype != np.uint8:
        im = (np.clip(im, 0, 1) * 255).astype(np.uint8)
    return im


def encode_png(im) -> bytes:
    """PNG bytes of an (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA image,
    float in [0, 1] or uint8; an (H, W) uint16 image is written as 16-bit
    gray."""
    im = np.asarray(im)
    depth = 16 if im.dtype == np.uint16 and im.ndim == 2 else 8
    if depth == 8:
        im = _to_uint8(im)
    channels = 1 if im.ndim == 2 else (im.shape[2] if im.ndim == 3 else 0)
    if channels not in _COLOR_TYPE:
        raise ValueError(f"expected an (H, W), (H, W, 3) or (H, W, 4) image, "
                         f"got {im.shape}")
    h, w = im.shape[:2]
    samples = im.astype(">u2") if depth == 16 else im  # big-endian samples

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(samples).view(np.uint8).reshape(h, -1)], 1)
    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[channels],
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(np.ascontiguousarray(rows).tobytes(), 6))
            + chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters (0 none, 1 sub, 2 up, 3 average, 4
    Paeth): ``raw`` holds h rows of a filter byte and ``stride`` bytes."""
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        pos = y * (stride + 1)
        kind = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        if kind == 0:
            rec = line.copy()
        elif kind == 1:  # sub: a running sum per channel, mod 256
            rec = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # up
            rec = line + prior
        elif kind in (3, 4):  # average, Paeth: each byte needs its left one
            cur, up = bytearray(line.tobytes()), prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            rec = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind} in row {y}")
        out[y] = rec
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """uint8 (H, W), (H, W, 3) or (H, W, 4) pixels of an 8-bit gray, RGB
    or RGBA PNG, or uint16 (H, W) pixels of a 16-bit gray PNG, without
    interlacing; any other PNG raises ValueError."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG has no IHDR or no IDAT chunk")
    w, h, depth, color_type, _, _, interlace = header
    gray16 = depth == 16 and color_type == 0
    if (depth != 8 and not gray16) or color_type not in _CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {color_type}, "
            f"interlace {interlace}): only 8-bit gray (0), RGB (2) and RGBA (6) "
            "and 16-bit gray without interlacing are read")
    raw = zlib.decompress(b"".join(idat))
    if gray16:  # two bytes a sample, big-endian
        return _unfilter(raw, h, 2 * w, 2).view(">u2").astype(np.uint16)
    channels = _CHANNELS[color_type]
    pix = _unfilter(raw, h, w * channels, channels)
    return pix.reshape(h, w) if channels == 1 else pix.reshape(h, w, channels)


def read_png(path: str) -> np.ndarray:
    """Pixels of the PNG at ``path`` (see `decode_png`)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def write_image(path: str, im) -> None:
    """Write an (H, W), (H, W, 3) or (H, W, 4) image as a PNG at ``path``."""
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
