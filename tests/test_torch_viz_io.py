"""The port's small IO and host utilities against gsdx's on the CPU: PLY
both ways, the .splat export byte for byte, the PNG decoder against PIL
(files PIL writes, each of the five scanline filters, the port's own
writer, refusals), the overlay drawings pixel for pixel, seeding and the
profiling hooks."""

import os
import random
import struct
import sys
import time
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from gsdx.io.episodes import save_to_splat as j_save_to_splat
from gsdx.io.ply import load_ply as j_load_ply
from gsdx.io.ply import save_ply as j_save_ply
from gsdx.utils import viz as jviz
from gsdx.utils.seeding import set_seed as j_set_seed
from gsdx_torch.io.episodes import save_to_splat
from gsdx_torch.io.ply import load_ply, save_ply
from gsdx_torch.io.video import decode_png, encode_png, read_png, write_image
from gsdx_torch.utils import viz as tviz
from gsdx_torch.utils.profiling import Timer, trace_to
from gsdx_torch.utils.seeding import set_seed

# ---------------------------------------------------------------- PLY, splat


@pytest.mark.parametrize("colors", [True, False])
def test_ply_round_trip_both_ways(tmp_path, rng, colors):
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.uniform(size=(50, 3)).astype(np.float32) if colors else None
    save_ply(str(tmp_path / "t.ply"), pts, cols)
    j_save_ply(str(tmp_path / "j.ply"), pts, cols)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for load in (load_ply, j_load_ply):  # each package reads the other's file
        for name in ("t.ply", "j.ply"):
            p, c = load(str(tmp_path / name))
            np.testing.assert_array_equal(p, pts)
            if colors:
                np.testing.assert_allclose(c, cols, atol=1 / 255)
            else:
                assert c is None


def test_ascii_ply_reads_as_in_gsdx(tmp_path, rng):
    pts = rng.normal(size=(7, 3))
    lines = ["ply", "format ascii 1.0", "element vertex 7", "property double x",
             "property double y", "property double z", "property uchar red",
             "property uchar green", "property uchar blue", "end_header"]
    lines += [f"{x} {y} {z} {r} 0 255" for (x, y, z), r in zip(pts, range(0, 70, 10))]
    path = str(tmp_path / "a.ply")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    (p_t, c_t), (p_j, c_j) = load_ply(path), j_load_ply(path)
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(c_t, c_j)


def test_save_to_splat_is_byte_equal(tmp_path, rng):
    n = 257
    args = (rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(size=(n, 3)).astype(np.float32),
            np.exp(rng.normal(-4, 1, size=(n, 3))).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32),
            rng.uniform(size=(n, 1)).astype(np.float32))
    save_to_splat(*args, str(tmp_path / "t.splat"))
    j_save_to_splat(*args, str(tmp_path / "j.splat"))
    data = (tmp_path / "t.splat").read_bytes()
    assert len(data) == 32 * n
    assert data == (tmp_path / "j.splat").read_bytes()


# ---------------------------------------------------------------- PNG


def _image(rng, shape):
    """Smooth gradients with noise: PIL's encoder picks several filters."""
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = (3 * xx + 5 * yy) % 256
    im = base[..., None] + np.arange(shape[2] if len(shape) == 3 else 1) * 40
    im = im + rng.integers(0, 3, size=im.shape)
    im = (im % 256).astype(np.uint8)
    return im[..., 0] if len(shape) == 2 else im


def _filters(path) -> set:
    """The scanline filter types a PNG file uses."""
    data = open(path, "rb").read()
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, _, ct, *_ = hdr
    stride = w * {0: 1, 2: 3, 6: 4}[ct] + 1
    raw = zlib.decompress(idat)
    return {raw[y * stride] for y in range(h)}


def _encode_filtered(im: np.ndarray, kind: int) -> bytes:
    """A PNG of ``im`` whose every row uses filter ``kind`` (the spec's
    definitions, byte by byte)."""
    h, w = im.shape[:2]
    bpp = 1 if im.ndim == 2 else im.shape[2]
    rows = im.reshape(h, w * bpp).astype(int)
    out = bytearray()
    for y in range(h):
        out.append(kind)
        for i in range(w * bpp):
            x = rows[y, i]
            a = rows[y, i - bpp] if i >= bpp else 0
            b = rows[y - 1, i] if y else 0
            c = rows[y - 1, i - bpp] if y and i >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out.append((x - pred) % 256)

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))

    ct = {1: 0, 3: 2, 4: 6}[bpp]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ct, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode,shape", [("L", (23, 37)), ("RGB", (23, 37, 3)),
                                        ("RGBA", (23, 37, 4))])
def test_read_png_equals_pil_on_files_pil_writes(tmp_path, rng, mode, shape):
    im = _image(rng, shape)
    path = str(tmp_path / "pil.png")
    Image.fromarray(im, mode).save(path)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    assert len(_filters(path)) > 1  # PIL's adaptive filtering mixed them


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 3), (9, 13, 4)])
def test_read_png_undoes_every_filter_as_pil(tmp_path, rng, kind, shape):
    im = rng.integers(0, 256, size=shape, dtype=np.uint8)
    path = tmp_path / f"f{kind}.png"
    path.write_bytes(_encode_filtered(im, kind))
    assert _filters(path) == {kind}
    np.testing.assert_array_equal(np.asarray(Image.open(path)), im)  # PIL agrees
    np.testing.assert_array_equal(read_png(str(path)), im)


def test_png_writer_round_trips(tmp_path, rng):
    for shape in ((5, 7), (5, 7, 3), (5, 7, 4)):
        im = rng.integers(0, 256, size=shape, dtype=np.uint8)
        write_image(str(tmp_path / "w.png"), im)
        np.testing.assert_array_equal(read_png(str(tmp_path / "w.png")), im)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png")), im)
    f = rng.uniform(-0.2, 1.2, size=(4, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(decode_png(encode_png(f)),
                                  (np.clip(f, 0, 1) * 255).astype(np.uint8))


@pytest.mark.parametrize("mode", ["P", "LA", "1"])
def test_read_png_refuses_other_formats(tmp_path, rng, mode):
    im = Image.fromarray(rng.integers(0, 200, size=(6, 8), dtype=np.uint8), "L")
    im.convert(mode).save(tmp_path / "x.png")
    with pytest.raises(ValueError, match="unsupported PNG"):
        read_png(str(tmp_path / "x.png"))
    # 16 bits a sample are read for gray only: a 16-bit RGB header is refused
    data = bytearray(encode_png(rng.integers(0, 256, size=(4, 4, 3), dtype=np.uint8)))
    data[24] = 16  # IHDR bit depth
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png(bytes(data))


def test_16_bit_gray_png_round_trips_with_pil(tmp_path, rng):
    """RealSense depth (uint16 millimetres), as gsdx's masks app reads it
    with PIL: the port's writer and reader against PIL's, both ways."""
    depth = rng.integers(0, 65536, size=(23, 37), dtype=np.uint16)
    depth[0, :4] = [0, 1, 255, 65535]  # both bytes of a sample matter
    write_image(str(tmp_path / "port.png"), depth)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "port.png")).astype(np.int64),
                          depth.astype(np.int64))
    Image.fromarray(depth).save(tmp_path / "pil.png")
    got = read_png(str(tmp_path / "pil.png"))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, depth)
    np.testing.assert_array_equal(read_png(str(tmp_path / "port.png")), depth)


def test_read_png_refuses_damage(tmp_path, rng):
    data = bytearray(encode_png(rng.integers(0, 256, size=(4, 4, 3), dtype=np.uint8)))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + bytes(data[6:]))
    data[40] ^= 0xFF  # inside IDAT
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))


# ---------------------------------------------------------------- overlays


def test_drawings_equal_gsdx(rng):
    img = (rng.uniform(size=(96, 128, 3)) * 255).astype(np.uint8)
    pts = np.array([[30, 40], [60, 20], [127, 95]])
    for fn, args in (
            ("draw_points_on_image", (img, pts)),
            ("draw_arrow_on_image", (img, (10, 10), (100, 80))),
            ("draw_mask_on_image", (img, rng.uniform(size=(96, 128)))),
            ("visualize_push", (img, np.array([[50, 50]]), (10, 10), (90, 90),
                                np.array([[100, 60]])))):
        out = getattr(tviz, fn)(*args)
        assert not np.array_equal(out, img)
        np.testing.assert_array_equal(out, getattr(jviz, fn)(*args), err_msg=fn)
    tv_t, tv_j = tviz.TrailVisualizer(history=5), jviz.TrailVisualizer(history=5)
    a = b = img
    for t in range(8):
        kp = np.array([[10 + 5 * t, 20 + 3 * t]]) if t != 4 else np.array([[np.inf, np.nan]])
        a, b = tv_t.draw(a, kp), tv_j.draw(b, kp)
        np.testing.assert_array_equal(a, b)
    rgba = rng.integers(0, 256, size=(5, 6, 4), dtype=np.uint8)
    np.testing.assert_array_equal(tviz.rgba_to_rgb(rgba), jviz.rgba_to_rgb(rgba))
    np.testing.assert_array_equal(tviz.rgb_colormap(3), jviz.rgb_colormap(3))
    intr = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    extr = np.eye(4)
    extr[2, 3] = 1.0
    xyz = rng.normal(size=(20, 3))
    np.testing.assert_array_equal(tviz.project_points(xyz, intr, extr),
                                  jviz.project_points(xyz, intr, extr))


def test_overlays_name_a_missing_package(monkeypatch):
    tviz.require_drawing_packages()  # both are here
    monkeypatch.setitem(sys.modules, "cv2", None)  # an import of cv2 now fails
    with pytest.raises(ImportError, match="'cv2'"):
        tviz.require_drawing_packages()


# ---------------------------------------------------------------- host utils


def test_set_seed_seeds_as_gsdx_and_returns_a_generator():
    g = set_seed(7)
    a = (random.random(), np.random.rand())
    j_set_seed(7)
    assert a == (random.random(), np.random.rand())
    assert isinstance(g, torch.Generator) and g.initial_seed() == 7


def test_timer_and_trace(tmp_path):
    t = Timer()
    for _ in range(2):
        with t("a"):
            time.sleep(0.01)
    assert t.counts["a"] == 2 and t.totals["a"] >= 0.02 and "a" in t.summary()
    with trace_to(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
