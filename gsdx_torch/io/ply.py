"""Minimal PLY point-cloud IO (counterpart of `gsdx/io/ply.py`; replaces
Open3D's reader for demo assets).

Supports ascii and binary_little_endian PLY with x/y/z (+ red/green/blue)
vertex properties — the format of the reference demo asset
(`assets/demo/pcd.ply`, loaded at `src/demo.py:125`).
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def load_ply(path: str):
    """Returns (points (N,3) f32, colors (N,3) f32 in [0,1] or None)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n_vertex = 0
        props = []
        in_vertex = False
        for l in header:
            if l.startswith("element"):
                parts = l.split()
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif l.startswith("property") and in_vertex:
                parts = l.split()
                if parts[1] == "list":
                    raise ValueError("list properties unsupported in vertex")
                props.append((parts[2], _DTYPES[parts[1]]))

        if fmt == "ascii":
            rows = []
            for _ in range(n_vertex):
                rows.append(f.readline().decode("ascii").split()[: len(props)])
            data = np.array(rows, dtype=np.float64)
            rec = {name: data[:, i] for i, (name, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(name, "<" + d) for name, d in props])
            raw = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype,
                                count=n_vertex)
            rec = {name: raw[name].astype(np.float64) for name, _ in props}
        else:
            raise ValueError(f"unsupported ply format {fmt}")

    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
    colors = None
    if all(c in rec for c in ("red", "green", "blue")):
        colors = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1)
        if colors.max() > 1.5:
            colors = colors / 255.0
        colors = colors.astype(np.float32)
    return pts, colors


def save_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    """Binary little-endian PLY writer."""
    n = len(points)
    props = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.zeros(n, dtype=np.dtype(props))
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        c = np.clip(colors * 255, 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], c[:, 2]
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
