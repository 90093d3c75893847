"""Point-cloud file IO, the port of `sp_gan_tpu/viz/io.py`: .xyz, .ply
(ascii and binary little-endian, optional uchar colors) and ascii .pcd,
numpy only. `load_xyz` parses with `np.loadtxt`; the JAX package's C++
parser has no port yet.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np


def save_xyz(path: str, pc: np.ndarray, fmt: str = "%.6f"):
    np.savetxt(path, np.asarray(pc), fmt=fmt)


def load_xyz(path: str) -> np.ndarray:
    return np.loadtxt(path, ndmin=2).astype(np.float32)


def save_ply(path: str, points: np.ndarray,
             colors: Optional[np.ndarray] = None, binary: bool = True):
    """colors: optional [N,3] floats in [0,1] or uint8."""
    points = np.asarray(points, np.float32)
    n = len(points)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)

    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_color:
                rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                         ("rgb", np.uint8, 3)])
                rec["xyz"], rec["rgb"] = points, colors
                f.write(rec.tobytes())
            else:
                f.write(points.astype("<f4").tobytes())
        else:
            for i in range(n):
                row = " ".join(f"{v:.6f}" for v in points[i])
                if has_color:
                    row += " " + " ".join(str(int(v)) for v in colors[i])
                f.write((row + "\n").encode())


def load_ply(path: str) -> np.ndarray:
    """Minimal PLY vertex reader (ascii + binary_little_endian, float xyz
    leading properties)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(h.split()[-1]) for h in header
                 if h.startswith("element vertex"))
        props = [h.split()[1:] for h in header if h.startswith("property")]
        binary = any("binary_little_endian" in h for h in header)
        if binary:
            fmt_map = {"float": "f", "float32": "f", "double": "d",
                       "uchar": "B", "uint8": "B", "int": "i", "uint": "I"}
            rec_fmt = "<" + "".join(fmt_map[p[0]] for p in props)
            size = struct.calcsize(rec_fmt)
            data = f.read(n * size)
            rows = [struct.unpack_from(rec_fmt, data, i * size)[:3]
                    for i in range(n)]
            return np.asarray(rows, np.float32)
        rows = []
        for _ in range(n):
            vals = f.readline().split()
            rows.append([float(v) for v in vals[:3]])
        return np.asarray(rows, np.float32)


def load_pcd(path: str) -> np.ndarray:
    """ASCII .pcd reader (the subset `pc_util.read_pcd` handles)."""
    pts = []
    with open(path, "r") as f:
        in_data = False
        for line in f:
            if in_data:
                vals = line.split()
                if len(vals) >= 3:
                    pts.append([float(v) for v in vals[:3]])
            elif line.startswith("DATA"):
                if "ascii" not in line:
                    raise ValueError("only ascii .pcd supported")
                in_data = True
    return np.asarray(pts, np.float32)
