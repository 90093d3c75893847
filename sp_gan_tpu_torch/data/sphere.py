"""Sphere templates, a numpy copy of `sp_gan_tpu/data/sphere.py`.

A deterministic fibonacci lattice stands in for the reference's pre-sampled
`template/balls/{N}.xyz`; `sphere_template(path=...)` loads such a file.
The arrays are byte-equal to the JAX package's, and so are the distances
of `sphere_sqdist`.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np


@functools.lru_cache(maxsize=8)
def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    golden = (1.0 + np.sqrt(5.0)) / 2.0
    theta = 2.0 * np.pi * i / golden
    y = 1.0 - (2.0 * i + 1.0) / n
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    pts = np.stack([r * np.cos(theta), y, r * np.sin(theta)], axis=1)
    pts = pts.astype(np.float32)
    pts.flags.writeable = False     # the cached array is shared
    return pts


def fibonacci_sphere(n: int) -> np.ndarray:
    """Near-uniform lattice of n points on the unit sphere, [n, 3] float32,
    y as the polar axis."""
    return _fibonacci_sphere(n).copy()


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center one [N, 3] cloud on its centroid, furthest point at radius 1."""
    pc = np.asarray(pc, np.float32)
    pc = pc - pc.mean(axis=0, keepdims=True)
    m = np.sqrt((pc ** 2).sum(axis=1)).max()
    return pc / m


def sphere_template(n: int, path: Optional[str] = None) -> np.ndarray:
    """[n, 3] float32 normalized template: the first 3 columns of the first
    n rows of an `.xyz` file when `path` is given (read by the native
    parser, as the JAX package reads it; a malformed file raises), else
    the fibonacci lattice."""
    if path is not None:
        from sp_gan_tpu_torch.viz.io import load_xyz
        ball = load_xyz(path)
        if ball.ndim != 2 or ball.shape[1] < 3:
            raise ValueError(f"template {path} has fewer than 3 columns")
        ball = ball[:, :3]
        if ball.shape[0] < n:
            raise ValueError(
                f"template {path} has {ball.shape[0]} points < requested {n}")
        return pc_normalize(ball[:n])
    return pc_normalize(_fibonacci_sphere(n))


def sphere_sqdist(ball: np.ndarray) -> np.ndarray:
    """[N, N] squared pairwise distances of a template,
    `|a|^2 - 2 a.b + |b|^2` clamped at 0 (the reference precomputes this
    matrix for its region sampler; `manipulate.region_mask` reads a row)."""
    ball = np.asarray(ball, np.float32)
    sq = (ball ** 2).sum(axis=1)
    d = sq[:, None] - 2.0 * ball @ ball.T + sq[None, :]
    return np.maximum(d, 0.0)
