"""Training data, a numpy copy of `sp_gan_tpu/data/h5.py`.

Layout as in the reference: `{data_root}/{n_points}/{choice}.h5` with the
dataset key `poisson_{n_points}`, unit-sphere normalization times `scale`,
and the multi-class concatenation of `--con`. The synthetic families stand
in where no ShapeNet file is present; their arrays are byte-equal to the
JAX package's.

`h5py` is imported inside `load_h5` only: on a machine without it,
`H5Dataset` raises `OSError`, which the trainer treats as missing data.
Batches are assembled by the trainer on the device (`train/trainer.py`),
so the JAX package's native host gather is not needed here.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from sp_gan_tpu_torch.data.sphere import fibonacci_sphere


def load_h5(path: str, num: int = 2048) -> np.ndarray:
    """Dataset `poisson_{num}` of an .h5 file as [M, num, 3] float32.
    Raises OSError when h5py is not installed."""
    try:
        import h5py
    except ImportError as e:
        raise OSError(f"cannot read {path}: h5py is not installed") from e
    with h5py.File(path, "r") as f:
        return np.asarray(f[f"poisson_{num}"][:], np.float32)


def _normalize_np(pc: np.ndarray) -> np.ndarray:
    """Batched unit-sphere normalization of [M, N, 3] clouds."""
    pc = np.asarray(pc, np.float32)
    centroid = pc.mean(axis=1, keepdims=True)
    pc = pc - centroid
    m = np.sqrt((pc ** 2).sum(axis=-1)).max(axis=1)
    return pc / (m[:, None, None] + 1e-12)


class _Dataset:
    """`.data` [M, N, 3] float32 and `.labels` (None unless
    multi-class)."""

    data: np.ndarray
    labels: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.data)


class H5Dataset(_Dataset):
    def __init__(self, data_root: str, choice: str, n_points: int = 2048,
                 scale: float = 1.0, cls: int = 2, con: bool = False):
        d = os.path.join(data_root, str(n_points))
        if con:
            cats = ["chair", "table", "bench"][:cls]
            pcs, labels = [], []
            for i, cat in enumerate(cats):
                pc = _normalize_np(load_h5(
                    os.path.join(d, cat + ".h5"), n_points))
                pcs.append(pc)
                labels.append(np.full((len(pc),), i, np.int32))
            self.data = np.concatenate(pcs, axis=0)
            self.labels = np.concatenate(labels, axis=0)
        elif choice in ("animal_all", "bottle"):
            cats = {"animal_all": ["animal-pose", "animal-deform"],
                    "bottle": ["bottle", "jar", "pot"]}[choice]
            self.data = np.concatenate(
                [_normalize_np(load_h5(os.path.join(d, c + ".h5"), n_points))
                 for c in cats], axis=0)
        else:
            self.data = load_h5(
                os.path.join(d, choice.lower() + ".h5"), n_points)
        self.data = (scale * _normalize_np(self.data)).astype(np.float32)


class SyntheticDataset(_Dataset):
    """Deterministic synthetic shapes for runs without ShapeNet:
    ellipsoidally scaled fibonacci spheres with a low-frequency radial
    modulation, normalized like real data."""

    def __init__(self, n_items: int = 24, n_points: int = 2048,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        base = fibonacci_sphere(n_points)                    # [N, 3]
        azim = np.arctan2(base[:, 2], base[:, 0])            # [N]
        items = []
        for _ in range(n_items):
            axes = rng.uniform(0.45, 1.0, size=(3,))
            freq = rng.integers(1, 4)
            phase = rng.uniform(0.0, 2.0 * np.pi)
            amp = rng.uniform(0.05, 0.2)
            radial = 1.0 + amp * np.sin(freq * azim + phase)
            items.append(base * axes[None, :] * radial[:, None])
        self.data = _normalize_np(np.stack(items).astype(np.float32))


class SyntheticMultiClassDataset(_Dataset):
    """The `--con` analog of SyntheticDataset: modulated ellipsoids (class
    0), tori (1) and superellipsoid boxes (2), with `.labels`."""

    def __init__(self, n_items: int = 24, n_points: int = 2048,
                 seed: int = 0, n_classes: int = 3):
        if not 1 <= n_classes <= 3:
            raise ValueError(f"n_classes must be 1..3, got {n_classes}")
        rng = np.random.default_rng(seed)
        base = fibonacci_sphere(n_points)                    # [N, 3]
        azim = np.arctan2(base[:, 2], base[:, 0])            # [N]
        golden = (1.0 + np.sqrt(5.0)) / 2.0
        i = np.arange(n_points)
        t_theta = 2.0 * np.pi * ((i * golden) % 1.0)         # minor angle
        t_phi = 2.0 * np.pi * i / n_points                   # major angle

        items, labels = [], []
        for j in range(n_items):
            c = j % n_classes
            axes = rng.uniform(0.45, 1.0, size=(3,))
            if c == 0:
                freq = rng.integers(1, 4)
                phase = rng.uniform(0.0, 2.0 * np.pi)
                amp = rng.uniform(0.05, 0.2)
                radial = 1.0 + amp * np.sin(freq * azim + phase)
                pc = base * axes[None, :] * radial[:, None]
            elif c == 1:
                r = float(rng.uniform(0.25, 0.45))           # r / R, R = 1
                ring = 1.0 + r * np.cos(t_theta)
                pc = np.stack([ring * np.cos(t_phi),
                               r * np.sin(t_theta),
                               ring * np.sin(t_phi)], axis=1) * axes[None, :]
            else:
                e = rng.uniform(0.25, 0.5)                   # boxiness
                pc = np.sign(base) * np.abs(base) ** e * axes[None, :]
            items.append(pc)
            labels.append(c)
        self.data = _normalize_np(np.stack(items).astype(np.float32))
        self.labels = np.asarray(labels, np.int32)
