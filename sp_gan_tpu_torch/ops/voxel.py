"""Voxel occupancy histograms for the JSD metric, the port of
`sp_gan_tpu/ops/voxel.py`.

A point of [-bound, bound)^3 falls into voxel floor((x + bound) * res /
(2 bound)) per axis, in the same f32 formula as the JAX package. The JAX
package sums f32 ones per voxel (`segment_sum`); here an integer
`bincount` counts them, exactly.
"""

from __future__ import annotations

import torch


def voxel_occupancy(clouds: torch.Tensor, res: int = 28,
                    bound: float = 0.5) -> torch.Tensor:
    """Points per voxel of clouds [S, N, 3] (or any [..., 3]): [res**3]
    int64. A point counts iff each coordinate lies in [-bound, bound)."""
    x = clouds.reshape(-1, 3).float()
    ids = torch.floor((x + bound) * (res / (2 * bound))).to(torch.int64)
    inside = ((x >= -bound) & (x < bound)).all(dim=-1)
    ids = ids.clamp(0, res - 1)
    flat = ids[:, 0] * res * res + ids[:, 1] * res + ids[:, 2]
    return torch.bincount(flat[inside], minlength=res ** 3)


def occupancy_distribution(clouds: torch.Tensor, res: int = 28,
                           bound: float = 0.5) -> torch.Tensor:
    """Normalized voxel occupancy distribution (sums to 1), float64."""
    counts = voxel_occupancy(clouds, res=res, bound=bound).double()
    return counts / max(float(counts.sum()), 1.0)
