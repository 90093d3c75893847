"""Latent-code sampling, the port of `sp_gan_tpu/data/noise.py::sample_z`
(and of `Manipulator.sample_codes`, `sp_gan_tpu/manipulate.py:119-131`).

Randomness comes from an explicit `torch.Generator`. It draws other numbers
than `jax.random` from the same seed, so parity tests hand both packages
the same z instead of the same seed. The training-time region mixing
(`n_mix`) and `masked_z` come with the slices that use them.
"""

from __future__ import annotations

import torch


def sample_z(generator: torch.Generator, bs: int, n_points: int, nz: int,
             sigma: float = 0.2, n_rand: bool = False) -> torch.Tensor:
    """[bs, n_points, nz] codes, `sigma * N(0, 1)`, on `generator.device`:
    one code per shape tiled over the points (an expanded view), or with
    `n_rand` an independent code per point."""
    g = dict(generator=generator, device=generator.device)
    if n_rand:
        return sigma * torch.randn(bs, n_points, nz, **g)
    return (sigma * torch.randn(bs, 1, nz, **g)).expand(bs, n_points, nz)
