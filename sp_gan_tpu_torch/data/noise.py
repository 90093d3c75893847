"""Latent-code sampling, the port of `sp_gan_tpu/data/noise.py` (and of
`Manipulator.sample_codes`, `sp_gan_tpu/manipulate.py:119-131`).

Randomness comes from an explicit `torch.Generator`. It draws other numbers
than `jax.random` from the same seed, so parity tests hand both packages
the same z instead of the same seed. For the same reason the region mixing
of `--n_mix` is split in two: `sample_z` draws its values (a gate, a second
code, an anchor and a size per shape) and `mix_codes`, a pure function of
those values, mixes; a parity test rebuilds the JAX draws from their key
and hands them to `mix_codes`.
"""

from __future__ import annotations

from typing import Optional

import torch


def mix_codes(z: torch.Tensor, z2: torch.Tensor, gate, anchor: torch.Tensor,
              u: torch.Tensor, sphere: torch.Tensor) -> torch.Tensor:
    """Region-mixed codes: where `gate` (one bool for the whole call) is
    set, each shape b takes `z2[b]` at its `num_b = int32(max(u_b, 0.1) *
    N)` template points nearest to point `anchor[b]`, and `z` elsewhere.

    z [B, N, nz]; z2 [B, 1, nz]; anchor [B] ints; u [B] f32 in [0, 1);
    sphere [N, 3]; gate a bool or a 0-dim bool tensor. The distance row
    is `sum((anchor - sphere)^2)` over the 3 channels, the form the JAX
    step computes (it passes no precomputed matrix), and points are ranked
    by a stable sort, so a tie at rank `num_b` falls as it does in
    `jnp.argsort`."""
    B, N, _ = z.shape
    sphere = sphere.to(z.device, torch.float32)
    anchors = sphere[anchor.to(z.device).long()]                  # [B, 3]
    d = ((anchors[:, None, :] - sphere[None]) ** 2).sum(-1)       # [B, N]
    # clamp takes 0.1 as f32, as jnp.maximum does; no host-to-device copy
    num = (u.to(z.device, torch.float32).clamp(min=0.1) * N).to(torch.int32)
    order = torch.argsort(d, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1)
    mask = (ranks < num[:, None]) & gate
    return torch.where(mask[..., None], z2.to(z.dtype), z)


def sample_z(generator: torch.Generator, bs: int, n_points: int, nz: int,
             sigma: float = 0.2, n_rand: bool = False, n_mix: bool = False,
             sphere: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[bs, n_points, nz] codes, `sigma * N(0, 1)`, on `generator.device`:
    one code per shape tiled over the points (an expanded view), or with
    `n_rand` an independent code per point. With `n_mix` and the template
    `sphere` [n_points, 3], the codes are then region-mixed (`mix_codes`):
    a gate of p = 0.5 for the call, a second code, an anchor point and a
    uniform size per shape, drawn in that order."""
    g = dict(generator=generator, device=generator.device)
    if n_rand:
        z = sigma * torch.randn(bs, n_points, nz, **g)
    else:
        z = (sigma * torch.randn(bs, 1, nz, **g)).expand(bs, n_points, nz)
    if n_mix and sphere is not None:
        gate = torch.rand((), **g) < 0.5
        z2 = sigma * torch.randn(bs, 1, nz, **g)
        anchor = torch.randint(0, n_points, (bs,), **g)
        u = torch.rand(bs, **g)
        z = mix_codes(z, z2, gate, anchor, u, sphere)
    return z


def masked_z(generator: torch.Generator, masks, nz: int,
             sigma: float = 0.2) -> torch.Tensor:
    """[B, N, nz] codes with one code per region: `masks` [B, N] holds
    small non-negative labels, and every point of a label (within a shape)
    gets the same `sigma * N(0, 1)` code, drawn on `generator.device`."""
    masks = torch.as_tensor(masks, device=generator.device).long()
    B = masks.shape[0]
    n_labels = int(masks.max()) + 1
    codes = sigma * torch.randn(B, n_labels, nz, generator=generator,
                                device=generator.device)
    return codes[torch.arange(B, device=masks.device)[:, None], masks]
