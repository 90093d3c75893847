"""CutMix for point clouds, the port of `sp_gan_tpu/losses/cutmix.py` on
one device (the JAX `points_axis` and `data_axis` belong to the parallel
slice).

Per item: a mix ratio lam ~ U(0, 1), a random anchor point of the real
cloud; the `int(lam * N)` points farthest from the anchor are replaced by
the EMD-aligned fake points, and with probability 1/2 the mask is inverted
for the whole batch. The draws (lam [B], anchor [B], flip) are arguments,
so that a test can hand in the JAX package's own.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sp_gan_tpu_torch.ops.emd import emd_auction
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist


def cutmix_draws(gen: torch.Generator, B: int, N: int, device=None):
    """(lam [B] U(0, 1), anchor [B] in [0, N), flip, a 0-d bool) from
    `gen`."""
    device = device or gen.device
    lam = torch.rand(B, generator=gen, device=gen.device).to(device)
    anchor = torch.randint(0, N, (B,), generator=gen,
                           device=gen.device).to(device)
    flip = (torch.rand((), generator=gen, device=gen.device) < 0.5).to(device)
    return lam, anchor, flip


def cutmix(real: torch.Tensor, fake: torch.Tensor, lam: torch.Tensor,
           anchor: torch.Tensor, flip: torch.Tensor, emd_eps: float = 0.005,
           emd_iters: int = 300
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """real, fake [B, N, 3] -> (mixed [B, N, 3], map_s [B], mask [B, N]).

    mask == 1 keeps the real point; map_s = mean(mask). The farthest-first
    rank of each point is the double stable argsort of minus its distance
    to the anchor (the anchor's row of `pairwise_sqdist(real, real)`, the
    same f32 values as the full matrix's row). Fake is aligned to real by
    the scaled EMD auction (`emd_auction(real, fake, emd_eps, emd_iters,
    scaled=True)`: kernel E on CUDA) and carries no gradient here."""
    B, N, _ = real.shape
    num = (lam * N).to(torch.int32)
    a_pt = torch.gather(real, 1, anchor.long()[:, None, None].expand(
        -1, 1, real.shape[-1]))                                # [B, 1, 3]
    d_anchor = pairwise_sqdist(a_pt, real)[:, 0, :]            # [B, N]
    order = torch.argsort(-d_anchor, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    mask = 1.0 - (rank < num[:, None]).to(real.dtype)
    mask = torch.where(flip, 1.0 - mask, mask)
    with torch.no_grad():
        _, assignment = emd_auction(real, fake, emd_eps, emd_iters, True)
        aligned = torch.gather(fake, 1, assignment.long()[..., None].expand(
            -1, -1, fake.shape[-1]))
    m = mask[..., None]
    mixed = m * real + (1.0 - m) * aligned
    return mixed, mask.mean(dim=-1), mask
