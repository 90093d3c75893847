"""CutMix for point clouds, the port of `sp_gan_tpu/losses/cutmix.py`.

Per item: a mix ratio lam ~ U(0, 1), a random anchor point of the real
cloud; the `int(lam * N)` points farthest from the anchor are replaced by
the EMD-aligned fake points, and with probability 1/2 the mask is inverted
for the whole batch. The draws (lam [B], anchor [B], flip) are arguments,
so that a test can hand in the JAX package's own, and under a mesh each
rank its rows of the global draw (the JAX `data_axis` branch). With the
points cut over ranks (`points_group`, the JAX `points_axis` branch) see
`cutmix`.
"""

from __future__ import annotations

from typing import Tuple

import torch

import torch.distributed as dist

from sp_gan_tpu_torch.ops.emd import emd_auction
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist
from sp_gan_tpu_torch.parallel.mesh import gather_rows_nograd
from sp_gan_tpu_torch.parallel.points import emd_auction_local


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
           emd_iters: int = 300, points_group=None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """real, fake [B, N, 3] -> (mixed [B, N, 3], map_s [B], mask [B, N]).

    mask == 1 keeps the real point; map_s = mean(mask). The farthest-first
    rank of each point is the double stable argsort of minus its distance
    to the anchor (the anchor's row of `pairwise_sqdist(real, real)`, the
    same f32 values as the full matrix's row). Fake is aligned to real by
    the scaled EMD auction (`emd_auction(real, fake, emd_eps, emd_iters,
    scaled=True)`: kernel E on CUDA) and carries no gradient here.

    With `points_group` real and fake are the rank's points [B, N / P, 3]
    and so are the outputs (map_s over all N): the anchor point comes from
    its owner by a sum over the group, the ranks' distances to it are
    gathered, and fake is aligned by `parallel.points.emd_auction_local`
    (the scaled Jacobi auction in one phase, as the JAX branch; the
    unsharded alignment is kernel E's block Gauss-Seidel auction, so the
    two may pick other matchings within the same eps)."""
    B, n, _ = real.shape
    p, P = ((0, 1) if points_group is None else
            (dist.get_rank(points_group), dist.get_world_size(points_group)))
    N = n * P
    num = (lam * N).to(torch.int32)
    local = anchor.long() - p * n
    mine = (local >= 0) & (local < n)
    a_pt = torch.gather(real, 1, local.clamp(0, n - 1)[:, None, None].expand(
        -1, 1, real.shape[-1]))                                # [B, 1, 3]
    if points_group is not None:
        a_pt = torch.where(mine[:, None, None], a_pt, torch.zeros_like(a_pt))
        dist.all_reduce(a_pt, group=points_group)
    d_anchor = gather_rows_nograd(pairwise_sqdist(a_pt, real)[:, 0, :],
                                  points_group, dim=1)         # [B, N]
    order = torch.argsort(-d_anchor, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)[:, p * n:(p + 1) * n]
    mask = 1.0 - (rank < num[:, None]).to(real.dtype)
    mask = torch.where(flip, 1.0 - mask, mask)
    with torch.no_grad():
        if points_group is not None:
            _, assignment = emd_auction_local(real, fake, emd_eps, emd_iters,
                                              points_group, phases=1)
            source = gather_rows_nograd(fake, points_group, dim=1)
        else:
            _, assignment = emd_auction(real, fake, emd_eps, emd_iters, True)
            source = fake
        aligned = torch.gather(source, 1, assignment.long()[..., None]
                               .expand(-1, -1, fake.shape[-1]))
    m = mask[..., None]
    mixed = m * real + (1.0 - m) * aligned
    map_s = mask.mean(dim=-1)
    if points_group is not None:
        dist.all_reduce(map_s, group=points_group)
        map_s = map_s / P
    return mixed, map_s, mask
