"""Earth Mover's Distance by the auction algorithm, the port of
`sp_gan_tpu/ops/emd.py`.

`emd_auction(xyz1, xyz2, eps, iters, scaled)` -> (dist [B, N] squared
distance of each point of xyz1 to its match, assignment [B, N] int32 into
xyz2). Gradients go to xyz1 only, `2 g (xyz1 - xyz2[sigma])`; xyz2 gets
zeros, as in the reference backward.

- `scaled=True`, the metric protocol's solver: the block Gauss-Seidel
  auction with eps-scaling (`phases = 1 if iters <= 500 else 4`,
  theta = 8, w = 64) that the JAX package runs in its Pallas kernel
  wherever Pallas runs: kernel E (`ops/kernels/auction.py`) on CUDA, its
  plain version on the CPU.
- `scaled=False`, the reference's fixed-iteration solver: `iters` Jacobi
  rounds, every unassigned point bidding each round, and the forced final
  pass (`_auction_single`). The JAX package computes it in XLA, so here it
  is plain PyTorch on either device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sp_gan_tpu_torch.ops.kernels.auction import auction
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist

THETA = 8.0
BLOCK_W = 64


def scaled_phases(iters: int) -> int:
    """eps-scaling phases of the scaled solver: one for a small cap (the
    training regime), four otherwise."""
    return 1 if iters <= 500 else 4


def auction_jacobi(d: torch.Tensor, eps: float, iters: int) -> torch.Tensor:
    """The fixed-iteration Jacobi auction with forced final pass, batched:
    d [B, N, M] -> assignment [B, N] int32 (JAX `_auction_single`)."""
    B, n, m = d.shape
    dev = d.device
    arange_m = torch.arange(m, device=dev)
    rows = torch.arange(B, device=dev)[:, None]
    assignment = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    assignment_inv = torch.full((B, m), -1, dtype=torch.int64, device=dev)
    price = torch.zeros((B, m), dtype=d.dtype, device=dev)
    ninf = torch.tensor(float("-inf"), dtype=d.dtype, device=dev)
    eps32 = torch.tensor(eps, dtype=d.dtype, device=dev)
    for _ in range(iters):
        unassigned = assignment < 0
        value = -d - price[:, None, :]
        best_idx = value.argmax(dim=2)
        best_val = value.gather(2, best_idx[..., None])[..., 0]
        is_best = best_idx[..., None] == arange_m
        second_val = torch.where(is_best, ninf, value).amax(dim=2)
        bid_inc = best_val - second_val + eps32
        bid_mat = torch.where(unassigned[..., None] & is_best,
                              bid_inc[..., None], ninf)
        max_bid = bid_mat.amax(dim=1)                           # [B, M]
        winner = bid_mat.argmax(dim=1)
        has_bid = torch.isfinite(max_bid)
        evict = torch.where(has_bid & (assignment_inv >= 0), assignment_inv,
                            n)
        padded = torch.cat([assignment,
                            torch.full((B, 1), -1, dtype=torch.int64,
                                       device=dev)], dim=1)
        padded[rows, evict] = -1
        win_point = torch.where(has_bid, winner, n)
        padded[rows, win_point] = torch.where(has_bid, arange_m, -1)
        assignment = padded[:, :n]
        assignment_inv = torch.where(has_bid, winner, assignment_inv)
        price = price + torch.where(has_bid, max_bid, 0.0)
    best_idx = (-d - price[:, None, :]).argmax(dim=2)
    return torch.where(assignment < 0, best_idx, assignment).to(torch.int32)


def _assignment(xyz1, xyz2, eps: float, iters: int,
                scaled: bool) -> torch.Tensor:
    d = pairwise_sqdist(xyz1, xyz2)
    if scaled:
        return auction(d, eps, iters, scaled_phases(iters), THETA,
                       BLOCK_W)[0]
    return auction_jacobi(d, eps, iters)


def _matched(xyz2: torch.Tensor, assignment: torch.Tensor) -> torch.Tensor:
    idx = assignment.long()[..., None].expand(-1, -1, xyz2.shape[-1])
    return torch.gather(xyz2, 1, idx)


class _EMD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2, eps, iters, scaled):
        assignment = _assignment(xyz1, xyz2, eps, iters, scaled)
        matched = _matched(xyz2, assignment)
        dist = ((xyz1 - matched) ** 2).sum(dim=-1)
        ctx.save_for_backward(xyz1, matched)
        ctx.xyz2_shape = xyz2.shape
        ctx.mark_non_differentiable(assignment)
        return dist, assignment

    @staticmethod
    def backward(ctx, g_dist, g_assignment):
        xyz1, matched = ctx.saved_tensors
        grad1 = 2.0 * g_dist[..., None] * (xyz1 - matched)
        return (grad1, matched.new_zeros(ctx.xyz2_shape), None, None,
                None)


def emd_auction(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.005,
                iters: int = 50, scaled: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate EMD of clouds [B, N, 3] and [B, M, 3]: (dist [B, N]
    squared, assignment [B, N] int32). See the module docstring."""
    return _EMD.apply(xyz1, xyz2, eps, iters, scaled)


def emd_cost(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.005,
             iters: int = 50, scaled: bool = False) -> torch.Tensor:
    """Mean L2 matching cost per cloud: [B] (sqrt of the per-point squared
    distances)."""
    dist, _ = emd_auction(xyz1, xyz2, eps, iters, scaled)
    return torch.sqrt(torch.clamp(dist, min=0.0)).mean(dim=-1)
