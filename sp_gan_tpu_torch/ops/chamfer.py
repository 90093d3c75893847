"""Chamfer distance, the port of `sp_gan_tpu/ops/chamfer.py` and of the
`chamfer_pallas` autograd wrapper of `sp_gan_tpu/ops/pallas/chamfer.py`.

`nn_distance`, `chamfer`, `chamfer_sums` and `chamfer_tiled` are plain
PyTorch on `pairwise_sqdist`, as the JAX package leaves them to XLA.
`chamfer_fused` is the counterpart of `chamfer_pallas`, which
`ops/dispatch.chamfer_directed` takes for large inputs: its forward is
kernel N (`ops/kernels/chamfer.py`, the plain version on the CPU), its
backward the JAX `_cp_bwd` in plain PyTorch: each point's gradient runs
along the vector to its matched neighbour, and the matched side's share is
scattered by target with `scatter_add` (kernel H on CUDA, whose sums run
in a fixed order, so two backward passes agree bit for bit).
"""

from __future__ import annotations

from typing import Tuple

import torch

from sp_gan_tpu_torch.ops.kernels.chamfer import chamfer_nn, chamfer_nn_plain
from sp_gan_tpu_torch.ops.kernels.scatter import scatter_add
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist

Pair = Tuple[torch.Tensor, torch.Tensor]


def nn_distance(x: torch.Tensor, y: torch.Tensor):
    """x [B, N, 3], y [B, M, 3] -> (dist1 [B, N], idx1 [B, N] int32,
    dist2 [B, M], idx2 [B, M] int32): each point's squared distance to its
    nearest neighbour in the other cloud and that neighbour's index, ties
    to the lowest index (kernel N's plain version, on any device)."""
    return chamfer_nn_plain(x, y)


def chamfer(x: torch.Tensor, y: torch.Tensor) -> Pair:
    """Mean squared NN distance in both directions: ([B], [B])."""
    d = pairwise_sqdist(x, y)
    return d.amin(dim=-1).mean(dim=-1), d.amin(dim=-2).mean(dim=-1)


def chamfer_sums(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Both directions' minima summed over points and batch (the
    reference's `ChamferLoss.forward`): a scalar."""
    d = pairwise_sqdist(x, y)
    return d.amin(dim=-2).sum() + d.amin(dim=-1).sum()


def chamfer_tiled(x: torch.Tensor, y: torch.Tensor, chunk: int = 512
                  ) -> Pair:
    """`chamfer` over chunks of `chunk` points of x at a time, so that no
    more than [B, chunk, M] distances exist at once. N % chunk == 0."""
    B, N, _ = x.shape
    if N % chunk:
        raise ValueError(f"N={N} must be divisible by chunk={chunk}")
    mins2 = torch.full((B, y.shape[1]), float("inf"), dtype=x.dtype,
                       device=x.device)
    d1s = []
    for c in range(0, N, chunk):
        d = pairwise_sqdist(x[:, c:c + chunk], y)
        d1s.append(d.amin(dim=-1))
        mins2 = torch.minimum(mins2, d.amin(dim=-2))
    return torch.cat(d1s, dim=1).mean(dim=-1), mins2.mean(dim=-1)


def _matched(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(pts, 1, idx.long()[..., None].expand(
        -1, -1, pts.shape[-1]))


def nn_backward(x, y, i1, i2, g1, g2, scatter=scatter_add):
    """(dx, dy) of the two NN distances given their matches i1 [B, N],
    i2 [B, M] (int32) and cotangents g1 [B, N], g2 [B, M]: each point's
    share `2 g (p - match)` on itself and its negative scattered onto its
    match by `scatter(rows, idx, n)` (kernel H's `scatter_add` by default;
    `scatter_add_plain` gives the plain version)."""
    x, y = x.float(), y.float()
    v1 = 2.0 * g1[..., None] * (x - _matched(y, i1))           # [B, N, C]
    v2 = 2.0 * g2[..., None] * (y - _matched(x, i2))           # [B, M, C]
    dx = v1 + scatter((-v2).contiguous(), i2, x.shape[1])
    dy = v2 + scatter((-v1).contiguous(), i1, y.shape[1])
    return dx, dy


class ChamferNN(torch.autograd.Function):
    """(dist1 [B, N], dist2 [B, M]) of x, y with kernel N's forward and
    the JAX `_cp_bwd` backward (`nn_backward`)."""

    @staticmethod
    def forward(ctx, x, y):
        d1, i1, d2, i2 = chamfer_nn(x, y)
        ctx.save_for_backward(x, y, i1, i2)
        return d1, d2

    @staticmethod
    def backward(ctx, g1, g2):
        return nn_backward(*ctx.saved_tensors, g1, g2)


def chamfer_fused(x: torch.Tensor, y: torch.Tensor) -> Pair:
    """x [B, N, C], y [B, M, C] -> (dist1 [B, N], dist2 [B, M]) squared NN
    distances, differentiable in both (`ChamferNN`)."""
    return ChamferNN.apply(x, y)
