"""Expansion penalty (MSN), the port of `sp_gan_tpu/ops/expansion.py` (the
reference's `expansion_penalty_cuda.cu`).

Each primitive (a run of `primitive_size` consecutive points) gets its
euclidean minimum spanning tree by Prim's algorithm; edges longer than
`alpha` times the primitive's mean edge are penalized. Each edge belongs
to its Prim child, as in the JAX package. Prim runs over all B * N / P
primitives at once, one round of P - 1 picking one node in each, with no
host synchronisation inside the loop; its argmin takes the first minimum,
as `jnp.argmin` does.

The backward is the JAX package's `_exp_bwd`: `2 g (x - x[assign])` on the
penalized points only; the assignment and `mean_mst_length` carry no
gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sp_gan_tpu_torch.ops.pairwise import first_argmin, sq_norms


def _prim_mst(pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prim's MST of each primitive. pts [G, P, 3] -> (parent [G, P]
    int64, edge_len [G, P]); node 0 is the root, parent -1 and length 0."""
    G, P, _ = pts.shape
    dev = pts.device
    rows = torch.arange(G, device=dev)
    visited = torch.zeros((G, P), dtype=torch.bool, device=dev)
    visited[:, 0] = True
    cur_dis = torch.full((G, P), float("inf"), dtype=pts.dtype, device=dev)
    cur_idx = torch.zeros((G, P), dtype=torch.int64, device=dev)
    parent = torch.full((G, P), -1, dtype=torch.int64, device=dev)
    edge_len = torch.zeros((G, P), dtype=pts.dtype, device=dev)
    last = torch.zeros((G,), dtype=torch.int64, device=dev)
    for _ in range(P - 1):
        d = torch.sqrt(sq_norms(pts - pts[rows, last][:, None]))
        closer = ~visited & (d < cur_dis)
        cur_dis = torch.where(closer, d, cur_dis)
        cur_idx = torch.where(closer, last[:, None], cur_idx)
        last = first_argmin(cur_dis.masked_fill(visited, float("inf")))
        visited[rows, last] = True
        parent[rows, last] = cur_idx[rows, last]
        edge_len[rows, last] = cur_dis[rows, last]
    return parent, edge_len


def _expansion_forward(xyz: torch.Tensor, primitive_size: int,
                       alpha: float):
    B, N, _ = xyz.shape
    P = primitive_size
    if N % P:
        raise ValueError(f"N={N} must be a multiple of primitive_size={P}")
    nprim = N // P
    parent, edge_len = _prim_mst(xyz.reshape(B * nprim, P, 3))
    mean_len = edge_len.sum(dim=-1) / (P - 1)                 # [B * nprim]
    penalized = edge_len > alpha * mean_len[:, None]
    dist = torch.where(penalized, edge_len, 0.0)
    # the parent's index in the whole cloud, -1 where not penalized
    offset = (torch.arange(B * nprim, device=xyz.device) % nprim) * P
    assign = torch.where(penalized, parent + offset[:, None], -1)
    return (dist.reshape(B, N), assign.reshape(B, N).to(torch.int32),
            mean_len.reshape(B, nprim).mean(dim=-1))


class _ExpansionPenalty(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, primitive_size, alpha):
        dist, assign, mean_len = _expansion_forward(xyz, primitive_size,
                                                    alpha)
        ctx.save_for_backward(xyz, assign)
        ctx.mark_non_differentiable(assign)
        return dist, assign, mean_len

    @staticmethod
    def backward(ctx, g_dist, g_assign, g_mean):
        xyz, assign = ctx.saved_tensors
        safe = assign.clamp_min(0).long()[..., None].expand(-1, -1, 3)
        nbr = torch.gather(xyz, 1, safe)
        grad = torch.where((assign >= 0)[..., None],
                           2.0 * g_dist[..., None] * (xyz - nbr), 0.0)
        return grad, None, None


def expansion_penalty(xyz: torch.Tensor, primitive_size: int,
                      alpha: float = 1.5
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xyz [B, N, 3], N % primitive_size == 0 -> (dist [B, N], assignment
    [B, N] int32, mean_mst_length [B])."""
    return _ExpansionPenalty.apply(xyz, primitive_size, alpha)


def expansion_loss(xyz: torch.Tensor, primitive_size: int,
                   alpha: float = 1.5) -> torch.Tensor:
    """The mean penalty, a scalar (the usual training reduction)."""
    dist, _, _ = expansion_penalty(xyz, primitive_size, alpha)
    return dist.mean()
