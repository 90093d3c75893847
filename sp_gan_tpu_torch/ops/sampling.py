"""Point sampling and interpolation, the port of `sp_gan_tpu/ops/sampling.py`
(the reference's pointnet2 sampling, ball-query and interpolation CUDA
extensions and MSN's minimum-density sampling).

Plain PyTorch on the input's device: the JAX package computes these
outside Pallas (distances by the plain `pairwise_sqdist`, FPS and MDS as
`lax.fori_loop`s). FPS and MDS run `npoint - 1` eager rounds of a few
elementwise kernels each, with no host synchronisation inside the loop.
A point's squared distance to the last pick is summed over x, y, z left
to right (`sq_norms`), and every argmax / argmin takes the first extreme
index, as `jnp.argmax` / `jnp.argmin` do.
"""

from __future__ import annotations

from typing import Optional

import torch

from sp_gan_tpu_torch.ops.pairwise import (first_argmax, first_argmin,
                                           pairwise_sqdist, smallest_k,
                                           sq_norms)


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative farthest-point sampling. xyz [B, N, 3] -> idx [B, npoint]
    int32: index 0 first, then each round the point farthest from the
    picks so far (`furthest_point_sampling_kernel`)."""
    B, N, _ = xyz.shape
    min_d = torch.full((B, N), float("inf"), dtype=xyz.dtype,
                       device=xyz.device)
    idxs = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    last = torch.zeros((B,), dtype=torch.int64, device=xyz.device)
    for i in range(1, npoint):
        d = sq_norms(xyz - gather_points(xyz, last[:, None]))
        min_d = torch.minimum(min_d, d)
        last = first_argmax(min_d)
        idxs[:, i] = last
    return idxs


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, M] -> [B, M, C] (`gather_points_kernel`;
    the backward scatter-adds by index)."""
    return torch.gather(points, 1, idx.long()[..., None].expand(
        -1, -1, points.shape[-1]))


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """For each query the `nsample` smallest indices of the points within
    `radius` (`d < radius^2`), slots past the hits padded with the first
    hit, a query with no hit all 0 (`ball_query_gpu.cu`).
    xyz [B, N, 3], new_xyz [B, S, 3] -> [B, S, nsample] int32."""
    d = pairwise_sqdist(new_xyz, xyz)                         # [B, S, N]
    N = xyz.shape[1]
    ar = torch.arange(N, dtype=torch.int32, device=xyz.device)
    order = torch.where(d < radius * radius, ar, N)
    picked = torch.topk(order, nsample, dim=-1, largest=False,
                        sorted=True).values
    picked = torch.where(picked >= N, picked[..., :1], picked)
    return torch.where(picked >= N, 0, picked).to(torch.int32)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """The 3 nearest `known` points of each `unknown` point: (squared
    distances [B, N, 3] ascending, idx [B, N, 3] int32), ties to the lower
    index (`three_nn_kernel`)."""
    dist, idx = smallest_k(pairwise_sqdist(unknown, known), 3)
    return dist, idx.to(torch.int32)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted 3-NN feature interpolation. points [B, M, C], idx
    [B, N, 3], weight [B, N, 3] -> [B, N, C], the three terms summed in
    order."""
    B, N, _ = idx.shape
    g = gather_points(points, idx.reshape(B, N * 3)).reshape(B, N, 3, -1)
    w = weight[..., None]
    return (g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1]) \
        + g[:, :, 2] * w[:, :, 2]


def interpolation_weights(dist: torch.Tensor, eps: float = 1e-8
                          ) -> torch.Tensor:
    """Inverse-distance weights for `three_interpolate`: 1 / (d + eps)
    normalized over the neighbours (pointnet2's convention)."""
    recip = 1.0 / (dist + eps)
    return recip / recip.sum(dim=-1, keepdim=True)


def minimum_density_sample(xyz: torch.Tensor, npoint: int,
                           mean_mst_length: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Minimum-density sampling (MSN's `MDS_cuda.cu`): index 0 is picked
    first; each round adds exp(-d^2 / sigma^2) of every point's squared
    distance to the last pick to its density and picks the unpicked point
    of least density. sigma is `mean_mst_length` [B] (1 by default).
    xyz [B, N, 3] -> idx [B, npoint] int32."""
    B, N, _ = xyz.shape
    dev = xyz.device
    if mean_mst_length is None:
        mean_mst_length = torch.ones((B,), dtype=xyz.dtype, device=dev)
    sigma2 = mean_mst_length[:, None] ** 2                      # [B, 1]
    rows = torch.arange(B, device=dev)
    density = torch.zeros((B, N), dtype=xyz.dtype, device=dev)
    selected = torch.zeros((B, N), dtype=torch.bool, device=dev)
    selected[:, 0] = True
    idxs = torch.zeros((B, npoint), dtype=torch.int32, device=dev)
    last = torch.zeros((B,), dtype=torch.int64, device=dev)
    for i in range(1, npoint):
        d2 = sq_norms(xyz - gather_points(xyz, last[:, None]))
        density = density + torch.exp(-d2 / sigma2)
        last = first_argmin(density.masked_fill(selected, float("inf")))
        selected[rows, last] = True
        idxs[:, i] = last
    return idxs
