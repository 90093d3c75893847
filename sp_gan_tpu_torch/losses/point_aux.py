"""Auxiliary point-set regularizers, the port of
`sp_gan_tpu/losses/point_aux.py` (the reference's `get_repulsion_loss`,
`get_uniform_loss` and `get_uniform_loss_knn`,
`Common/model_utils.py:141-331`, of the PU-GAN lineage).

Plain PyTorch over the plain kNN (`knn_indices`, self excluded) and the
port's FPS, ball query and grouping, as the JAX package computes them
with XLA.
"""

from __future__ import annotations

import math

import torch

from sp_gan_tpu_torch.ops.grouping import group_points
from sp_gan_tpu_torch.ops.pairwise import (knn_indices, pairwise_sqdist,
                                           sq_norms)
from sp_gan_tpu_torch.ops.sampling import (ball_query, farthest_point_sample,
                                           gather_points)


def repulsion_loss(pc: torch.Tensor, k: int = 5, h: float = 0.03
                   ) -> torch.Tensor:
    """The mean of relu(h - d)^2 over each point's k nearest neighbours'
    distances d: points closer than `h` are pushed apart."""
    _, d2 = knn_indices(pc, k, return_dists=True)
    d = torch.sqrt(torch.clamp_min(d2, 1e-12))
    return (torch.relu(h - d) ** 2).mean()


def uniform_loss(pc: torch.Tensor, percentages=(0.4, 0.6, 0.8, 1.0, 1.2),
                 radius: float = 1.0, n_seed: int = 32,
                 nsample: int = 32) -> torch.Tensor:
    """Multi-scale uniformity over `n_seed` FPS seed balls of radius
    r(p) = radius * sqrt(p / 100) for each percentage p: the occupancy
    deviation E[(count - p N / 100)^2 / expect], and inside each ball (up
    to `nsample` members) each member's nearest-member distance against
    the hexagonal-packing spacing d_hat = sqrt(2 pi r^2 / (sqrt(3)
    expect)): E[(d - d_hat)^2 / d_hat]. The mean over the percentages of
    both terms."""
    B, N, _ = pc.shape
    seeds = gather_points(pc, farthest_point_sample(pc, n_seed))  # [B, S, 3]
    d_seed = pairwise_sqdist(seeds, pc)                          # [B, S, N]
    k = nsample
    others = ~torch.eye(k, dtype=torch.bool, device=pc.device)
    slots = torch.arange(k, device=pc.device)
    loss = 0.0
    for p in percentages:
        r = radius * math.sqrt(p / 100.0)
        expect = max(p / 100.0 * N, 1.0)
        counts = (d_seed < r * r).sum(dim=-1)                    # [B, S]
        loss_occ = ((counts - expect) ** 2 / expect).mean()

        members = group_points(pc, ball_query(r, nsample, pc, seeds))
        dd = sq_norms(members[..., :, None, :] - members[..., None, :, :])
        valid = slots < torch.clamp_max(counts, k)[..., None]    # [B, S, k]
        pair_ok = valid[..., :, None] & valid[..., None, :] & others
        nn_d = torch.sqrt(torch.where(pair_ok, dd, float("inf"))
                          .amin(dim=-1))
        member_ok = valid & (counts[..., None] >= 2)
        d_hat = math.sqrt(2.0 * math.pi * r * r / (math.sqrt(3.0) * expect))
        dev = torch.where(member_ok, (nn_d - d_hat) ** 2 / d_hat, 0.0)
        loss_spacing = dev.sum() / torch.clamp_min(member_ok.sum(), 1)
        loss = loss + loss_occ + loss_spacing
    return loss / len(percentages)


def uniform_loss_knn(pc: torch.Tensor, k: int = 6) -> torch.Tensor:
    """`get_uniform_loss_knn`: the variance over points of each point's
    mean kNN squared distance, plus the summed per-point variances of
    those distances; the reference's kNN includes the point itself, so a
    zero column leads the k - 1 self-excluded distances."""
    _, d2 = knn_indices(pc, k - 1, return_dists=True)            # [B, N, k-1]
    d2 = torch.cat([torch.zeros_like(d2[..., :1]), d2], dim=-1)
    mean_k = d2.mean(dim=2)                                      # [B, N]
    variance1 = mean_k.var(dim=1, unbiased=False).sum()
    variance2 = d2.var(dim=2, unbiased=False).sum()
    return variance1 + variance2
