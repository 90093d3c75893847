"""kNN query and feature grouping, the port of `sp_gan_tpu/ops/grouping.py`
(the reference's `pointops` extension: `knnquery`, `grouping`,
`QueryAndGroup`, `Gen_QueryAndGroupXYZ`, `featuredistribute`,
`featuregather`, `labelstat`).

Plain PyTorch on the input's device over the plain `pairwise_sqdist`, as
the JAX package computes them with XLA. Selections take ties to the lower
index.
"""

from __future__ import annotations

from typing import Optional

import torch

from sp_gan_tpu_torch.ops.pairwise import (first_argmin, pairwise_sqdist,
                                           smallest_k)
from sp_gan_tpu_torch.ops.sampling import gather_points


def knn_query(k: int, xyz: torch.Tensor,
              new_xyz: Optional[torch.Tensor] = None):
    """The k nearest `xyz` points of each `new_xyz` query, the query
    itself included (unlike `knn_indices`, which masks it): xyz [B, N, 3],
    new_xyz [B, S, 3] -> (idx [B, S, k] int32, squared distances
    [B, S, k]), ascending."""
    if new_xyz is None:
        new_xyz = xyz
    dist, idx = smallest_k(pairwise_sqdist(new_xyz, xyz), k)
    return idx.to(torch.int32), dist


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, S, k] -> [B, S, k, C] (`grouping_forward`)."""
    B, S, k = idx.shape
    return gather_points(points, idx.reshape(B, S * k)).reshape(B, S, k, -1)


def query_and_group(xyz: torch.Tensor, features: Optional[torch.Tensor],
                    k: int, new_xyz: Optional[torch.Tensor] = None,
                    use_xyz: bool = True) -> torch.Tensor:
    """pointops `QueryAndGroup` (kNN flavour): the neighbours' coordinates
    relative to their query, and their features, concatenated with
    `use_xyz`. -> [B, S, k, 3 + C] (3 without features, C without
    `use_xyz`)."""
    if new_xyz is None:
        new_xyz = xyz
    idx, _ = knn_query(k, xyz, new_xyz)
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if features is None:
        return grouped_xyz
    grouped_feats = group_points(features, idx)
    if use_xyz:
        return torch.cat([grouped_xyz, grouped_feats], dim=-1)
    return grouped_feats


def query_and_group_xyz(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """pointops `Gen_QueryAndGroupXYZ`: each point's k nearest neighbours'
    coordinates, not recentred. [B, N, 3] -> [B, N, k, 3]."""
    idx, _ = knn_query(k, xyz, xyz)
    return group_points(xyz, idx)


def feature_distribute(max_xyz: torch.Tensor, xyz: torch.Tensor
                       ) -> torch.Tensor:
    """pointops `featuredistribute`: the index of each `xyz` point's
    nearest `max_xyz` point. [B, M, 3], [B, N, 3] -> [B, N] int32."""
    return first_argmin(pairwise_sqdist(xyz, max_xyz)).to(torch.int32)


def feature_gather(max_feature: torch.Tensor, distribute_idx: torch.Tensor
                   ) -> torch.Tensor:
    """pointops `featuregather`: max_feature [B, M, C], idx [B, N] ->
    [B, N, C]."""
    return gather_points(max_feature, distribute_idx)


def _one_hot(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    # a label outside [0, n_classes) counts in no class, as jax.nn.one_hot
    classes = torch.arange(n_classes, device=labels.device)
    return labels[..., None] == classes


def label_stat(labels: torch.Tensor, idx: torch.Tensor, n_classes: int
               ) -> torch.Tensor:
    """Each neighbourhood's label histogram: labels [B, N] int, idx
    [B, S, k] -> [B, S, n_classes] int32 counts."""
    grouped = group_points(labels[..., None], idx)[..., 0]       # [B, S, k]
    return _one_hot(grouped, n_classes).sum(dim=2, dtype=torch.int32)


def label_stat_ball_range(labels: torch.Tensor, xyz: torch.Tensor,
                          new_xyz: torch.Tensor, radius: float,
                          n_classes: int) -> torch.Tensor:
    """pointops `labelstat_ballrange`: per query, the label histogram of
    every point within `radius` -> [B, S, n_classes] int32 counts. The
    counts are an f32 product of 0/1 matrices, exact below 2^24 points."""
    inside = (pairwise_sqdist(new_xyz, xyz) < radius * radius).float()
    onehot = _one_hot(labels, n_classes).float()                # [B, N, Cl]
    return torch.matmul(inside, onehot).round().to(torch.int32)
