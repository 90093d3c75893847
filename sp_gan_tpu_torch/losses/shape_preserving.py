"""Shape-preserving loss, the port of `sp_gan_tpu/losses/shape_preserving.py`
(the reference's `get_local_pair` / `compute_mean_covariance`,
`Common/loss_utils.py:196-257`): Chamfer distance between the local
neighbourhood means and covariances of two clouds, both grouped at the
first cloud's points.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sp_gan_tpu_torch.ops.chamfer import chamfer_sums
from sp_gan_tpu_torch.ops.grouping import group_points, knn_query


def local_mean_covariance(groups: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """groups [B, M, K, 3] -> (mu [B, M, 3], biased covariance
    [B, M, 3, 3])."""
    mu = groups.mean(dim=2, keepdim=True)
    centered = groups - mu
    cov = torch.einsum("bmkc,bmkd->bmcd", centered, centered) \
        / groups.shape[2]
    return mu[:, :, 0], cov


def shape_preserving_loss(pt1: torch.Tensor, pt2: torch.Tensor,
                          k: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """pt1 [B, M, 3], pt2 [B, N, 3] -> (like_mu, like_var) scalars: the
    summed Chamfer distance between the k-neighbourhood means (and the
    flattened covariances) of pt1 and of pt2 around pt1's points, over M
    (the reference's `chamfer_loss(...) / pt1_M`)."""
    B, M, _ = pt1.shape
    idx1, _ = knn_query(k, pt1, pt1)
    idx2, _ = knn_query(k, pt2, pt1)
    mu1, var1 = local_mean_covariance(group_points(pt1, idx1))
    mu2, var2 = local_mean_covariance(group_points(pt2, idx2))
    like_mu = chamfer_sums(mu1, mu2) / M
    like_var = chamfer_sums(var1.reshape(B, M, 9),
                            var2.reshape(B, M, 9)) / M
    return like_mu, like_var
