"""Distances, kNN selection and edge features."""

from sp_gan_tpu_torch.ops.edge import (edge_diff_features, edge_features,
                                       gather_neighbors)
from sp_gan_tpu_torch.ops.pairwise import knn_indices, pairwise_sqdist

__all__ = ["edge_diff_features", "edge_features", "gather_neighbors",
           "knn_indices", "pairwise_sqdist"]
