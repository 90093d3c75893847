"""Distances, kNN selection, edge features and the EMD auction."""

from sp_gan_tpu_torch.ops.edge import (edge_diff_features, edge_features,
                                       gather_neighbors)
from sp_gan_tpu_torch.ops.emd import emd_auction, emd_cost
from sp_gan_tpu_torch.ops.pairwise import knn_indices, pairwise_sqdist

__all__ = ["edge_diff_features", "edge_features", "emd_auction", "emd_cost",
           "gather_neighbors", "knn_indices", "pairwise_sqdist"]
