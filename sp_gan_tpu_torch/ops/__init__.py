"""Distances, kNN selection, edge features, Chamfer and the EMD auction."""

from sp_gan_tpu_torch.ops.chamfer import (chamfer, chamfer_sums,
                                          chamfer_tiled, nn_distance)
from sp_gan_tpu_torch.ops.edge import (edge_diff_features, edge_features,
                                       gather_neighbors)
from sp_gan_tpu_torch.ops.emd import emd_auction, emd_cost
from sp_gan_tpu_torch.ops.pairwise import knn_indices, pairwise_sqdist

__all__ = ["chamfer", "chamfer_sums", "chamfer_tiled", "edge_diff_features",
           "edge_features", "emd_auction", "emd_cost", "gather_neighbors",
           "knn_indices", "nn_distance", "pairwise_sqdist"]
