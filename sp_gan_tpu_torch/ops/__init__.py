"""Distances, kNN selection, edge features, Chamfer, the EMD auction, and
the point-network ops (sampling, grouping, the expansion penalty)."""

from sp_gan_tpu_torch.ops.chamfer import (chamfer, chamfer_sums,
                                          chamfer_tiled, nn_distance)
from sp_gan_tpu_torch.ops.edge import (edge_diff_features, edge_features,
                                       gather_neighbors)
from sp_gan_tpu_torch.ops.emd import emd_auction, emd_cost
from sp_gan_tpu_torch.ops.expansion import expansion_penalty
from sp_gan_tpu_torch.ops.grouping import (group_points, knn_query,
                                           query_and_group)
from sp_gan_tpu_torch.ops.pairwise import knn_indices, pairwise_sqdist
from sp_gan_tpu_torch.ops.sampling import (ball_query, farthest_point_sample,
                                           gather_points,
                                           minimum_density_sample,
                                           three_interpolate, three_nn)
from sp_gan_tpu_torch.ops.voxel import voxel_occupancy

__all__ = ["ball_query", "chamfer", "chamfer_sums", "chamfer_tiled",
           "edge_diff_features", "edge_features", "emd_auction", "emd_cost",
           "expansion_penalty", "farthest_point_sample", "gather_neighbors",
           "gather_points", "group_points", "knn_indices", "knn_query",
           "minimum_density_sample", "nn_distance", "pairwise_sqdist",
           "query_and_group", "three_interpolate", "three_nn",
           "voxel_occupancy"]
