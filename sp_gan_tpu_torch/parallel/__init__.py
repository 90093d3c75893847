"""The device mesh and point-axis sharding over `torch.distributed`, the
port of `sp_gan_tpu/parallel/`: data parallelism (each rank a contiguous
block of the batch, gradients averaged by an explicit all-reduce,
BatchNorm synchronized or per replica) and the point-sharded ops of the
high-resolution step, on NCCL over CUDA or gloo over the CPU.
"""

from sp_gan_tpu_torch.parallel.mesh import (Mesh, backend_for,
                                            init_distributed, make_mesh,
                                            shard_batch)
from sp_gan_tpu_torch.parallel.points import (chamfer_pointsharded,
                                              edge_diff_local,
                                              edge_features_pointsharded,
                                              emd_auction_local,
                                              global_max_points,
                                              knn_pointsharded,
                                              pairwise_emd_matrix_pointsharded)

__all__ = ["Mesh", "backend_for", "init_distributed", "make_mesh",
           "shard_batch", "chamfer_pointsharded", "edge_diff_local",
           "edge_features_pointsharded", "emd_auction_local",
           "global_max_points", "knn_pointsharded",
           "pairwise_emd_matrix_pointsharded"]
