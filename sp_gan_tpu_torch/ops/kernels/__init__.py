"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version. See `_build.py` for how the CUDA sources are compiled and loaded."""

from sp_gan_tpu_torch.ops.kernels.auction import auction, auction_plain
from sp_gan_tpu_torch.ops.kernels.auction_jacobi import (jacobi_auction,
                                                         jacobi_auction_plain)
from sp_gan_tpu_torch.ops.kernels.chamfer import chamfer_nn, chamfer_nn_plain
from sp_gan_tpu_torch.ops.kernels.edgeblock import edge_tail, edge_tail_plain
from sp_gan_tpu_torch.ops.kernels.edgeblock_train import (
    edge_train_bwd1, edge_train_bwd1_plain, edge_train_bwd2,
    edge_train_bwd2_plain, edge_train_bwd3, edge_train_bwd3_plain,
    edge_train_stats2, edge_train_stats2_plain)
from sp_gan_tpu_torch.ops.kernels.knn import knn, knn_plain
from sp_gan_tpu_torch.ops.kernels.knn_blocked import (knn_blocked,
                                                      knn_blocked_plain)
from sp_gan_tpu_torch.ops.kernels.knn_edge import knn_edge, knn_edge_plain
from sp_gan_tpu_torch.ops.kernels.knn_edge_window import (
    knn_edge_window, knn_edge_window_plain)
from sp_gan_tpu_torch.ops.kernels.scatter import (edge_scatter_bwd,
                                                  edge_scatter_bwd_plain,
                                                  scatter_add,
                                                  scatter_add_plain,
                                                  scatter_diff_bwd,
                                                  scatter_diff_bwd_plain)

# kernels A to O by wrapper name
KERNELS = {"knn": knn, "knn_edge": knn_edge, "edge_tail": edge_tail,
           "scatter_diff_bwd": scatter_diff_bwd, "auction": auction,
           "knn_edge_window": knn_edge_window, "knn_blocked": knn_blocked,
           "scatter_add": scatter_add, "edge_train_stats2": edge_train_stats2,
           "edge_train_bwd1": edge_train_bwd1,
           "edge_train_bwd2": edge_train_bwd2,
           "edge_train_bwd3": edge_train_bwd3,
           "edge_scatter_bwd": edge_scatter_bwd, "chamfer_nn": chamfer_nn,
           "jacobi_auction": jacobi_auction}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["KERNELS", "auction", "auction_plain", "chamfer_nn",
           "chamfer_nn_plain", "edge_scatter_bwd", "edge_scatter_bwd_plain",
           "edge_tail", "edge_tail_plain", "edge_train_bwd1",
           "edge_train_bwd1_plain", "edge_train_bwd2", "edge_train_bwd2_plain", "edge_train_bwd3",
           "edge_train_bwd3_plain", "edge_train_stats2",
           "edge_train_stats2_plain", "jacobi_auction",
           "jacobi_auction_plain", "knn", "knn_blocked", "knn_blocked_plain",
           "knn_edge", "knn_edge_plain", "knn_edge_window",
           "knn_edge_window_plain", "knn_plain", "launch_counts",
           "reset_launch_counts", "scatter_add", "scatter_add_plain",
           "scatter_diff_bwd", "scatter_diff_bwd_plain"]
