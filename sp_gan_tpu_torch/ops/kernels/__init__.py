"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version. See `_build.py` for how the CUDA sources are compiled and loaded."""

from sp_gan_tpu_torch.ops.kernels.edgeblock import edge_tail, edge_tail_plain
from sp_gan_tpu_torch.ops.kernels.knn import knn, knn_plain
from sp_gan_tpu_torch.ops.kernels.knn_edge import knn_edge, knn_edge_plain
from sp_gan_tpu_torch.ops.kernels.scatter import (scatter_diff_bwd,
                                                  scatter_diff_bwd_plain)

KERNELS = {"knn": knn, "knn_edge": knn_edge, "edge_tail": edge_tail,
           "scatter_diff_bwd": scatter_diff_bwd}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["KERNELS", "edge_tail", "edge_tail_plain", "knn", "knn_edge",
           "knn_edge_plain", "knn_plain", "launch_counts",
           "reset_launch_counts", "scatter_diff_bwd",
           "scatter_diff_bwd_plain"]
