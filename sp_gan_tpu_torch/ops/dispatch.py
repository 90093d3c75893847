"""Kernel dispatch, the port of `sp_gan_tpu/ops/dispatch.py`.

The device of the tensor decides: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to its plain PyTorch version (inside the kernel's
wrapper). There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sp_gan_tpu_torch.ops.chamfer import chamfer_fused
from sp_gan_tpu_torch.ops.kernels.knn import knn as knn_kernel
from sp_gan_tpu_torch.ops.kernels.knn_blocked import (BLOCKED_ABOVE,
                                                      knn_blocked)
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist

# B * N * M above which `chamfer_directed` takes kernel N: the JAX switch
# (`sp_gan_tpu/ops/dispatch.py:63`), a 512 MiB f32 distance matrix
CHAMFER_FUSED_ABOVE = 512 * 1024 * 1024 // 4


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """Self-kNN indices [B, N, k] int32 of x [B, N, C] (self excluded,
    ascending, ties to the lower index), on f32 distances. Kernel A on
    CUDA, or kernel G above 8192 points (the switch of the JAX
    `knn_pallas`, `knn.py:503-506`); their plain versions on the CPU. Both
    take C <= 128 and k <= 32 on CUDA and give the same indices. Indices
    carry no gradient."""
    x = x.detach().float().contiguous()
    with torch.no_grad():
        if x.shape[1] > BLOCKED_ABOVE:
            return knn_blocked(x, k)[0]
        return knn_kernel(x, k)[0]


def uses_fused_chamfer(B: int, N: int, M: int) -> bool:
    """Whether `chamfer_directed` takes the fused op at these sizes."""
    return B * N * M > CHAMFER_FUSED_ABOVE


def chamfer_directed(x: torch.Tensor, y: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist1 [B, N], dist2 [B, M]) squared NN distances both ways,
    differentiable. Above B * N * M = 128 Mi (`uses_fused_chamfer`) the
    fused op (`chamfer_fused`: kernel N on CUDA, its plain version on the
    CPU), which never holds the [B, N, M] matrix; at or below, the matrix
    and its two minima, as the JAX package decides."""
    B, N, _ = x.shape
    if uses_fused_chamfer(B, N, y.shape[1]):
        return chamfer_fused(x, y)
    d = pairwise_sqdist(x, y)
    return d.amin(dim=-1), d.amin(dim=-2)
