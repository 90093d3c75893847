"""Kernel dispatch, the port of `sp_gan_tpu/ops/dispatch.py`.

The device of the tensor decides: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to its plain PyTorch version (inside the kernel's
wrapper). There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from sp_gan_tpu_torch.ops.kernels.knn import knn as knn_kernel
from sp_gan_tpu_torch.ops.kernels.knn_blocked import (BLOCKED_ABOVE,
                                                      knn_blocked)


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
