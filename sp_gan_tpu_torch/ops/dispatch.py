"""Kernel dispatch, the port of `sp_gan_tpu/ops/dispatch.py`.

The device of the tensor decides: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to its plain PyTorch version (inside the kernel's
wrapper). There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from sp_gan_tpu_torch.ops.kernels.knn import knn as knn_kernel


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """Self-kNN indices [B, N, k] int32 of x [B, N, C] (self excluded,
    ascending, ties to the lower index), on f32 distances. Kernel A on
    CUDA (C <= 128, k <= 32), its plain version on the CPU. Indices carry
    no gradient."""
    with torch.no_grad():
        return knn_kernel(x.detach().float().contiguous(), k)[0]
