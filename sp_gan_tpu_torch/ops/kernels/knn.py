"""Kernel A: exact self-kNN, `csrc/knn.cu`.

Replaces `sp_gan_tpu/ops/pallas/knn.py::knn_pallas` (`_knn_kernel`): for
each point of each cloud, the k nearest other points of the same cloud by
f32 squared distance, ascending, ties to the lower index, self masked to
+inf. Returns idx [B, N, k] int32 and dist [B, N, k] f32.

On an H100 the serial per-query loop (distance, then insertion into a
running top-k) bounds the kernel; at batch 1 ([1, 2048, 3], the unfused
path) its 16 blocks use 16 of the card's 132 SMs. The CUDA source has the
numbers.

`knn` launches the kernel for a CUDA tensor and runs `knn_plain`, the plain
PyTorch version of the same arithmetic, for a CPU tensor. `knn.launches`
counts kernel launches.
"""

from __future__ import annotations

import torch

from sp_gan_tpu_torch.ops.kernels import _build
from sp_gan_tpu_torch.ops.pairwise import self_sqdist, smallest_k

MAX_C = 128
MAX_K = 32


def _check(x: torch.Tensor, k: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, C], got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    B, N, C = x.shape
    if not 1 <= k <= N - 1:
        raise ValueError(f"k={k} outside 1..N-1={N - 1}")
    if min(B, C) < 1:
        raise ValueError(f"x must be non-empty, got shape {tuple(x.shape)}")


def check_kernel_limits(name: str, k: int, C: int = 1, B: int = 1) -> None:
    """The CUDA kernels' limits, checked before a launch: k <= 32 (the
    generator's --nk <= 64), C <= 128 channels and B <= 65535 clouds. The
    plain versions have none of them, but a CUDA tensor never falls back
    to a plain version."""
    if k > MAX_K or C > MAX_C or B > 65535:
        raise ValueError(
            f"{name} takes k <= {MAX_K} (--nk <= {2 * MAX_K}), C <= {MAX_C} "
            f"channels and B <= 65535 clouds on CUDA; got k={k} (from --nk "
            f"{2 * k}), C={C}, B={B}")


def knn_plain(x: torch.Tensor, k: int):
    """The kernel's function in plain PyTorch: the same f32 distances
    (`ops.pairwise.self_sqdist`, self at +inf) in (distance, index)
    order."""
    dist, idx = smallest_k(self_sqdist(x), k)
    return idx.to(torch.int32), dist


def knn(x: torch.Tensor, k: int):
    """x [B, N, C] float32 contiguous -> (idx [B, N, k] int32,
    dist [B, N, k] float32). Kernel A on CUDA, `knn_plain` on the CPU."""
    _check(x, k)
    if x.device.type == "cpu":
        return knn_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"knn runs on cuda or cpu, not {x.device}")
    B, N, C = x.shape
    check_kernel_limits("kernel A (knn)", k, C, B)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=x.device)
    dist = torch.empty((B, N, k), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spgan_knn(x.data_ptr(), idx.data_ptr(), dist.data_ptr(),
                            B, N, C, k, stream)
    _build.check(err, "spgan_knn")
    knn.launches += 1
    return idx, dist


knn.launches = 0
