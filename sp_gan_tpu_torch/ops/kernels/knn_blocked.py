"""Kernel G: exact self-kNN with the key axis split across thread blocks,
`csrc/knn_blocked.cu`, for clouds above 8192 points.

Replaces `sp_gan_tpu/ops/pallas/knn.py::knn_pallas_blocked`
(`_knn_blocked_kernel`), which `knn_pallas` takes for N > 8192
(`knn.py:503-506`). The function is kernel A's: idx [B, N, k] int32 and
dist [B, N, k] f32 of the k nearest other points, ascending, ties to the
lower index. A first pass scans chunks of 2048 keys in parallel and keeps
each chunk's k best per query; a second merges them. The result is
bit-identical to kernel A's and to `knn_plain`'s on every input.

On an H100 at P2's EdgeConv2 shape [16, 16384, 64], k=10, the distances
are 550 GFLOP of f32 arithmetic, so operations bound it (8.2 ms at 67
TFLOP/s); the CUDA source has the numbers.

`knn_blocked` launches the kernel for a CUDA tensor and runs
`knn_blocked_plain` for a CPU tensor: `knn_plain` on chunks of queries,
since the [B, N, N] distances of a large cloud would not fit in memory
(17 GB at [16, 16384, 16384]). `knn_blocked.launches` counts kernel
launches (one per call: both passes are one launch of the function).
"""

from __future__ import annotations

import torch

from sp_gan_tpu_torch.ops.kernels import _build
from sp_gan_tpu_torch.ops.kernels.knn import _check, check_kernel_limits
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist, smallest_k

# `knn_pallas` hands clouds above this many points to the blocked kernel
BLOCKED_ABOVE = 8192


def knn_blocked_plain(x: torch.Tensor, k: int, block: int = 1024):
    """`knn_plain` on `block` queries at a time: the same f32 distances of
    each query to every point (self at +inf) in (distance, index) order,
    so the result equals `knn_plain`'s bit for bit."""
    B, N, _ = x.shape
    idx, dist = [], []
    for q0 in range(0, N, block):
        q1 = min(N, q0 + block)
        d = pairwise_sqdist(x[:, q0:q1], x)                  # [B, Q, N]
        q = torch.arange(q1 - q0, device=x.device)
        d[:, q, q0 + q] = float("inf")
        v, i = smallest_k(d, k)
        idx.append(i.to(torch.int32))
        dist.append(v)
    return torch.cat(idx, dim=1), torch.cat(dist, dim=1)


def knn_blocked(x: torch.Tensor, k: int):
    """x [B, N, C] float32 contiguous -> (idx [B, N, k] int32,
    dist [B, N, k] float32). Kernel G on CUDA, `knn_blocked_plain` on the
    CPU."""
    _check(x, k)
    if x.device.type == "cpu":
        return knn_blocked_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"knn_blocked runs on cuda or cpu, not {x.device}")
    B, N, C = x.shape
    check_kernel_limits("kernel G (knn_blocked)", k, C, B)
    lib = _build.library()
    S = lib.spgan_knn_blocked_chunks(N)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=x.device)
    dist = torch.empty((B, N, k), dtype=torch.float32, device=x.device)
    # the chunks' partial lists; freeing them on return is safe, since the
    # caching allocator hands them only to work queued later on this stream
    part = torch.empty((2, B, N, S, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spgan_knn_blocked(x.data_ptr(), part[0].data_ptr(),
                                    part[1].data_ptr(), idx.data_ptr(),
                                    dist.data_ptr(), B, N, C, k, stream)
    _build.check(err, "spgan_knn_blocked")
    knn_blocked.launches += 1
    return idx, dist


knn_blocked.launches = 0
