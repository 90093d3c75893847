"""Kernel G: exact self-kNN for clouds above 8192 points, `csrc/knn.cu`.

Replaces `sp_gan_tpu/ops/pallas/knn.py::knn_pallas_blocked`
(`_knn_blocked_kernel`), which `knn_pallas` takes for N > 8192
(`knn.py:503-506`). The function is kernel A's: idx [B, N, k] int32 and
dist [B, N, k] f32 of the k nearest other points, ascending, ties to the
lower index, on the FMA-free f32 distances of `ops/pairwise.py`. The result
is bit-identical to kernel A's and to `knn_plain`'s on every input.

Kernels A and G are one code path (`csrc/knn.cu` on the selection engine
of `csrc/knn_filter.cuh`; `knn.py` has the design and the filter's margin,
`FILTER_MU` and `FILTER_NU`): the CUDA cores fold every pair at C <= 4, a
TF32 tensor-core filter decides which keys get the exact fold above. G is
the route `knn_pallas` takes above `BLOCKED_ABOVE` points, with its own
launch count and a plain version that chunks the queries.

What bounds it on an H100: at P2's EdgeConv2 call [16, 16384, 64] the
three TF32 products (1.65 TFLOP, 3.3 ms at 495 TFLOP/s); at EdgeConv1's
[16, 16384, 3] the exact fold of every pair (9 f32 operations a pair, 1.2
ms at 33.5 Tops/s). `chip_smoke.py` counts the pairs a call refines
(`refined=`) and bounds it by that count.

`knn_blocked` launches the kernel for a CUDA tensor and runs
`knn_blocked_plain` for a CPU tensor: `knn_plain` on chunks of queries,
since the [B, N, N] distances of a large cloud would not fit in memory
(17 GB at [16, 16384, 16384]). `knn_blocked.launches` counts calls that
launch the kernel (norms, selection and merge are one launch of the
function).
"""

from __future__ import annotations

from typing import Optional

import torch

from sp_gan_tpu_torch.ops.kernels.knn import (FILTER_MU, FILTER_NU,
                                              _check, _launch)
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


def knn_blocked(x: torch.Tensor, k: int,
                refined: Optional[torch.Tensor] = None):
    """x [B, N, C] float32 contiguous -> (idx [B, N, k] int32,
    dist [B, N, k] float32). Kernel G on CUDA, `knn_blocked_plain` on the
    CPU. `refined`, an int64 CUDA tensor of one element, gets the count of
    (query, key) pairs the kernel folded exactly added to it."""
    _check(x, k)
    if x.device.type == "cpu":
        return knn_blocked_plain(x, k)
    out = _launch(x, k, FILTER_MU, FILTER_NU, refined,
                  "kernel G (knn_blocked)")
    knn_blocked.launches += 1
    return out


knn_blocked.launches = 0
