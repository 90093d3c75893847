"""Kernel G: exact self-kNN for clouds above 8192 points,
`csrc/knn_blocked.cu`.

Replaces `sp_gan_tpu/ops/pallas/knn.py::knn_pallas_blocked`
(`_knn_blocked_kernel`), which `knn_pallas` takes for N > 8192
(`knn.py:503-506`). The function is kernel A's: idx [B, N, k] int32 and
dist [B, N, k] f32 of the k nearest other points, ascending, ties to the
lower index, on the FMA-free f32 distances of `ops/pairwise.py`. The result
is bit-identical to kernel A's and to `knn_plain`'s on every input.

Design (the CUDA source has the details and the proof):

- C <= 4 (EdgeConv1's C = 3): the CUDA cores fold every pair into one
  running list per query, as kernel A does.
- C > 4 (EdgeConv2's C = 64): a filter on the tensor cores in front of the
  exact selection. `mma.sync` TF32 computes the cross term of each tile of
  64 keys in three products (hi.hi + hi.lo + lo.hi, x = hi + lo, one f32
  accumulator); a key stays a candidate unless its estimate
  qn - 2 c~ + kn (rounded down) exceeds `tau + FILTER_NU + FILTER_MU *
  (qn + kn)` (rounded up), tau the exact distance of the query's k-th
  entry so far. Only the candidates get the exact fold and enter the
  list. A key of the exact top-k always has d <= tau, and the estimate
  lies within `FILTER_MU * (qn + kn) + FILTER_NU` of the fold's distance,
  so no such key is dropped and the list ends exactly as kernel A's: TF32
  decides which keys are folded, never a pick or a distance.
- The keys of a cloud are split into chunks only as far as filling the
  card needs (S = ceil(2048 / (B * ceil(N / 128))), at most N / 64): one
  chunk at P2's batch of 16, 16 at B = 1, N = 16384; a merge pass then
  joins the chunks' lists. A block walks its chunk from the tile of its
  own queries, so on a cloud stored in spatial order (the sphere
  template) the k-th distance falls within the first tiles.

`FILTER_MU` covers, with a factor of safety of 2.22 at 128 channels (4.30
at 64): the dropped lo.lo term and the splits' rounding (3.003 * 2^-20 of
S = sum_c |q_c k_c|), the tensor cores' f32 sums in any order with
truncation (3 Cp * 2^-22 of S, twice the bound of f32 additions), the
exact fold's own error ((Cp + 2) * 2^-24 of S), the roundings of the outer
adds (4 * 2^-24 of qn + kn), S <= (qn + kn) / 2, and operands the cores
may flush below 2^-126 (a sixteenth of the margin). `FILTER_NU` covers
flushed products and sums (2^-115 in all) by a factor of 2^14. The model
of the cores' sums follows the truncating sums measured on earlier NVIDIA
tensor cores (the source cites them); on the H100 `chip_smoke.py` sweeps
the margin down to 0 on the hard inputs, and the card test holds that a
margin of 0 breaks the result on a cloud far from the origin.

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

from sp_gan_tpu_torch.ops.kernels import _build
from sp_gan_tpu_torch.ops.kernels.knn import _check, check_kernel_limits
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist, smallest_k

# `knn_pallas` hands clouds above this many points to the blocked kernel
BLOCKED_ABOVE = 8192
# the filter's margin: a key is dropped only if its tensor-core distance
# exceeds tau + FILTER_NU + FILTER_MU * (|q|^2 + |k|^2) (csrc/knn_blocked.cu
# derives both)
FILTER_MU = 2.0 ** -12
FILTER_NU = 2.0 ** -100


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
    out = _launch(x, k, FILTER_MU, FILTER_NU, refined)
    knn_blocked.launches += 1
    return out


def _launch(x: torch.Tensor, k: int, mu: float, nu: float,
            refined: Optional[torch.Tensor] = None):
    """Kernel G on a CUDA tensor with the filter's margin mu, nu. Only
    `knn_blocked` passes the margin the source proves; the checks of that
    margin on the card pass others."""
    if x.device.type != "cuda":
        raise ValueError(f"knn_blocked runs on cuda or cpu, not {x.device}")
    B, N, C = x.shape
    check_kernel_limits("kernel G (knn_blocked)", k, C, B)
    if refined is not None and (refined.dtype != torch.int64
                                or refined.device != x.device
                                or refined.numel() != 1):
        raise ValueError("refined must be one int64 on x's device")
    lib = _build.library()
    idx = torch.empty((B, N, k), dtype=torch.int32, device=x.device)
    dist = torch.empty((B, N, k), dtype=torch.float32, device=x.device)
    # the norms and the chunks' partial lists; freeing them on return is
    # safe, since the caching allocator hands them only to work queued
    # later on this stream
    scratch = torch.empty(max(1, lib.spgan_knn_blocked_scratch(B, N, C, k)),
                          dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spgan_knn_blocked(
            x.data_ptr(), scratch.data_ptr(), idx.data_ptr(),
            dist.data_ptr(), None if refined is None else refined.data_ptr(),
            B, N, C, k, mu, nu, stream)
    _build.check(err, "spgan_knn_blocked")
    return idx, dist


knn_blocked.launches = 0
