"""Kernel A: exact self-kNN, `csrc/knn.cu`.

Replaces `sp_gan_tpu/ops/pallas/knn.py::knn_pallas` (`_knn_kernel`): for
each point of each cloud, the k nearest other points of the same cloud by
f32 squared distance, ascending, ties to the lower index, self masked to
+inf. Returns idx [B, N, k] int32 and dist [B, N, k] f32.

Kernels A and G (`knn_blocked.py`, above 8192 points) are one code path,
the selection engine of `csrc/knn_filter.cuh`, whose header has the design
and the proof:

- C <= 4 (EdgeConv1's C = 3): the CUDA cores fold every pair into one
  running list per query, walked from the tile of the block's own
  queries, so on a cloud stored in spatial order (the sphere template) the
  list's k-th distance falls within the first tiles.
- C > 4 (EdgeConv2's C = 64): a filter on the tensor cores in front of the
  exact selection. `mma.sync` TF32 computes the cross term of each tile of
  64 or 32 keys in three products (hi.hi + hi.lo + lo.hi, x = hi + lo, one f32
  accumulator); a key stays a candidate unless its estimate
  qn - 2 c~ + kn (rounded down) exceeds `tau + FILTER_NU + FILTER_MU *
  (qn + kn)` (rounded up), tau the exact distance of the query's k-th
  entry so far. Only the candidates get the exact fold and enter the
  list. A key of the exact top-k always has d <= tau, and the estimate
  lies within `FILTER_MU * (qn + kn) + FILTER_NU` of the fold's distance,
  so no such key is dropped and the list ends exactly as the plain
  version's: TF32 decides which keys are folded, never a pick or a
  distance.
- The keys of a cloud are split into chunks only as far as filling the
  card needs; a merge pass then joins the chunks' lists.

`FILTER_MU` covers, with a factor of safety of 2.22 at 128 channels (4.30
at 64): the dropped lo.lo term and the splits' rounding (3.003 * 2^-20 of
S = sum_c |q_c k_c|), the tensor cores' f32 sums in any order with
truncation (3 Cp * 2^-22 of S, twice the bound of f32 additions), the
exact fold's own error ((Cp + 2) * 2^-24 of S), the roundings of the outer
adds (4 * 2^-24 of qn + kn), S <= (qn + kn) / 2, and operands the cores
may flush below 2^-126 (a sixteenth of the margin). `FILTER_NU` covers
flushed products and sums (2^-115 in all) by a factor of 2^14. Kernel B
(`knn_edge.py`) takes the same margin in both of its selection orders.

`knn` launches the kernel for a CUDA tensor and runs `knn_plain`, the plain
PyTorch version of the same arithmetic, for a CPU tensor. `knn.launches`
counts the calls that launch it (norms, selection and merge are one
launch of the function).
"""

from __future__ import annotations

from typing import Optional

import torch

from sp_gan_tpu_torch.ops.kernels import _build
from sp_gan_tpu_torch.ops.pairwise import self_sqdist, smallest_k

MAX_C = 128
MAX_K = 32
# the filter's margin, the one definition for kernels A, B and G: a key is
# dropped only if its tensor-core distance exceeds tau + FILTER_NU +
# FILTER_MU * (|q|^2 + |k|^2) (csrc/knn_filter.cuh derives both)
FILTER_MU = 2.0 ** -12
FILTER_NU = 2.0 ** -100


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


def check_refined(refined: Optional[torch.Tensor], x: torch.Tensor) -> None:
    if refined is not None and (refined.dtype != torch.int64
                                or refined.device != x.device
                                or refined.numel() != 1):
        raise ValueError("refined must be one int64 on x's device")


def knn(x: torch.Tensor, k: int, refined: Optional[torch.Tensor] = None):
    """x [B, N, C] float32 contiguous -> (idx [B, N, k] int32,
    dist [B, N, k] float32). Kernel A on CUDA, `knn_plain` on the CPU.
    `refined`, an int64 CUDA tensor of one element, gets the count of
    (query, key) pairs the kernel folded exactly added to it."""
    _check(x, k)
    if x.device.type == "cpu":
        return knn_plain(x, k)
    out = _launch(x, k, FILTER_MU, FILTER_NU, refined, "kernel A (knn)")
    knn.launches += 1
    return out


def _launch(x: torch.Tensor, k: int, mu: float, nu: float,
            refined: Optional[torch.Tensor] = None,
            name: str = "kernel A (knn)"):
    """The selection of kernels A and G on a CUDA tensor with the filter's
    margin mu, nu. Only the wrappers pass the margin the source proves;
    the checks of that margin on the card pass others."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    B, N, C = x.shape
    check_kernel_limits(name, k, C, B)
    check_refined(refined, x)
    lib = _build.library()
    idx = torch.empty((B, N, k), dtype=torch.int32, device=x.device)
    dist = torch.empty((B, N, k), dtype=torch.float32, device=x.device)
    # the norms and the chunks' partial lists; freeing them on return is
    # safe, since the caching allocator hands them only to work queued
    # later on this stream
    scratch = torch.empty(max(1, lib.spgan_knn_scratch(B, N, C, k)),
                          dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spgan_knn(
            x.data_ptr(), scratch.data_ptr(), idx.data_ptr(),
            dist.data_ptr(), None if refined is None else refined.data_ptr(),
            B, N, C, k, mu, nu, stream)
    _build.check(err, "spgan_knn")
    return idx, dist


knn.launches = 0
