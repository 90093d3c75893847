"""Kernel F: banded self-kNN + neighbor gather + edge features,
`csrc/knn_edge_window.cu`.

Replaces `sp_gan_tpu/ops/pallas/knn.py::knn_edge_window_pallas`
(`_knn_edge_window_kernel`), the `--knn_mode approx` twin of kernel B.
x [B, N, C] -> (ee, idx) as `knn_edge` returns them, except that each
query's candidates are exactly the circular index band of offsets
0 < |o| <= W around it and idx holds GLOBAL indices (mod N). W is
`window` clamped to (N - tq) // 2, as in the JAX function, where tq is the
JAX kernel's query tile (256 unless given, halved until it divides N); a
clamped W below k raises. Selection runs on f32 distances:

- `select_mode="exact"`: ascending (distance, band position), so ties go
  to the lower offset;
- `select_mode="packed"`: the int32 key of kernel B with the band position
  in its low bit_length(tq + 2W - 1) bits, the JAX kernel's quantum.

Above 4 channels the selection is kernels A, B and G's engine
(`csrc/knn_filter.cuh`) on the band: a TF32 tensor-core filter with the
margin `FILTER_MU`, `FILTER_NU` decides which of a query's band keys get the
exact f32 fold, and in packed mode compares with tau_q, the top of the k-th
key's quantum under F's low mask; at C <= 4 every band pair is folded on
the CUDA cores. Every pick and distance is the fold's, so the result is
bit-equal to the plain version. On an H100 at the P1 training shape [4,
8192, 64] -> bf16 diffs, k=10, W=512, the filter's TF32 products and the
exact folds the call counts (`refined=`) bound it; the CUDA source has
the numbers.

`knn_edge_window` launches the kernel for a CUDA tensor and runs
`knn_edge_window_plain`, the plain PyTorch version of the same arithmetic
(`ops.approx_knn.band_select`), for a CPU tensor.
`knn_edge_window.launches` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from sp_gan_tpu_torch.ops.approx_knn import band_select
from sp_gan_tpu_torch.ops.kernels import _build
from sp_gan_tpu_torch.ops.kernels.knn import (FILTER_MU, FILTER_NU, _check,
                                              check_kernel_limits,
                                              check_refined)
from sp_gan_tpu_torch.ops.kernels.knn_edge import _out_dtype, edges_from_idx


def jax_tile(n: int, tq: int = 256) -> int:
    """The JAX kernel's query tile: `tq` halved until it divides n."""
    while n % tq:
        tq //= 2
    return tq


def window_geometry(n: int, k: int, window: int, tq: int = 256):
    """(W, low_mask) of the JAX kernel at n points: W = min(window,
    (n - tq) // 2) for its tile tq, and the packed key's column mask
    (1 << bit_length(tq + 2W - 1)) - 1. Raises when W < k."""
    tq = jax_tile(n, tq)
    W = int(min(window, (n - tq) // 2))
    if W < k:
        raise ValueError(f"band W={W} (window {window} clamped to (N - tq) "
                         f"// 2 at N={n}, tq={tq}) is below k={k}")
    bits = max((tq + 2 * W - 1).bit_length(), 1)
    return W, (1 << bits) - 1


def knn_edge_window_plain(x: torch.Tensor, k: int, window: int,
                          out_dtype=None, tq: int = 256,
                          diff_only: bool = False,
                          select_mode: str = "exact"):
    """The kernel's function in plain PyTorch: the same f32 distances, the
    same selection order and the same edge rounding."""
    cd = _out_dtype(x, out_dtype, select_mode)
    x32 = x.float()
    W, low_mask = window_geometry(x.shape[1], k, window, tq)
    idx = band_select(x32, k, W, select_mode, low_mask)
    return edges_from_idx(x32, idx, cd, diff_only), idx.to(torch.int32)


def knn_edge_window(x: torch.Tensor, k: int, window: int,
                    out_dtype: Optional[torch.dtype] = None, tq: int = 256,
                    diff_only: bool = False, select_mode: str = "exact",
                    refined: Optional[torch.Tensor] = None):
    """x [B, N, C] float32 contiguous -> (ee, idx), see the module
    docstring. Kernel F on CUDA, `knn_edge_window_plain` on the CPU.
    `refined`, an int64 CUDA tensor of one element, gets the count of
    (query, key) pairs the kernel folded exactly added to it."""
    _check(x, k)
    cd = _out_dtype(x, out_dtype, select_mode)
    if x.device.type == "cpu":
        return knn_edge_window_plain(x, k, window, cd, tq, diff_only,
                                     select_mode)
    out = _launch(x, k, window, cd, tq, diff_only, select_mode, FILTER_MU,
                  FILTER_NU, refined)
    knn_edge_window.launches += 1
    return out


def _launch(x: torch.Tensor, k: int, window: int, cd: torch.dtype, tq: int,
            diff_only: bool, select_mode: str, mu: float, nu: float,
            refined: Optional[torch.Tensor] = None):
    """Kernel F on a CUDA tensor with the filter's margin mu, nu. Only
    `knn_edge_window` passes the margin the source proves; the checks of
    that margin on the card pass others."""
    if x.device.type != "cuda":
        raise ValueError(f"knn_edge_window runs on cuda or cpu, not "
                         f"{x.device}")
    B, N, C = x.shape
    check_kernel_limits("kernel F (knn_edge_window)", k, C, B)
    check_refined(refined, x)
    W, low_mask = window_geometry(N, k, window, tq)
    ec = C if diff_only else 2 * C
    ee = torch.empty((B, N, k, ec), dtype=cd, device=x.device)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=x.device)
    lib = _build.library()
    # the norms and the partial lists, freed on return as in knn.py
    scratch = torch.empty(
        max(1, lib.spgan_knn_edge_window_scratch(B, N, C, k, W)),
        dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spgan_knn_edge_window(
            x.data_ptr(), scratch.data_ptr(), ee.data_ptr(), idx.data_ptr(),
            None if refined is None else refined.data_ptr(), B, N, C, k, W,
            low_mask, int(diff_only), int(select_mode == "packed"),
            int(cd == torch.bfloat16), mu, nu, stream)
    _build.check(err, "spgan_knn_edge_window")
    return ee, idx


knn_edge_window.launches = 0
