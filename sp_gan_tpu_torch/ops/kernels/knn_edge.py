"""Kernel B: fused self-kNN + neighbor gather + edge features,
`csrc/knn_edge.cu`.

Replaces `sp_gan_tpu/ops/pallas/knn.py::knn_edge_pallas`
(`_knn_edge_kernel`). x [B, N, C] -> (ee, idx): ee is `nbr - central`
[B, N, k, C] with `diff_only`, else `[central, nbr - central]`
[B, N, k, 2C], in `out_dtype` (float32 or bfloat16, default x's); idx is
[B, N, k] int32. Selection always runs on f32 distances:

- `select_mode="exact"`: ascending (distance, index);
- `select_mode="packed"`: ascending int32 key made of the bits of
  max(distance, 0) with the low ceil(log2 N) bits replaced by the column
  index, so neighbors whose distances share a quantum order by index.

The JAX kernel's `dist_mode="bf16_3x"` emulates f32 on the TPU's matrix
unit; it does not apply here, where every distance is true f32.

The selection is kernels A and G's engine (`csrc/knn_filter.cuh`; `knn.py`
has the design): at C <= 4 the CUDA cores fold every pair, above a TF32
tensor-core filter with the margin `FILTER_MU`, `FILTER_NU` decides which
keys get the exact fold. In packed mode the filter compares with tau_q, the
largest float that shares the k-th key's high bits, not with its distance:
a key past that distance but in the same quantum, with a lower column,
still comes first. Once a block's lists are whole, it writes the edge rows.

On an H100 at the serving shape [64, 2048, 64] -> f32 `[central, nbr -
central]`, k=10, the bound is the larger of the filter's three TF32
products (103 GFLOP, 0.208 ms) and the 0.71 GB of input and output (0.212
ms); `chip_smoke.py` adds the exact folds the call counts (`refined=`).

`knn_edge` launches the kernel for a CUDA tensor and runs `knn_edge_plain`,
the plain PyTorch version of the same arithmetic, for a CPU tensor.
`knn_edge.launches` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from sp_gan_tpu_torch.ops.kernels import _build
from sp_gan_tpu_torch.ops.kernels.knn import (FILTER_MU, FILTER_NU, _check,
                                              check_kernel_limits,
                                              check_refined)
from sp_gan_tpu_torch.ops.pairwise import self_sqdist, smallest_k

SELECT_MODES = ("exact", "packed")
OUT_DTYPES = (torch.float32, torch.bfloat16)


def _out_dtype(x: torch.Tensor, out_dtype, select_mode: str) -> torch.dtype:
    if select_mode not in SELECT_MODES:
        raise ValueError(f"select_mode must be one of {SELECT_MODES}, "
                         f"got {select_mode!r}")
    cd = out_dtype or x.dtype
    if cd not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {OUT_DTYPES}, got {cd}")
    return cd


def packed_bits(n: int) -> int:
    """Low bits of the packed key that hold the column index."""
    return max((n - 1).bit_length(), 1)


def select_plain(d: torch.Tensor, k: int, select_mode: str) -> torch.Tensor:
    """[B, N, N] f32 distances (self already +inf) -> [B, N, k] int64
    neighbor indices in the kernel's order."""
    if select_mode == "exact":
        return smallest_k(d, k)[1]
    n = d.shape[-1]
    low = (1 << packed_bits(n)) - 1
    cols = torch.arange(n, dtype=torch.int32, device=d.device)
    dpos = torch.where(d < 0, 0.0, d)          # keeps NaN, like the kernel
    keys = (dpos.view(torch.int32) & ~low) | cols
    sel = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
    return (sel & low).long()


def edges_from_idx(x: torch.Tensor, idx: torch.Tensor, cd: torch.dtype,
                   diff_only: bool) -> torch.Tensor:
    """Edge features of f32 x [B, N, C] at neighbor indices idx [B, N, k]:
    `bf16/f32(nbr) - bf16/f32(central)`, with `central` in front unless
    `diff_only`."""
    B = x.shape[0]
    nbr = x[torch.arange(B, device=x.device)[:, None, None], idx.long()]
    central = x.to(cd)[:, :, None, :]
    diff = nbr.to(cd) - central
    if diff_only:
        return diff
    return torch.cat([central.expand_as(diff), diff], dim=-1)


def knn_edge_plain(x: torch.Tensor, k: int, out_dtype=None,
                   diff_only: bool = False, select_mode: str = "exact"):
    """The kernel's function in plain PyTorch: the same f32 distances
    (`ops.pairwise.self_sqdist`), the same selection order and the same
    edge rounding."""
    cd = _out_dtype(x, out_dtype, select_mode)
    x32 = x.float()
    idx = select_plain(self_sqdist(x32), k, select_mode)
    return edges_from_idx(x32, idx, cd, diff_only), idx.to(torch.int32)


def knn_edge(x: torch.Tensor, k: int, out_dtype: Optional[torch.dtype] = None,
             diff_only: bool = False, select_mode: str = "exact",
             refined: Optional[torch.Tensor] = None):
    """x [B, N, C] float32 contiguous -> (ee, idx), see the module
    docstring. Kernel B on CUDA, `knn_edge_plain` on the CPU. `refined`,
    an int64 CUDA tensor of one element, gets the count of (query, key)
    pairs the kernel folded exactly added to it."""
    _check(x, k)
    cd = _out_dtype(x, out_dtype, select_mode)
    if x.device.type == "cpu":
        return knn_edge_plain(x, k, cd, diff_only, select_mode)
    out = _launch(x, k, cd, diff_only, select_mode, FILTER_MU, FILTER_NU,
                  refined)
    knn_edge.launches += 1
    return out


def _launch(x: torch.Tensor, k: int, cd: torch.dtype, diff_only: bool,
            select_mode: str, mu: float, nu: float,
            refined: Optional[torch.Tensor] = None):
    """Kernel B on a CUDA tensor with the filter's margin mu, nu. Only
    `knn_edge` passes the margin the source proves; the checks of that
    margin on the card pass others."""
    if x.device.type != "cuda":
        raise ValueError(f"knn_edge runs on cuda or cpu, not {x.device}")
    B, N, C = x.shape
    check_kernel_limits("kernel B (knn_edge)", k, C, B)
    check_refined(refined, x)
    ec = C if diff_only else 2 * C
    ee = torch.empty((B, N, k, ec), dtype=cd, device=x.device)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=x.device)
    lib = _build.library()
    # the norms and the chunks' partial lists, freed on return as in
    # knn.py
    scratch = torch.empty(max(1, lib.spgan_knn_edge_scratch(B, N, C, k)),
                          dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spgan_knn_edge(
            x.data_ptr(), scratch.data_ptr(), ee.data_ptr(), idx.data_ptr(),
            None if refined is None else refined.data_ptr(), B, N, C, k,
            int(diff_only), int(select_mode == "packed"),
            int(cd == torch.bfloat16), mu, nu, stream)
    _build.check(err, "spgan_knn_edge")
    return ee, idx


knn_edge.launches = 0
