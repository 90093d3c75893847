"""Edge features for the generator's EdgeConvs, the port of
`sp_gan_tpu/ops/edge.py`.

Channel-last like the JAX package: x [B, N, C] -> [B, N, k, C] diffs
`nbr - central`, or [B, N, k, 2C] `[central, nbr - central]`.

With idx=None, an eligible input runs the fused kNN + gather kernel (kernel
B, `ops/kernels/knn_edge.py`); any other input selects with kernel A
(`ops/dispatch.knn`) and gathers in PyTorch. Gradients: the diff-only fused
op is a `torch.autograd.Function` whose backward is kernel D
(`ops/kernels/scatter.py`), the counterpart of the JAX `_knn_edge_diff`
VJP; the gather's backward is an `index_add_` by target (the JAX
`scatter_rows`). The concat-form fused op (serving only) carries no
gradient. Eligibility is the JAX rule of
`_use_fused_knn_edge` (N % 8 == 0, N <= 8192, N*C*4 <= 8 MiB, C >= 16)
minus its TPU condition, plus the port's own limits: the CUDA kernels take
C <= 128 and k <= 32, and kernel B no N limit beyond those. Selection order
comes from env `SPGAN_KNN_SELECT` (packed, the default, or exact), as in
the JAX package; `SPGAN_DIST_MODE` does not apply, distances are always
true f32.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from sp_gan_tpu_torch.ops.dispatch import knn as knn_dispatch
from sp_gan_tpu_torch.ops.kernels.knn import MAX_C, MAX_K
from sp_gan_tpu_torch.ops.kernels.knn_edge import knn_edge
from sp_gan_tpu_torch.ops.kernels.scatter import (scatter_diff_bwd,
                                                  scatter_rows)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    B = x.shape[0]
    return x[torch.arange(B, device=x.device)[:, None, None], idx.long()]


class _GatherNeighbors(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n, ctx.dtype = x.shape[1], x.dtype
        return _gather(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_rows(g, idx, ctx.n).to(ctx.dtype), None


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C], idx [B, N, k] -> neighbor rows [B, N, k, C]. The
    backward scatters the rows' gradient by target (`scatter_rows`)."""
    return _GatherNeighbors.apply(x, idx)


def use_fused_knn_edge(x: torch.Tensor, k: int) -> bool:
    B, N, C = x.shape
    return (N % 8 == 0 and N <= 8192 and N * C * 4 <= (8 << 20)
            and 16 <= C <= MAX_C and k <= MAX_K)


def knn_select_mode() -> str:
    """Selection order of the fused kernel, from env SPGAN_KNN_SELECT."""
    mode = os.environ.get("SPGAN_KNN_SELECT", "packed")
    if mode not in ("packed", "exact"):
        raise ValueError(f"SPGAN_KNN_SELECT must be packed|exact, "
                         f"got {mode!r}")
    return mode


def _fused(x, k, out_dtype, diff_only):
    with torch.no_grad():
        return knn_edge(x.detach().float().contiguous(), k,
                        out_dtype=out_dtype or x.dtype, diff_only=diff_only,
                        select_mode=knn_select_mode())


class EdgeDiff(torch.autograd.Function):
    """The diff-only fused op under autograd: forward kernel B
    (`diff_only=True`, selection from SPGAN_KNN_SELECT), backward kernel D
    on the saved indices, cast to x's dtype. kNN selection is piecewise
    constant and carries no gradient. Under `no_grad`, or for an x that
    needs no gradient, autograd keeps no node and nothing is saved."""

    @staticmethod
    def forward(ctx, x, k, out_dtype):
        diff, idx = _fused(x, k, out_dtype, diff_only=True)
        ctx.save_for_backward(idx)
        ctx.dtype = x.dtype
        ctx.mark_non_differentiable(idx)
        return diff, idx

    @staticmethod
    def backward(ctx, d_diff, d_idx):
        (idx,) = ctx.saved_tensors
        d_x = scatter_diff_bwd(d_diff.contiguous(), idx)
        return d_x.to(ctx.dtype), None, None


def edge_diff_fused(x: torch.Tensor, k: int,
                    out_dtype: Optional[torch.dtype] = None):
    """(diff [B, N, k, C], idx [B, N, k] int32) from kernel B,
    differentiable in x through kernel D (`EdgeDiff`)."""
    return EdgeDiff.apply(x, k, out_dtype)


def edge_diff_features(x: torch.Tensor, k: int,
                       idx: Optional[torch.Tensor] = None,
                       out_dtype: Optional[torch.dtype] = None,
                       window: Optional[int] = None) -> torch.Tensor:
    """[B, N, C] -> `nbr - central` [B, N, k, C] in `out_dtype` (default
    x's), neighbors self-excluded and ascending, selected on f32 distances.
    `window` (the JAX package's `--knn_mode approx` band) is not ported."""
    if window is not None:
        raise NotImplementedError("banded kNN (knn_mode=approx) is not "
                                  "ported yet")
    if idx is None and use_fused_knn_edge(x, k):
        return edge_diff_fused(x, k, out_dtype)[0]
    if idx is None:
        idx = knn_dispatch(x, k)
    if out_dtype is not None:
        x = x.to(out_dtype)
    return gather_neighbors(x, idx) - x[:, :, None, :]


def edge_features(x: torch.Tensor, k: int,
                  idx: Optional[torch.Tensor] = None,
                  return_idx: bool = False,
                  out_dtype: Optional[torch.dtype] = None):
    """[B, N, C] -> `[central, nbr - central]` [B, N, k, 2C] (and idx with
    `return_idx`), the reference's `get_edge_features`. The fused form
    (idx=None) is the serving path's and carries no gradient."""
    if idx is None and use_fused_knn_edge(x, k):
        ee, idx = _fused(x, k, out_dtype, diff_only=False)
        return (ee, idx) if return_idx else ee
    if idx is None:
        idx = knn_dispatch(x, k)
    if out_dtype is not None:
        x = x.to(out_dtype)
    nbrs = gather_neighbors(x, idx)
    central = x[:, :, None, :].expand_as(nbrs)
    ee = torch.cat([central, nbrs - central], dim=-1)
    return (ee, idx) if return_idx else ee
