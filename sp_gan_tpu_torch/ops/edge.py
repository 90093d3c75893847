"""Edge features for the generator's EdgeConvs, the port of
`sp_gan_tpu/ops/edge.py`.

Channel-last like the JAX package: x [B, N, C] -> [B, N, k, C] diffs
`nbr - central`, or [B, N, k, 2C] `[central, nbr - central]`.

With idx=None, an eligible input runs the fused kNN + gather kernel (kernel
B, `ops/kernels/knn_edge.py`); any other input selects with kernel A, or
kernel G above 8192 points (`ops/dispatch.knn`), and gathers in PyTorch.
`window` (`--knn_mode approx`) restricts the selection to a circular index
band: an eligible input runs the banded fused kernel F
(`ops/kernels/knn_edge_window.py`), any other input the plain band
selection `ops/approx_knn.knn_indices_window` and the gather, as the JAX
package runs it in XLA. Gradients: the fused ops are
`torch.autograd.Function`s whose backward is kernel D
(`ops/kernels/scatter.py`): the diff-only ones are the counterparts of the
JAX `_knn_edge_diff` and `_knn_edge_diff_window` VJPs, the concat form
(`EdgeConcat`, which the fused training forward differentiates) of the
default branch of `_knn_edge`'s VJP, or with SPGAN_EDGE_BWD=pallas of its
kernel M branch; the gather's backward is
`scatter_rows` (kernel H where the JAX package calls its Pallas scatter,
else `index_add_`). Eligibility is the JAX rule of
`_use_fused_knn_edge` (N % 8 == 0, N <= 8192, N*C*4 <= 8 MiB, C >= 16)
minus its TPU condition, plus the port's own limits: the CUDA kernels take
C <= 128 and k <= 64, and kernel B no N limit beyond those. Selection order
comes from env `SPGAN_KNN_SELECT` (packed, the default, or exact), as in
the JAX package; `SPGAN_DIST_MODE` does not apply, distances are always
true f32.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from sp_gan_tpu_torch.ops.approx_knn import knn_indices_window
from sp_gan_tpu_torch.ops.dispatch import knn as knn_dispatch
from sp_gan_tpu_torch.ops.kernels.knn import MAX_C, MAX_K
from sp_gan_tpu_torch.ops.kernels.knn_edge import knn_edge
from sp_gan_tpu_torch.ops.kernels.knn_edge_window import (jax_tile,
                                                          knn_edge_window)
from sp_gan_tpu_torch.ops.kernels.scatter import (edge_scatter_bwd,
                                                  scatter_diff_bwd,
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


def edge_bwd_mode() -> str:
    """Backward of the concat-form fused op, from env SPGAN_EDGE_BWD as in
    the JAX package: xla (the default) or pallas (kernel M)."""
    mode = os.environ.get("SPGAN_EDGE_BWD", "xla")
    if mode not in ("xla", "pallas"):
        raise ValueError(f"SPGAN_EDGE_BWD must be xla|pallas, got {mode!r}")
    return mode


def _fused(x, k, out_dtype, diff_only):
    with torch.no_grad():
        return knn_edge(x.detach().float().contiguous(), k,
                        out_dtype=out_dtype or x.dtype, diff_only=diff_only,
                        select_mode=knn_select_mode())


class EdgeConcat(torch.autograd.Function):
    """The concat-form fused op under autograd: forward kernel B
    (`[central, nbr - central]`, selection from SPGAN_KNN_SELECT), backward
    the default branch of the JAX `_knn_edge` VJP: the central half
    collects sum_k(d[..., :C] - d[..., C:]) at its own row and the
    neighbor half scatters through the indices. The scatter is kernel D on
    the neighbor half (which subtracts that half's own sum over k in f32,
    added back here). As in JAX, the central sum, the scatter and their
    sum are each in the edges' type before the cast to x's. Kernel D reads
    the neighbor half in place, at its row stride of 2C. With
    SPGAN_EDGE_BWD=pallas and N % 8 == 0 the backward is instead the JAX
    branch that calls `edge_scatter_bwd_pallas` (`sp_gan_tpu/ops/edge.py:
    147-155`): kernel M, f32 sums whatever the edges' type, cast to x's
    type once. kNN selection carries no gradient."""

    @staticmethod
    def forward(ctx, x, k, out_dtype):
        ee, idx = _fused(x, k, out_dtype, diff_only=False)
        ctx.save_for_backward(idx)
        ctx.dtype = x.dtype
        ctx.mark_non_differentiable(idx)
        return ee, idx

    @staticmethod
    def backward(ctx, d_ee, d_idx):
        (idx,) = ctx.saved_tensors
        if edge_bwd_mode() == "pallas" and d_ee.shape[1] % 8 == 0:
            return (edge_scatter_bwd(d_ee.contiguous(), idx).to(ctx.dtype),
                    None, None)
        d_ee = d_ee.contiguous()
        C = d_ee.shape[-1] // 2
        d_nbr = d_ee[..., C:]   # rows at a stride of 2C, which D reads
        d_central = (d_ee[..., :C] - d_nbr).sum(dim=2)
        scattered = (scatter_diff_bwd(d_nbr, idx)
                     + d_nbr.float().sum(dim=2)).to(d_ee.dtype)
        return (d_central + scattered).to(ctx.dtype), None, None


def edge_concat_fused(x: torch.Tensor, k: int,
                      out_dtype: Optional[torch.dtype] = None):
    """(ee [B, N, k, 2C], idx [B, N, k] int32) from kernel B, differentiable
    in x through kernel D (`EdgeConcat`)."""
    return EdgeConcat.apply(x, k, out_dtype)


def normalize_window(n: int, k: int, window: int) -> Optional[int]:
    """The band the JAX `edge_diff_features` uses at n points, or None for
    the exact path: `window` clamped to (n - tq) // 2, the fused kernel's
    slices at its tile tq = 256 (halved until it divides n), and to
    (n - 1) // 2, which keeps a circular band free of duplicates; a band
    narrower than k means exact selection."""
    W = min(int(window), (n - jax_tile(n)) // 2, (n - 1) // 2)
    return W if W >= k else None


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


class EdgeDiffWindow(torch.autograd.Function):
    """`EdgeDiff` on the band: forward kernel F (`diff_only=True`, the JAX
    tile tq=256, selection from SPGAN_KNN_SELECT), backward kernel D on
    its global indices, as the JAX `_knn_edge_diff_window` reuses
    `_knn_edge_diff`'s backward."""

    @staticmethod
    def forward(ctx, x, k, window, out_dtype):
        with torch.no_grad():
            diff, idx = knn_edge_window(
                x.detach().float().contiguous(), k, window,
                out_dtype=out_dtype or x.dtype, diff_only=True,
                select_mode=knn_select_mode())
        ctx.save_for_backward(idx)
        ctx.dtype = x.dtype
        ctx.mark_non_differentiable(idx)
        return diff, idx

    @staticmethod
    def backward(ctx, d_diff, d_idx):
        return EdgeDiff.backward(ctx, d_diff, d_idx) + (None,)


def edge_diff_window(x: torch.Tensor, k: int, window: int,
                     out_dtype: Optional[torch.dtype] = None):
    """(diff [B, N, k, C], idx [B, N, k] int32 global) from kernel F on
    the band of half-width `window`, differentiable in x through kernel D
    (`EdgeDiffWindow`)."""
    return EdgeDiffWindow.apply(x, k, window, out_dtype)


def edge_diff_features(x: torch.Tensor, k: int,
                       idx: Optional[torch.Tensor] = None,
                       out_dtype: Optional[torch.dtype] = None,
                       window: Optional[int] = None) -> torch.Tensor:
    """[B, N, C] -> `nbr - central` [B, N, k, C] in `out_dtype` (default
    x's), neighbors self-excluded and ascending, selected on f32 distances.
    `window` (with idx=None) restricts the selection to the circular index
    band |i - j| <= window (`--knn_mode approx`), normalized once by
    `normalize_window` so that kernel F and the plain band see the same
    band."""
    if window is not None:
        window = normalize_window(x.shape[1], k, window)
    if idx is None and use_fused_knn_edge(x, k):
        if window is not None:
            return edge_diff_window(x, k, window, out_dtype)[0]
        return edge_diff_fused(x, k, out_dtype)[0]
    if idx is None and window is not None:
        idx = knn_indices_window(x, k, window)
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
    `return_idx`), the reference's `get_edge_features`, in `out_dtype`
    (default x's). With idx=None an eligible input takes the fused op
    (`edge_concat_fused`), differentiable in x."""
    if idx is None and use_fused_knn_edge(x, k):
        ee, idx = edge_concat_fused(x, k, out_dtype)
        return (ee, idx) if return_idx else ee
    if idx is None:
        idx = knn_dispatch(x, k)
    if out_dtype is not None:
        x = x.to(out_dtype)
    nbrs = gather_neighbors(x, idx)
    central = x[:, :, None, :].expand_as(nbrs)
    ee = torch.cat([central, nbrs - central], dim=-1)
    return (ee, idx) if return_idx else ee
