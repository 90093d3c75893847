"""Candidate-pruned kNN selection for large-N training (`--knn_mode
approx`), the port of `sp_gan_tpu/ops/approx_knn.py`.

The generator's second EdgeConv works in a feature space that is smooth over
the sphere template, whose fibonacci spiral puts spatial neighbors at
nearby indices. So its neighbors can be searched in a circular index band
(`knn_indices_window`) or among fixed per-point candidate lists
(`knn_indices_candidates`, e.g. the template's own kNN from
`template_candidates`) instead of over all N points.

Plain PyTorch on the tensor's device, with the distances of
`ops/pairwise.py` (true f32, a fixed fold order, no TF32): squared L2, self
excluded, ascending. Ties go to the lower candidate position, which is what
the JAX package's `top_k` gives: for the band, the lower offset -W .. W,
not the lower global index. `band_select` is also the selection of kernel
F's plain version (`ops/kernels/knn_edge_window.py`).

Queries are taken in chunks of `block` rows to bound the memory of the
gathered keys; the band's default chunk holds as many queries as keep them
within KEYS_BYTES, since on a GPU each chunk costs some 200 small launches
(at N=16384, bs=2, W=512: 9 chunks, where 256 rows a chunk made 64). A
chunk may be ragged, so unlike the JAX function the chunk does not have to
divide N (the JAX block halves until it does, down to 1 for an odd N, and
a block of 0 fails with a ZeroDivisionError); the result does not depend
on it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sp_gan_tpu_torch.ops.pairwise import knn_indices, smallest_k, sq_norms


# bytes of gathered keys in one chunk of the band's queries
KEYS_BYTES = 1 << 30


def _check_block(block: int) -> int:
    block = int(block)
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    return block


def template_candidates(template, C: int,
                        device: Optional[torch.device] = None
                        ) -> torch.Tensor:
    """Static candidate lists from the training template: each point's C
    nearest template neighbors (exact, self excluded). [N, 3] -> [N, C]
    int32 on `device` (default the template's, or the CPU for an array)."""
    t = torch.as_tensor(np.asarray(template, np.float32)
                        if not isinstance(template, torch.Tensor)
                        else template, device=device)
    return knn_indices(t[None].float(), C)[0]


def _fold_sqdist(x: torch.Tensor, q0: int, q1: int,
                 rows: torch.Tensor) -> torch.Tensor:
    """f32 x [B, N, F], queries q0 .. q1 - 1 and their key rows
    rows [q1 - q0, P] -> d [B, q1 - q0, P]: (|q|^2 - 2 q.k) + |k|^2, each
    sum folded over the channels left to right with every product and
    partial sum rounded to f32, the order of `pairwise.pairwise_sqdist`
    and of the CUDA kNN kernels."""
    xq = x[:, q0:q1]
    keys = x.transpose(1, 2)[:, :, rows]                   # [B, F, Q, P]
    norms = sq_norms(x)
    acc = xq[..., 0, None] * keys[:, 0]
    for c in range(1, x.shape[-1]):
        acc = acc + xq[..., c, None] * keys[:, c]
    return (norms[:, q0:q1, None] - acc * 2.0) + norms[:, rows]


def band_sqdist(x: torch.Tensor, W: int, q0: int, q1: int) -> torch.Tensor:
    """f32 x [B, N, F] -> d [B, q1 - q0, 2W + 1]: the distance of query i
    to row (i + p - W) mod N at band position p, the query itself (p = W)
    at +inf."""
    N = x.shape[1]
    q = torch.arange(q0, q1, device=x.device)
    rows = (q[:, None] - W + torch.arange(2 * W + 1, device=x.device)) % N
    d = _fold_sqdist(x, q0, q1, rows)
    d[..., W] = float("inf")
    return d


def band_select(x: torch.Tensor, k: int, W: int, select_mode: str = "exact",
                low_mask: Optional[int] = None,
                block: Optional[int] = None) -> torch.Tensor:
    """The k nearest of each query's circular band of offsets 0 < |o| <= W,
    as global indices [B, N, k] int64, from f32 x [B, N, F]. `exact`
    orders by (distance, band position); `packed` by the int32 key made of
    the bits of max(distance, 0) with the bits of `low_mask` replaced by
    the band position (kernel F's packed selection). `block` queries a
    chunk, by default as many as keep the keys within KEYS_BYTES."""
    B, N, F = x.shape
    P = 2 * W + 1
    if block is None:
        block = max(1, KEYS_BYTES // (4 * B * F * P))
    block = _check_block(block)
    pos = torch.arange(P, dtype=torch.int32, device=x.device)
    out = []
    for q0 in range(0, N, block):
        q1 = min(N, q0 + block)
        d = band_sqdist(x, W, q0, q1)
        if select_mode == "exact":
            p = smallest_k(d, k)[1]
        else:
            dpos = torch.where(d < 0, 0.0, d)         # keeps NaN, like F
            keys = (dpos.view(torch.int32) & ~low_mask) | pos
            sel = torch.topk(keys, k, dim=-1, largest=False,
                             sorted=True).values
            p = (sel & low_mask).long()
        q = torch.arange(q0, q1, device=x.device)
        out.append((q[None, :, None] + p - W) % N)
    return torch.cat(out, dim=1)


def knn_indices_window(x: torch.Tensor, k: int, window: int = 256,
                       block: Optional[int] = None) -> torch.Tensor:
    """k nearest within the circular index band |i - j| <= window around
    each query (self excluded), [B, N, F] -> [B, N, k] int32. The candidate
    set is exactly the band, so the result is independent of `block`, the
    query chunk (default: `band_select`'s). Like the JAX function it
    asserts 2 * window < N: a wider band would wrap onto itself and repeat
    neighbors."""
    x = x.detach().float()
    N = x.shape[1]
    W = int(window)
    assert 2 * W < N, (N, W)
    return band_select(x, k, W, "exact", block=block).to(torch.int32)


def knn_indices_candidates(x: torch.Tensor, k: int, cand: torch.Tensor,
                           block: int = 512) -> torch.Tensor:
    """k nearest among per-point candidate lists cand [N, C] (C >= k) of
    x [B, N, F], ascending, ties to the lower candidate position:
    [B, N, k] int32."""
    x = x.detach().float()
    B, N, F = x.shape
    cand = torch.as_tensor(cand, device=x.device).long()
    C = cand.shape[1]
    assert C >= k, (C, k)
    block = _check_block(block)
    out = []
    for q0 in range(0, N, block):
        rows = cand[q0:q0 + block]                         # [Q, C]
        d = _fold_sqdist(x, q0, q0 + rows.shape[0], rows)
        sel = smallest_k(d, k)[1]                          # [B, Q, k]
        out.append(torch.gather(rows.expand(B, -1, -1), 2, sel))
    return torch.cat(out, dim=1).to(torch.int32)
