"""Pairwise squared distances and exact k-nearest-neighbor selection, the
port of `sp_gan_tpu/ops/pairwise.py`.

Distances are true float32 with a fixed order of operations and no
tensor-core (TF32) rounding: the cross term is a sequential fold over the
channels, one rounded multiply and one rounded add per channel, and the
distance is `(|x|^2 - 2 x.y) + |y|^2`. The CUDA kernels in `ops/kernels`
compute the same sequence with `__fmul_rn`/`__fadd_rn`, so the kernels and
these functions pick bit-identical neighbors on every input.
"""

from __future__ import annotations

import os

import torch


def fold_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[..., N, C] x [..., M, C] -> [..., N, M] inner products, summed over
    C left to right with every product and every partial sum rounded to
    float32 (no fused multiply-add)."""
    acc = x[..., :, None, 0] * y[..., None, :, 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., :, None, c] * y[..., None, :, c]
    return acc


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """[..., N, C] -> [..., N] squared norms in the same fold order."""
    acc = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c] * x[..., c]
    return acc


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """d[..., n, m] = (|x_n|^2 - 2 x_n.y_m) + |y_m|^2 in float32."""
    x = x.float()
    y = y.float()
    two_cross = fold_dot(x, y) * 2.0
    return (sq_norms(x)[..., :, None] - two_cross) + sq_norms(y)[..., None, :]


def self_sqdist(x: torch.Tensor) -> torch.Tensor:
    """`pairwise_sqdist(x, x)` with each point's distance to itself +inf."""
    d = pairwise_sqdist(x, x)
    n = d.shape[-1]
    return d.masked_fill(torch.eye(n, dtype=torch.bool, device=d.device),
                         float("inf"))


def smallest_k(key: torch.Tensor, k: int):
    """(values, int64 indices) of the k smallest entries of each row of
    `key`, ascending, ties to the lower index (a stable sort)."""
    srt = torch.sort(key, dim=-1, stable=True)
    return srt.values[..., :k], srt.indices[..., :k]


def _first_hit(key: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    # the lowest index of each row where `hit` (or the key is NaN) holds
    n = key.shape[-1]
    ar = torch.arange(n, device=key.device)
    return torch.where(hit | torch.isnan(key), ar, n).amin(dim=-1)


def first_argmax(key: torch.Tensor) -> torch.Tensor:
    """int64 index of the largest entry of each row (the last axis), the
    first one on ties and the first NaN where there is one, as
    `jnp.argmax` takes it on every device."""
    return _first_hit(key, key == key.amax(dim=-1, keepdim=True))


def first_argmin(key: torch.Tensor) -> torch.Tensor:
    """`first_argmax`'s rule for the smallest entry (`jnp.argmin`)."""
    return _first_hit(key, key == key.amin(dim=-1, keepdim=True))


def stable_knn_grid() -> float:
    """Bucket width of the sort-stable tie-break mode, or 0.0 (off), from
    env `SPGAN_KNN_STABLE` as in the JAX package: unset or empty is off,
    "1" the default relative grid 1e-4, any other value the grid itself."""
    v = os.environ.get("SPGAN_KNN_STABLE", "")
    if not v:
        return 0.0
    return 1e-4 if v == "1" else float(v)


def knn_indices(x: torch.Tensor, k: int, *, exclude_self: bool = True,
                return_dists: bool = False, tie_break: str = "value"):
    """Indices [B, N, k] int32 of the k nearest neighbors of each point in
    its own cloud, ascending, ties to the lower index; self is masked to
    +inf when `exclude_self`. With `return_dists` also the squared distances.

    tie_break="stable" (or env SPGAN_KNN_STABLE) orders by distance buckets
    on a relative grid, stably by index inside a bucket: the JAX package's
    cross-implementation parity mode."""
    d = self_sqdist(x) if exclude_self else pairwise_sqdist(x, x)
    grid = stable_knn_grid()
    if tie_break == "stable" or grid:
        rel = grid or 1e-4
        finite = torch.isfinite(d)
        mean_d = torch.where(finite, d, 0.0).sum() / finite.sum()
        scale = torch.exp2(torch.round(torch.log2(mean_d)))
        key = torch.floor(d / (rel * scale))
    else:
        key = d
    idx = smallest_k(key, k)[1]
    if return_dists:
        return idx.to(torch.int32), torch.gather(d, -1, idx)
    return idx.to(torch.int32)
