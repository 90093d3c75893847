"""Point-axis sharding over `torch.distributed`, the port of
`sp_gan_tpu/parallel/points.py`: each rank of a `points` group holds N / P
contiguous points of every cloud, the keys are all-gathered, and the
quadratic [N / P, N] distance blocks and the [B, N / P, k, C] edge tensors
stay on their rank.

Every function here runs inside one rank's program (as the JAX `*_local`
functions run inside `shard_map`) on the rank's block `x_local`
[B, n_local, C] and takes the `points` process group. Rank p of the group
holds points [p n_local, (p + 1) n_local). Indices are global, and a
point's own index is excluded globally. The JAX functions are plain XLA
(`pairwise_sqdist` and `lax.top_k`), so these are plain PyTorch, and they
select as `ops.pairwise.knn_indices` does: the same f32 distance fold,
ties to the lower index.

Gradients pass through the gathers (`parallel.mesh.all_gather_cat`), whose
backward sums the cotangents that every rank holds for a block. A loss that
the P ranks of a group each hold a copy of therefore gets P times its
gradient through them; the training step accounts for that
(`train/step.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sp_gan_tpu_torch.ops.emd import THETA, scaled_phases
from sp_gan_tpu_torch.ops.kernels.auction import phase_eps
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist, smallest_k
from sp_gan_tpu_torch.parallel.mesh import (all_gather_cat, all_reduce_sum,
                                            gather_rows_nograd)

# f32 distance rows a kNN chunk takes: [B, rows, N]
KNN_CHUNK_BYTES = 256 << 20
# f32 distance matrices of one solve call of the sharded protocol
EMD_CHUNK_BYTES = 2 << 30
# auction rounds between two looks of the host at the pairs
CHECK_ROUNDS = 8


def _place(group) -> Tuple[int, int]:
    """(this rank's place in `group`, the group's size); (0, 1) for None,
    which stands for one rank holding every point."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    """In-place all-reduce over `group` (nothing for None)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)


def _local_knn(xq: torch.Tensor, xk: torch.Tensor, k: int,
               row_base: int) -> torch.Tensor:
    """int64 [B, nq, k]: the k nearest keys of each query (the queries are
    keys row_base.. row_base + nq - 1, each excluded from its own list),
    ascending, ties to the lower index; in row chunks of KNN_CHUNK_BYTES."""
    B, nq, _ = xq.shape
    N = xk.shape[1]
    chunk = max(1, KNN_CHUNK_BYTES // (4 * B * N))
    cols = torch.arange(N, device=xq.device)
    out = []
    for lo in range(0, nq, chunk):
        d = pairwise_sqdist(xq[:, lo:lo + chunk].float(), xk.float())
        rows = row_base + lo + torch.arange(d.shape[1], device=xq.device)
        d = d.masked_fill((rows[:, None] == cols[None, :])[None],
                          float("inf"))
        out.append(smallest_k(d, k)[1])
    return torch.cat(out, dim=1)


def _neighbors(x_full: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    B = x_full.shape[0]
    return x_full[torch.arange(B, device=idx.device)[:, None, None], idx]


def knn_pointsharded(x_local: torch.Tensor, k: int, group) -> torch.Tensor:
    """Self-kNN of a point-sharded cloud: int32 [B, n_local, k] global
    indices of each local point's neighbours among all N, self
    excluded."""
    p, _ = _place(group)
    with torch.no_grad():
        x_full = gather_rows_nograd(x_local, group, dim=1)
        idx = _local_knn(x_local, x_full, k, p * x_local.shape[1])
    return idx.to(torch.int32)


def edge_features_pointsharded(x_local: torch.Tensor, k: int,
                               group) -> torch.Tensor:
    """Edge features [B, n_local, k, 2C] `[central, nbr - central]` of the
    local points against all N (differentiable)."""
    diff = edge_diff_local(x_local, k, group)
    central = x_local[:, :, None, :].expand_as(diff)
    return torch.cat([central, diff], dim=-1)


def edge_diff_local(x_local: torch.Tensor, k: int, group) -> torch.Tensor:
    """`nbr - central` [B, n_local, k, C] of the local points against the
    all-gathered keys, in x's dtype (the selection in f32 and without
    gradient). The gradient reaches a neighbour's owner through the
    gather's backward."""
    p, _ = _place(group)
    x_full = all_gather_cat(x_local, group, dim=1)               # [B, N, C]
    with torch.no_grad():
        idx = _local_knn(x_local.detach(), x_full.detach(), k,
                         p * x_local.shape[1])
    return _neighbors(x_full, idx) - x_local[:, :, None, :]


class _GlobalMax(torch.autograd.Function):
    """Max over the sharded point axis. The backward spreads the summed
    cotangent of every rank's copy evenly over all the points, on every
    rank, that hold the maximum: the unsharded `amax`'s routing."""

    @staticmethod
    def forward(ctx, x, group):
        local = x.amax(dim=1)                                     # [B, C]
        g = gather_rows_nograd(local[None], group, dim=0).amax(dim=0)
        hit = x == g[:, None, :]
        count = hit.sum(dim=1).to(torch.float32)
        _reduce_(count, group)
        ctx.save_for_backward(hit, count)
        ctx.group = group
        return g

    @staticmethod
    def backward(ctx, grad):
        hit, count = ctx.saved_tensors
        grad = all_reduce_sum(grad, ctx.group)
        share = (grad / count.to(grad.dtype))[:, None, :]
        return torch.where(hit, share, torch.zeros_like(share)), None


def global_max_points(x_local: torch.Tensor, group) -> torch.Tensor:
    """[B, n_local, C] -> [B, C], the max over all N points, the same on
    every rank of the group (differentiable, also twice)."""
    return _GlobalMax.apply(x_local, group)


def chamfer_pointsharded(x_local: torch.Tensor, y_local: torch.Tensor,
                         group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Directed Chamfer minima of two point-sharded clouds: (d1 [B, nx_local]
    each local x point's nearest squared distance among all of y, d2
    [B, ny_local] each local y point's among all of x)."""
    p, _ = _place(group)
    with torch.no_grad():
        y_full = gather_rows_nograd(y_local, group, dim=1)
        d = pairwise_sqdist(x_local, y_full)                   # [B, nx, M]
        d2 = d.amin(dim=-2)
        _reduce_(d2, group, dist.ReduceOp.MIN)
        n = y_local.shape[1]
        return d.amin(dim=-1), d2[:, p * n:(p + 1) * n]


def _auction_rounds(d: torch.Tensor, eps: float, iters: int, phases: int,
                    theta: float, group, row_base: int) -> torch.Tensor:
    """The Jacobi auction with eps-scaling of B point-sharded pairs,
    d [B, n_local, M] this rank's rows -> assignment [B, n_local] int64
    global item ids. Pair by pair it is `ops.emd.auction_scaled_jacobi`
    round for round: each pair keeps its own round count and stops a
    phase when its rows are all assigned or its rounds reach `iters`;
    prices and the item owners (global rows) are kept whole on every rank,
    so every rank counts the open rows from the owners. A round's bids
    meet in one all_gather of each rank's best bid and lowest bidding row
    per item. A row's values are taken as d + price, the negation of the
    one-device solver's -d - price, so the same items win on the same
    (exactly negated) numbers. The host looks at the pairs every
    CHECK_ROUNDS rounds: a round of a pair that is done changes nothing
    and is not counted, so the extra rounds are exact."""
    B, nl, M = d.shape
    dev = d.device
    inf = float("inf")
    n_rows = nl * _place(group)[1]
    rows = (row_base + torch.arange(nl, device=dev)).expand(B, nl)
    pair = torch.arange(B, device=dev)[:, None]
    item = torch.arange(M, device=dev).expand(B, M)
    # the writes of rows that bid on nothing, of items that got no bid
    # and of rows that live on other ranks go to slots past B * M and
    # B * nl, one a writer, so that no atomic or store queues on one
    # address
    no_item = B * M + torch.arange(B * nl, device=dev).view(B, nl)
    no_row = B * nl + torch.arange(B * M, device=dev).view(B, M)
    # a round's best bid (from -inf) and lowest bidding row (from +inf) of
    # each item, in f64, which holds both exactly
    start = torch.tensor([[-inf], [inf]], dtype=torch.float64,
                         device=dev).repeat(1, B * (M + nl))
    price = torch.zeros(B, M, dtype=d.dtype, device=dev)
    rounds = torch.zeros(B, dtype=torch.int64, device=dev)
    flat = None
    for e in phase_eps(eps, theta, phases):
        eps_p = torch.tensor(e, dtype=d.dtype, device=dev)
        flat = torch.full((B * (nl + M),), -1, dtype=torch.int64,
                          device=dev)
        asg = flat[:B * nl].view(B, nl)
        owner = torch.full((B, M), -1, dtype=torch.int64, device=dev)

        def open_pairs():
            return (rounds < iters) & ((owner >= 0).sum(dim=1) < n_rows)

        while bool(open_pairs().any()):
            for _ in range(CHECK_ROUNDS):
                live = open_pairs()
                bidding = (asg < 0) & live[:, None]
                u = d + price[:, None, :]
                best_u, best = u.min(dim=2)
                second_u = u.scatter_(2, best[..., None], inf).amin(dim=2)
                bid = second_u - best_u + eps_p
                slot = torch.where(bidding, pair * M + best, no_item)
                part = start.clone()
                part[0].scatter_reduce_(
                    0, slot.reshape(-1),
                    torch.where(bidding, bid, -inf).reshape(-1).double(),
                    "amax")
                top = bidding & (bid.double() == part[0][slot])
                part[1].scatter_reduce_(
                    0, torch.where(top, slot, no_item).reshape(-1),
                    rows.reshape(-1).double(), "amin")
                every = gather_rows_nograd(part[None, :, :B * M], group,
                                           dim=0)          # [P, 2, B * M]
                max_bid = every[:, 0].amax(dim=0)
                has_bid = torch.isfinite(max_bid).view(B, M)
                winner = torch.where(every[:, 0] == max_bid, every[:, 1],
                                     inf).amin(dim=0).view(B, M)
                winner = torch.where(has_bid, winner, -1.0).long()
                max_bid = max_bid.view(B, M).to(d.dtype)
                # evict the previous owners that live here, then install
                # the winners that live here
                here = has_bid & (owner >= row_base) \
                    & (owner < row_base + nl)
                flat[torch.where(here, pair * nl + owner - row_base,
                                 no_row).reshape(-1)] = -1
                here = has_bid & (winner >= row_base) \
                    & (winner < row_base + nl)
                flat[torch.where(here, pair * nl + winner - row_base,
                                 no_row).reshape(-1)] = \
                    torch.where(here, item, -1).reshape(-1)
                owner = torch.where(has_bid, winner, owner)
                price = price + torch.where(has_bid, max_bid, 0.0)
                rounds += live
    asg = flat[:B * nl].view(B, nl)
    best = (d + price[:, None, :]).min(dim=2)[1]
    return torch.where(asg < 0, best, asg)


def emd_auction_local(x_local: torch.Tensor, y_local: torch.Tensor,
                      eps: float = 0.005, iters: int = 50, group=None,
                      phases: Optional[int] = None, theta: float = THETA
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The EMD auction of point-sharded clouds x, y [B, N, 3] (both cut
    along their points over `group`): (dist [B, n_local] the squared
    distance of each local x point to its match, assignment [B, n_local]
    int32 global indices into y). Each rank keeps its [n_local, M]
    distance rows; the solver is `_auction_rounds`, pair for pair and
    round for round `ops.emd.auction_scaled_jacobi` (equal bids to the
    lowest global row), with `phases` by default as the scaled solver
    takes them. `iters` caps each pair's rounds over all phases; rows left
    then take their best item. Gradients reach x only, 2 g (x - y[sigma])
    (y's part of the graph is cut)."""
    B, nl, _ = x_local.shape
    if phases is None:
        phases = scaled_phases(iters)
    p, _ = _place(group)
    with torch.no_grad():
        y_full = gather_rows_nograd(y_local.detach().float(), group, dim=1)
        d = pairwise_sqdist(x_local.detach().float(), y_full)
        asg = _auction_rounds(d, eps, iters, phases, theta, group, p * nl)
        matched = _neighbors(y_full, asg[..., None])[:, :, 0]
    return ((x_local - matched) ** 2).sum(dim=-1), asg.to(torch.int32)


def pairwise_emd_matrix_pointsharded(gen, ref, group, eps: float = 0.005,
                                     iters: int = 50, row_batch: int = 8
                                     ) -> np.ndarray:
    """The metric protocol's EMD matrix [S1, S2] (mean L2 matching cost of
    each pair) of gen [S1, N, 3] and ref [S2, N, 3], each whole on every
    rank, with every solve's [N, N] distances cut over `group`'s ranks
    (`emd_auction_local`): each rank holds [pairs, N / P, N] of them.
    Pairs go in row-major order, `row_batch` rows a call or fewer where
    their distances pass EMD_CHUNK_BYTES. The same on every rank."""
    p, P = _place(group)
    S1, N = gen.shape[0], gen.shape[1]
    S2 = ref.shape[0]
    if N % P:
        raise ValueError(f"{N} points do not divide over {P} ranks")
    nl = N // P
    g_loc = gen[:, p * nl:(p + 1) * nl].float()
    r_loc = ref[:, p * nl:(p + 1) * nl].float().to(g_loc.device)
    per = max(1, min(row_batch * S2,
                     EMD_CHUNK_BYTES // (nl * ref.shape[1] * 4)))
    out = torch.empty(S1 * S2, dtype=torch.float32, device=g_loc.device)
    with torch.no_grad():
        for lo in range(0, S1 * S2, per):
            pairs = torch.arange(lo, min(lo + per, S1 * S2),
                                 device=g_loc.device)
            d, _ = emd_auction_local(g_loc[pairs // S2], r_loc[pairs % S2],
                                     eps, iters, group)
            s = torch.sqrt(torch.clamp(d, min=0.0)).sum(dim=-1)
            _reduce_(s, group)
            out[lo:lo + len(pairs)] = s / N
    return out.reshape(S1, S2).cpu().numpy()
