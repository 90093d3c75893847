"""Earth Mover's Distance by the auction algorithm, the port of
`sp_gan_tpu/ops/emd.py`.

`emd_auction(xyz1, xyz2, eps, iters, scaled)` -> (dist [B, N] squared
distance of each point of xyz1 to its match, assignment [B, N] int32 into
xyz2). Gradients go to xyz1 only, `2 g (xyz1 - xyz2[sigma])`; xyz2 gets
zeros, as in the reference backward.

- `scaled=True`, the metric protocol's solver, eps-scaling over
  `phases = 1 if iters <= 500 else 4` phases (theta = 8). A pair whose
  matrix takes up to `MAX_BYTES` (1 GiB) runs the block Gauss-Seidel
  auction (w = 64) that the JAX package runs in its Pallas kernel wherever
  Pallas runs: kernel E (`ops/kernels/auction.py`) on CUDA, its plain
  version on the CPU. A larger pair leaves the kernel at the same line as
  the JAX package leaves Pallas, for its XLA solver
  `_auction_single_scaled`, whose counterpart here is
  `auction_scaled_jacobi`: plain PyTorch on either device, one pair at a
  time, in row chunks, so that the memory is the pair's matrix and one
  chunk's temporaries.
- `scaled=False`, the reference's fixed-iteration solver: `iters` Jacobi
  rounds, every unassigned point bidding each round, and the forced final
  pass (`_auction_single`). The JAX package computes it in XLA, so here it
  is plain PyTorch on either device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sp_gan_tpu_torch.ops.kernels.auction import MAX_BYTES, auction, phase_eps
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist

THETA = 8.0
BLOCK_W = 64
# f32 [rows, M] temporaries of one row chunk of `auction_scaled_jacobi` and
# of the large pair's distance matrix
CHUNK_BYTES = 256 << 20


def scaled_phases(iters: int) -> int:
    """eps-scaling phases of the scaled solver: one for a small cap (the
    training regime), four otherwise."""
    return 1 if iters <= 500 else 4


def auction_jacobi(d: torch.Tensor, eps: float, iters: int) -> torch.Tensor:
    """The fixed-iteration Jacobi auction with forced final pass, batched:
    d [B, N, M] -> assignment [B, N] int32 (JAX `_auction_single`)."""
    B, n, m = d.shape
    dev = d.device
    arange_m = torch.arange(m, device=dev)
    rows = torch.arange(B, device=dev)[:, None]
    assignment = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    assignment_inv = torch.full((B, m), -1, dtype=torch.int64, device=dev)
    price = torch.zeros((B, m), dtype=d.dtype, device=dev)
    ninf = torch.tensor(float("-inf"), dtype=d.dtype, device=dev)
    eps32 = torch.tensor(eps, dtype=d.dtype, device=dev)
    for _ in range(iters):
        unassigned = assignment < 0
        value = -d - price[:, None, :]
        best_idx = value.argmax(dim=2)
        best_val = value.gather(2, best_idx[..., None])[..., 0]
        is_best = best_idx[..., None] == arange_m
        second_val = torch.where(is_best, ninf, value).amax(dim=2)
        bid_inc = best_val - second_val + eps32
        bid_mat = torch.where(unassigned[..., None] & is_best,
                              bid_inc[..., None], ninf)
        max_bid = bid_mat.amax(dim=1)                           # [B, M]
        winner = bid_mat.argmax(dim=1)
        has_bid = torch.isfinite(max_bid)
        evict = torch.where(has_bid & (assignment_inv >= 0), assignment_inv,
                            n)
        padded = torch.cat([assignment,
                            torch.full((B, 1), -1, dtype=torch.int64,
                                       device=dev)], dim=1)
        padded[rows, evict] = -1
        win_point = torch.where(has_bid, winner, n)
        padded[rows, win_point] = torch.where(has_bid, arange_m, -1)
        assignment = padded[:, :n]
        assignment_inv = torch.where(has_bid, winner, assignment_inv)
        price = price + torch.where(has_bid, max_bid, 0.0)
    best_idx = (-d - price[:, None, :]).argmax(dim=2)
    return torch.where(assignment < 0, best_idx, assignment).to(torch.int32)


def _chunk_rows(m: int) -> int:
    return max(1, CHUNK_BYTES // (4 * m))


def _bids(d: torch.Tensor, rows: torch.Tensor, price: torch.Tensor,
          eps_p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of `rows` (ascending): its best item under `price`
    (the first maximum of -d - price) and its bid, (best - second) +
    eps_p, second being the maximum over every other item; row chunk by
    row chunk."""
    chunk = _chunk_rows(d.shape[1])
    best, bid = [], []
    for lo in range(0, rows.numel(), chunk):
        v = d.index_select(0, rows[lo:lo + chunk]).neg_().sub_(price)
        best_val, best_idx = v.max(dim=1)
        second = v.scatter_(1, best_idx[:, None], float("-inf")).amax(dim=1)
        best.append(best_idx)
        bid.append(best_val - second + eps_p)
    return torch.cat(best), torch.cat(bid)


def auction_scaled_jacobi(d: torch.Tensor, eps: float, iters: int,
                          phases: int, theta: float = THETA,
                          return_state: bool = False):
    """The Jacobi auction with eps-scaling of one pair, d [N, M] f32 ->
    assignment [N] int32 (the JAX package's `_auction_single_scaled`,
    element for element); with `return_state` also the final prices [M]
    and the rounds run.

    Phase p bids at eps * theta ** (phases - 1 - p) (computed in float64,
    rounded once to f32), keeps the prices of the phase before and starts
    with every row unassigned. A round: each unassigned row bids
    (best - second) + eps_p on its best item (ties to the lowest item);
    each item that got bids takes the highest (ties to the lowest row),
    evicts its owner and adds the bid to its price. A phase ends when every
    row is assigned; `iters` caps the rounds of all phases together. Rows
    left unassigned take their best item under the final prices.

    Only the unassigned rows are scanned, in row chunks of `CHUNK_BYTES`,
    and the bids are resolved per item by `scatter_reduce` (amax, then amin
    of the rows that bid the maximum): the memory is d and one chunk's
    temporaries."""
    if d.dim() != 2 or d.dtype != torch.float32:
        raise ValueError(f"d must be [N, M] float32, got {d.dtype} "
                         f"{tuple(d.shape)}")
    n, m = d.shape
    dev = d.device
    price = torch.zeros(m, dtype=d.dtype, device=dev)
    item = torch.arange(m, device=dev)
    ninf = torch.full((m,), float("-inf"), dtype=d.dtype, device=dev)
    nobody = torch.full((m,), n, dtype=torch.int64, device=dev)
    rounds = 0
    asg = None
    for e in phase_eps(eps, theta, phases):
        eps_p = torch.tensor(e, dtype=d.dtype, device=dev)
        # slot n takes the writes of items that got no bid
        asg = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
        owner = torch.full((m,), -1, dtype=torch.int64, device=dev)
        while rounds < iters:
            rows = torch.nonzero(asg[:n] < 0)[:, 0]
            if rows.numel() == 0:
                break
            best, bid = _bids(d, rows, price, eps_p)
            max_bid = ninf.scatter_reduce(0, best, bid, "amax")
            top = bid == max_bid[best]
            winner = nobody.scatter_reduce(0, best[top], rows[top], "amin")
            has_bid = torch.isfinite(max_bid)
            asg[torch.where(has_bid & (owner >= 0), owner, n)] = -1
            asg[torch.where(has_bid, winner, n)] = torch.where(has_bid, item,
                                                               -1)
            owner = torch.where(has_bid, winner, owner)
            price = price + torch.where(has_bid, max_bid, 0.0)
            rounds += 1
    asg = asg[:n]
    left = torch.nonzero(asg < 0)[:, 0]
    if left.numel():
        asg[left] = _bids(d, left, price, torch.zeros((), dtype=d.dtype,
                                                      device=dev))[0]
    asg = asg.to(torch.int32)
    return (asg, price, rounds) if return_state else asg


def _sqdist_rows(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """`pairwise_sqdist` of one pair x [N, 3], y [M, 3] -> [N, M], computed
    in row chunks: the same values without the full-size temporaries."""
    d = torch.empty(x.shape[0], y.shape[0], dtype=torch.float32,
                    device=x.device)
    chunk = _chunk_rows(y.shape[0])
    for lo in range(0, x.shape[0], chunk):
        d[lo:lo + chunk] = pairwise_sqdist(x[lo:lo + chunk], y)
    return d


def _assignment(xyz1, xyz2, eps: float, iters: int,
                scaled: bool) -> torch.Tensor:
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    if scaled and N * M * 4 > MAX_BYTES:
        # above kernel E's limit: one pair at a time
        return torch.stack([auction_scaled_jacobi(
            _sqdist_rows(xyz1[b], xyz2[b]), eps, iters, scaled_phases(iters))
            for b in range(B)])
    d = pairwise_sqdist(xyz1, xyz2)
    if scaled:
        return auction(d, eps, iters, scaled_phases(iters), THETA,
                       BLOCK_W)[0]
    return auction_jacobi(d, eps, iters)


def _matched(xyz2: torch.Tensor, assignment: torch.Tensor) -> torch.Tensor:
    idx = assignment.long()[..., None].expand(-1, -1, xyz2.shape[-1])
    return torch.gather(xyz2, 1, idx)


class _EMD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2, eps, iters, scaled):
        assignment = _assignment(xyz1, xyz2, eps, iters, scaled)
        matched = _matched(xyz2, assignment)
        dist = ((xyz1 - matched) ** 2).sum(dim=-1)
        ctx.save_for_backward(xyz1, matched)
        ctx.xyz2_shape = xyz2.shape
        ctx.mark_non_differentiable(assignment)
        return dist, assignment

    @staticmethod
    def backward(ctx, g_dist, g_assignment):
        xyz1, matched = ctx.saved_tensors
        grad1 = 2.0 * g_dist[..., None] * (xyz1 - matched)
        return (grad1, matched.new_zeros(ctx.xyz2_shape), None, None,
                None)


def emd_auction(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.005,
                iters: int = 50, scaled: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate EMD of clouds [B, N, 3] and [B, M, 3]: (dist [B, N]
    squared, assignment [B, N] int32). See the module docstring."""
    return _EMD.apply(xyz1, xyz2, eps, iters, scaled)


def emd_cost(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.005,
             iters: int = 50, scaled: bool = False) -> torch.Tensor:
    """Mean L2 matching cost per cloud: [B] (sqrt of the per-point squared
    distances)."""
    dist, _ = emd_auction(xyz1, xyz2, eps, iters, scaled)
    return torch.sqrt(torch.clamp(dist, min=0.0)).mean(dim=-1)
