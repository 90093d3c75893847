"""Kernel O: the Jacobi EMD auction, modes "jacobi" and "packed",
`csrc/auction_jacobi.cu`.

Replaces `sp_gan_tpu/ops/pallas/auction.py::auction_assignment_pallas` in
`mode="jacobi"` (`_auction_kernel`) and `mode="packed"`
(`_auction_kernel_packed`). d [B, N, M] f32 squared distances ->
(assignment [B, N] int32, the item of cloud 2 matched to each point of
cloud 1; rounds [B] int32, the rounds each pair ran; bidders [B] int64,
the unassigned rows that bid, summed over the pair's rounds). Per pair:

- prices start at 0; phase p runs at `eps * theta ** (phases - 1 - p)`,
  computed in float64 and rounded once to f32 (`auction.phase_eps`); each
  phase resets the owners to -1 and keeps the prices;
- a phase runs rounds while its flag is > 0 and the pair has run fewer
  than `iters` rounds over all phases. The flag starts at N and each round
  sets it to the number of rows unassigned at the round's start, so the
  round after convergence runs with no bidder and is counted;
- jacobi round: every row takes best = max_m(-d - price) (lowest m on
  ties) and second = the max over the other columns with -1e30 as the
  floor; each unassigned row bids `(best - second) + eps_p` on its best
  item; each item takes its highest bid, ties to the lowest row, evicts
  its owner and adds the bid to its price;
- packed round: u = max(d + price, 0), whose f32 bits with the low
  `bits = max((max(N, M) - 1).bit_length(), 1)` replaced by the column
  order as int32; one int32 min gives the best item and its quantized
  value, a second (the best column masked to INT32_MAX) the second value;
  the bid `(second - best) + eps_p`, clamped at 0, has its low bits
  replaced by the row, and each item takes the int32 max of the bids on it
  (SMALL = -(2^31 - 1) where none), so a tie goes to the highest row, and
  adds the quantized bid to its price;
- forced final pass: an owned row takes its item, an unowned row
  argmin_m(d + price) (lowest index).

`jacobi_auction_plain` runs this round by round in PyTorch, the pairs side
by side, through the same f32 and int32 operations as the kernel, so the
two agree bit for bit. `jacobi_auction` launches the kernel for a CUDA
tensor and runs the plain version for a CPU tensor;
`jacobi_auction.launches` counts kernel launches, both modes together.

The kernel runs kernel E's round engine: it keeps the list of unassigned
rows from round to round (a round's losers, then the owners its winners
evicted), splits each bidding row's columns at float4 slots over the 4
blocks of a cluster and over warps and lanes, merges the partials (exact
and order-free), and resolves each item's bids by the maximum of their
keys. `tests/test_torch_auction_modes.py` emulates that round in numpy and
holds it to `jacobi_auction_plain(..., trace=)` round by round.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sp_gan_tpu_torch.ops.kernels import _build
from sp_gan_tpu_torch.ops.kernels.auction import (MAX_BYTES, MAX_PHASES, NEG,
                                                  SMEM_LIMIT, SMEM_STATIC,
                                                  phase_eps)

MODES = ("jacobi", "packed")
BIG = 2 ** 31 - 1
SMALL = -(2 ** 31 - 1)

Solution = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(d: torch.Tensor, phases: int, mode: str) -> None:
    if d.dim() != 3:
        raise ValueError(f"d must be [B, N, M], got shape {tuple(d.shape)}")
    if d.dtype != torch.float32:
        raise TypeError(f"d must be float32, got {d.dtype}")
    if min(d.shape) < 1:
        raise ValueError(f"d must be non-empty, got shape {tuple(d.shape)}")
    if not 1 <= phases <= MAX_PHASES:
        raise ValueError(f"phases={phases} outside 1..{MAX_PHASES}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def pack_bits(n: int, m: int) -> int:
    """Low bits of a packed value that carry the column or row."""
    return max((max(n, m) - 1).bit_length(), 1)


def _jacobi_bids(d, price, bidding, eps_p):
    """(has_bid, winner, bid) of each item [B, M] in a jacobi round."""
    value = -d - price[:, None, :]                            # [B, N, M]
    best_idx = value.argmax(dim=2, keepdim=True)
    best = value.gather(2, best_idx)[..., 0]
    second = value.scatter(2, best_idx, NEG).amax(dim=2)
    bid = (best - second) + eps_p
    bid_mat = torch.full_like(value, NEG).scatter_(
        2, best_idx, bid[..., None])
    bid_mat.masked_fill_(~bidding[..., None], NEG)
    max_bid, winner = bid_mat.max(dim=1)
    return max_bid > NEG * 0.5, winner, max_bid


def _packed_bids(d, price, bidding, eps_p, bits):
    """(has_bid, winner, bid) of each item [B, M] in a packed round."""
    B, n, m = d.shape
    low = (1 << bits) - 1
    hi = ~low
    col = torch.arange(m, dtype=torch.int32, device=d.device)
    row = torch.arange(n, dtype=torch.int32, device=d.device)
    u = d + price[:, None, :]
    u = torch.where(u < 0, 0.0, u)
    u_pk = (u.view(torch.int32) & hi) | col                   # [B, N, M]
    p1 = u_pk.amin(dim=2)
    is_best = col == (p1 & low)[..., None]
    p2 = torch.where(is_best, BIG, u_pk).amin(dim=2)
    best_u = (p1 & hi).view(torch.float32)
    second_u = (p2 & hi).view(torch.float32)
    bid = (second_u - best_u) + eps_p
    bp = torch.where(bid < 0, 0.0, bid).view(torch.int32) & hi
    bid_pk = torch.where(bidding[..., None] & is_best,
                         (bp | row)[..., None], SMALL)
    pm = bid_pk.amax(dim=1)                                   # [B, M]
    return pm > SMALL, (pm & low).long(), (pm & hi).view(torch.float32)


def jacobi_auction_plain(d: torch.Tensor, eps: float, iters: int,
                         phases: int, theta: float = 8.0,
                         mode: str = "jacobi", trace=None) -> Solution:
    """The kernel's function in plain PyTorch: d [B, N, M] f32 ->
    (assignment [B, N] int32, rounds [B] int32, bidders [B] int64), on d's
    device. The pairs run side by side: a round leaves a pair whose phase
    is done as it was, so each phase runs until its last pair is done. See
    the module docstring. `trace(active, owner, price)`, if given, sees
    each round's result: the pairs that ran it [B] bool, owner [B, M] int64
    and price [B, M] f32."""
    _check(d, phases, mode)
    B, n, m = d.shape
    dev = d.device
    bits = pack_bits(n, m)
    price = torch.zeros(B, m, dtype=torch.float32, device=dev)
    owner = torch.empty(B, m, dtype=torch.int64, device=dev)
    flag = torch.empty(B, dtype=torch.int64, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    bidders = torch.zeros(B, dtype=torch.int64, device=dev)
    for e in phase_eps(eps, theta, phases):
        eps_p = torch.tensor(float(e), dtype=torch.float32, device=dev)
        owner.fill_(-1)
        flag.fill_(n)
        while True:
            active = (flag > 0) & (it < iters)
            if not bool(active.any()):
                break
            owned = torch.zeros(B, n + 1, dtype=torch.bool, device=dev)
            owned.scatter_(1, torch.where(owner >= 0, owner, n), True)
            unassigned = ~owned[:, :n]
            nu = unassigned.sum(dim=1)
            flag = torch.where(active, nu, flag)
            bidders += torch.where(active, nu, 0)
            bidding = unassigned & active[:, None]
            if mode == "jacobi":
                has_bid, winner, bid = _jacobi_bids(d, price, bidding, eps_p)
            else:
                has_bid, winner, bid = _packed_bids(d, price, bidding, eps_p,
                                                    bits)
            owner = torch.where(has_bid, winner, owner)
            price = price + torch.where(has_bid, bid, 0.0)
            it += active.long()
            if trace is not None:
                trace(active, owner, price)
    item_of = torch.full((B, n + 1), -1, dtype=torch.int64, device=dev)
    item_of.scatter_(1, torch.where(owner >= 0, owner, n),
                     torch.arange(m, device=dev).expand(B, m))
    forced = (d + price[:, None, :]).argmin(dim=2)
    asg = torch.where(item_of[:, :n] >= 0, item_of[:, :n], forced)
    return asg.to(torch.int32), it.to(torch.int32), bidders


def smem_bytes(n: int, m: int) -> int:
    """The shared memory a block needs at least: the bid keys [M] (8
    bytes), price and owner [M], the list of unassigned rows [N], and as
    much again for the partials of the rows a round scans (the kernel
    takes what the block has left for them)."""
    return 16 * m + 8 * n


def jacobi_auction(d: torch.Tensor, eps: float, iters: int, phases: int,
                   theta: float = 8.0, mode: str = "jacobi") -> Solution:
    """d [B, N, M] f32 -> (assignment [B, N] int32, rounds [B] int32,
    bidders [B] int64). Kernel O on CUDA, `jacobi_auction_plain` on the
    CPU."""
    _check(d, phases, mode)
    if d.device.type == "cpu":
        return jacobi_auction_plain(d, eps, iters, phases, theta, mode)
    if d.device.type != "cuda":
        raise ValueError(f"jacobi_auction runs on cuda or cpu, not "
                         f"{d.device}")
    B, N, M = d.shape
    if N * M * 4 > MAX_BYTES:
        raise ValueError(f"kernel O takes N*M*4 <= 1 GB per pair, got "
                         f"N={N}, M={M}")
    smem = smem_bytes(N, M)
    if smem + SMEM_STATIC > SMEM_LIMIT:
        raise ValueError(f"kernel O keeps its state [M={M}], [N={N}] in "
                         f"shared memory: {smem} bytes exceed the block's "
                         f"{SMEM_LIMIT - SMEM_STATIC}")
    if not 1 <= B <= 2 ** 31 - 1 or not 0 <= iters <= 2 ** 31 - 1:
        raise ValueError(f"B={B} or iters={iters} out of range")
    d = d.contiguous()
    asg = torch.empty((B, N), dtype=torch.int32, device=d.device)
    rounds = torch.empty((B,), dtype=torch.int32, device=d.device)
    bidders = torch.empty((B,), dtype=torch.int64, device=d.device)
    eps_p = np.zeros(MAX_PHASES, dtype=np.float32)
    eps_p[:phases] = phase_eps(eps, theta, phases)
    lib = _build.library()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spgan_auction_jacobi(
            d.data_ptr(), asg.data_ptr(), rounds.data_ptr(),
            bidders.data_ptr(), B, N, M, phases, eps_p.ctypes.data, iters,
            int(mode == "packed"), stream)
    _build.check(err, "spgan_auction_jacobi")
    jacobi_auction.launches += 1
    return asg, rounds, bidders


jacobi_auction.launches = 0
