"""Kernel E: the block Gauss-Seidel EMD auction, `csrc/auction.cu`.

Replaces `sp_gan_tpu/ops/pallas/auction.py::auction_assignment_pallas` in
`mode="blockgs"` (`_auction_kernel_blockgs`) and `mode="blockgs_hbm"`
(`_auction_kernel_blockgs_hbm` plus its forced pass in XLA): both modes
run one algorithm, and differ on the TPU only in where the [N, M] matrix
lives. On an H100 neither matrix fits a block's shared memory, so one
kernel serves both, reading d from device memory.

d [B, N, M] f32 squared distances -> (assignment [B, N] int32, the item
of cloud 2 matched to each point of cloud 1; block-rounds [B] int32, the
rounds each pair ran; bidders [B] int64, the unassigned rows that bid,
summed over the pair's rounds, i.e. the rows of d its rounds scanned).
The algorithm, per pair:

- the N rows are cut into NB = N / w blocks (w halved from `block_w`
  until it divides N); prices start at 0, a cursor at block 0;
- eps-scaling: phase p runs at `eps * theta ** (phases - 1 - p)`, computed
  in float64 and rounded once to f32; each phase resets the owners and the
  per-block counts of unassigned rows to w, and keeps the prices;
- a block-round takes the first block at or after the cursor (cyclically)
  whose count is > 0 and moves the cursor past it. Each unassigned row r
  of that block finds best = max_m(-d[r, m] - price[m]) (ties to the
  lowest m) and second = the max over every other column, with -1e30 as
  the floor, and bids `(best - second) + eps_p` on its best item. Each
  item takes its highest bid (ties to the lowest row), evicts its owner
  (whose block count goes up by one) and adds the bid to its price; the
  bidding block's count goes down by the bids accepted;
- a phase ends when no row is unassigned or when the pair has run
  `iters * NB` block-rounds, counted over all phases;
- forced final pass: an owned row takes its item, an unowned row
  argmin_m(d[r, m] + price[m]) (lowest index).

`auction_plain` runs this step by step in PyTorch, the pairs side by side,
and the kernel runs the same f32 operations in the same order: the two agree
bit for bit, and a difference is a bug. `auction` launches the kernel for
a CUDA tensor (N * M * 4 <= 1 GB; the JAX package's XLA solver above that
is not ported) and runs `auction_plain` for a CPU tensor.
`auction.launches` counts kernel launches. `auction(mode="jacobi")` and
`mode="packed"` go to kernel O (`auction_jacobi.py`), which counts its own
launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sp_gan_tpu_torch.ops.kernels import _build

NEG = -1e30                 # the JAX kernel's sentinel (auction.py:44)
MAX_BLOCK_W = 64
MAX_PHASES = 16
MAX_BYTES = 1 << 30         # d per pair; the JAX package's blockgs_hbm limit
SMEM_LIMIT = 232448         # shared memory a block may use on an H100
SMEM_STATIC = 1024          # kernel O's static shared memory, rounded up
# kernel E's static shared memory, rounded up: each bidding row's partial
# (best, index, second) from each of 16 warps, 64 rows, twice (by the
# round's parity), and the bids
E_SMEM_STATIC = 26624
GRAPH_ROUNDS = 32           # block-rounds per CUDA graph of auction_plain


def block_width(n: int, block_w: int) -> int:
    """w: `block_w` halved until it divides n."""
    while n % block_w:
        block_w //= 2
    return block_w


def phase_eps(eps: float, theta: float, phases: int) -> np.ndarray:
    """eps of each phase, computed in float64 as the JAX kernel does, then
    rounded once to f32."""
    return np.array([eps * (theta ** (phases - 1 - p))
                     for p in range(phases)], dtype=np.float32)


def _check(d: torch.Tensor, phases: int, block_w: int) -> None:
    if d.dim() != 3:
        raise ValueError(f"d must be [B, N, M], got shape {tuple(d.shape)}")
    if d.dtype != torch.float32:
        raise TypeError(f"d must be float32, got {d.dtype}")
    if min(d.shape) < 1:
        raise ValueError(f"d must be non-empty, got shape {tuple(d.shape)}")
    if not 1 <= phases <= MAX_PHASES:
        raise ValueError(f"phases={phases} outside 1..{MAX_PHASES}")
    if not 1 <= block_w <= MAX_BLOCK_W:
        raise ValueError(f"block_w={block_w} outside 1..{MAX_BLOCK_W}")


def _graphed(fn, k: int):
    """Record `k` calls of `fn` (which updates tensors in place) as one
    CUDA graph, after one call on a side stream to warm up; returns the
    graph's replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            fn()
    return graph.replay


def auction_plain(d: torch.Tensor, eps: float, iters: int, phases: int,
                  theta: float = 8.0, block_w: int = 64
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: d [B, N, M] f32 ->
    (assignment [B, N] int32, block-rounds [B] int32, bidders [B] int64),
    on d's device. The pairs run side by side, each with its own cursor,
    block and counts, through the same f32 operations as one pair alone; a
    round leaves a pair that is done as it was, so the pairs of a phase run
    until the last is done. On CUDA the rounds are replayed
    `GRAPH_ROUNDS` at a time from a CUDA graph, which saves the host's
    launches and changes no operation. See the module docstring."""
    _check(d, phases, block_w)
    B, n, m = d.shape
    dev = d.device
    w = block_width(n, block_w)
    nb = n // w
    cap = iters * nb
    pair = torch.arange(B, device=dev)[:, None]
    lanes = torch.arange(w, device=dev)
    blocks = torch.arange(nb, device=dev)
    # the last column of price, owner, item_of and cnt is a dump slot that
    # takes the writes of rows and items that did not win
    price = torch.zeros(B, m + 1, dtype=torch.float32, device=dev)
    owner = torch.empty(B, m + 1, dtype=torch.int64, device=dev)
    item_of = torch.empty(B, n + 1, dtype=torch.int64, device=dev)
    cnt = torch.empty(B, nb + 1, dtype=torch.int64, device=dev)
    tot = torch.empty(B, dtype=torch.int64, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    bidders = torch.zeros(B, dtype=torch.int64, device=dev)
    cursor = torch.zeros(B, dtype=torch.int64, device=dev)
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    eps32 = torch.zeros((), dtype=torch.float32, device=dev)

    def block_round():
        active = (tot > 0) & (it < cap)
        # the first block at or after the cursor with a count > 0
        order = (cursor[:, None] + blocks) % nb
        live = cnt.gather(1, order) > 0
        j = torch.where(live.any(1), order.gather(
            1, live.to(torch.int8).argmax(1, keepdim=True))[:, 0], cursor)
        cursor.copy_(torch.where(active, (j + 1) % nb, cursor))
        rows = j[:, None] * w + lanes                              # [B, w]
        value = -d[pair, rows] - price[:, None, :m]                # [B, w, M]
        best_idx = value.argmax(dim=2, keepdim=True)
        best = value.gather(2, best_idx)[..., 0]
        second = value.scatter_(2, best_idx,
                                neg.expand(B, w, 1)).amax(dim=2)
        item = best_idx[..., 0]
        bid = (best - second) + eps32
        # a bidder wins unless another bids more on its item, or as much
        # from a lower row
        bids = (item_of.gather(1, rows) < 0) & active[:, None]
        beaten = (bids[:, None, :] & (item[:, None, :] == item[..., None])
                  & ((bid[:, None, :] > bid[..., None])
                     | ((bid[:, None, :] == bid[..., None])
                        & (lanes[:, None] > lanes)))).any(2)
        won = bids & ~beaten
        prev = owner.gather(1, item)
        evict = won & (prev >= 0)
        bidders.add_(torch.where(active, cnt.gather(1, j[:, None])[:, 0], 0))
        # evicted owners' blocks gain a row, the bidding block loses the
        # bids accepted
        cnt.scatter_add_(1, torch.where(evict, prev // w, nb),
                         evict.to(torch.int64))
        cnt.scatter_add_(1, j[:, None], -won.sum(1, keepdim=True))
        tot.add_(evict.sum(1) - won.sum(1))
        item_of.scatter_(1, torch.where(evict, prev, n), -1)
        item_of.scatter_(1, torch.where(won, rows, n), item)
        won_item = torch.where(won, item, m)
        owner.scatter_(1, won_item, rows)
        price.scatter_(1, won_item, price.gather(1, item) + bid)
        it.add_(active.to(torch.int64))

    run = block_round
    for p, e in enumerate(phase_eps(eps, theta, phases)):
        eps32.fill_(float(e))
        owner.fill_(-1)
        item_of.fill_(-1)
        cnt.fill_(w)
        tot.fill_(n)
        if p == 0 and dev.type == "cuda":
            run = _graphed(block_round, GRAPH_ROUNDS)
        while bool(((tot > 0) & (it < cap)).any()):
            run()
    asg = item_of[:, :n]
    forced = torch.stack([(d[b] + price[b, :m]).argmin(dim=1)
                          for b in range(B)])
    return (torch.where(asg >= 0, asg, forced).to(torch.int32),
            it.to(torch.int32), bidders)


def smem_bytes(n: int, m: int, w: int) -> int:
    """Dynamic shared memory of one block: price and owner [M], the
    row-to-item inverse [N] and the per-block counts [N / w]."""
    return 4 * (2 * m + n + n // w)


def check_fits(N: int, M: int, block_w: int) -> int:
    """Raises if kernel E cannot take a pair of N x M: d over 1 GB, or its
    state over the block's shared memory. Returns the block width w."""
    if N * M * 4 > MAX_BYTES:
        raise ValueError(
            f"kernel E takes N*M*4 <= 1 GB per pair, got N={N}, M={M} "
            f"({N * M * 4} bytes); the JAX package's XLA auction for larger "
            "pairs is not ported")
    w = block_width(N, block_w)
    smem = smem_bytes(N, M, w)
    if smem + E_SMEM_STATIC > SMEM_LIMIT:
        raise ValueError(f"kernel E keeps price, owner [M={M}] and the "
                         f"inverse [N={N}] in shared memory: {smem} bytes "
                         f"exceed the block's {SMEM_LIMIT - E_SMEM_STATIC}")
    return w


def auction(d: torch.Tensor, eps: float, iters: int, phases: int,
            theta: float = 8.0, block_w: int = 64, mode: str = "blockgs"
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """d [B, N, M] f32 -> (assignment [B, N] int32, rounds [B] int32,
    bidders [B] int64) in the JAX kernel's `mode`. "blockgs" and
    "blockgs_hbm": kernel E on CUDA, `auction_plain` on the CPU, the rounds
    being block-rounds; "jacobi" and "packed": kernel O
    (`auction_jacobi.jacobi_auction`, which ignores `block_w`)."""
    if mode in ("jacobi", "packed"):
        # a local import: auction_jacobi imports this module
        from sp_gan_tpu_torch.ops.kernels.auction_jacobi import jacobi_auction
        return jacobi_auction(d, eps, iters, phases, theta, mode)
    if mode not in ("blockgs", "blockgs_hbm"):
        raise ValueError(f"unknown auction mode {mode!r}")
    _check(d, phases, block_w)
    if d.device.type == "cpu":
        return auction_plain(d, eps, iters, phases, theta, block_w)
    if d.device.type != "cuda":
        raise ValueError(f"auction runs on cuda or cpu, not {d.device}")
    B, N, M = d.shape
    w = check_fits(N, M, block_w)
    if not 1 <= B <= 2 ** 31 - 1:
        raise ValueError(f"B={B} outside 1..2^31-1")
    out = launch_e(d, eps, iters, phases, theta, w)
    auction.launches += 1
    return out


auction.launches = 0


def launch_e(d: torch.Tensor, eps: float, iters: int, phases: int,
             theta: float, w: int, prof: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel E's launch on a CUDA d that `auction` has checked, at block
    width w; `auction` counts it in `auction.launches`. For timing the
    kernel: `prof`, a [B, 4] int64 CUDA tensor, receives per pair the SM
    clock cycles its rounds spent in warp 0's loads and columns, its warp
    merges, the wait for the other warps' scans, and the rest of the round
    (merge of the partials, resolve, pick)."""
    B, N, M = d.shape
    d = d.contiguous()
    asg = torch.empty((B, N), dtype=torch.int32, device=d.device)
    rounds = torch.empty((B,), dtype=torch.int32, device=d.device)
    bidders = torch.empty((B,), dtype=torch.int64, device=d.device)
    eps_p = np.zeros(MAX_PHASES, dtype=np.float32)
    eps_p[:phases] = phase_eps(eps, theta, phases)
    lib = _build.library()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spgan_auction(d.data_ptr(), asg.data_ptr(),
                                rounds.data_ptr(), bidders.data_ptr(), B,
                                N, M, w, phases,
                                eps_p.ctypes.data, iters * (N // w),
                                None if prof is None else prof.data_ptr(),
                                stream)
    _build.check(err, "spgan_auction")
    return asg, rounds, bidders
