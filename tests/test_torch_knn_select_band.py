"""Kernel F's selection above 4 channels: the selection engine of kernels
A, B and G (`csrc/knn_filter.cuh`) on a circular index band, with no JAX
import, so that its card tests run wherever the port does.

Its column is the band position, its packed mask the JAX kernel's, and a
band mask drops a query's keys outside its band. The band's filter is
emulated on the CPU with the sums of `tests/test_torch_knn_select.py`, over
the engine's split of each block's slice and over one chunk (P1's), with
the quantum cloud laid along a band: with the wrapper's margin and the
packed widening it keeps every neighbour; without the widening it drops one
of the quantum band cloud, and with no margin one of the far cloud.

On the card (`cuda` marker; `python -m pytest
tests/test_torch_knn_select_band.py -m cuda -q` on the H100) kernel F is
held bit for bit to `knn_edge_window_plain` in all eight forms, over
widths, list sizes, P1's shape, a ragged N, a narrow band and the hard
inputs, twice alike.
"""

import numpy as np
import pytest
import torch

from sp_gan_tpu_torch.ops.approx_knn import band_select, band_sqdist
from sp_gan_tpu_torch.ops.kernels.knn import FILTER_MU, FILTER_NU
from sp_gan_tpu_torch.ops.kernels.knn_edge_window import window_geometry
from sp_gan_tpu_torch.ops.pairwise import sq_norms
from test_torch_knn_select import (FORMS, _card, _estimates, _f32_up,
                                   _randn, _widen)

torch.set_num_threads(2)   # six test workers share the host's cores

# the estimates and band distances of one input's blocks (`cache` of
# band_filter_select), kept from one test to the next on the same input:
# its packed and exact runs
_LAST_INPUT = {"name": None, "cache": {}}


def input_cache(name: str) -> dict:
    if _LAST_INPUT["name"] != name:
        _LAST_INPUT.update(name=name, cache={})
    return _LAST_INPUT["cache"]


def band_split(B: int, N: int, W: int, fill: int = 256):
    """(S, chunk) of the engine's key_split for the band's slice of
    min(128, N) + 2 W keys a block of 128 queries."""
    keys = min(128, N) + 2 * W
    S = max(1, -(-fill // (B * -(-N // 128))))
    S = min(S, -(-keys // 64))
    chunk = -(-(-(-keys // S)) // 64) * 64
    return -(-keys // chunk), chunk


def band_tile(B: int, N: int, W: int, sms: int = 132) -> int:
    """The band filter's keys a tile on a card of `sms` SMs: 32 where the
    grid fits one wave at three blocks an SM but not at two, else 64."""
    blocks = -(-N // 128) * band_split(B, N, W)[0] * B
    return 32 if 2 * sms < blocks <= 3 * sms else 64


def _orderable(d: torch.Tensor) -> torch.Tensor:
    """int64 image of f32 d that orders like d (the kernels' orderable)."""
    b = d.contiguous().view(torch.int32)
    return (b ^ ((b >> 31) & 0x7FFFFFFF)).long()


def band_filter_select(x: torch.Tensor, k: int, W: int, mode: str,
                       low: int, mu: float, nu: float, widen: bool = True,
                       split=None, tile=None, queries: int = 128,
                       cache=None):
    """Kernel F's selection above 4 channels, in plain PyTorch: each block
    of `queries` walks the circular slice of rows q0 - W .. q0 + nq + W - 1
    in its S chunks (`split`, by default the card's), each from the tile
    holding its first query's position W (or the chunk's first), in tiles
    of `tile` keys. Query t's candidates are its band, slice positions r =
    t .. t + 2 W, column p = r - t; the band mask drops every other key
    before the test and in the first tile's bound. A key is pushed unless
    qn - 2 c~ > tau + nu + mu (qn + kn) - kn, tau as `filter_select` has
    it, the packed key's low mask `low` (F's). Each chunk keeps the k
    first of what it pushed; the merge keeps the k first of those. Returns
    the global neighbour indices [B, N, k]. `cache`, a dict, keeps the
    estimates and distances of a block for later calls on the same x."""
    B, N, C = x.shape
    S, chunk = split or band_split(B, N, W)
    tile = tile or band_tile(B, N, W)
    M = ((10 if k <= 10 else 32) + 3) // 4
    norms = sq_norms(x).double()
    never = torch.iinfo(torch.int64).max
    out = []
    for q0 in range(0, N, queries):
        nq = min(queries, N - q0)
        L = nq + 2 * W
        rows = (q0 - W + torch.arange(L)) % N
        qn, kn = norms[:, q0:q0 + nq, None], norms[:, None, rows]
        r = torch.arange(L)[None, :]
        p = r - torch.arange(nq)[:, None]
        band = (p >= 0) & (p <= 2 * W)
        me = p == W
        cache = {} if cache is None else cache
        if (q0, W) not in cache:
            cache[q0, W] = (
                qn - 2 * _estimates(x[:, q0:q0 + nq], x[:, rows]).double(),
                band_sqdist(x, W, q0, q0 + nq).gather(
                    -1, p.clamp(0, 2 * W).expand(B, nq, L).contiguous()))
        e, d = cache[q0, W]
        key = ((torch.where(d < 0, 0.0, d).view(torch.int32) & ~low)
               | p.clamp(0, 2 * W).int())
        # the list's order as one int64: the packed key, or (distance, p)
        order = key.long() if mode == "packed" else (_orderable(d) << 32) + r
        margin = nu + mu * (qn + kn) - kn
        big = (qn >= 2.0 ** 125) | (kn >= 2.0 ** 125)
        chosen = torch.zeros(B, nq, L, dtype=torch.bool)
        for s in range(S):
            key0, key1 = s * chunk, min(L, (s + 1) * chunk)
            if key1 <= key0:
                continue
            tiles = -(-(key1 - key0) // tile)
            first = (W - key0) // tile if key0 <= W < key1 else 0
            pushed = torch.zeros(B, nq, L, dtype=torch.bool)
            for it in range(tiles):
                tile0 = key0 + (first + it) % tiles * tile
                t1 = min(tile0 + tile, key1)
                cand = band[:, tile0:t1]   # the tile's columns of the band
                if it == 0:
                    u = (e + kn + mu * kn + mu * qn + nu)[..., tile0:t1]
                    u = torch.where(cand & ~me[:, tile0:t1], u,
                                    float("inf"))
                    lane = torch.arange(t1 - tile0) % 8 // 2
                    tau = torch.stack(
                        [torch.where(lane == t, u, float("inf"))
                         .sort(dim=-1).values[..., M - 1] for t in range(4)],
                        -1).amax(-1)
                    if mode == "packed":
                        tau = _widen(_f32_up(tau), low)
                else:
                    kth = torch.where(pushed, order, never).topk(
                        k, dim=-1, largest=False)
                    short = kth.values[..., k - 1] == never
                    if mode == "packed" and widen:
                        tau = (kth.values[..., k - 1].int() | low).view(
                            torch.float32).double()
                    else:   # the k-th entry's own distance
                        at = torch.where(short, 0, kth.indices[..., k - 1])
                        tau = d.gather(-1, at[..., None])[..., 0].double()
                    tau = torch.where(short, float("nan"), tau)
                sl = slice(tile0, t1)
                keep = ~(e[..., sl] > tau[..., None] + margin[..., sl]) | \
                    ~torch.isfinite(tau)[..., None] | big[..., sl] | me[:, sl]
                pushed[..., sl] |= keep & cand
            first_k = torch.where(pushed, order, never).topk(
                k, dim=-1, largest=False)
            chosen |= torch.zeros_like(chosen).scatter_(
                -1, first_k.indices, first_k.values != never)
        at = torch.where(chosen, order, never).topk(
            k, dim=-1, largest=False).indices
        out.append(rows[at])
    return torch.cat(out, dim=1)


def quantum_band_cloud(N: int = 2048, C: int = 16) -> torch.Tensor:
    """[1, N, C] laid along the band of query 1000 at W = 512 (F's low mask
    at N = 2048 is 2^11 - 1, as B's): the query at e1, every other point
    at -e1 + delta e2, so that all its band distances lie in one packed
    quantum [4, 4 + 2^-10) and its packed top-k are the lowest band
    positions, rows 488 .. 497. Its block (queries 896 .. 1023) walks the
    tiles of its own queries (rows 896 .. 1023, at delta^2 ~ 1e-6) first
    and those rows, at the start of its slice, after the wrap: compared
    with the k-th distance, about 4 + 1e-6, and a margin of about 2^-11,
    they are dropped though they belong."""
    x = np.zeros((1, N, C), np.float32)
    x[0, :, 0] = -1.0
    delta2 = np.full(N, 0.5 * 2.0 ** -10)
    delta2[896:1024] = 1e-6 * (1 + np.arange(128) / 128)
    delta2[488:498] = 0.9 * 2.0 ** -10
    x[0, :, 1] = np.sqrt(delta2)
    x[0, 1000] = 0.0
    x[0, 1000, 0] = 1.0
    return torch.from_numpy(x)


def hard_band_input(name: str, N: int = 1024) -> torch.Tensor:
    """The hard inputs of `hard_input`, two clouds of N points each, and
    the quantum band cloud."""
    if name == "quantum":
        return quantum_band_cloud()
    rng = np.random.default_rng(23)
    kind, c = name.split("_")
    r = rng.standard_normal((2, N, int(c)))
    point = np.broadcast_to(100 * r[:1, :1], r.shape).astype(np.float32)
    ulps = rng.integers(-2, 3, r.shape) * np.spacing(point)
    x = {"grid": np.round(4 * r), "offset": r + 1000,
         "repeat": np.broadcast_to(r[:1, :1], r.shape),
         "near": point + ulps, "randn": r}[kind]
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


HARD_BAND = ("grid_64", "offset_64", "repeat_64", "near_64", "randn_16",
             "randn_64", "quantum")


def band_plain(x: torch.Tensor, k: int, window: int, mode: str):
    """Kernel F's plain selection at `window`: (global indices, W, low)."""
    W, low = window_geometry(x.shape[1], k, window)
    return band_select(x, k, W, mode, low), W, low


def check_margin(name: str, mode: str) -> None:
    """Kernel F's filter with the wrapper's margin on hard input `name`
    keeps exactly the plain band selection's neighbours in `mode`, at k 10
    and 20 with W at its clamp, at k 10 with a small W, over the card's
    split and over one chunk with tiles of 32."""
    x, cache = hard_band_input(name), input_cache(name)
    for k, window in ((10, 512), (20, 512), (10, 24)):
        ref, W, low = band_plain(x, k, window, mode)
        for split, tile in ((None, None), ((1, 2 ** 20), 32)):
            idx = band_filter_select(x, k, W, mode, low, FILTER_MU,
                                     FILTER_NU, split=split, tile=tile,
                                     cache=cache)
            assert torch.equal(idx, ref), (k, W, split, tile)


class TestBandFilterRule:
    """Kernel F's filter with the wrapper's margin, first tile bound and
    packed widening under F's low mask picks exactly what the plain band
    selection picks, in both orders, on every hard input, with W at its
    clamp and small, k 10 and 20, the card's split of the slice (S > 1 at
    these sizes) and one chunk (as at P1), tiles of 32 and 64; without the
    widening it drops a neighbour of the quantum band cloud, and with no
    margin one of the far cloud."""

    @pytest.mark.parametrize("mode", ["packed"])
    @pytest.mark.parametrize("name", HARD_BAND)
    def test_margin_keeps_every_neighbour(self, name, mode):
        # the exact order's half: tests/test_torch_knn_select_band_exact.py
        check_margin(name, mode)

    def test_quantum_band_cloud_needs_the_widening(self):
        x = quantum_band_cloud()
        ref, W, low = band_plain(x, 10, 512, "packed")
        assert (W, low) == (512, 2047)
        assert ref[0, 1000].tolist() == list(range(488, 498))
        one = dict(split=(1, 2 ** 20), tile=64)   # P1's: one chunk
        narrow = band_filter_select(x, 10, W, "packed", low, FILTER_MU,
                                    FILTER_NU, widen=False, **one)
        assert not torch.equal(narrow[0, 1000], ref[0, 1000])
        assert torch.equal(band_filter_select(
            x, 10, W, "packed", low, FILTER_MU, FILTER_NU, **one), ref)

    def test_no_margin_drops_a_neighbour(self):
        x = hard_band_input("offset_64")
        for mode in ("packed", "exact"):
            ref, W, low = band_plain(x, 10, 512, mode)
            idx = band_filter_select(x, 10, W, mode, low, 0.0, 0.0,
                                     split=(1, 2 ** 20), tile=32)
            assert not torch.equal(idx, ref), mode

    def test_split_and_tiles_follow_the_engine(self):
        """P1's call [4, 8192, C] at W = 512: one chunk, tiles of 64 (256
        blocks, one wave at two an SM); the small clouds above split."""
        assert band_split(4, 8192, 512)[0] == 1
        assert band_tile(4, 8192, 512) == 64
        assert band_split(2, 1024, 384) == (14, 64)
        assert band_tile(6, 8192, 512) == 32   # 384 blocks



def _hold_f(x: torch.Tensor, k: int, window: int, forms=FORMS) -> None:
    """Kernel F against `knn_edge_window_plain` in every form, bit for
    bit, and against itself over two launches."""
    from sp_gan_tpu_torch.ops.kernels.knn_edge_window import (
        knn_edge_window, knn_edge_window_plain)
    for mode, cd, diff_only in forms:
        kw = dict(out_dtype=cd, diff_only=diff_only, select_mode=mode)
        ee, idx = knn_edge_window(x, k, window, **kw)
        ee2, idx2 = knn_edge_window(x, k, window, **kw)
        pee, pidx = knn_edge_window_plain(x, k, window, **kw)
        tag = (mode, cd, diff_only)
        assert torch.equal(idx, pidx) and torch.equal(ee, pee), tag
        assert torch.equal(idx, idx2) and torch.equal(ee, ee2), tag


@pytest.mark.cuda
class TestBandOnCard:
    @pytest.mark.parametrize("C, k", [(16, 7), (64, 10), (64, 20),
                                      (128, 32)])
    def test_kernel_f_split_slice(self, C, k):
        """Two clouds of 1024: the slice split into chunks and merged, W
        at its clamp (384)."""
        _hold_f(_card(_randn((2, 1024, C), seed=C + k)), k, 512)

    @pytest.mark.parametrize("mode", ["packed", "exact"])
    def test_kernel_f_p1_call(self, mode):
        """P1's shape [4, 8192, 64], W = 512: one chunk, tiles of 32."""
        _hold_f(_card(_randn((4, 8192, 64), seed=3)), 10, 512,
                [(mode, torch.bfloat16, True), (mode, torch.float32, False)])

    def test_kernel_f_ragged_and_narrow(self):
        """N not a multiple of 128 (the last block's slice shorter), a
        narrow band, and C = 3 (the CUDA-core pass)."""
        for C in (3, 64):
            _hold_f(_card(_randn((3, 1999, C), seed=5)), 10, 512)
            _hold_f(_card(_randn((3, 1999, C), seed=6)), 10, 24)

    @pytest.mark.parametrize("name", HARD_BAND)
    def test_kernel_f_hard_inputs(self, name):
        """The hard inputs at W = 384; the quantum band cloud 16 times,
        so that its slice is one chunk, as P1's."""
        x = hard_band_input(name)
        if name == "quantum":
            x = x.repeat(16, 1, 1)
        _hold_f(_card(x), 10, 512)

    def test_kernel_f_no_margin_differs(self):
        """The control of the margin on the card: kernel F in packed mode
        launched with mu = nu = 0 on a cloud far from the origin differs
        from its plain version."""
        from sp_gan_tpu_torch.ops.kernels.knn_edge_window import (
            _launch, knn_edge_window_plain)
        x = _card(_randn((4, 8192, 64), seed=9) + 1000)
        _, idx = _launch(x, 10, 512, torch.bfloat16, 256, True, "packed",
                         0.0, 0.0)
        assert not torch.equal(idx, knn_edge_window_plain(
            x, 10, 512, torch.bfloat16, diff_only=True,
            select_mode="packed")[1])
