"""The selection engine of kernels A, B, G and F (`csrc/knn_filter.cuh`),
with no JAX import, so that its card tests run wherever the port does.

On the CPU the tensor-core filter is emulated in plain PyTorch (TF32
rounding, the three-product split, f32 sums in another order than the
fold, the first tile's bound from its own estimates, the wrapper's margin)
in both selection orders of kernel B: exact (distance, index) and packed,
where the list orders by (bits(max(d, 0)) & ~low) | j and the filter
compares with tau_q, the largest float that shares the k-th key's high
bits. With the margin and that widening it keeps every neighbour on the
inputs where a broken filter would show; compared with the k-th distance
instead of tau_q it loses one on a cloud built for that: many keys in one
packed quantum, the lower columns walked last.

On the card (`cuda` marker; `python -m pytest
tests/test_torch_knn_select.py -m cuda -q` on the H100) kernel B is held
bit for bit (`torch.equal` on ee and idx) to `knn_edge_plain` in all
eight forms, over widths, list sizes, batch sizes that split the keys (B
= 1) and that do not (B = 64), a ragged N and the hard inputs, twice
alike; kernel A to `knn_plain` and to kernel G.

Kernel F, the same engine on a circular index band, is emulated and held
on the card in `tests/test_torch_knn_select_band.py`, which takes this
file's emulation of the filter's sums.
"""

import itertools

import numpy as np
import pytest
import torch

from sp_gan_tpu_torch.ops.kernels.knn import FILTER_MU, FILTER_NU
from sp_gan_tpu_torch.ops.kernels.knn_edge import packed_bits, select_plain
from sp_gan_tpu_torch.ops.pairwise import self_sqdist, smallest_k, sq_norms

torch.set_num_threads(2)   # six test workers share the host's cores

FORMS = list(itertools.product(("packed", "exact"),
                               (torch.float32, torch.bfloat16),
                               (True, False)))
INT_MAX = 2 ** 31 - 1


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 to nearest, ties away from zero: half of the
    dropped 13 bits added to the magnitude, then masked (the kernel's
    `to_tf32`)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _estimates(x: torch.Tensor, keys: torch.Tensor = None) -> torch.Tensor:
    """c~ [B, N, K] ~ q.k of the rows q of x [B, N, C] and k of `keys` [B,
    K, C] (x itself by default): the three tf32 products hi.hi + hi.lo +
    lo.hi, summed in f32 in another order than the exact fold (per 8
    channels, last channel first, into one accumulator)."""
    keys = x if keys is None else keys
    B, N, C = x.shape
    cp = -(-C // 16) * 16

    def split(v):
        vp = torch.nn.functional.pad(v, (0, cp - C))
        hi = _tf32(vp)
        return hi, _tf32(vp - hi)
    (qh, ql), (kh, kl) = split(x), split(keys)
    acc = torch.zeros(B, N, keys.shape[1])
    for ks in range(cp // 8):
        for a, b in ((qh, kh), (qh, kl), (ql, kh)):
            s = None
            for c in reversed(range(8 * ks, 8 * ks + 8)):
                p = a[:, :, None, c] * b[:, None, :, c]
                s = p if s is None else s + p
            acc = acc + s
    return acc


def _f32_up(v: torch.Tensor) -> torch.Tensor:
    """float64 v rounded up to float32."""
    f = v.float()
    return torch.where(f.double() < v, torch.nextafter(
        f, torch.tensor(float("inf"))), f)


def _widen(tau: torch.Tensor, low: int) -> torch.Tensor:
    """tau_q: the largest float32 whose bits share max(tau, 0)'s high
    bits, as float64."""
    b = torch.clamp(tau, min=0.0).float().view(torch.int32) | low
    return b.view(torch.float32).double()


def filter_select(x: torch.Tensor, k: int, mode: str, mu: float, nu: float,
                  widen: bool = True, tile: int = 64, queries: int = 128):
    """The kernel's selection over one chunk of keys, in plain PyTorch:
    each block of `queries` walks the key tiles from its own; a key is
    pushed (folded exactly) unless qn - 2 c~ > tau + nu + mu (qn + kn) -
    kn, with tau the list's threshold: the k-th pushed distance (exact) or
    tau_q of the k-th pushed key (packed; the k-th distance with `widen`
    False), every key kept while it is not finite. The first tile's
    threshold is first_bound's: for each query, the M-th smallest upper
    bound (qn - 2 c~) + kn + mu (qn + kn) + nu of each lane's tile / 4
    columns (column c is lane (c % 8) // 2's, M = ceil(KM / 4), KM = 10 or
    32), the largest of the four lanes'; with a wide list (KM = 64, k >
    32, whose tiles hold 32 keys) it is +inf, the first tile taken whole.
    Returns the k neighbours [B, N, k] of the pushed keys in the mode's
    order."""
    B, N, C = x.shape
    acc = _estimates(x).double()
    qn = sq_norms(x).double()[:, :, None]
    kn = sq_norms(x).double()[:, None, :]
    e = qn - 2 * acc
    margin = nu + mu * (qn + kn) - kn
    d = self_sqdist(x)
    low = (1 << packed_bits(N)) - 1
    cols = torch.arange(N, dtype=torch.int32)
    key = (torch.where(d < 0, 0.0, d).view(torch.int32) & ~low) | cols
    big = (qn >= 2.0 ** 125) | (kn >= 2.0 ** 125)
    q = torch.arange(N)
    tiles = -(-N // tile)
    first = (q // queries * queries) // tile
    key_tile = q // tile
    eye = torch.eye(N, dtype=torch.bool)
    pushed = torch.zeros(B, N, N, dtype=torch.bool)
    km = 10 if k <= 10 else (32 if k <= 32 else 64)
    for it in range(tiles):
        in_tile = key_tile[None, :] == ((first + it) % tiles)[:, None]
        if it == 0 and km == 64:
            tau = torch.full((B, N), float("inf"), dtype=torch.float64)
        elif it == 0:
            u = e + kn + mu * kn + mu * qn + nu
            u = torch.where(in_tile & ~eye, u, float("inf"))
            lane = (q % tile % 8) // 2
            per_lane = [torch.where(lane[None, None, :] == t, u,
                                    float("inf")).sort(dim=-1).values
                        [..., (km + 3) // 4 - 1] for t in range(4)]
            tau = torch.stack(per_lane, -1).amax(-1)
            if mode == "packed":
                tau = _widen(_f32_up(tau), low)
        elif mode == "packed":
            kth = torch.where(pushed, key, INT_MAX).topk(
                k, dim=-1, largest=False).values[..., k - 1]
            if widen:
                tau = (kth | low).view(torch.float32).double()
            else:   # the k-th entry's own distance
                col = torch.where(kth == INT_MAX, 0, kth & low).long()
                tau = d.gather(-1, col[..., None])[..., 0].double()
            tau = torch.where(kth == INT_MAX, float("nan"), tau)
        else:
            tau = torch.where(pushed, d, float("inf")).topk(
                k, dim=-1, largest=False).values[..., k - 1].double()
        keep = ~(e > tau[..., None] + margin) | \
            ~torch.isfinite(tau)[..., None] | big | eye
        pushed |= keep & in_tile
    if mode == "packed":
        sel = torch.where(pushed, key, INT_MAX).topk(
            k, dim=-1, largest=False).values
        return (sel & low).long()
    return smallest_k(torch.where(pushed, d, float("inf")), k)[1]


def quantum_cloud(N: int = 2048, C: int = 16) -> torch.Tensor:
    """[1, N, C]: query 1000 at e1, every other point at -e1 + delta e2,
    so that every distance from the query lies in one packed quantum [4, 4
    + 2^-10) (low = 2^11 - 1 at N = 2048) and the query's packed top-k are
    the lowest columns. The block of queries 896 .. 1023 walks its own
    tiles (keys 896 .. 1023, at delta^2 ~ 1e-6) first and columns 0 .. 63
    (delta^2 = 0.9 * 2^-10) after them: compared with the k-th distance,
    about 4 + 1e-6, and a margin of 2^-11, the lowest columns are dropped
    though they belong."""
    x = np.zeros((1, N, C), np.float32)
    x[0, :, 0] = -1.0
    delta2 = np.full(N, 0.5 * 2.0 ** -10)
    delta2[896:1024] = 1e-6 * (1 + np.arange(128) / 128)
    delta2[:64] = 0.9 * 2.0 ** -10
    x[0, :, 1] = np.sqrt(delta2)
    x[0, 1000] = 0.0
    x[0, 1000, 0] = 1.0
    return torch.from_numpy(x)


def hard_input(name: str) -> torch.Tensor:
    """The inputs on which a filter that broke the contract would show:
    an integer grid with many exact ties, a cloud far from the origin (the
    margin then covers every distance), one point repeated (every distance
    0), one point perturbed by an ulp or two (the fold's distances fall on
    both sides of 0, and the packed key clamps those below), normal draws
    at 16 channels, the quantum cloud, and normal draws at kernel B's
    serving width and size ([1, 2048, 64])."""
    rng = np.random.default_rng(21)
    if name == "quantum":
        return quantum_cloud()
    if name == "randn_2048":
        return torch.from_numpy(rng.standard_normal((1, 2048, 64))
                                .astype(np.float32))
    kind, c = name.split("_")
    r = rng.standard_normal((2, 512, int(c)))
    point = np.broadcast_to(100 * r[:1, :1], r.shape).astype(np.float32)
    ulps = rng.integers(-2, 3, r.shape) * np.spacing(point)
    x = {"grid": np.round(4 * r), "offset": r + 1000,
         "repeat": np.broadcast_to(r[:1, :1], r.shape),
         "near": point + ulps, "randn": r}[kind]
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


HARD = ("grid_64", "offset_64", "repeat_64", "near_64", "randn_16",
        "quantum", "randn_2048")


def plain_select(x: torch.Tensor, k: int, mode: str) -> torch.Tensor:
    return select_plain(self_sqdist(x), k, mode)


class TestFilterRule:
    """The filter with the wrappers' margin, first tile bound and packed
    widening picks exactly what the plain selection picks, in both orders,
    on every hard input; without the widening it drops a neighbour of the
    quantum cloud, and with no margin one of the far cloud."""

    @pytest.mark.parametrize("mode", ["packed", "exact"])
    @pytest.mark.parametrize("name", HARD)
    def test_margin_keeps_every_neighbour(self, name, mode):
        x = hard_input(name)
        for k in (10, 20):
            idx = filter_select(x, k, mode, FILTER_MU, FILTER_NU)
            assert torch.equal(idx, plain_select(x, k, mode)), k

    def test_quantum_cloud_needs_the_widening(self):
        x = quantum_cloud()
        ref = plain_select(x, 10, "packed")
        assert ref[0, 1000].tolist() == list(range(10))
        narrow = filter_select(x, 10, "packed", FILTER_MU, FILTER_NU,
                               widen=False)
        assert not torch.equal(narrow[0, 1000], ref[0, 1000])
        assert torch.equal(filter_select(x, 10, "packed", FILTER_MU,
                                         FILTER_NU), ref)

    def test_no_margin_drops_a_neighbour(self):
        x = hard_input("offset_64")
        for mode in ("packed", "exact"):
            idx = filter_select(x, 10, mode, 0.0, 0.0)
            assert not torch.equal(idx, plain_select(x, 10, mode)), mode

    def test_near_point_clamps_below_zero(self):
        """The perturbed point's fold gives distances on both sides of 0;
        the packed key clamps those below 0 to 0, so the packed order
        takes the lowest columns among them."""
        x = hard_input("near_64")
        d = self_sqdist(x)[0, 0]
        assert int((d < 0).sum()) >= 10 and int((d > 0).sum()) >= 10
        below = [j for j in range(1, d.numel()) if d[j] <= 0][:10]
        assert plain_select(x, 10, "packed")[0, 0].tolist() == below


def _card(x: torch.Tensor) -> torch.Tensor:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return x.cuda()


def _hold_b(x: torch.Tensor, k: int, forms=FORMS) -> None:
    """Kernel B against `knn_edge_plain` in every form, bit for bit, and
    against itself over two launches."""
    from sp_gan_tpu_torch.ops.kernels.knn_edge import (knn_edge,
                                                       knn_edge_plain)
    for mode, cd, diff_only in forms:
        ee, idx = knn_edge(x, k, cd, diff_only, mode)
        ee2, idx2 = knn_edge(x, k, cd, diff_only, mode)
        pee, pidx = knn_edge_plain(x, k, cd, diff_only, mode)
        tag = (mode, cd, diff_only)
        assert torch.equal(idx, pidx) and torch.equal(ee, pee), tag
        assert torch.equal(idx, idx2) and torch.equal(ee, ee2), tag


def _hold_a(x: torch.Tensor, k: int) -> None:
    """Kernel A against `knn_plain` and kernel G, bit for bit."""
    from sp_gan_tpu_torch.ops.kernels import knn, knn_blocked, knn_plain
    idx, dist = knn(x, k)
    for ridx, rdist in (knn_plain(x, k), knn_blocked(x, k)):
        assert torch.equal(idx, ridx) and torch.equal(dist, rdist)


def _randn(shape, seed=0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed)
                            .standard_normal(shape).astype(np.float32))


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("C, k", [(16, 7), (64, 10), (64, 20),
                                      (128, 32)])
    def test_kernel_b_single_cloud(self, C, k):
        """B = 1: the keys split into chunks and merged."""
        _hold_b(_card(_randn((1, 2048, C), seed=C + k)), k)

    @pytest.mark.parametrize("C, k", [(64, 10), (128, 32)])
    def test_kernel_b_serving_batch(self, C, k):
        """B = 64 at the serving size: one chunk, the merge pass writes
        the edges."""
        _hold_b(_card(_randn((64, 2048, C), seed=C)), k)

    def test_kernel_b_ragged(self):
        """A cloud size that fills no tile or block, at the widths of the
        CUDA-core pass (3) and of the filter (64)."""
        for C in (3, 64):
            _hold_b(_card(_randn((3, 1999, C), seed=5)), 10)

    @pytest.mark.parametrize("name", HARD)
    def test_kernel_b_hard_inputs(self, name):
        _hold_b(_card(hard_input(name)), 10)

    def test_kernel_b_no_margin_differs(self):
        """The control of the margin on the card: kernel B in packed mode
        launched with mu = nu = 0 on a cloud far from the origin differs
        from its plain version, so the checks above would catch a margin
        that the card's TF32 sums break."""
        from sp_gan_tpu_torch.ops.kernels.knn_edge import (_launch,
                                                           knn_edge_plain)
        x = _card(_randn((2, 2048, 64), seed=9) + 1000)
        _, idx = _launch(x, 10, torch.float32, True, "packed", 0.0, 0.0)
        assert not torch.equal(idx, knn_edge_plain(x, 10, torch.float32,
                                                   True, "packed")[1])

    @pytest.mark.parametrize("C, k", list(itertools.product((3, 4, 8, 64),
                                                            (10, 32))))
    def test_kernel_a(self, C, k):
        _hold_a(_card(_randn((4, 2048, C), seed=C * k)), k)

    @pytest.mark.parametrize("name", ("template", "grid_3", "repeat_3",
                                      "grid_64", "offset_64"))
    def test_kernel_a_hard_inputs(self, name):
        """The serving request's EdgeConv1 input (the sphere template 64
        times) and the hard inputs at C = 3 and C = 64."""
        if name == "template":
            from sp_gan_tpu_torch.data.sphere import sphere_template
            x = torch.from_numpy(sphere_template(2048))[None] \
                .repeat(64, 1, 1)
        else:
            x = hard_input(name)
        _hold_a(_card(x), 10)
