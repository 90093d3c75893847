"""Kernel G's plain version (`ops/kernels/knn_blocked.py`, exact kNN for
clouds above 8192 points) against the JAX package's `knn_pallas_blocked`
(interpret mode, jitted, as tests/test_pallas.py runs it) and against
kernel A's plain version, and the N > 8192 route of `ops/dispatch.knn`
against the switch in JAX `knn_pallas` (`knn.py:503-506`).

Kernel G's tensor-core filter is emulated in plain PyTorch (TF32 rounding,
the three-product split, f32 sums in another order, the wrapper's margin):
with the margin it picks exactly what `knn_plain` picks on the inputs where
a broken filter would show, without it it does not. Kernel G itself runs
only on a GPU: the `cuda` tests hold it against kernel A and its plain
version bit for bit at N = 9000 (`python -m pytest
tests/test_torch_knn_blocked.py -m cuda -q` on the H100), as chip_smoke.py
does at N = 16384, and launched with no margin it must differ from kernel
A on the cloud far from the origin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sp_gan_tpu.ops.pallas import knn as jknn
from sp_gan_tpu_torch.ops import dispatch
from sp_gan_tpu_torch.ops.kernels import (knn_blocked, knn_blocked_plain,
                                          knn_plain)

torch.set_num_threads(2)   # six test workers share the host's cores


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


class TestKernelGPlain:
    """Indices equal; distances within 1e-6 of their largest (f32 sums in
    other orders; measured 2.4e-7 relative at C=16). Against kernel A's
    plain version bit for bit, whatever the query chunk."""

    @pytest.mark.parametrize("shape", [(2, 384, 3), (2, 384, 16)])
    def test_matches_pallas_blocked(self, shape):
        x = _x(shape, seed=shape[-1])
        idx, dist = knn_blocked_plain(torch.from_numpy(x), 7)
        fn = jax.jit(lambda v: jknn.knn_pallas_blocked(v, 7, tq=128, cb=128))
        with pltpu.force_tpu_interpret_mode():
            pidx, pdist = fn(jnp.asarray(x))
        assert idx.dtype == torch.int32 and dist.dtype == torch.float32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
        pdist = np.asarray(pdist)
        np.testing.assert_allclose(dist.numpy(), pdist, rtol=0,
                                   atol=1e-6 * np.abs(pdist).max())

    @pytest.mark.parametrize("block", [1, 100, 384, 1000])
    def test_equals_knn_plain(self, block):
        x = torch.from_numpy(_x((2, 384, 16), seed=2))
        idx, dist = knn_blocked_plain(x, 10, block=block)
        ridx, rdist = knn_plain(x, 10)
        assert torch.equal(idx, ridx) and torch.equal(dist, rdist)

    def test_wrapper_takes_plain_version_on_cpu(self):
        x = torch.from_numpy(_x((1, 200, 3)))
        before = knn_blocked.launches
        idx, dist = knn_blocked(x, 5)
        ref = knn_blocked_plain(x, 5)
        assert torch.equal(idx, ref[0]) and torch.equal(dist, ref[1])
        assert knn_blocked.launches == before

    @pytest.mark.parametrize("bad, err", [
        (lambda: knn_blocked(torch.zeros(1, 8, 3, dtype=torch.float64), 2),
         TypeError),
        (lambda: knn_blocked(torch.zeros(1, 8, 3), 8), ValueError),
        (lambda: knn_blocked(torch.zeros(1, 8, 3, device="meta"), 2),
         ValueError),
    ])
    def test_wrapper_rejects(self, bad, err):
        with pytest.raises(err):
            bad()


class TestRoute:
    @pytest.mark.parametrize("N", [8192, 8200])
    def test_routes_like_jax(self, N, monkeypatch):
        """The port takes kernel G exactly where JAX `knn_pallas` takes its
        blocked kernel: above 8192 points."""
        calls = []
        monkeypatch.setattr(jknn, "knn_pallas_blocked",
                            lambda x, k: calls.append("blocked") or (
                                jnp.zeros(x.shape[:2] + (k,), jnp.int32),
                                jnp.zeros(x.shape[:2] + (k,))))
        jax.eval_shape(lambda v: jknn.knn_pallas(v, 3),
                       jax.ShapeDtypeStruct((1, N, 5), jnp.float32))
        jax_blocked = calls == ["blocked"]
        taken = []
        monkeypatch.setattr(dispatch, "knn_blocked", lambda x, k: (
            taken.append("G"), (torch.zeros(1, N, k, dtype=torch.int32),))[1])
        monkeypatch.setattr(dispatch, "knn_kernel", lambda x, k: (
            taken.append("A"), (torch.zeros(1, N, k, dtype=torch.int32),))[1])
        dispatch.knn(torch.zeros(1, N, 5), 3)
        assert taken == (["G"] if jax_blocked else ["A"])
        assert jax_blocked == (N > 8192)


# ------------------------------------------------------------------ filter
# Kernel G's tensor-core filter (csrc/knn_filter.cuh), emulated in plain
# PyTorch: the inputs it must get right, at a small N, and the rule that
# decides which keys get the exact fold.

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (the low 13 mantissa bits cleared) to nearest,
    ties away from zero, as cvt.rna does: half of the dropped bits is added
    to the magnitude before they are masked."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _filter_select(x: torch.Tensor, k: int, mu: float, nu: float,
                   tile: int = 64, queries: int = 128):
    """The kernel's selection over one chunk of keys, in plain PyTorch:
    each block of `queries` walks the key tiles from its own; a key is
    folded exactly (pushed) unless qn - 2 c~ > tau + nu + mu (qn + kn) - kn,
    with c~ the three tf32 products summed in f32 in another order than
    the fold (per 8 channels, last channel first, hi.hi then hi.lo then
    lo.hi into one accumulator) and tau the k-th pushed distance (every key
    kept while it is not finite). Returns (idx, dist) of the k smallest
    pushed keys by the fold's distances."""
    from sp_gan_tpu_torch.ops.pairwise import self_sqdist, smallest_k, sq_norms
    B, N, C = x.shape
    cp = -(-C // 16) * 16
    xp = torch.nn.functional.pad(x, (0, cp - C))
    hi = _tf32(xp)
    lo = _tf32(xp - hi)
    acc = torch.zeros(B, N, N)
    for ks in range(cp // 8):
        for a, b in ((hi, hi), (hi, lo), (lo, hi)):
            s = None
            for c in reversed(range(8 * ks, 8 * ks + 8)):
                p = a[:, :, None, c] * b[:, None, :, c]
                s = p if s is None else s + p
            acc = acc + s
    qn = sq_norms(x).double()
    e = qn[:, :, None] - 2 * acc.double()
    kn = qn[:, None, :]
    t_off = mu * qn[:, :, None] + nu + mu * kn - kn
    big = (qn[:, :, None] >= 2.0 ** 125) | (kn >= 2.0 ** 125)
    d = self_sqdist(x)
    q = torch.arange(N)
    tiles = -(-N // tile)
    first = (q // queries * queries) // tile
    key_tile = q // tile
    pushed = torch.zeros(B, N, N, dtype=torch.bool)
    for it in range(tiles):
        in_tile = key_tile[None, :] == ((first + it) % tiles)[:, None]
        dp = torch.where(pushed, d, torch.full_like(d, float("inf")))
        tau = torch.sort(dp, dim=-1).values[..., k - 1].double()
        keep = ~(e > tau[..., None] + t_off) | ~torch.isfinite(tau)[..., None]
        keep = keep | big | torch.eye(N, dtype=torch.bool)
        pushed |= keep & in_tile
    dist, idx = smallest_k(torch.where(pushed, d, float("inf")), k)
    return idx.to(torch.int32), dist


def _features(N: int, device: str) -> torch.Tensor:
    """The 64-channel features that EdgeConv2 of a request of two shapes
    from the port's generator (seeded weights) hands to the kNN, at N
    points on `device`."""
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.manipulate import Manipulator
    from sp_gan_tpu_torch.nn import fused_eval
    from sp_gan_tpu_torch.nn.generator import Generator
    cfg = Config(np=N)
    man = Manipulator(cfg, Generator(cfg, seed=0), device=device)
    seen = []
    real = fused_eval.edge_features

    def record(x, k, idx=None):
        seen.append(x.detach().clone())
        return real(x, k, idx=idx)
    mp = pytest.MonkeyPatch()
    mp.setattr(fused_eval, "edge_features", record)
    try:
        man.generate(2, seed=3, batch=2)
    finally:
        mp.undo()
    return next(s for s in seen if s.shape[-1] == 64).contiguous()


def _hard_input(name: str) -> torch.Tensor:
    """The inputs on which a filter that broke the contract would show,
    at N = 512: EdgeConv2's features from a request of the port's
    generator, an integer grid with many exact ties, a cloud far from the
    origin (the margin then covers every distance), one point repeated,
    the sphere template and plain normal draws."""
    rng = np.random.default_rng(11)
    N = 512
    if name == "features":
        return _features(N, "cpu")
    if name == "template":
        from sp_gan_tpu_torch.data.sphere import sphere_template
        return torch.from_numpy(sphere_template(N))[None].repeat(2, 1, 1)
    c = int(name.split("_")[1])
    if name.startswith("grid"):
        return torch.from_numpy(np.round(4 * rng.standard_normal((2, N, c)))
                                .astype(np.float32))
    if name.startswith("offset"):
        return torch.from_numpy((rng.standard_normal((2, N, c)) + 1000)
                                .astype(np.float32))
    if name.startswith("repeat"):
        return torch.from_numpy(np.broadcast_to(
            rng.standard_normal((1, 1, c)), (2, N, c)).astype(np.float32))
    return torch.from_numpy(rng.standard_normal((2, N, c))
                            .astype(np.float32))


HARD = ("features", "grid_64", "grid_3", "offset_64", "repeat_64",
        "template", "randn_64", "randn_16")


class TestFilterRule:
    """The filter with the wrapper's margin picks exactly what `knn_plain`
    picks, indices and distances bit for bit, on every hard input; with no
    margin it drops a true neighbour on an input built for that: a cloud
    far from the origin, where qn and kn are about 6.4e7 and the tf32
    sums' error (about 1e2) passes the distances between neighbours."""

    @pytest.mark.parametrize("name", HARD)
    def test_margin_keeps_every_neighbour(self, name):
        from sp_gan_tpu_torch.ops.kernels.knn_blocked import (FILTER_MU,
                                                              FILTER_NU)
        x = _hard_input(name)
        idx, dist = _filter_select(x, 10, FILTER_MU, FILTER_NU)
        ridx, rdist = knn_plain(x, 10)
        assert torch.equal(idx, ridx) and torch.equal(dist, rdist)

    def test_no_margin_drops_a_neighbour(self):
        x = _hard_input("offset_64")
        idx, _ = _filter_select(x, 10, 0.0, 0.0)
        assert not torch.equal(idx, knn_plain(x, 10)[0])

    def test_tf32_rounding(self):
        """Round to nearest at 10 mantissa bits, ties away from zero; the
        largest finite value rounds to inf, as cvt.rna does."""
        one = 1.0
        ulp = 2.0 ** -10
        x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2.01,
                          3.4028234663852886e38, float("inf")],
                         dtype=torch.float32)
        assert _tf32(x).tolist() == [one + ulp, -(one + ulp), one,
                                     float("inf"), float("inf")]


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("name", HARD)
    def test_kernel_g_bit_equal(self, name):
        """Kernel G against `knn_blocked_plain` and kernel A at N = 9000 on
        the card, bit for bit, and bit-identical over two launches."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (kernels have no CPU mode)")
        from sp_gan_tpu_torch.ops.kernels import knn
        x = _card_input(name)
        idx, dist = knn_blocked(x, 10)
        idx2, dist2 = knn_blocked(x, 10)
        aidx, adist = knn(x, 10)
        pidx, pdist = knn_blocked_plain(x, 10)
        assert torch.equal(idx, idx2) and torch.equal(dist, dist2)
        assert torch.equal(idx, aidx) and torch.equal(dist, adist)
        assert torch.equal(idx, pidx) and torch.equal(dist, pdist)

    @pytest.mark.parametrize("C, k", [(128, 32), (9, 11), (8, 10), (5, 10),
                                      (4, 10), (3, 32), (64, 1)])
    def test_kernel_g_widths(self, C, k):
        """The widths and list sizes G takes beside P2's: the widest rows
        (the most shared memory), 4-byte copies of odd widths, the filter
        at its narrowest widths (5 and 8), the CUDA-core kernel at its
        widest (4), lists of 32 and of 1."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (kernels have no CPU mode)")
        from sp_gan_tpu_torch.ops.kernels import knn
        x = torch.from_numpy(_x((2, 9000, C), seed=C)).cuda()
        idx, dist = knn_blocked(x, k)
        aidx, adist = knn(x, k)
        pidx, pdist = knn_blocked_plain(x, k)
        assert torch.equal(idx, aidx) and torch.equal(dist, adist)
        assert torch.equal(idx, pidx) and torch.equal(dist, pdist)


    def test_no_margin_differs_on_card(self):
        """The control of the margin on the card: kernel G launched with
        mu = nu = 0 on the cloud far from the origin differs from kernel
        A, so the bit-equality checks above would catch a margin that the
        card's TF32 sums break."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (kernels have no CPU mode)")
        from sp_gan_tpu_torch.ops.kernels import knn
        from sp_gan_tpu_torch.ops.kernels.knn_blocked import _launch
        x = _card_input("offset_64")
        idx, dist = _launch(x, 10, 0.0, 0.0)
        aidx, adist = knn(x, 10)
        assert not (torch.equal(idx, aidx) and torch.equal(dist, adist))


def _card_input(name: str) -> torch.Tensor:
    """The hard inputs at N = 9000 (above kernel G's switch) on the card:
    the features from a request of the port's generator at that size."""
    N = 9000
    if name == "features":
        return _features(N, "cuda")
    rng = np.random.default_rng(12)
    if name == "template":
        from sp_gan_tpu_torch.data.sphere import sphere_template
        x = np.broadcast_to(sphere_template(N), (2, N, 3))
    else:
        c = int(name.split("_")[1])
        r = rng.standard_normal((2, N, c))
        x = {"grid": np.round(4 * r), "offset": r + 1000,
             "repeat": np.broadcast_to(r[:1, :1], (2, N, c)),
             "randn": r}[name.split("_")[0]]
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()
