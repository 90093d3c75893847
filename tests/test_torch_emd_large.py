"""The scaled EMD past kernel E's limit, on the CPU: `auction_scaled_jacobi`
(`sp_gan_tpu_torch/ops/emd.py`) against the JAX package's
`_auction_single_scaled`, element for element, and the route of
`emd_auction(scaled=True)` that sends a pair above `MAX_BYTES` to it.

The sizes are small; `MAX_BYTES` and `CHUNK_BYTES` are monkeypatched down
so that small pairs take the large pairs' route and several row chunks.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_gan_tpu.ops import emd as jemd
from sp_gan_tpu_torch.ops import emd
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist

# the module of kernel E (the package exports its `auction` function under
# the module's name)
kernel_e = importlib.import_module("sp_gan_tpu_torch.ops.kernels.auction")

torch.set_num_threads(2)   # six test workers share the host's cores


def clouds(seed: int, B: int, n: int, m: int, repeat: bool = False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n, 3)).astype(np.float32)
    y = rng.standard_normal((B, m, 3)).astype(np.float32)
    if repeat:
        # tie-heavy: a few points repeated many times on both sides
        x = x[:, rng.integers(0, 6, n)]
        y = y[:, rng.integers(0, 6, m)]
    return x, y


def sqdist(x, y) -> np.ndarray:
    return pairwise_sqdist(torch.from_numpy(x), torch.from_numpy(y)).numpy()


def jax_scaled(d: np.ndarray, eps: float, iters: int, phases: int):
    return np.asarray(jax.vmap(lambda dd: jemd._auction_single_scaled(
        dd, eps, iters, phases=phases))(jnp.asarray(d)))


def ours(d: np.ndarray, eps: float, iters: int, phases: int):
    runs = [emd.auction_scaled_jacobi(torch.from_numpy(d[b]), eps, iters,
                                      phases, return_state=True)
            for b in range(d.shape[0])]
    return (np.stack([a.numpy() for a, _, _ in runs]),
            [p for _, p, _ in runs], [r for _, _, r in runs])


# (B, N, M, eps, iters, phases, tie-heavy): phases 1 and 4, caps that let
# every phase end and caps that leave rows to the forced pass, N != M
CASES = {
    "128x128, 4 phases, ends": (2, 128, 128, 0.01, 10000, 4, False),
    "96x160, 4 phases, ends": (2, 96, 160, 0.002, 10000, 4, False),
    "128x128, 1 phase, ends": (2, 128, 128, 0.05, 10000, 1, False),
    "128x128, 1 phase, capped": (2, 128, 128, 0.005, 40, 1, False),
    "128x128, 4 phases, capped": (2, 128, 128, 0.002, 30, 4, False),
    "96x160, 4 phases, capped": (2, 96, 160, 0.002, 12, 4, False),
    "tie-heavy 128x128, 4 phases": (2, 128, 128, 0.01, 10000, 4, True),
    "tie-heavy 96x160, 1 phase, capped": (2, 96, 160, 0.005, 25, 1, True),
}


class TestAgainstJax:
    @pytest.mark.parametrize("case", list(CASES))
    def test_assignments_equal(self, case):
        B, n, m, eps, iters, phases, repeat = CASES[case]
        d = sqdist(*clouds(len(case), B, n, m, repeat))
        asg, _, rounds = ours(d, eps, iters, phases)
        np.testing.assert_array_equal(asg, jax_scaled(d, eps, iters, phases))
        assert asg.dtype == np.int32
        ended = [r < iters for r in rounds]
        if "capped" in case:
            assert rounds == [iters] * B
            # the forced pass gave some row an item another row holds
            assert any(len(np.unique(a)) < n for a in asg)
        else:
            assert all(ended)
            # a completed final phase is a full assignment: no item twice
            assert all(len(np.unique(a)) == n for a in asg)

    def test_chunks_do_not_change_the_result(self, monkeypatch):
        B, n, m, eps, iters, phases, _ = CASES["96x160, 4 phases, ends"]
        d = sqdist(*clouds(3, B, n, m))
        whole = ours(d, eps, iters, phases)[0]
        # 7 rows a chunk: the unassigned rows of a round span several
        monkeypatch.setattr(emd, "CHUNK_BYTES", 7 * m * 4)
        np.testing.assert_array_equal(ours(d, eps, iters, phases)[0], whole)

    def test_eps_complementary_slackness(self):
        # dual value less primal cost at most N * eps, in float64, on the
        # final prices of a run whose rounds ended before the cap
        eps = 0.01
        d = sqdist(*clouds(4, 1, 128, 128))[0]
        asg, price, rounds = emd.auction_scaled_jacobi(
            torch.from_numpy(d), eps, 10000, 4, return_state=True)
        assert rounds < 10000
        a = -d.astype(np.float64)
        p = price.numpy().astype(np.float64)
        asg = asg.numpy().astype(np.int64)
        assert len(np.unique(asg)) == len(asg)
        dual = (a - p).max(axis=1).sum() + p.sum()
        primal = a[np.arange(len(asg)), asg].sum()
        assert 0.0 <= dual - primal <= len(asg) * eps

    def test_rejects_a_batch(self):
        with pytest.raises(ValueError, match=r"\[N, M\]"):
            emd.auction_scaled_jacobi(torch.zeros(2, 4, 4), 0.01, 10, 1)


class TestRoute:
    @pytest.mark.parametrize("iters", [50, 10000])
    def test_above_max_bytes_matches_jax(self, monkeypatch, iters):
        # a pair above the (lowered) line takes auction_scaled_jacobi, never
        # kernel E's plain version; JAX on the CPU runs
        # _auction_single_scaled for every pair
        n = 64
        monkeypatch.setattr(emd, "MAX_BYTES", n * n * 4 - 1)

        def no_kernel_e(*a, **k):
            raise AssertionError("kernel E's plain version was called")
        monkeypatch.setattr(kernel_e, "auction_plain", no_kernel_e)
        x, y = clouds(iters, 3, n, n)
        dist, asg = emd.emd_auction(torch.from_numpy(x), torch.from_numpy(y),
                                    0.005, iters, scaled=True)
        jdist, jasg = jemd.emd_auction(jnp.asarray(x), jnp.asarray(y), 0.005,
                                       iters, scaled=True)
        np.testing.assert_array_equal(asg.numpy(), np.asarray(jasg))
        np.testing.assert_allclose(dist.numpy(), np.asarray(jdist),
                                   rtol=1e-6, atol=1e-7)

    def test_pair_matrix_in_row_chunks(self, monkeypatch):
        x, y = clouds(5, 1, 50, 70)
        monkeypatch.setattr(emd, "CHUNK_BYTES", 9 * 70 * 4)
        got = emd._sqdist_rows(torch.from_numpy(x[0]), torch.from_numpy(y[0]))
        assert torch.equal(got, torch.from_numpy(sqdist(x, y)[0]))

    def test_at_the_line_kernel_e_runs(self, monkeypatch):
        n = 32
        monkeypatch.setattr(emd, "MAX_BYTES", n * n * 4)

        def no_jacobi(*a, **k):
            raise AssertionError("auction_scaled_jacobi was called")
        monkeypatch.setattr(emd, "auction_scaled_jacobi", no_jacobi)
        x, y = clouds(6, 2, n, n)
        asg = emd.emd_auction(torch.from_numpy(x), torch.from_numpy(y),
                              0.005, 50, scaled=True)[1]
        d = torch.from_numpy(sqdist(x, y))
        assert torch.equal(asg, kernel_e.auction(d, 0.005, 50, 1)[0])

    def test_kernel_e_limit_message(self):
        with pytest.raises(ValueError, match="auction_scaled_jacobi"):
            kernel_e.check_fits(32768, 16384, 64)
