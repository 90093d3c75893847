"""Kernel O's plain version (`ops/kernels/auction_jacobi.py::
jacobi_auction_plain`, the Jacobi EMD auction in modes "jacobi" and
"packed") against the JAX package's `auction_assignment_pallas` in the
same modes (interpret mode, jitted, as tests/test_pallas.py runs it):
assignments equal exactly on the same d, the spent-cap case and N != M
included. Rounds and bidders against a step-by-step count in numpy, pair
by pair; the routing of `auction(mode=...)`.

Kernel O itself runs only on a GPU (`cuda` marker); chip_smoke.py holds it
against its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sp_gan_tpu.ops.pairwise import pairwise_sqdist as jsqdist
from sp_gan_tpu.ops.pallas.auction import auction_assignment_pallas
from sp_gan_tpu_torch.ops import kernels
from sp_gan_tpu_torch.ops.kernels import (auction, jacobi_auction,
                                          jacobi_auction_plain)
from sp_gan_tpu_torch.ops.kernels.auction import phase_eps
from sp_gan_tpu_torch.ops.kernels.auction_jacobi import pack_bits

torch.set_num_threads(2)   # six test workers share the host's cores


def jax_d(seed, B=2, n=64, m=None, scale=0.3):
    rng = np.random.default_rng(seed)
    x1 = (rng.standard_normal((B, n, 3)) * scale).astype(np.float32)
    x2 = (rng.standard_normal((B, m or n, 3)) * scale).astype(np.float32)
    return np.array(jax.jit(jsqdist)(jnp.asarray(x1), jnp.asarray(x2)))


def jax_auction(d, **kw):
    fn = jax.jit(lambda dd: auction_assignment_pallas(dd, **kw))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(jnp.asarray(d)))


def f32(v):
    return np.float32(v)


def step_by_step(D, eps, iters, phases, theta, mode):
    """One pair in numpy, a row and an item at a time: (assignment,
    rounds, bidders)."""
    n, m = D.shape
    bits = pack_bits(n, m)
    low, hi = (1 << bits) - 1, ~((1 << bits) - 1)
    price = np.zeros(m, np.float32)
    rounds = bidders = 0
    owner = None
    for e in phase_eps(eps, theta, phases):
        owner = np.full(m, -1)
        flag = n
        while flag > 0 and rounds < iters:
            unassigned = [r for r in range(n) if r not in set(owner)]
            flag = len(unassigned)
            bidders += flag
            offers = {}                   # item -> (key, bid, row)
            for r in unassigned:
                if mode == "jacobi":
                    v = (-D[r]).astype(np.float32) - price
                    best_i = int(np.argmax(v))
                    others = np.delete(v, best_i)
                    second = max(f32(-1e30), others.max()) if m > 1 \
                        else f32(-1e30)
                    bid = f32(f32(v[best_i] - second) + e)
                    key = (bid, -r)       # the higher bid, then the lower row
                else:
                    u = D[r] + price
                    u = np.where(u < 0, f32(0), u).astype(np.float32)
                    pk = (u.view(np.int32) & hi) | np.arange(m, dtype=np.int32)
                    p1 = pk.min()
                    best_i = int(p1 & low)
                    p2 = np.delete(pk, best_i).min() if m > 1 \
                        else np.int32(2 ** 31 - 1)
                    best_u = np.int32(p1 & hi).view(np.float32)
                    second_u = np.int32(p2 & hi).view(np.float32)
                    raw = f32(f32(second_u - best_u) + e)
                    bp = np.array(max(raw, f32(0)), np.float32).view(
                        np.int32) & hi
                    key = int(bp | r)     # the higher packed bid and row
                    bid = np.int32(bp).view(np.float32)
                if best_i not in offers or key > offers[best_i][0]:
                    offers[best_i] = (key, bid, r)
            for item, (_, bid, r) in offers.items():
                owner[item] = r
                price[item] = f32(price[item] + bid)
            rounds += 1
    asg = np.argmin((D + price).astype(np.float32), axis=1)
    for item, r in enumerate(owner):
        if r >= 0:
            asg[r] = item
    return asg, rounds, bidders


CASES = [
    # n, m, eps, iters, phases: converged, converged over 3 phases, N < M,
    # N > M (rows always left unassigned: the cap is spent), the cap spent
    # in phase 1
    (64, 64, 0.01, 400, 1),
    (48, 48, 0.005, 200, 3),
    (40, 64, 0.005, 300, 2),
    (64, 40, 0.01, 300, 1),
    (64, 64, 0.002, 7, 3),
]


@pytest.mark.parametrize("mode", ["jacobi", "packed"])
@pytest.mark.parametrize("n, m, eps, iters, phases", CASES)
def test_equals_the_pallas_kernel(mode, n, m, eps, iters, phases):
    d = jax_d(n + m, n=n, m=m)
    want = jax_auction(d, eps=eps, iters=iters, phases=phases, mode=mode)
    asg, rounds, bidders = jacobi_auction_plain(torch.from_numpy(d), eps,
                                                iters, phases, mode=mode)
    assert asg.dtype == torch.int32 and asg.shape == (2, n)
    np.testing.assert_array_equal(asg.numpy(), want)
    assert (rounds <= iters).all()
    if iters == 7:
        assert (rounds == iters).all()          # the cap was spent


@pytest.mark.parametrize("mode", ["jacobi", "packed"])
@pytest.mark.parametrize("n, m, eps, iters, phases", [
    (24, 24, 0.01, 500, 2), (20, 28, 0.005, 500, 1), (24, 24, 0.002, 5, 2)])
def test_rounds_and_bidders_step_by_step(mode, n, m, eps, iters, phases):
    """Each pair's assignment, rounds (the no-op round after convergence
    counted) and bidders (rows unassigned at each round's start, summed)
    equal a numpy run of one pair a row at a time."""
    d = jax_d(7 * n + m, B=3, n=n, m=m)
    asg, rounds, bidders = jacobi_auction_plain(torch.from_numpy(d), eps,
                                                iters, phases, mode=mode)
    for b in range(3):
        a, r, u = step_by_step(d[b], eps, iters, phases, 8.0, mode)
        np.testing.assert_array_equal(asg[b].numpy(), a)
        assert (int(rounds[b]), int(bidders[b])) == (r, u)


def test_a_converged_pair_is_a_bijection():
    d = jax_d(3, B=2, n=48)
    for mode in ("jacobi", "packed"):
        asg, rounds, _ = jacobi_auction_plain(torch.from_numpy(d), 0.005,
                                              2000, 3, mode=mode)
        assert (rounds < 2000).all()
        for b in range(2):
            assert len(set(asg[b].tolist())) == 48


def test_auction_routes_by_mode():
    """`auction(mode="jacobi"|"packed")` is kernel O's wrapper, the
    blockgs modes kernel E's; on the CPU nothing launches."""
    d = torch.from_numpy(jax_d(5, n=32))
    kernels.reset_launch_counts()
    for mode in ("jacobi", "packed"):
        got = auction(d, 0.005, 300, 2, mode=mode)
        want = jacobi_auction(d, 0.005, 300, 2, mode=mode)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(kernels.launch_counts().values())
    with pytest.raises(ValueError):
        auction(d, 0.005, 300, 2, mode="gauss")
    with pytest.raises(ValueError):
        jacobi_auction(d, 0.005, 300, 2, mode="blockgs")


@pytest.mark.cuda
def test_kernel_o_matches_plain_on_cuda():
    """Kernel O against its plain version on the card in both modes:
    assignments, rounds and bidders bit-equal (chip_smoke.py does the same
    at [4, 2048, 2048] in the metric regime)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    d = torch.from_numpy(jax_d(9, B=3, n=256)).cuda()
    for mode in ("jacobi", "packed"):
        for iters in (7, 10000):
            got = jacobi_auction(d, 0.002, iters, 4, mode=mode)
            want = jacobi_auction_plain(d, 0.002, iters, 4, mode=mode)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
