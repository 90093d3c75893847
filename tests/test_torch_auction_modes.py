"""Kernel O's plain version (`ops/kernels/auction_jacobi.py::
jacobi_auction_plain`, the Jacobi EMD auction in modes "jacobi" and
"packed") against the JAX package's `auction_assignment_pallas` in the
same modes (interpret mode, jitted, as tests/test_pallas.py runs it):
assignments equal exactly on the same d, the spent-cap case and N != M
included. Rounds and bidders against a step-by-step count in numpy, pair
by pair; the routing of `auction(mode=...)`.

Kernel O's round engine (`csrc/auction_jacobi.cu`) emulated in numpy
(`emulate_engine`): the list of unassigned rows kept from round to round,
each bidding row's columns split at float4 slots over the cluster's 4
blocks and over lanes, the partials merged in a shuffled order, the bids
resolved by shuffles (32 bidders or fewer) or by the maximum of 64-bit keys
in chunks of rows; held to `jacobi_auction_plain` round by round on
tie-heavy d in both modes.

Kernel O itself runs only on a GPU (`cuda` marker); chip_smoke.py holds it
against its plain version there, and the `cuda` tests below on the hard
inputs.
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
from sp_gan_tpu_torch.ops.kernels.auction_jacobi import SMALL, pack_bits

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


# ---------------------------------------------------------------------------
# Kernel O's round engine, emulated

KNEG = np.float32(-1e30)
INT_MAX = 2 ** 31 - 1
POS_BITS = 15


def orderable(v):
    """uint32 image of float32 v that orders like the float."""
    u = int(np.float32(v).view(np.uint32))
    return (~u & 0xffffffff) if u & 0x80000000 else u | 0x80000000


def lane_groups(m, ranks, rng):
    """The column groups a lane of one of `ranks` blocks takes: block k
    scans float4 slots [k S, (k + 1) S) (S = M / (4 ranks) in a cluster,
    all ceil(M / 4) slots for a block alone), lane l of its warp the slots
    l, l + 32, ... of them; shuffled, so that the merges run in another
    order than the kernel's."""
    slots = m // (4 * ranks) if ranks > 1 else -(-m // 4)
    groups = []
    for k in range(ranks):
        for lane in range(32):
            cols = [4 * s + e for s in range(k * slots + lane,
                                             (k + 1) * slots, 32)
                    for e in range(4) if 4 * s + e < m]
            if cols:
                groups.append(np.array(cols))
    rng.shuffle(groups)
    return groups


def top2_parts(v, groups):
    """(best, index, second) of each row of v [nu, M], one partial per
    column group (top2_take's result), merged by top2_merge."""
    b = None
    for cols in groups:
        g = v[:, cols]
        j = g.argmax(axis=1)
        gb = g[np.arange(len(g)), j]
        rest = g.copy()
        rest[np.arange(len(g)), j] = -np.inf
        gs = np.maximum(KNEG, rest.max(axis=1)) if g.shape[1] > 1 \
            else np.full(len(g), KNEG, np.float32)
        gi = cols[j]
        if b is None:
            b, bi, s = gb, gi, gs
            continue
        take = (gb > b) | ((gb == b) & (gi < bi))
        s = np.where(take, np.maximum(gs, b), np.maximum(s, gb))
        b = np.where(take, gb, b)
        bi = np.where(take, gi, bi)
    return b.astype(np.float32), bi, s.astype(np.float32)


def min2_parts(pk, groups):
    """The two smallest packed values of each row of pk [nu, M] int64, one
    partial per column group, merged as the kernel's Min2."""
    m1 = m2 = None
    for cols in groups:
        g = np.sort(pk[:, cols], axis=1)
        o1 = g[:, 0]
        o2 = g[:, 1] if g.shape[1] > 1 else np.full(len(g), INT_MAX)
        if m1 is None:
            m1, m2 = o1, o2
            continue
        m2 = np.minimum(np.maximum(m1, o1), np.minimum(m2, o2))
        m1 = np.minimum(m1, o1)
    return m1, m2


def emulate_engine(D, eps, iters, phases, mode, ranks=4, P=16, seed=0,
                   theta=8.0):
    """Kernel O on one pair D [N, M] f32 as its round engine runs it: (the
    assignment, rounds, bidders, [(owner, price) after each round],
    [the bid ties each round]); see the module docstring."""
    rng = np.random.default_rng(seed)
    n, m = D.shape
    bits = pack_bits(n, m)
    low, hi = (1 << bits) - 1, ~((1 << bits) - 1)
    cols = np.arange(m)
    price = np.zeros(m, np.float32)
    rounds = bidders = 0
    history, ties = [], []
    owner = np.full(m, -1)
    for e in phase_eps(eps, theta, phases):
        e = np.float32(e)
        owner = np.full(m, -1)
        ulist = list(range(n))
        nu = flag = n
        while flag > 0 and rounds < iters:
            flag = nu
            rounds += 1
            bidders += nu
            rows = np.array(ulist, dtype=np.int64)
            groups = lane_groups(m, ranks, rng)
            if mode == "jacobi":
                v = (-D[rows]).astype(np.float32) - price
                b, item, sec = top2_parts(v, groups)
                val = ((b - sec).astype(np.float32) + e).astype(np.float32)
                has = val > np.float32(-5e29)
                pk = np.zeros(nu, np.int64)
            else:
                u = (D[rows] + price).astype(np.float32)
                u = np.where(u < 0, np.float32(0), u).astype(np.float32)
                pkm = (u.view(np.int32).astype(np.int64) & hi) | cols
                m1, m2 = min2_parts(pkm, groups)
                item = m1 & low
                best_u = (m1 & hi).astype(np.int32).view(np.float32)
                second_u = (m2 & hi).astype(np.int32).view(np.float32)
                bid = ((second_u - best_u).astype(np.float32) + e
                       ).astype(np.float32)
                bid = np.where(bid < 0, np.float32(0), bid).astype(
                    np.float32)
                bp = bid.view(np.int32).astype(np.int64) & hi
                val = bp.astype(np.int32).view(np.float32)
                pk = bp | rows
                has = pk > SMALL
            # ties: two bidders on one item with equal bids
            seen = {}
            for x in range(nu):
                if has[x]:
                    seen.setdefault((int(item[x]), val[x].tobytes()),
                                    []).append(x)
            ties.append(sum(len(g) > 1 for g in seen.values()))
            if nu <= min(32, P):
                # the one-warp pick: each bidder against every other
                win = []
                for x in range(nu):
                    beaten = not has[x]
                    for y in range(nu):
                        if y == x or item[y] != item[x] or not has[y]:
                            continue
                        if mode == "jacobi":
                            beaten |= bool(val[y] > val[x] or (
                                val[y] == val[x] and rows[y] < rows[x]))
                        else:
                            beaten |= bool(pk[y] > pk[x])
                    win.append(not beaten)
                evicted = []
                for x in range(nu):
                    if win[x]:
                        prev = owner[item[x]]
                        owner[item[x]] = rows[x]
                        price[item[x]] = np.float32(price[item[x]] + val[x])
                        if prev >= 0:
                            evicted.append(int(prev))
                ulist = [int(rows[x]) for x in range(nu) if not win[x]] \
                    + evicted
            else:
                # chunks of P rows offer 64-bit keys; max per item
                key = {}
                for c0 in range(0, nu, P):
                    for x in rng.permutation(range(c0, min(nu, c0 + P))):
                        if not has[x]:
                            continue
                        if mode == "jacobi":
                            v0 = np.float32(0) if val[x] == 0 else val[x]
                            k = (orderable(v0) << 32) | (
                                ((1 << POS_BITS) - 1 - int(rows[x]))
                                << POS_BITS) | int(x)
                        else:
                            k = ((int(pk[x]) ^ 0x80000000) << 32) | int(x)
                        key[int(item[x])] = max(key.get(int(item[x]), 0), k)
                won, evicted = set(), []
                for it in sorted(key):
                    x = key[it] & ((1 << POS_BITS) - 1)
                    prev = owner[it]
                    owner[it] = rows[x]
                    price[it] = np.float32(price[it] + val[x])
                    won.add(x)
                    if prev >= 0:
                        evicted.append(int(prev))
                ulist = evicted + [int(rows[x]) for x in range(nu)
                                   if x not in won]
            nu = len(ulist)
            history.append((owner.copy(), price.copy()))
    asg = np.argmin((D + price).astype(np.float32), axis=1)
    for it, r in enumerate(owner):
        if r >= 0:
            asg[r] = it
    return asg, rounds, bidders, history, ties


def rounded_pairs(seed, B, n, m, step=0.25):
    """d between clouds on a coarse grid: many duplicated points, so ties
    in d and in the bids."""
    rng = np.random.default_rng(seed)
    x1 = np.round(rng.standard_normal((B, n, 3)) * 0.5 / step) * step
    x2 = np.round(rng.standard_normal((B, m, 3)) * 0.5 / step) * step
    return np.array(jax.jit(jsqdist)(jnp.asarray(x1, jnp.float32),
                                     jnp.asarray(x2, jnp.float32)))


def hard_d(kind, seed):
    """The tie-heavy inputs: rounded clouds, repeated rows (N > distinct
    rows) and integer-valued d."""
    rng = np.random.default_rng(seed)
    if kind == "rounded":
        return rounded_pairs(seed, 2, 64, 64)
    if kind == "repeated":
        d = jax_d(seed, B=2, n=48, m=64)
        d[:, 16:32] = d[:, :16]
        d[:, 40:] = d[:, 3:4]
        return d
    if kind == "integer":
        return rng.integers(0, 4, (2, 40, 48)).astype(np.float32)
    return rounded_pairs(seed, 2, 36, 50)   # M % 4 != 0: a block alone


HARD = [("rounded", 0.002, 300, 3), ("repeated", 0.005, 400, 2),
        ("integer", 0.25, 300, 2), ("scalar", 0.01, 300, 2)]


@pytest.mark.parametrize("mode", ["jacobi", "packed"])
@pytest.mark.parametrize("kind, eps, iters, phases", HARD)
@pytest.mark.parametrize("P", [8, 64])
def test_round_engine_equals_plain_round_by_round(mode, kind, eps, iters,
                                                  phases, P):
    """The emulated engine, its columns over 4 blocks where M splits into
    float4 slots (else one), chunks of P rows: owner and price after every
    round, and the assignment, rounds and bidders, equal the plain
    version's; the inputs put ties in the bids."""
    d = hard_d(kind, 11)
    B, n, m = d.shape
    ranks = 4 if m % 16 == 0 else 1
    seen = []
    asg, rounds, bidders = jacobi_auction_plain(
        torch.from_numpy(d), eps, iters, phases, mode=mode,
        trace=lambda a, o, p: seen.append((a.clone(), o.clone(),
                                           p.clone())))
    tie_rounds = 0
    for b in range(B):
        a, r, u, hist, ties = emulate_engine(d[b], eps, iters, phases, mode,
                                             ranks=ranks, P=P, seed=b)
        plain = [(o[b].numpy(), p[b].numpy()) for act, o, p in seen
                 if act[b]]
        assert len(hist) == len(plain) == r
        for k, ((o1, p1), (o2, p2)) in enumerate(zip(hist, plain)):
            np.testing.assert_array_equal(o1, o2, err_msg=f"round {k}")
            assert p1.tobytes() == p2.tobytes(), f"price, round {k}"
        np.testing.assert_array_equal(asg[b].numpy(), a)
        assert (int(rounds[b]), int(bidders[b])) == (r, u)
        tie_rounds += sum(t > 0 for t in ties)
    assert tie_rounds > 0              # the input reached the tie rules


def test_packed_ties_go_to_the_highest_row():
    """Integer-valued d in packed mode: equal quantized bids on one item,
    and the emulated engine, as the plain version, gives it to the highest
    bidding row (and jacobi mode to the lowest)."""
    d = np.zeros((1, 4, 4), np.float32)
    d[0, :, 0] = 1.0
    d[0, :, 1:] = 3.0        # rows 0-3 all prefer item 0, by the same bid
    for mode, want in (("packed", 3), ("jacobi", 0)):
        seen = []
        jacobi_auction_plain(torch.from_numpy(d), 0.5, 1, 1, mode=mode,
                             trace=lambda a, o, p: seen.append(o.clone()))
        assert int(seen[0][0, 0]) == want
        for P in (2, 32):
            _, _, _, hist, ties = emulate_engine(d[0], 0.5, 1, 1, mode,
                                                 ranks=1, P=P)
            assert int(hist[0][0][0]) == want and ties[0] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind, eps, iters, phases", HARD)
def test_kernel_o_on_hard_inputs_on_cuda(kind, eps, iters, phases):
    """Kernel O on the tie-heavy inputs in both modes: assignments, rounds
    and bidders bit-equal to the plain version and twice alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    d = torch.from_numpy(hard_d(kind, 11)).cuda()
    for mode in ("jacobi", "packed"):
        got = jacobi_auction(d, eps, iters, phases, mode=mode)
        again = jacobi_auction(d, eps, iters, phases, mode=mode)
        want = jacobi_auction_plain(d, eps, iters, phases, mode=mode)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("B, n, m", [(40, 128, 128), (2, 256, 258),
                                     (3, 1000, 1024)])
def test_kernel_o_variants_on_cuda(B, n, m):
    """Kernel O without a cluster (B * 4 above the SMs), with scalar loads
    (M % 4 != 0) and at N != M in a cluster: bit-equal to the plain
    version in both modes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    d = torch.from_numpy(jax_d(B + n, B=B, n=n, m=m)).cuda()
    for mode in ("jacobi", "packed"):
        got = jacobi_auction(d, 0.002, 10000, 4, mode=mode)
        want = jacobi_auction_plain(d, 0.002, 10000, 4, mode=mode)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
