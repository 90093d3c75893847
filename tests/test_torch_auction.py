"""The port's EMD auction (kernel E's plain version, `ops/emd.py`) and voxel
histogram against the JAX package on the CPU.

`auction_plain` runs the algorithm of `auction_assignment_pallas` in modes
"blockgs" and "blockgs_hbm" step for step, so on the same d the
assignments must be equal exactly, the spent-cap case included; the JAX
side runs in Pallas interpret mode, jitted. Where the cap is not spent,
the assignment is also a bijection within n * eps of scipy's Hungarian
optimum. End to end, the two packages compute d in other f32 orders, so
there the assignments may part at a near-tie and the costs are held to
the n * eps bound instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy.optimize import linear_sum_assignment

import sp_gan_tpu.ops.dispatch as jdispatch
from sp_gan_tpu.ops import emd as jemd
from sp_gan_tpu.ops.pairwise import pairwise_sqdist as jsqdist
from sp_gan_tpu.ops.pallas.auction import auction_assignment_pallas
from sp_gan_tpu.ops.voxel import voxel_occupancy as jvoxel
from sp_gan_tpu_torch.ops import emd
from sp_gan_tpu_torch.ops.kernels import KERNELS, auction, auction_plain
from sp_gan_tpu_torch.ops.kernels.auction import (E_SMEM_STATIC, SMEM_LIMIT,
                                                  block_width, check_fits,
                                                  phase_eps, smem_bytes)
from sp_gan_tpu_torch.ops.voxel import occupancy_distribution, voxel_occupancy

torch.set_num_threads(2)   # six test workers share the host's cores


def clouds(seed, B=2, n=64, m=None, scale=0.3):
    rng = np.random.default_rng(seed)
    x1 = (rng.standard_normal((B, n, 3)) * scale).astype(np.float32)
    x2 = (rng.standard_normal((B, m or n, 3)) * scale).astype(np.float32)
    return x1, x2


def jax_d(x1, x2):
    return np.array(jax.jit(jsqdist)(jnp.asarray(x1), jnp.asarray(x2)))


def jax_auction(d, **kw):
    fn = jax.jit(lambda dd: auction_assignment_pallas(dd, **kw))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(jnp.asarray(d)))


def hungarian_gap(d, asg):
    """(cost of asg - optimal cost) per pair."""
    out = []
    for b in range(d.shape[0]):
        r, c = linear_sum_assignment(d[b])
        out.append(d[b][np.arange(d.shape[1]), asg[b]].sum()
                   - d[b][r, c].sum())
    return np.array(out)


class TestAuctionPlain:
    @pytest.mark.parametrize("mode, eps, iters, phases", [
        ("blockgs", 0.005, 800, 3),
        ("blockgs_hbm", 0.005, 800, 3),
        ("blockgs", 0.005, 50, 1),          # the training regime's phases
        ("blockgs", 0.002, 3, 3),           # the cap runs out in phase 1
    ])
    def test_equals_the_pallas_kernel(self, mode, eps, iters, phases):
        d = jax_d(*clouds(5))
        want = jax_auction(d, eps=eps, iters=iters, phases=phases,
                           mode=mode, block_w=16)
        asg, rounds, bidders = auction_plain(torch.from_numpy(d), eps,
                                             iters, phases, block_w=16)
        np.testing.assert_array_equal(asg.numpy(), want)
        cap = iters * 64 // 16
        spent = rounds.numpy() >= cap
        assert (rounds.numpy() <= cap).all()
        # a round has 1 to w bidders
        assert (rounds <= bidders).all() and (bidders <= 16 * rounds).all()
        if iters == 3:
            assert spent.all()       # every row forced in the last phase
        for b in np.flatnonzero(~spent):
            assert len(set(want[b])) == 64, "not a bijection"
            assert hungarian_gap(d[b:b + 1], want[b:b + 1])[0] \
                <= 64 * eps + 1e-5

    @pytest.mark.parametrize("kind, mode, eps, iters, phases, block_w", [
        ("ties", "blockgs", 0.005, 800, 3, 16),
        ("ties", "blockgs_hbm", 0.005, 50, 1, 64),
        ("m_not_4", "blockgs", 0.005, 400, 2, 16),
        ("m_not_4", "blockgs_hbm", 0.002, 3, 3, 8),    # the cap runs out
    ])
    def test_hard_inputs_equal_the_pallas_kernel(self, kind, mode, eps, iters,
                                                 phases, block_w):
        """The inputs that reach kernel E's edge cases, as chip_smoke.py
        holds the kernel on them: clouds on a coarse grid (many duplicated
        points, so exact ties in d and in the bids) and M = N + 2, not a
        multiple of 4 (the kernel's scalar columns); block widths below
        64. The plain version equals the Pallas kernel exactly."""
        if kind == "ties":
            x1, x2 = (np.round(c * 2) / 2 for c in clouds(13))
            assert len(np.unique(x1[0], axis=0)) < 32   # of 64 points
        else:
            x1, x2 = clouds(14, m=66)
        d = jax_d(x1.astype(np.float32), x2.astype(np.float32))
        want = jax_auction(d, eps=eps, iters=iters, phases=phases,
                           mode=mode, block_w=block_w)
        asg, rounds, _ = auction_plain(torch.from_numpy(d), eps, iters,
                                       phases, block_w=block_w)
        np.testing.assert_array_equal(asg.numpy(), want)
        cap = iters * 64 // block_w
        for b in np.flatnonzero(rounds.numpy() < cap):
            assert len(set(want[b])) == 64, "not a bijection"

    def test_uneven_block_width_and_sizes(self):
        """w is halved until it divides N (N=48: 64 -> 16), and M may
        differ from N."""
        assert block_width(48, 64) == 16 and block_width(2048, 64) == 64
        d = jax_d(*clouds(3, B=1, n=48, m=56))
        want = jax_auction(d, eps=0.005, iters=400, phases=2,
                           mode="blockgs", block_w=64)
        asg, _, _ = auction_plain(torch.from_numpy(d), 0.005, 400, 2)
        np.testing.assert_array_equal(asg.numpy(), want)

    @pytest.mark.parametrize("iters, phases", [(800, 3), (3, 3)])
    def test_pairs_side_by_side_equal_each_pair_alone(self, iters, phases):
        """The pairs of one call share nothing: each ends as it would
        alone, with its own rounds and bidders (the cap spent or not)."""
        d = torch.from_numpy(jax_d(*clouds(9, B=3)))
        together = auction_plain(d, 0.005, iters, phases, block_w=16)
        for b in range(3):
            alone = auction_plain(d[b:b + 1], 0.005, iters, phases,
                                  block_w=16)
            for x, y in zip(together, alone):
                assert torch.equal(x[b:b + 1], y)

    def test_bidders_of_one_round(self):
        """iters=1, one block: the single round's bidders are all N rows."""
        d = torch.from_numpy(jax_d(*clouds(4, B=2, n=16)))
        _, rounds, bidders = auction_plain(d, 0.005, 1, 1, block_w=16)
        assert rounds.tolist() == [1, 1] and bidders.tolist() == [16, 16]

    def test_phase_eps_rounds_once_from_float64(self):
        e = phase_eps(0.002, 8.0, 4)
        assert e.dtype == np.float32
        assert e.tolist() == [np.float32(0.002 * 8.0 ** k) for k in
                              (3, 2, 1, 0)]

    def test_wrapper_runs_the_plain_version_on_cpu(self):
        d = torch.from_numpy(jax_d(*clouds(7)))
        before = KERNELS["auction"].launches
        a, r, u = auction(d, 0.005, 100, 2, block_w=16)
        b, s, v = auction_plain(d, 0.005, 100, 2, block_w=16)
        assert torch.equal(a, b) and torch.equal(r, s) and torch.equal(u, v)
        assert a.dtype == torch.int32 and r.dtype == torch.int32
        assert u.dtype == torch.int64
        assert KERNELS["auction"].launches == before

    @pytest.mark.parametrize("bad, match", [
        (dict(phases=17), "phases"), (dict(block_w=128), "block_w")])
    def test_rejects(self, bad, match):
        d = torch.zeros(1, 8, 8)
        kw = {**dict(eps=0.01, iters=1, phases=1), **bad}
        with pytest.raises(ValueError, match=match):
            auction(d, **kw)


@pytest.mark.parametrize("N, M, fits", [
    (2048, 2048, True), (16384, 16384, True), (4096, 4096, True),
    (8192, 24000, False),            # state over the block's shared memory
    (16384, 16385, False)])          # d over 1 GB
def test_kernel_e_shared_memory_refusal(N, M, fits):
    """Kernel E's wrapper refuses, before any launch, a pair whose price,
    owner, inverse and counts (and the kernel's static partials) pass the
    block's shared memory, or whose d passes 1 GB."""
    if fits:
        assert check_fits(N, M, 64) == block_width(N, 64)
        assert smem_bytes(N, M, 64) + E_SMEM_STATIC <= SMEM_LIMIT
    else:
        with pytest.raises(ValueError, match="kernel E"):
            check_fits(N, M, 64)


@pytest.mark.cuda
def test_kernel_e_matches_plain_on_cuda():
    """Kernel E against its plain version on the card: bit-equal
    assignments, rounds and bidders (chip_smoke.py does the same at
    N=2048/4096)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    d = torch.from_numpy(jax_d(*clouds(5, B=3, n=256))).cuda()
    for eps, iters, phases in ((0.005, 50, 1), (0.002, 10000, 4)):
        a, r, u = auction(d, eps, iters, phases)
        b, s, v = auction_plain(d, eps, iters, phases)
        assert torch.equal(a, b) and torch.equal(r, s) and torch.equal(u, v)


class TestEMD:
    def test_jacobi_equals_jax_auction_single(self):
        d = jax_d(*clouds(11))
        want = np.asarray(jax.jit(jax.vmap(
            lambda dd: jemd._auction_single(dd, 0.005, 50)))(jnp.asarray(d)))
        got = emd.auction_jacobi(torch.from_numpy(d), 0.005, 50)
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("iters", [80, 1000])
    def test_scaled_end_to_end(self, monkeypatch, iters):
        """emd_auction(scaled=True) against JAX's with Pallas patched on
        (the block Gauss-Seidel kernel in interpret mode). The packages'
        d differ in rounding; where the assignments agree, the distances
        agree within 1e-6, and each pair's cost within n * eps."""
        x1, x2 = clouds(13, B=3)
        monkeypatch.setattr(jdispatch, "pallas_enabled", lambda: True)
        fn = jax.jit(lambda a, b: jemd.emd_auction(a, b, 0.005, iters, True))
        with pltpu.force_tpu_interpret_mode():
            jd, ja = (np.asarray(v) for v in fn(jnp.asarray(x1),
                                               jnp.asarray(x2)))
        pd, pa = emd.emd_auction(torch.from_numpy(x1), torch.from_numpy(x2),
                                 0.005, iters, True)
        pd, pa = pd.numpy(), pa.numpy()
        same = pa == ja
        assert same.mean() > 0.9
        np.testing.assert_allclose(pd[same], jd[same], rtol=0, atol=1e-6)
        np.testing.assert_allclose(pd.sum(-1), jd.sum(-1), rtol=0,
                                   atol=64 * 0.005)

    @pytest.mark.parametrize("scaled", [False, True])
    def test_gradient(self, scaled):
        """2 g (x1 - x2[sigma]) for xyz1, zeros for xyz2."""
        x1, x2 = (torch.from_numpy(c).requires_grad_()
                  for c in clouds(17, n=32, m=40))
        dist, asg = emd.emd_auction(x1, x2, 0.01, 60, scaled)
        g = torch.from_numpy(np.random.default_rng(0).standard_normal(
            dist.shape).astype(np.float32))
        (dist * g).sum().backward()
        matched = torch.gather(x2.detach(), 1,
                               asg.long()[..., None].expand(-1, -1, 3))
        want = 2.0 * g[..., None] * (x1.detach() - matched)
        assert torch.equal(x1.grad, want)
        assert x2.grad.shape == x2.shape and not x2.grad.any()
        assert not asg.requires_grad

    def test_emd_cost(self):
        x1, x2 = (torch.from_numpy(c) for c in clouds(19, n=32))
        dist, _ = emd.emd_auction(x1, x2, 0.005, 50)
        want = torch.sqrt(torch.clamp(dist, min=0)).mean(-1)
        assert torch.equal(emd.emd_cost(x1, x2, 0.005, 50), want)
        jc = np.asarray(jax.jit(lambda a, b: jemd.emd_cost(a, b, 0.005, 50))(
            jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy())))
        np.testing.assert_allclose(want.numpy(), jc, rtol=1e-5)


class TestVoxel:
    @pytest.mark.parametrize("res", [28, 7])
    def test_counts_equal(self, res):
        rng = np.random.default_rng(3)
        pcs = (rng.standard_normal((4, 500, 3)) * 0.3).astype(np.float32)
        pcs[0, :5] = [[0.5, 0, 0], [-0.5, 0, 0], [0.4999999, 0.1, -0.5],
                      [0.2, 0.7, 0], [-0.25, 0.25, 0.0]]
        want = np.asarray(jvoxel(jnp.asarray(pcs), res=res))
        got = voxel_occupancy(torch.from_numpy(pcs), res=res)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        p = occupancy_distribution(torch.from_numpy(pcs), res=res)
        want = want.astype(np.float64)
        np.testing.assert_allclose(p.numpy(), want / want.sum(), rtol=1e-12)
