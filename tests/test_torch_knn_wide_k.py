"""The kNN kernels A, B, F and G past k = 32 (33 <= k <= 64, the
generator's --nk up to 128): their plain versions, which the port runs for
a CPU tensor and which the CUDA kernels equal bit for bit, against the JAX
package's Pallas kernels in interpret mode (as tests/test_pallas.py runs
them) at k = 33, 40 and 64; the selection engine's filter rule for wide
lists, emulated on the CPU; the kernels' limit; and one default training
step at --nk 80 against the JAX step at the bounds of
tests/test_torch_train_step.py (D's gradients at the step's own
conditioning, see TestNk80StepParity).

Each Pallas kernel runs once, at k = 64, and the plain versions at k = 33
and 40 are held against the first k columns of its result: every one of
them orders its neighbours ascending by a total order ((distance, index),
or the packed key whose low bits hold the column), so its k nearest are
the first k of its 64, as k rounds of argmin give them. Indices are held
exactly and edge rows bit for bit, except kernel A's indices against
`knn_pallas`, whose distances sum the channels in another order (a dot
product) than every other function here: they are held as
tests/test_torch_ops.py holds them at k = 10, equal up to f32 near-ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import test_torch_knn_select as select
import test_torch_train_step as base
from sp_gan_tpu.ops.pallas import knn as jknn
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.ops.kernels.knn import (FILTER_MU, FILTER_NU, MAX_K,
                                              check_kernel_limits, knn_plain)
from sp_gan_tpu_torch.ops.kernels.knn_blocked import knn_blocked_plain
from sp_gan_tpu_torch.ops.kernels.knn_edge import knn_edge_plain
from sp_gan_tpu_torch.ops.kernels.knn_edge_window import \
    knn_edge_window_plain
from test_torch_ops import assert_same_up_to_near_ties

torch.set_num_threads(2)   # six test workers share the host's cores

WIDE_K = (33, 40, MAX_K)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _interpret(fn, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        out = fn(*args, **kw)
    return [np.asarray(o) for o in out]


def test_kernel_a_plain_matches_pallas():
    """knn_plain at k = 33, 40 and 64 against knn_pallas at k = 64 on [1,
    128, 3]: indices equal up to f32 near-ties, distances within the
    tolerance of tests/test_torch_ops.py (sorted: a near-tie may swap
    two)."""
    x = _x((1, 128, 3), seed=0)
    pidx, pdist = _interpret(jknn.knn_pallas, jnp.asarray(x), MAX_K, tq=64)
    for k in WIDE_K:
        idx, dist = knn_plain(torch.from_numpy(x), k)
        assert idx.shape == (1, 128, k)
        assert_same_up_to_near_ties(idx.numpy(), pidx[..., :k], x)
        np.testing.assert_allclose(np.sort(dist.numpy(), -1),
                                   np.sort(pdist[..., :k], -1), rtol=1e-5,
                                   atol=1e-4)


def test_kernel_g_plain_matches_pallas():
    """knn_blocked_plain at k = 33, 40 and 64 against knn_pallas_blocked
    at k = 64 on [1, 384, 16] (three key blocks of 128): distances within
    1e-6 of their largest, as tests/test_torch_knn_blocked.py holds them
    (f32 sums in other orders), so indices equal up to f32 near-ties: at 64
    neighbours two picks of this draw trade places."""
    x = _x((1, 384, 16), seed=1)
    fn = jax.jit(lambda v: jknn.knn_pallas_blocked(v, MAX_K, tq=128,
                                                   cb=128))
    with pltpu.force_tpu_interpret_mode():
        pidx, pdist = (np.asarray(o) for o in fn(jnp.asarray(x)))
    for k in WIDE_K:
        idx, dist = knn_blocked_plain(torch.from_numpy(x), k)
        assert_same_up_to_near_ties(idx.numpy(), pidx[..., :k], x)
        np.testing.assert_allclose(np.sort(dist.numpy(), -1),
                                   np.sort(pdist[..., :k], -1), rtol=0,
                                   atol=1e-6 * np.abs(pdist).max())


@pytest.mark.parametrize("mode, out_dtype, diff_only", [
    ("exact", "float32", False), ("packed", "bfloat16", True),
    ("exact", "bfloat16", True)])
def test_kernel_b_plain_matches_pallas(mode, out_dtype, diff_only):
    """knn_edge_plain at k = 33, 40 and 64 against knn_edge_pallas at k =
    64 on [1, 128, 32], in the forms on the paths (f32 concat rows, bf16
    diffs in both orders): indices equal, edge rows bit-equal."""
    x = _x((1, 128, 32), seed=2)
    pee, pidx = _interpret(jknn.knn_edge_pallas, jnp.asarray(x), MAX_K,
                           out_dtype, tq=64, diff_only=diff_only,
                           select_mode=mode)
    for k in WIDE_K:
        ee, idx = knn_edge_plain(torch.from_numpy(x), k,
                                 getattr(torch, out_dtype), diff_only, mode)
        np.testing.assert_array_equal(idx.numpy(), pidx[..., :k])
        np.testing.assert_array_equal(ee.float().numpy(),
                                      pee[:, :, :k].astype(np.float32))


@pytest.mark.parametrize("mode", ["exact", "packed"])
def test_kernel_f_plain_matches_pallas(mode):
    """knn_edge_window_plain at k = 33, 40 and 64 against
    knn_edge_window_pallas at k = 64 on [1, 384, 16] with a band of W =
    100 (tq = 128, the JAX tile at N = 384): global indices equal, bf16
    diffs bit-equal."""
    x = _x((1, 384, 16), seed=3)
    pee, pidx = _interpret(jknn.knn_edge_window_pallas, jnp.asarray(x),
                           MAX_K, 100, "bfloat16", diff_only=True,
                           select_mode=mode)
    for k in WIDE_K:
        ee, idx = knn_edge_window_plain(torch.from_numpy(x), k, 100,
                                        torch.bfloat16, diff_only=True,
                                        select_mode=mode)
        np.testing.assert_array_equal(idx.numpy(), pidx[..., :k])
        np.testing.assert_array_equal(ee.float().numpy(),
                                      pee[:, :, :k].astype(np.float32))


# the hard inputs of tests/test_torch_knn_select.py, their first cloud
# ([1, 512, C])
WIDE_HARD = ("grid_64", "offset_64", "repeat_64", "near_64", "randn_16")


@pytest.mark.parametrize("mode", ["packed", "exact"])
@pytest.mark.parametrize("name", WIDE_HARD)
def test_wide_filter_keeps_every_neighbour(name, mode):
    """The engine's rule for wide lists (csrc/knn_filter.cuh): tiles of 32
    keys, the first tile taken whole, the filter with the wrappers' margin
    from the list's k-th entry on. It picks exactly what the plain
    selection picks at k = 33, 40 and 64."""
    x = select.hard_input(name)[:1].contiguous()
    for k in WIDE_K:
        idx = select.filter_select(x, k, mode, FILTER_MU, FILTER_NU, tile=32)
        assert torch.equal(idx, select.plain_select(x, k, mode)), k


def test_limit_is_k_64():
    """The CUDA kernels take k <= 64 (--nk <= 128): k = 64 at 128 channels
    passes, k = 65 raises naming the limit and the flag it came from."""
    assert MAX_K == 64
    check_kernel_limits("kernel B (knn_edge)", 64, 128, 65535)
    with pytest.raises(ValueError, match=r"k <= 64 \(--nk <= 128\).*k=65 "
                                         r"\(from --nk 130\)"):
        check_kernel_limits("kernel B (knn_edge)", 65, 3)


@pytest.fixture(scope="module")
def nk80_step():
    return base.run_both(dtype="float32", nk=80, np=128, zd_one_ulp=True)


class TestNk80StepParity(base.TestOneStepParity):
    """One default step at --nk 80 (k = 40: EdgeConv2's kNN through kernel
    B's plain version, in the exact order `run_both` sets) at N 128, bs 4,
    against the JAX step at the bounds of tests/test_torch_train_step.py,
    D's gradients also at the step's own conditioning (test_d_gradients).
    """

    @pytest.fixture
    def f32_step(self, nk80_step):
        return nk80_step

    def test_d_gradients(self, f32_step):
        """Every element within 1e-3 of its tensor's max-abs and each
        tensor within 2e-4 in relative L2, as at --nk 8, or, where larger,
        within twice the port's own response to one ulp of z_d (the D
        phase's codes moved up and down, every kNN choice the same), by
        element and in L2. With 40 neighbours the D phase's fakes carry
        rounding into D's first layers. Here one ulp of z_d moves D's
        gradients by up to 1.3e-3 (bn1.scale) and the packages lie 1.5e-4
        apart; at N 256 the response is 7.5e-4 and the packages 7.2e-4
        apart (mlp1.kernel), where at --nk 8 the response is 1e-4, and at
        --nk 40 (k = 20, the fused path before wide lists) the packages
        lie 1.1e-3 apart too: the gap is the step's conditioning, not the
        wide lists."""
        ours, theirs = f32_step["free"]["d_grads"], f32_step["jax"]["d_grads"]
        assert set(ours) == set(theirs)
        ulps = f32_step["zd_one_ulp"]
        assert all(same for _, same in ulps)
        for name in ours:
            a, b = ours[name], theirs[name]
            own = [u["d_grads"][name] - a for u, _ in ulps]
            np.testing.assert_allclose(
                a, b, rtol=0, atol=max(1e-3 * base.grad_scale(theirs, name),
                                       2 * max(np.abs(o).max() for o in own)),
                err_msg=name)
            if not base.PRE_BN_BIAS.search(name):
                assert np.linalg.norm(a - b) <= max(
                    2e-4 * np.linalg.norm(b),
                    2 * max(np.linalg.norm(o) for o in own)), name

    def test_forty_neighbours(self):
        assert Config(nk=80).k == 40
