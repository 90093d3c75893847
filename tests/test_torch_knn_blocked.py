"""Kernel G's plain version (`ops/kernels/knn_blocked.py`, exact kNN for
clouds above 8192 points) against the JAX package's `knn_pallas_blocked`
(interpret mode, jitted, as tests/test_pallas.py runs it) and against
kernel A's plain version, and the N > 8192 route of `ops/dispatch.knn`
against the switch in JAX `knn_pallas` (`knn.py:503-506`).

Kernel G itself runs only on a GPU (`cuda` marker); chip_smoke.py holds it
against kernel A and its plain version there.
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
