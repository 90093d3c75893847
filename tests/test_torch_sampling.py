"""The port's sampling ops (`sp_gan_tpu_torch/ops/sampling.py`) against the
JAX package's on the CPU: FPS, MDS and the ball query's indices exactly,
three_nn's indices exactly, distances and interpolations within 2e-4.

Ball membership is `d < r^2` on each package's own f32 distance (the port
folds the channels, JAX runs a HIGHEST matmul), so a point within an ulp
of the radius could fall on either side. The inputs are uniform in
[-1, 1]^3 (f32 rounding of a distance under 1e-6) and every test checks
that each query-to-point squared distance lies at least CLEAR = 1e-5 from
r^2 in f64 before it compares.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_gan_tpu.ops import sampling as js
from sp_gan_tpu_torch.ops import sampling as ps

torch.set_num_threads(2)   # six test workers share the host's cores

TOL = 2e-4
CLEAR = 1e-5


def uniform(seed, *shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape) \
        .astype(np.float32)


def both(a):
    return jnp.asarray(a), torch.from_numpy(a)


def assert_clear(q, x, r):
    d = ((q.astype(np.float64)[:, :, None]
          - x.astype(np.float64)[:, None]) ** 2).sum(-1)
    assert np.abs(d - r * r).min() > CLEAR


def grid_cloud(b, n, seed):
    """Points of an integer grid, shuffled: many exactly equal distances,
    so every FPS and MDS round meets ties that both packages must break
    to the first index."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1)
    g = g.reshape(-1, 3).astype(np.float32)
    return np.stack([g[rng.permutation(len(g))[:n]] for _ in range(b)])


class TestFarthestPointSample:
    @pytest.mark.parametrize("b,n,npoint,grid", [
        (2, 64, 16, False), (3, 256, 32, False), (1, 200, 200, False),
        (2, 64, 40, True)])
    def test_indices_equal(self, b, n, npoint, grid):
        x = grid_cloud(b, n, 1) if grid else uniform(n, b, n, 3)
        jx, tx = both(x)
        want = np.asarray(js.farthest_point_sample(jx, npoint))
        got = ps.farthest_point_sample(tx, npoint)
        assert got.dtype == torch.int32 and got.shape == (b, npoint)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_gather_points(self):
        x, idx = uniform(2, 2, 50, 6), np.random.default_rng(3).integers(
            0, 50, (2, 17)).astype(np.int32)
        want = js.gather_points(jnp.asarray(x), jnp.asarray(idx))
        got = ps.gather_points(torch.from_numpy(x), torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestMinimumDensitySample:
    @pytest.mark.parametrize("sigma,grid", [(None, False), (0.3, False),
                                            ((0.5, 0.2), False),
                                            (None, True)])
    def test_indices_equal(self, sigma, grid):
        x = grid_cloud(2, 64, 4) if grid else uniform(5, 2, 128, 3)
        jx, tx = both(x)
        if sigma is None:
            js_args, ps_args = (), ()
        else:
            s = np.broadcast_to(np.float32(sigma), (2,)).astype(np.float32)
            js_args, ps_args = (jnp.asarray(s),), (torch.from_numpy(s),)
        want = np.asarray(js.minimum_density_sample(jx, 24, *js_args))
        got = ps.minimum_density_sample(tx, 24, *ps_args)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got[:, 0] == 0).all()
        assert all(len(set(r.tolist())) == 24 for r in got)


class TestBallQuery:
    @pytest.mark.parametrize("r,nsample", [(0.3, 8), (0.5, 16), (0.8, 32)])
    def test_indices_equal(self, r, nsample):
        x, q = uniform(6, 2, 256, 3), uniform(7, 2, 40, 3)
        q[:, 0] = 5.0                      # a query with no point in range
        assert_clear(q, x, r)
        (jx, tx), (jq, tq) = both(x), both(q)
        want = np.asarray(js.ball_query(r, nsample, jx, jq))
        got = ps.ball_query(r, nsample, tx, tq)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert not got[:, 0].any()
        assert (got[:, 1:, 0] != got[:, 1:, -1]).any()   # padding and full


class TestInterpolation:
    @pytest.mark.parametrize("n,m", [(64, 16), (200, 3)])
    def test_three_nn_and_interpolate(self, n, m):
        u, k = uniform(8, 2, n, 3), uniform(9, 2, m, 3)
        f = np.random.default_rng(10).standard_normal((2, m, 7)) \
            .astype(np.float32)
        (ju, tu), (jk, tk), (jf, tf) = both(u), both(k), both(f)
        jd, ji = js.three_nn(ju, jk)
        td, ti = ps.three_nn(tu, tk)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=TOL)
        # weights and interpolation on the same (JAX's) distances
        jw = js.interpolation_weights(jd)
        tw = ps.interpolation_weights(torch.tensor(np.asarray(jd)))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=TOL,
                                   atol=TOL)
        want = js.three_interpolate(jf, ji, jw)
        got = ps.three_interpolate(tf, ti, torch.tensor(np.asarray(jw)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)

    def test_interpolation_gradient_reaches_the_features(self):
        f = torch.randn(1, 5, 4, generator=torch.Generator().manual_seed(0),
                        requires_grad=True)
        idx = torch.tensor([[[0, 1, 2], [2, 3, 4]]], dtype=torch.int32)
        w = torch.tensor([[[0.5, 0.25, 0.25], [1.0, 0.0, 0.0]]])
        ps.three_interpolate(f, idx, w).sum().backward()
        np.testing.assert_allclose(f.grad[0, :, 0].numpy(),
                                   [0.5, 0.25, 1.25, 0.0, 0.0])
