"""The port's auxiliary point losses (`sp_gan_tpu_torch/losses/point_aux.py`,
`losses/shape_preserving.py`) against the JAX package's on the CPU: values
within 2e-4 relative, and the gradients of `repulsion_loss` and
`shape_preserving_loss` against `jax.grad` of the same scalar within 2e-4
of the gradient's largest entry.

`uniform_loss` counts the points of each FPS seed ball (`d < r^2`), so its
inputs must keep every seed-to-point squared distance clear of each
radius: the test checks in f64 that each lies at least 1e-5 from every
r^2 (inputs in [-1, 1]^3 or on the unit sphere, whose f32 distances round
by under 1e-6).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_gan_tpu.losses import point_aux as jpa
from sp_gan_tpu.losses import shape_preserving as jsp
from sp_gan_tpu_torch.losses import point_aux as ppa
from sp_gan_tpu_torch.losses import shape_preserving as psp
from sp_gan_tpu_torch.ops.sampling import farthest_point_sample

torch.set_num_threads(2)   # six test workers share the host's cores

TOL = 2e-4
PERCENTAGES = (0.4, 0.6, 0.8, 1.0, 1.2)


def uniform(seed, b, n, scale=1.0):
    return (scale * np.random.default_rng(seed).uniform(-1, 1, (b, n, 3))) \
        .astype(np.float32)


def sphere(seed, b, n):
    x = np.random.default_rng(seed).standard_normal((b, n, 3))
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def grad_close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max())
    assert np.abs(want).max() > 0


class TestRepulsion:
    @pytest.mark.parametrize("k,h,scale", [(5, 0.03, 0.2), (3, 0.1, 0.5),
                                           (8, 0.05, 0.3)])
    def test_value_and_gradient(self, k, h, scale):
        x = uniform(k, 2, 128, scale)
        jf = jax.jit(jax.value_and_grad(lambda a: jpa.repulsion_loss(a, k,
                                                                     h)))
        want, jg = jf(jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_(True)
        got = ppa.repulsion_loss(tx, k, h)
        got.backward()
        assert float(got.detach()) == pytest.approx(float(want), rel=TOL)
        grad_close(tx.grad.numpy(), np.asarray(jg))


class TestUniform:
    @pytest.mark.parametrize("cloud,radius,n_seed,nsample", [
        ("uniform", 1.0, 32, 32), ("sphere", 2.0, 16, 16),
        ("clumped", 1.0, 32, 32), ("uniform", 3.0, 8, 64)])
    def test_value(self, cloud, radius, n_seed, nsample):
        x = {"uniform": uniform(4, 2, 256), "sphere": sphere(5, 2, 256),
             "clumped": np.concatenate([uniform(6, 2, 128, 0.05),
                                        uniform(7, 2, 128)], 1)}[cloud]
        idx = farthest_point_sample(torch.from_numpy(x), n_seed).numpy()
        seeds = np.take_along_axis(x, idx[..., None].astype(np.int64), 1)
        d = ((seeds.astype(np.float64)[:, :, None]
              - x.astype(np.float64)[:, None]) ** 2).sum(-1)
        for p in PERCENTAGES:
            r = radius * math.sqrt(p / 100)
            assert np.abs(d - r * r).min() > 1e-5, p
        want = float(jax.jit(lambda a: jpa.uniform_loss(
            a, radius=radius, n_seed=n_seed, nsample=nsample))(
                jnp.asarray(x)))
        got = float(ppa.uniform_loss(torch.from_numpy(x), radius=radius,
                                     n_seed=n_seed, nsample=nsample))
        assert got == pytest.approx(want, rel=TOL)

    @pytest.mark.parametrize("k", [2, 6, 10])
    def test_knn_variance(self, k):
        x = uniform(8, 2, 96)
        want = float(jax.jit(jpa.uniform_loss_knn, static_argnums=1)(
            jnp.asarray(x), k))
        got = float(ppa.uniform_loss_knn(torch.from_numpy(x), k))
        assert got == pytest.approx(want, rel=TOL)


class TestShapePreserving:
    @pytest.mark.parametrize("m,n,k", [(64, 64, 8), (48, 96, 20),
                                       (64, 32, 4)])
    def test_value_and_gradient(self, m, n, k):
        x, y = uniform(9, 2, m), uniform(10, 2, n)

        def loss(a, b):
            mu, var = jsp.shape_preserving_loss(a, b, k)
            return mu + 0.5 * var
        jmu, jvar = jax.jit(jsp.shape_preserving_loss, static_argnums=2)(
            jnp.asarray(x), jnp.asarray(y), k)
        gx, gy = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x),
                                                         jnp.asarray(y))
        tx = torch.from_numpy(x).requires_grad_(True)
        ty = torch.from_numpy(y).requires_grad_(True)
        mu, var = psp.shape_preserving_loss(tx, ty, k)
        (mu + 0.5 * var).backward()
        assert float(mu.detach()) == pytest.approx(float(jmu), rel=TOL)
        assert float(var.detach()) == pytest.approx(float(jvar), rel=TOL)
        grad_close(tx.grad.numpy(), np.asarray(gx))
        grad_close(ty.grad.numpy(), np.asarray(gy))

    def test_local_mean_covariance(self):
        g = np.random.default_rng(11).standard_normal((2, 5, 7, 3)) \
            .astype(np.float32)
        jmu, jcov = jsp.local_mean_covariance(jnp.asarray(g))
        tmu, tcov = psp.local_mean_covariance(torch.from_numpy(g))
        np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=TOL)
        np.testing.assert_allclose(tcov.numpy(), np.asarray(jcov), atol=TOL)
