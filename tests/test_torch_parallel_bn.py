"""BatchNorm's statistic scopes in the port (`nn/layers.py`: `Scope`,
`SPBatchNorm`, `instance_norm_points`): contiguous groups of the batch on
one device against the JAX package's `SPBatchNorm(groups=2)`, the
one-process grouped training step against the JAX package's one-device
step under `bn_stats="per_shard"` with a mesh shape of 2 (two statistic
groups), and, on 2 gloo ranks, BatchNorm synchronized over the ranks
(against the whole batch), per replica with rank 0's running averages
(against the groups) and the instance norm with the points cut over the
ranks (against the whole cloud).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as base
import torch_parallel_workers as workers
from sp_gan_tpu.nn import discriminator as jdisc
from sp_gan_tpu.nn import layers as jlayers
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.nn.layers import (Scope, SPBatchNorm,
                                        instance_norm_points, sharded)

torch.set_num_threads(2)   # six test workers share the host's cores


def _port_bn(c, scale, bias):
    bn = SPBatchNorm(c)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    return bn


@pytest.mark.parametrize("shape", [(8, 12), (8, 16, 5, 12)])
def test_grouped_batchnorm_matches_jax(shape):
    """groups=2 in training mode: the output, the running averages (group
    0's statistics) and the gradients of a weighted sum, within 2e-4 of
    JAX's (f32 sums in other orders)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    c = shape[-1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)

    jbn = jlayers.SPBatchNorm(groups=2)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x[:2]))
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def jloss(p, xx):
        y, mut = jbn.apply({"params": p,
                            "batch_stats": variables["batch_stats"]},
                           xx, train=True, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mut["batch_stats"])

    (_, (jy, jstats)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    bn = _port_bn(c, scale, bias)
    xt = torch.from_numpy(x).requires_grad_(True)
    with sharded(Scope(groups=2), bn):
        y = bn(xt, train=True)
    gx, gs, gb = torch.autograd.grad((y * torch.from_numpy(r)).sum(),
                                     [xt, bn.scale, bn.bias])
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(jstats["mean"]),
                               **tol)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(jstats["var"]),
                               **tol)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **tol)
    np.testing.assert_allclose(gs.numpy(), np.asarray(jg["scale"]), **tol)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jg["bias"]), **tol)


def test_groups_must_divide_the_batch():
    bn = SPBatchNorm(4)
    with sharded(Scope(groups=3), bn), pytest.raises(ValueError):
        bn(torch.zeros(4, 4), train=True)


class LayersJnp:
    """The `jnp` of the JAX discriminator module, taken from the JAX
    layers module at each use: inside `base.run_both` that is its
    `Replay`, so that D's max pool outside `MaxPoolBNLReLU` (per_shard
    turns the pool's commutation off) replays the port's choice too."""

    def __getattr__(self, name):
        return getattr(jlayers.jnp, name)


# the choices both packages make: EdgeConv2's kNN in each phase; G's pool,
# D's pools (max only off the commuted form) in call order
GROUPED_KEYS = [("knn", 0), ("knn", 1)] + [("pool", i, 1) for i in range(5)]


@pytest.fixture(scope="module")
def grouped_step():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdisc, "jnp", LayersJnp())
        return base.run_both(near_tie=1e-3, tie_keys=GROUPED_KEYS,
                             dtype="float32", np=64, bs=8,
                             bn_stats="per_shard", mesh_shape=(2,))


class TestGroupedStepParity(base.TestOneStepParity):
    """The one-process step with two statistic groups against the JAX
    package's one-device per_shard step at the bounds of
    tests/test_torch_train_step.py."""

    @pytest.fixture
    def f32_step(self, grouped_step):
        return grouped_step

    def test_d_gradients(self, f32_step):
        """Every element within 1e-3 of its tensor's max-abs, each tensor
        within 5e-4 in relative L2. The D phase runs on each package's own
        fakes, whose global BatchNorm here takes 4 clouds a group: they
        part by more than under the whole batch, and D's first layers'
        gradients with them (measured: up to 2.6e-4, bn2.bias; 1e-4 for
        the kernels; JAX's own response to one ulp of the real batch is
        1.1e-6 there, so the gap comes in with the fakes)."""
        ours, theirs = f32_step["free"]["d_grads"], f32_step["jax"]["d_grads"]
        assert set(ours) == set(theirs)
        for name in ours:
            a, b = ours[name], theirs[name]
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-3 * base.grad_scale(theirs, name),
                err_msg=name)
            if not base.PRE_BN_BIAS.search(name):
                assert np.linalg.norm(a - b) <= 5e-4 * np.linalg.norm(b), \
                    name

    def test_two_groups(self):
        cfg = Config(bn_stats="per_shard", mesh_shape=(2,))
        assert cfg.bn_groups == 2


def _bn_inputs():
    rng = np.random.default_rng(1)
    f32 = np.float32
    return {"x": (rng.standard_normal((8, 16, 6)) * 3 + 2).astype(f32),
            "r": rng.standard_normal((8, 16, 6)).astype(f32),
            "scale": rng.uniform(0.5, 1.5, 6).astype(f32),
            "bias": rng.standard_normal(6).astype(f32),
            "h": (rng.standard_normal((3, 32, 5)) + 4).astype(f32),
            "rh": rng.standard_normal((3, 32, 5)).astype(f32)}


@pytest.fixture(scope="module")
def ranks():
    inp = _bn_inputs()
    return inp, workers.spawn(2, "bn", inp)


def _reference(inp, scope):
    bn = _port_bn(6, inp["scale"], inp["bias"])
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    with sharded(scope, bn):
        y = bn(x, train=True)
    gx, gs, gb = torch.autograd.grad((y * torch.from_numpy(inp["r"])).sum(),
                                     [x, bn.scale, bn.bias])
    return {"y": y.detach().numpy(), "gx": gx.numpy(), "gscale": gs.numpy(),
            "gbias": gb.numpy(), "mean": bn.mean.numpy(),
            "var": bn.var.numpy()}


@pytest.mark.parametrize("name,groups", [("sync", 1), ("replica", 2)])
def test_batchnorm_over_ranks(ranks, name, groups):
    """Synchronized BN on 2 ranks equals BN of the whole batch; per-replica
    BN equals the batch in 2 groups, with group 0's running averages on
    both ranks; each within 1e-5 (f32 sums in other orders)."""
    inp, out = ranks
    ref = _reference(inp, Scope(groups=groups))
    tol = dict(rtol=1e-5, atol=1e-6)
    for key in ("y", "gx"):
        got = np.concatenate([r[name][key] for r in out])
        np.testing.assert_allclose(got, ref[key], err_msg=key, **tol)
    for r in out:
        for key in ("gscale", "gbias", "mean", "var"):
            np.testing.assert_allclose(r[name][key], ref[key], err_msg=key,
                                       **tol)
        np.testing.assert_array_equal(r[name]["mean"], out[0][name]["mean"])
        np.testing.assert_array_equal(r[name]["var"], out[0][name]["var"])


def test_instance_norm_over_point_ranks(ranks):
    """The instance norm with the points cut over 2 ranks equals the
    unsharded one, output and gradient, within 1e-5."""
    inp, out = ranks
    h = torch.from_numpy(inp["h"]).requires_grad_(True)
    y = instance_norm_points(h)
    (gh,) = torch.autograd.grad((y * torch.from_numpy(inp["rh"])).sum(), [h])
    for key, ref in (("y", y.detach().numpy()), ("gh", gh.numpy())):
        got = np.concatenate([r["inorm"][key] for r in out], axis=1)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=key)
