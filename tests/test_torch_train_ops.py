"""The PyTorch port's training pieces against the JAX package's, on the
same numpy-seeded inputs and weights: kernel D's plain version and the
autograd edge op against the Pallas kernels in interpret mode, the
training-mode layers, the generator's training forward, the discriminator
and the GAN losses.

The Pallas functions are called jitted (two eager interpret-mode calls in
one process can deadlock). Kernel D itself runs only on a GPU (`cuda`
marker); chip_smoke.py holds it against the plain version there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sp_gan_tpu.config import Config as JaxConfig
from sp_gan_tpu.data import sphere_template
from sp_gan_tpu.losses import gan as jgan
from sp_gan_tpu.nn import Discriminator as JaxDiscriminator
from sp_gan_tpu.nn import Generator as JaxGenerator
from sp_gan_tpu.nn import layers as jlayers
from sp_gan_tpu.ops import dispatch as jdispatch
from sp_gan_tpu.ops import edge as jedge
from sp_gan_tpu.ops.pallas.knn import knn_edge_pallas
from sp_gan_tpu.ops.pallas.scatter import scatter_diff_bwd_pallas
from sp_gan_tpu_torch.compat import trees
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.losses import gan as tgan
from sp_gan_tpu_torch.nn import Discriminator, Generator, layers
from sp_gan_tpu_torch.ops import edge as tedge
from sp_gan_tpu_torch.ops.edge import edge_diff_features
from sp_gan_tpu_torch.ops.kernels import (knn_edge, scatter_diff_bwd,
                                          scatter_diff_bwd_plain)

torch.set_num_threads(2)   # six test workers share the host's cores


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _idx(shape, n, seed):
    return np.random.default_rng(seed).integers(0, n, shape).astype(np.int32)


def jax_vars(module):
    params, stats = trees(module)
    return {"params": params, "batch_stats": stats}


def assert_rel_max(ours, theirs, rel):
    """|ours - theirs| <= rel * max|theirs|."""
    theirs = np.asarray(theirs, np.float32)
    np.testing.assert_allclose(np.asarray(ours), theirs, rtol=0,
                               atol=rel * np.abs(theirs).max())


# ---------------------------------------------------------------- kernel D
class TestScatterDiffBwdPlain:
    @pytest.mark.parametrize("dtype, rel", [(jnp.float32, 1e-6),
                                            (jnp.bfloat16, 1e-5)])
    def test_matches_pallas(self, dtype, rel):
        """[2, 256, 6, 64], indices from kernel B's plain version on a
        random cloud (a real kNN graph's in-degrees)."""
        x = torch.from_numpy(_np((2, 256, 64), seed=0))
        idx = knn_edge(x, 6, diff_only=True, select_mode="exact")[1]
        dd = jnp.asarray(_np((2, 256, 6, 64), seed=1)).astype(dtype)
        fn = jax.jit(functools.partial(scatter_diff_bwd_pallas, t_tile=128))
        with pltpu.force_tpu_interpret_mode():
            theirs = fn(dd, jnp.asarray(idx.numpy()))
        ours = scatter_diff_bwd_plain(
            torch.from_numpy(np.asarray(dd.astype(jnp.float32))).to(
                torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32),
            idx)
        assert ours.dtype == torch.float32
        assert_rel_max(ours.numpy(), theirs, rel)

    @pytest.mark.parametrize("n, c", [(200, 32), (200, 64), (97, 32)])
    def test_odd_sizes_match_autodiff(self, n, c):
        """N not a multiple of any block size and C = 32: against the JAX
        autodiff of `nbr - central` on the XLA gather."""
        k = 5
        x = jnp.asarray(_np((3, n, c), seed=2))
        idx = jnp.asarray(_idx((3, n, k), n, seed=3))
        dd = _np((3, n, k, c), seed=4)
        ref = jax.jit(jax.grad(lambda xx: jnp.sum(
            jedge.edge_diff_features(xx, k, idx=idx) * dd)))(x)
        ours = scatter_diff_bwd_plain(torch.from_numpy(dd),
                                      torch.from_numpy(np.asarray(idx)))
        assert_rel_max(ours.numpy(), ref, 1e-6)

    def test_hub_target(self):
        """Every point picks the same few neighbors: in-degree N."""
        n, k = 64, 4
        idx = np.broadcast_to(np.arange(1, k + 1, dtype=np.int32),
                              (1, n, k)).copy()
        dd = _np((1, n, k, 32), seed=5)
        ours = scatter_diff_bwd_plain(torch.from_numpy(dd),
                                      torch.from_numpy(idx)).numpy()
        ref = -dd.sum(2)
        for j in range(k):
            ref[0, j + 1] += dd[0, :, j].sum(0)
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)

    def test_wrapper_takes_plain_version_on_cpu(self):
        dd = torch.from_numpy(_np((1, 32, 3, 16), seed=6))
        idx = torch.from_numpy(_idx((1, 32, 3), 32, seed=7))
        before = scatter_diff_bwd.launches
        assert torch.equal(scatter_diff_bwd(dd, idx),
                           scatter_diff_bwd_plain(dd, idx))
        assert scatter_diff_bwd.launches == before

    @pytest.mark.parametrize("bad", ["dtype", "idx_dtype", "shape", "wide"])
    def test_wrapper_rejects(self, bad):
        dd = torch.zeros(1, 8, 2, 16)
        idx = torch.zeros(1, 8, 2, dtype=torch.int32)
        if bad == "dtype":
            dd = dd.half()
        elif bad == "idx_dtype":
            idx = idx.long()
        elif bad == "shape":
            idx = idx[:, :4]
        else:
            dd = torch.zeros(1, 8, 2, 256)
        with pytest.raises((TypeError, ValueError)):
            scatter_diff_bwd(dd, idx)


# ---------------------------------------------------------------- edge op
class TestEdgeDiffAutograd:
    @pytest.mark.parametrize("mode", ["exact", "packed"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_jax_fused_vjp(self, mode, dtype, monkeypatch):
        """The port's op (kernel B forward, kernel D backward, plain
        versions on the CPU) against `_knn_edge_diff` with Pallas on:
        `knn_edge_pallas` forward and `scatter_diff_bwd_pallas` backward,
        in interpret mode. Indices equal, edges bit-equal, d_x within
        1e-6 (f32) or 1e-5 (bf16) of its max-abs."""
        monkeypatch.setenv("SPGAN_KNN_SELECT", mode)
        monkeypatch.setattr(jdispatch, "pallas_enabled", lambda: True)
        k = 6
        x = _np((2, 256, 64), seed=8)
        tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        g = torch.from_numpy(_np((2, 256, k, 64), seed=9)).to(tdt)

        def fwd(xx):
            return jedge._knn_edge_diff(xx, k, dtype)[0]

        @jax.jit
        def jax_side(xx, gg):
            diff, vjp = jax.vjp(fwd, xx)
            idx = knn_edge_pallas(xx, k, dtype, tq=128, diff_only=True,
                                  select_mode=mode)[1]
            return diff, idx, vjp(gg)[0]

        with pltpu.force_tpu_interpret_mode():
            j_diff, j_idx, j_dx = jax_side(
                jnp.asarray(x), jnp.asarray(g.float().numpy()).astype(dtype))
        xt = torch.from_numpy(x).requires_grad_()
        diff = edge_diff_features(xt, k, out_dtype=tdt)
        diff.backward(g)
        assert diff.dtype == tdt and xt.grad.dtype == torch.float32
        t_idx = knn_edge(torch.from_numpy(x), k, tdt, True, mode)[1]
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(
            diff.detach().float().numpy(),
            np.asarray(j_diff.astype(jnp.float32)))
        assert_rel_max(xt.grad.numpy(), j_dx,
                       1e-5 if dtype == "bfloat16" else 1e-6)

    def test_no_grad_saves_nothing(self):
        x = torch.from_numpy(_np((1, 64, 32), seed=10)).requires_grad_()
        with torch.no_grad():
            diff = edge_diff_features(x, 4)
        assert diff.grad_fn is None

    def test_gather_backward_matches_jax(self):
        """The unfused path: `gather_neighbors`' backward against the JAX
        custom VJP (`scatter_rows`)."""
        x = jnp.asarray(_np((2, 40, 16), seed=11))
        idx = _idx((2, 40, 5), 40, seed=12)
        g = _np((2, 40, 5, 16), seed=13)
        ref = jax.jit(jax.grad(lambda xx: jnp.sum(
            jedge.gather_neighbors(xx, jnp.asarray(idx)) * g)))(x)
        xt = torch.from_numpy(np.asarray(x)).requires_grad_()
        from sp_gan_tpu_torch.ops.edge import gather_neighbors
        gather_neighbors(xt, torch.from_numpy(idx)).backward(
            torch.from_numpy(g))
        assert_rel_max(xt.grad.numpy(), ref, 1e-6)


# ---------------------------------------------------------------- layers
class TestTrainLayers:
    def test_batchnorm_train(self):
        """Output and updated running statistics within 1e-6."""
        bn = layers.SPBatchNorm(16)
        with torch.no_grad():
            bn.scale.copy_(torch.from_numpy(_np((16,), 14, 0.3) + 1))
            bn.bias.copy_(torch.from_numpy(_np((16,), 15, 0.3)))
            bn.mean.copy_(torch.from_numpy(_np((16,), 16, 0.3)))
        x = _np((3, 40, 5, 16), seed=17, scale=2.0) + 1.5
        v = jax_vars(bn)
        ours = bn(torch.from_numpy(x), train=True).detach().numpy()
        theirs, mut = jax.jit(lambda v, x: jlayers.SPBatchNorm().apply(
            v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-6,
                                   atol=1e-6)
        for name in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(bn, name).numpy(),
                np.asarray(mut["batch_stats"][name]), rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("train", [True, False])
    def test_maxpool_bn_lrelu(self, train):
        """Forward and backward within 2e-4, on an input with tied maxima
        (the gradient splits evenly among them in both packages) and a
        negative scale (the min branch)."""
        m = layers.MaxPoolBNLReLU(8)
        with torch.no_grad():
            m.scale.copy_(torch.tensor([1.0, -0.5, 2.0, 0.7, -1.0, 1.0,
                                        0.3, 1.2]))
            m.bias.copy_(torch.from_numpy(_np((8,), 18, 0.3)))
            m.var.copy_(torch.full((8,), 1.5))
        h = _np((2, 50, 8), seed=19)
        h[:, 7, :] = h[:, 3, :] = h.max(axis=1) + 1.0       # tied maxima
        h[:, 9, 1] = h[:, 11, 1] = h[:, :, 1].min(axis=1) - 1.0
        g = _np((2, 8), seed=20)
        v = jax_vars(m)

        def jloss(params, x):
            out = jlayers.MaxPoolBNLReLU().apply(
                {"params": params, "batch_stats": v["batch_stats"]}, x,
                train=train, mutable=["batch_stats"])[0]
            return jnp.sum(out * g), out

        (_, j_out), (j_dp, j_dx) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(v["params"],
                                                  jnp.asarray(h))
        ht = torch.from_numpy(h).requires_grad_()
        out = m(ht, train=train)
        (out * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                                   rtol=2e-4, atol=2e-4)
        assert_rel_max(ht.grad.numpy(), j_dx, 2e-4)
        for name in ("scale", "bias"):
            assert_rel_max(getattr(m, name).grad.numpy(), j_dp[name], 2e-4)

    @pytest.mark.parametrize("mixed", [False, True])
    def test_edge_block_with_ee(self, mixed):
        """Training mode on a precomputed edge tensor (the template's):
        output and the updated statistics within 2e-4 in f32; under
        `mixed` the diff half is cast to bf16, `bf16(nbr - central)`,
        where the two packages round their bf16 matmuls alike to 1e-2."""
        blk = layers.EdgeBlock(3, 64, 4, mixed=mixed)
        blk.init_weights(np.random.default_rng(21))
        for sub in (blk.conv_w1, blk.conv_w2, blk.conv_x):
            sub.init_weights(np.random.default_rng(22))
        x = _np((1, 128, 3), seed=23)
        ee = _np((1, 128, 4, 6), seed=24)
        v = jax_vars(blk)
        ours = blk(torch.from_numpy(x), train=True,
                   ee=torch.from_numpy(ee)).detach().numpy()
        theirs, mut = jax.jit(lambda v, x, ee: jlayers.EdgeBlock(
            3, 64, 4, mixed=mixed).apply(v, x, True, None, ee,
                                         mutable=["batch_stats"]))(
            v, jnp.asarray(x), jnp.asarray(ee))
        tol = 1e-2 if mixed else 2e-4
        assert_rel_max(ours, theirs, tol)
        stats = trees(blk)[1]
        for bn in ("bn_w1", "bn_w2", "bn_x"):
            for name in ("mean", "var"):
                assert_rel_max(stats[bn][name],
                               mut["batch_stats"][bn][name], tol)


class TestGeneratorTrain:
    @pytest.mark.parametrize("b1", [True, False])
    def test_train_forward_and_stats(self, b1, monkeypatch):
        """The training forward on the template's precomputed edges
        (EdgeConv1 at batch 1 with `edge1_b1`, else at the full batch),
        in f32: output and every updated statistic within 2e-4. EdgeConv2's
        neighbors are the port's, replayed into the JAX kNN dispatch (a
        near-tie may otherwise pick another neighbor)."""
        from sp_gan_tpu_torch.train.step import template_edges
        monkeypatch.setenv("SPGAN_KNN_SELECT", "exact")
        cfg = Config(np=128, nk=8, dtype="float32")
        G = Generator(cfg, seed=36)
        v = jax_vars(G)
        sph = torch.from_numpy(sphere_template(128))
        idx, ee = template_edges(sph, cfg.k)
        x = sph[None].expand(3, -1, -1)
        z = torch.from_numpy(np.broadcast_to(_np((3, 1, cfg.nz), 37, 0.2),
                                             (3, 128, cfg.nz)).copy())
        if not b1:
            idx, ee = idx.expand(3, -1, -1), ee.expand(3, -1, -1, -1)
        picks = []
        fused = tedge.edge_diff_fused

        def recording(xx, k, out_dtype=None):
            diff, i = fused(xx, k, out_dtype)
            picks.append(i.numpy())
            return diff, i

        monkeypatch.setattr(tedge, "edge_diff_fused", recording)
        ours = G(x, z, train=True, edge1_idx=idx, edge1_ee=ee,
                 template_batch_const=b1).detach().numpy()
        monkeypatch.setattr(jdispatch, "knn",
                            lambda xx, k: jnp.asarray(picks[0]))
        jg = JaxGenerator(JaxConfig(np=128, nk=8, dtype="float32"))
        theirs, mut = jax.jit(lambda v, x, z, i, e: jg.apply(
            v, x, z, train=True, edge1_idx=i, edge1_ee=e,
            template_batch_const=b1, mutable=["batch_stats"]))(
            v, jnp.asarray(x.numpy()), jnp.asarray(z.numpy()),
            jnp.asarray(idx.numpy()), jnp.asarray(ee.numpy()))
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=2e-4,
                                   atol=2e-4)
        flat_ours = trees(G)[1]
        for block, leaves in flat_ours.items():
            for bn, val in leaves.items():
                ref = mut["batch_stats"][block][bn]
                if isinstance(val, dict):
                    for name in val:
                        assert_rel_max(val[name], ref[name], 2e-4)
                else:
                    assert_rel_max(val, ref, 2e-4)


class TestDiscriminator:
    @pytest.mark.parametrize("cfg_kw", [{}, {"pool_commute": False},
                                        {"small_d": True}])
    def test_train_forward_and_stats(self, cfg_kw):
        cfg = Config(np=128, **cfg_kw)
        D = Discriminator(cfg, seed=25)
        x = _np((3, 128, 3), seed=26)
        v = jax_vars(D)
        ours = D(torch.from_numpy(x), train=True).detach().numpy()
        jd = JaxDiscriminator(JaxConfig(np=128, **cfg_kw))
        theirs, mut = jax.jit(lambda v, x: jd.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
        assert ours.shape == (3, 1)
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=2e-4,
                                   atol=2e-4)
        stats = trees(D)[1]
        for bn, leaves in stats.items():
            for name, val in leaves.items():
                np.testing.assert_allclose(
                    val, np.asarray(mut["batch_stats"][bn][name]),
                    rtol=2e-4, atol=2e-4, err_msg=f"{bn}.{name}")

    def test_eval_forward(self):
        cfg = Config(np=64)
        D = Discriminator(cfg, seed=27)
        x = _np((2, 64, 3), seed=28)
        ours = D(torch.from_numpy(x)).detach().numpy()
        theirs = jax.jit(lambda v, x: JaxDiscriminator(
            JaxConfig(np=64)).apply(v, x, train=False))(jax_vars(D),
                                                        jnp.asarray(x))
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=2e-4,
                                   atol=2e-4)


# ---------------------------------------------------------------- losses
GANS = ["ls", "wgan", "hinge", "gan", "real"]


class TestLosses:
    @pytest.mark.parametrize("gan", GANS)
    def test_dis_loss(self, gan):
        real, fake = _np((8, 1), seed=29), _np((8, 1), seed=30)
        ours, info = tgan.dis_loss(torch.from_numpy(real),
                                   torch.from_numpy(fake), gan=gan)
        theirs, jinfo = jgan.dis_loss(jnp.asarray(real), jnp.asarray(fake),
                                      gan=gan)
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)
        for key in ("real_acc", "fake_acc"):
            assert float(info[key]) == float(jinfo[key])

    @pytest.mark.parametrize("gan", GANS)
    def test_gen_loss(self, gan):
        real, fake = _np((8, 1), seed=31), _np((8, 1), seed=32)
        ours, _ = tgan.gen_loss(torch.from_numpy(real),
                                torch.from_numpy(fake), gan=gan)
        theirs, _ = jgan.gen_loss(jnp.asarray(real), jnp.asarray(fake),
                                  gan=gan)
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)

    @pytest.mark.parametrize("gan", ["ls", "gan"])
    def test_mix_loss(self, gan):
        mix = _np((8, 1), seed=33)
        ours, _ = tgan.mix_loss(torch.from_numpy(mix), gan=gan)
        theirs, _ = jgan.mix_loss(jnp.asarray(mix), gan=gan)
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)

    def test_label_noise(self):
        """Smoothed real labels lie in [0.9, 1) with about 5% flipped: the
        ls loss on logits of 1 is the mean square of (1 - label)."""
        gen = torch.Generator().manual_seed(0)
        ones = torch.ones(20000)
        loss, _ = tgan.dis_loss(ones, torch.zeros(20000), noise_label=True,
                                gen=gen)
        # E[(1 - y)^2]: 0.95 * E[U(0, 0.1)^2] + 0.05 * E[U(0.9, 1)^2]
        expect = 0.95 * 0.01 / 3 + 0.05 * (1 - 0.9 ** 3) / 0.3
        assert abs(float(loss) - expect) < 0.005
        with pytest.raises(ValueError):
            tgan.dis_loss(ones, ones, noise_label=True)


@pytest.mark.cuda
class TestOnCard:
    def test_scatter_kernel_matches_plain_and_is_deterministic(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (kernels have no CPU mode)")
        x = torch.from_numpy(_np((2, 300, 64), seed=34)).cuda()
        idx = knn_edge(x, 10, torch.float32, True, "packed")[1]
        for dt in (torch.float32, torch.bfloat16):
            dd = torch.from_numpy(_np((2, 300, 10, 64), seed=35)).cuda().to(dt)
            a, b = scatter_diff_bwd(dd, idx), scatter_diff_bwd(dd, idx)
            assert torch.equal(a, b)
            ref = scatter_diff_bwd_plain(dd.cpu(), idx.cpu())
            assert (a.cpu() - ref).abs().max() <= 1e-6 * ref.abs().max()
