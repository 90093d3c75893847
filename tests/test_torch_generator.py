"""The PyTorch port's generator layers and eval forward against the JAX
package's, on the same weights and inputs.

Weights are drawn by the port (`Generator(cfg, seed)`, numpy), BatchNorm
running statistics are randomized so the eval path is not the identity, and
the JAX side receives the same values through `compat.generator_trees`.
Inputs are numpy arrays from a seed. The JAX generator runs on the CPU,
where its kNN is the exact XLA top-k, so the port runs with
SPGAN_KNN_SELECT=exact for these comparisons.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sp_gan_tpu.config import Config as JaxConfig
from sp_gan_tpu.nn import Generator as JaxGenerator
from sp_gan_tpu.nn import layers as jlayers
from sp_gan_tpu.nn.fused_eval import generator_forward_eval as jfused_forward
from sp_gan_tpu.nn.fused_eval import supports_fused as jsupports_fused
from sp_gan_tpu_torch.compat import generator_state_from_jax, generator_trees
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data.sphere import sphere_template
from sp_gan_tpu_torch.manipulate import load_jax_generator
from sp_gan_tpu_torch.nn import layers
from sp_gan_tpu_torch.nn.fused_eval import (fold_bn, generator_forward_eval,
                                            supports_fused)
from sp_gan_tpu_torch.nn.generator import Generator
from sp_gan_tpu_torch.train.checkpoint import load_generator

torch.set_num_threads(2)   # six test workers share the host's cores

CKPT = "runs/keep/campaign_horizon_best.pkl"
VARIANTS = dict(use_head=True, attn=True, eql=True, z_norm=True, off=True)


@pytest.fixture(autouse=True)
def exact_selection(monkeypatch):
    monkeypatch.setenv("SPGAN_KNN_SELECT", "exact")


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def randomize_bn(module: torch.nn.Module, seed: int) -> None:
    """Random running statistics and affines in every SPBatchNorm."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, layers.SPBatchNorm):
                c = m.mean.shape[0]
                m.mean.copy_(torch.from_numpy(_np((c,), rng.integers(1e9),
                                                  0.5)))
                m.var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 2.0, c).astype(np.float32)))
                m.scale.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(_np((c,), rng.integers(1e9),
                                                  0.2)))


def jax_vars(module: torch.nn.Module) -> dict:
    params, stats = generator_trees(module)
    return {"params": params, "batch_stats": stats}


def template_batch(n: int, b: int) -> np.ndarray:
    return np.broadcast_to(sphere_template(n)[None], (b, n, 3)).copy()


def tiled_codes(b: int, n: int, nz: int, seed: int) -> np.ndarray:
    z = _np((b, 1, nz), seed, 0.2)
    return np.broadcast_to(z, (b, n, nz)).copy()


def run_both(cfg_kw: dict, G: Generator = None, b: int = 2, n: int = 256):
    cfg = Config(np=n, **cfg_kw)
    if G is None:
        G = Generator(cfg, seed=1)
        randomize_bn(G, seed=2)
    x, z = template_batch(n, b), tiled_codes(b, n, cfg.nz, seed=3)
    with torch.inference_mode():
        ours = G.eval()(torch.from_numpy(x), torch.from_numpy(z),
                        template_batch_const=True).numpy()
    jg = JaxGenerator(JaxConfig(np=n, **cfg_kw))
    fwd = jax.jit(lambda v, x, z: jg.apply(v, x, z, train=False,
                                           template_batch_const=True))
    theirs = np.asarray(fwd(jax_vars(G), jnp.asarray(x), jnp.asarray(z)))
    return ours, theirs


class TestLayers:
    def test_batchnorm_eval_uses_running_biased_var(self):
        bn = layers.SPBatchNorm(16)
        randomize_bn(bn, seed=0)
        x = _np((2, 8, 5, 16), seed=1)
        ours = bn(torch.from_numpy(x)).detach().numpy()
        theirs = jlayers.SPBatchNorm().apply(jax_vars(bn), jnp.asarray(x),
                                             train=False)
        # one rsqrt and two f32 roundings apart (measured 4.8e-7)
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-6,
                                   atol=1e-6)
        with pytest.raises(NotImplementedError):
            bn(torch.from_numpy(x), train=True)

    @pytest.mark.parametrize("eql", [False, True])
    def test_adaptive_point_norm(self, eql):
        m = layers.AdaptivePointNorm(16, 32, use_eql=eql)
        m.init_weights(np.random.default_rng(0))
        x, style = _np((2, 64, 16), 1), _np((2, 64, 32), 2)
        ours = m(torch.from_numpy(x), torch.from_numpy(style)).detach()
        theirs = jlayers.AdaptivePointNorm(16, use_eql=eql).apply(
            jax_vars(m), jnp.asarray(x), jnp.asarray(style))
        # f32 matmul of width 32 and an instance norm: ulps of values up
        # to 43 (measured 7.6e-6)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-5, atol=2e-5)

    @pytest.mark.parametrize("mixed", [False, True])
    def test_edge_block(self, mixed):
        m = layers.EdgeBlock(16, 32, 5, mixed=mixed)
        m.init_weights(np.random.default_rng(0))
        for sub in m.children():
            if hasattr(sub, "init_weights"):
                sub.init_weights(np.random.default_rng(1))
        randomize_bn(m, seed=2)
        x = _np((2, 64, 16), 3)
        ours = m(torch.from_numpy(x)).detach().numpy()
        fwd = jax.jit(lambda v, x: jlayers.EdgeBlock(16, 32, 5, mixed=mixed)
                      .apply(v, x, train=False))
        theirs = np.asarray(fwd(jax_vars(m), jnp.asarray(x)))
        assert ours.dtype == np.float32
        if mixed:
            # bf16 rounds in other places in torch and XLA (softmax, bias
            # adds); measured 1.5e-3 on outputs up to 0.26, where a bf16
            # ulp is 9.8e-4: four ulps allowed
            np.testing.assert_allclose(ours, theirs, rtol=0, atol=4e-3)
        else:
            # matmul summation order; measured 1.2e-7
            np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)

    def test_attention(self):
        m = layers.Attention(64)
        for sub in m.children():
            sub.init_weights(np.random.default_rng(0))
        with torch.no_grad():
            m.gamma.fill_(0.7)
        x = _np((2, 32, 64), 1)
        ours = m(torch.from_numpy(x)).detach().numpy()
        theirs = jlayers.Attention(64).apply(jax_vars(m), jnp.asarray(x))
        # measured 2.4e-7
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-5,
                                   atol=1e-5)


class TestParameterTree:
    @pytest.mark.parametrize("cfg_kw", [{}, VARIANTS])
    def test_names_and_shapes_match_jax_init(self, cfg_kw):
        G = Generator(Config(np=64, **cfg_kw))
        params, stats = generator_trees(G)
        shapes = jax.eval_shape(lambda: JaxGenerator(
            JaxConfig(np=64, **cfg_kw)).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 64, 3)),
                jnp.zeros((1, 64, 128)), train=True))
        ours = jax.tree.map(lambda a: a.shape,
                            {"params": params, "batch_stats": stats})
        theirs = jax.tree.map(lambda a: a.shape, shapes)
        assert ours == theirs

    def test_round_trip_strict(self):
        cfg = Config(np=64, **VARIANTS)
        G = Generator(cfg, seed=5)
        G2 = Generator(cfg, seed=None)
        G2.load_state_dict(generator_state_from_jax(*generator_trees(G)),
                           strict=True)
        for (n1, t1), (n2, t2) in zip(G.state_dict().items(),
                                      G2.state_dict().items()):
            assert n1 == n2 and torch.equal(t1, t2)

    def test_seeded_init_is_deterministic(self):
        a = Generator(Config(np=64), seed=7).state_dict()
        b = Generator(Config(np=64), seed=7).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)


class TestGeneratorParity:
    """Eval forward at B=2, N=256, full widths, against JAX Generator.apply
    (jitted, CPU).

    f32 holds the roadmap's 2e-4 (measured 6e-7 for the defaults, at most
    4.2e-6 for each variant flag). The flags are checked one at a time: with
    all five on, the two packages' EdgeConv2 inputs differ by 3.4e-5 at
    magnitude 13 (f32 rounding in other orders) and two of 5120 neighbor
    picks swap on near-ties; the global max-pool then moves every point.

    mixed_edge cannot be held that close: EdgeConv1's bf16 output differs by
    one bf16 ulp between torch and XLA, AdaIN scales that to 2% of its
    output, and 622 of 5120 EdgeConv2 neighbor picks differ (measured with
    random weights). The bf16 arithmetic itself is held tight per EdgeBlock
    (TestLayers.test_edge_block); here the bound is twice the measured
    error: max 0.071 and mean 0.0078 with random weights, max 0.059 and
    mean 0.0069 with the trained checkpoint."""

    def test_float32(self):
        ours, theirs = run_both(dict(dtype="float32"))
        assert ours.shape == (2, 256, 3)
        np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("flag", sorted(VARIANTS))
    def test_float32_variant(self, flag):
        ours, theirs = run_both(dict(dtype="float32", **{flag: True}))
        np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)

    def test_mixed_edge(self):
        ours, theirs = run_both({})
        assert np.abs(ours - theirs).max() < 0.15
        assert np.abs(ours - theirs).mean() < 0.016

    def test_trained_checkpoint(self):
        try:
            params, stats = load_generator(CKPT)
        except FileNotFoundError:
            pytest.skip(f"{CKPT} is not in this checkout")
        cfg = Config(np=256)
        ours, theirs = run_both({}, G=load_jax_generator(params, stats, cfg))
        # trained weights, mixed_edge as trained (see the class docstring)
        assert np.abs(ours - theirs).max() < 0.12
        assert np.abs(ours - theirs).mean() < 0.014


class TestFusedEval:
    """The fused eval forward (the serving path: BatchNorm folded, each
    EdgeBlock's tail in kernel C) against the JAX package's
    `generator_forward_eval`, jitted with `edge_tail_pallas` in interpret
    mode, at B=2, N=256, full widths, BatchNorm statistics randomized. Both
    compute in f32 whatever `dtype` says. Limit: the roadmap's 2e-4;
    measured 6.3e-7 (defaults) and 6.0e-7 (off, z_norm)."""

    @pytest.mark.parametrize("cfg_kw", [
        {}, dict(dtype="float32"), dict(eql=True), dict(attn=True),
        dict(use_head=True), dict(dtype="bfloat16"),
        dict(dtype="bfloat16_tail32")])
    def test_supports_matches_jax(self, cfg_kw):
        assert supports_fused(Config(**cfg_kw)) == \
            jsupports_fused(JaxConfig(**cfg_kw))

    @pytest.mark.parametrize("cfg_kw", [{}, dict(off=True, z_norm=True)])
    def test_matches_jax_fused_forward(self, cfg_kw):
        cfg = Config(np=256, **cfg_kw)
        G = Generator(cfg, seed=1)
        randomize_bn(G, seed=2)
        x, z = template_batch(256, 2), tiled_codes(2, 256, cfg.nz, seed=3)
        with torch.inference_mode():
            ours = generator_forward_eval(G, torch.from_numpy(x),
                                          torch.from_numpy(z)).numpy()
        jcfg = JaxConfig(np=256, **cfg_kw)
        fwd = jax.jit(lambda v, x, z: jfused_forward(jcfg, v, x, z))
        with pltpu.force_tpu_interpret_mode():
            theirs = np.asarray(fwd(jax_vars(G), jnp.asarray(x),
                                    jnp.asarray(z)))
        assert ours.shape == (2, 256, 3) and ours.dtype == np.float32
        np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)

    def test_matches_unfused_forward(self):
        """Folding BatchNorm and fusing the tail change only rounding:
        measured 4.1e-7 against `Generator.forward` in f32."""
        cfg = Config(np=256, dtype="float32")
        G = Generator(cfg, seed=4)
        randomize_bn(G, seed=5)
        x = torch.from_numpy(template_batch(256, 2))
        z = torch.from_numpy(tiled_codes(2, 256, cfg.nz, seed=6))
        with torch.inference_mode():
            fused = generator_forward_eval(G, x, z)
            ref = G(x, z)
        np.testing.assert_allclose(fused.numpy(), ref.numpy(), rtol=2e-4,
                                   atol=2e-4)
        with pytest.raises(ValueError):
            generator_forward_eval(Generator(Config(np=64, attn=True)), x, z)

    def test_fold_bn(self):
        """dense + eval BatchNorm == x @ kernel * scale + shift (f32
        rounding, measured 4.8e-7)."""
        dense, bn = layers.TorchDense(16, 8), layers.SPBatchNorm(8)
        dense.init_weights(np.random.default_rng(0))
        randomize_bn(bn, seed=1)
        x = torch.from_numpy(_np((4, 16), seed=2))
        kernel, aff = fold_bn(dense, bn)
        assert not kernel.requires_grad and not aff.requires_grad
        np.testing.assert_allclose(
            (x @ kernel * aff[0] + aff[1]).numpy(),
            bn(dense(x)).detach().numpy(), rtol=1e-5, atol=1e-5)
