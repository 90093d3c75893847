"""`--knn_mode approx` in the port's generator and training step, against
the JAX package on the CPU.

The generator's EdgeConv2 selects in the circular index band of half-width
`knn_window` (`ops/edge.py`): the port runs kernel F's plain version there
(its input is fused-eligible), the JAX package on the CPU its XLA window
selection, so the port runs with SPGAN_KNN_SELECT=exact, the order that
selection gives. At N=384 the band is `knn_window`, clamped to 128
(`edge.normalize_window`). Weights are drawn by the port and carried to
JAX through `compat`; inputs are numpy arrays from a seed.

The one-step parity reuses tests/test_torch_train_step.py's harness and
tolerances (explicit z, the port's choices replayed into the JAX step,
which for EdgeConv2 here is the window selection).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as step_parity
from sp_gan_tpu.config import Config as JaxConfig
from sp_gan_tpu.nn import Generator as JaxGenerator
from sp_gan_tpu.ops import approx_knn as japprox
from sp_gan_tpu_torch.compat import generator_trees, trees
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data.sphere import sphere_template
from sp_gan_tpu_torch.nn import layers
from sp_gan_tpu_torch.nn.generator import Generator
from sp_gan_tpu_torch.ops import edge as tedge
from sp_gan_tpu_torch.train import step as tstep
from sp_gan_tpu_torch.train.state import create_train_state
from sp_gan_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)   # six test workers share the host's cores

N, WINDOW = 384, 48
CAMPAIGN = "runs/campaign_n8192_approx/config.json"


@pytest.fixture(autouse=True)
def exact_selection(monkeypatch):
    monkeypatch.setenv("SPGAN_KNN_SELECT", "exact")


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def randomize_bn(module, seed):
    """Random running statistics and affines in every SPBatchNorm."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, layers.SPBatchNorm):
                c = m.mean.shape[0]
                m.mean.copy_(torch.from_numpy(_np((c,), 1, 0.5)))
                m.var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 2.0, c).astype(np.float32)))
                m.scale.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(_np((c,), 2, 0.2)))


def jax_vars(G):
    params, stats = generator_trees(G)
    return {"params": params, "batch_stats": stats}


def inputs(cfg, b=2, seed=3):
    x = np.broadcast_to(sphere_template(cfg.np)[None], (b, cfg.np, 3)).copy()
    z = np.broadcast_to(_np((b, 1, cfg.nz), seed, 0.2),
                        (b, cfg.np, cfg.nz)).copy()
    return x, z


class TestApproxGenerator:
    """The approx generator against JAX `Generator.apply` at N=384, full
    widths, W=48, at the tolerances of tests/test_torch_generator.py: 2e-4
    in f32; under mixed_edge max 0.15 and mean 0.016 (one bf16 ulp of
    EdgeConv1's output, scaled by AdaIN, swaps neighbor picks). Eval mode
    at B=2 as there, training mode at B=3 as in
    tests/test_torch_train_ops.py: the global BatchNorm over 2 clouds
    turns f32 rounding into 1e-3 of the output, in the exact mode too
    (measured 1.7e-3 exact, 1.4e-3 approx at B=2; 1.5e-5 at B=3)."""

    def _run(self, dtype, train):
        kw = dict(np=N, dtype=dtype, knn_mode="approx", knn_window=WINDOW)
        cfg = Config(**kw)
        G = Generator(cfg, seed=1)
        randomize_bn(G, seed=2)
        v = jax_vars(G)
        x, z = inputs(cfg, b=3 if train else 2)
        picks = []
        window = tedge.edge_diff_window

        def recording(xx, k, w, out_dtype=None):
            diff, idx = window(xx, k, w, out_dtype)
            picks.append((xx.detach().float().numpy(), idx.numpy(), w))
            return diff, idx
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tedge, "edge_diff_window", recording)
            with torch.no_grad():
                ours = G(torch.from_numpy(x), torch.from_numpy(z),
                         train=train, template_batch_const=True).numpy()
        jg = JaxGenerator(JaxConfig(**kw))
        if train:
            fwd = jax.jit(lambda v, x, z: jg.apply(
                v, x, z, train=True, template_batch_const=True,
                mutable=["batch_stats"]))
            theirs, mut = fwd(v, jnp.asarray(x), jnp.asarray(z))
        else:
            theirs = jax.jit(lambda v, x, z: jg.apply(
                v, x, z, train=False, template_batch_const=True))(
                    v, jnp.asarray(x), jnp.asarray(z))
            mut = None
        # EdgeConv2 ran kernel F's plain version once, on the band W=48,
        # and picked what the JAX window selection picks on its input
        assert len(picks) == 1
        xx, idx, w = picks[0]
        assert w == WINDOW
        np.testing.assert_array_equal(
            idx, np.asarray(japprox.knn_indices_window(jnp.asarray(xx), 10,
                                                       window=WINDOW)))
        return G, ours, np.asarray(theirs), mut

    @pytest.mark.parametrize("train", [False, True])
    def test_float32(self, train):
        G, ours, theirs, mut = self._run("float32", train)
        assert ours.shape == (3 if train else 2, N, 3)
        np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)
        if train:         # every updated statistic within 2e-4 of its max
            ref = step_parity.flat(mut["batch_stats"])
            got = step_parity.flat(trees(G)[1])
            assert set(got) == set(ref)
            for name, a in got.items():
                np.testing.assert_allclose(
                    a, ref[name], rtol=0,
                    atol=2e-4 * max(np.abs(ref[name]).max(), 1e-30),
                    err_msg=name)

    def test_mixed_edge_eval(self):
        _, ours, theirs, _ = self._run("mixed_edge", False)
        assert np.abs(ours - theirs).max() < 0.15
        assert np.abs(ours - theirs).mean() < 0.016

    def test_mixed_edge_train(self):
        """Under mixed_edge in training mode the packages' bf16 rounding is
        amplified by the batch statistics: JAX's own mixed_edge output lies
        0.20 (max) and 0.036 (mean) from its float32 output here. So the
        port is held against the JAX float32 output as witness, as
        tests/test_torch_train_mixed.py does for the step: no farther than
        1.5x (max) and 1.25x (mean) JAX's own mixed_edge output (measured
        1.12x and 0.96x)."""
        _, ours, jmixed, _ = self._run("mixed_edge", True)
        _, _, witness, _ = self._run("float32", True)
        ours, theirs = np.abs(ours - witness), np.abs(jmixed - witness)
        assert ours.max() <= 1.5 * theirs.max()
        assert ours.mean() <= 1.25 * theirs.mean()

    def test_sampler_is_banded(self):
        """`make_sample_fn` follows JAX's `G.apply(train=False)`: with
        knn_mode approx it runs `Generator.forward`, banded, not the fused
        eval path (which has no band)."""
        cfg = Config(np=N, dtype="float32", knn_mode="approx",
                     knn_window=WINDOW, bs=2)
        G = Generator(cfg, seed=4)
        randomize_bn(G, seed=5)
        state = create_train_state(cfg, device="cpu", G=G)
        x, z = inputs(cfg, seed=6)
        got = tstep.make_sample_fn(cfg, x[0])(state, torch.from_numpy(z))
        with torch.no_grad():
            ref = G(torch.from_numpy(x), torch.from_numpy(z),
                    template_batch_const=True)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def f32_step():
    return step_parity.run_both(dtype="float32", np=N, knn_mode="approx",
                                knn_window=WINDOW, jax_one_ulp=True)


class TestApproxStepParity(step_parity.TestOneStepParity):
    """One approx G+D step (N=384, bs=4, nk=8, W=48, float32) of the port
    against the JAX step: the tests and bounds of
    tests/test_torch_train_step.py::TestOneStepParity, on this step, except
    G's gradients (below)."""

    def test_g_phase(self, f32_step):
        """g_loss within 5e-5 relative, as in the exact step. G's gradients
        are held to the JAX step's own conditioning, measured in the same
        run: the port's gap to JAX (largest error over a tensor's max-abs,
        and largest relative L2) no larger than the larger gap between the
        JAX step and itself with the real batch moved by one ulp, the same
        choices replayed. This step is far worse conditioned than the exact
        one of tests/test_torch_train_step.py (there one ulp moves G's
        gradients by under 1e-2): here the JAX step moves by 4.7e-2 and
        4.4e-2 for one ulp up, 0.42 and 0.36 for one ulp down, so the
        exact step's 2e-2 and 1e-2 cannot hold for JAX against itself. The
        port's gap measured 0.22 and 5.1e-2."""
        ours, theirs = f32_step["pinned"], f32_step["jax"]
        np.testing.assert_allclose(ours["g_loss"], theirs["g_loss"],
                                   rtol=5e-5)
        own = [step_parity.grad_errors(u["g_grads"], theirs["g_grads"])
               for u in f32_step["jax_one_ulp"]]
        elem, l2 = step_parity.grad_errors(ours["g_grads"],
                                           theirs["g_grads"])
        assert elem <= max(e for e, _ in own), (elem, own)
        assert l2 <= max(r for _, r in own), (l2, own)


class TestCampaignConfig:
    def test_loads_into_trainer_and_steps(self, tmp_path):
        """The N=8192 approx campaign's config.json builds a `Trainer` on
        the CPU as it is (its JAX-only `watchdog_secs` and
        `steps_per_call` accepted and ignored), then at np=384 takes one
        step, EdgeConv2 through the band in both phases."""
        with open(CAMPAIGN) as f:
            cfg = Config.from_json(f.read())
        assert (cfg.np, cfg.bs, cfg.nk, cfg.knn_mode, cfg.knn_window,
                cfg.dtype) == (8192, 4, 20, "approx", 512, "mixed_edge")
        assert json.load(open(CAMPAIGN))["watchdog_secs"] == 600
        cfg = dataclasses.replace(cfg, log_dir=str(tmp_path / "run"))
        tr = Trainer(cfg, device="cpu", logs=False)
        assert tr.data.shape[1:] == (8192, 3)
        small = dataclasses.replace(cfg, np=N, bs=2, steps_per_epoch=1)
        tr = Trainer(small, device="cpu", logs=False)
        bands = []
        window = tedge.edge_diff_window
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tedge, "edge_diff_window", lambda x, k, w, cd=None: (
                bands.append(w), window(x, k, w, cd))[1])
            run = tr.time_steps(1)
        assert bands == [128, 128]        # knn_window 512, clamped at N=384
        assert np.isfinite([run["metrics"][0][k]
                            for k in ("d_loss", "g_loss")]).all()
