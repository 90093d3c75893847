"""WGAN-GP and CutMix in the port (`losses/gp.py`, `losses/cutmix.py` and
the training step's D phase) against the JAX package on the CPU.

The loss functions take the JAX functions' own random draws (alpha of
WGAN-GP; lam, anchor and flip of CutMix), rebuilt from the same keys.
Where an EMD assignment enters (`--gp_mapping`'s pairing, CutMix's
alignment), the packages compute the distance matrix in other f32 orders
and the JAX package runs another solver on the CPU for the scaled auction
(`_auction_single_scaled`; kernel E is the port of its Pallas solver), so
the JAX side is handed the port's assignment; the fixed-iteration pairing
is also held to JAX's own assignment's cost. One training step of each
package follows tests/test_torch_train_step.py at its tolerances, with
the draws and assignments handed over as its codes are.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as base
from sp_gan_tpu.config import Config as JaxConfig
from sp_gan_tpu.data.h5 import SyntheticDataset as JaxSynthetic
from sp_gan_tpu.losses import gp as jgp
from sp_gan_tpu.ops import emd as jemd
from sp_gan_tpu.train.state import create_train_state as jcreate
from sp_gan_tpu_torch.compat import state_from_jax
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.losses import cutmix_draws, r1_penalty, wgan_gp
from sp_gan_tpu_torch.nn import Discriminator
from sp_gan_tpu_torch.nn.layers import frozen_running_stats
from sp_gan_tpu_torch.ops.emd import emd_auction
from sp_gan_tpu_torch.train.state import create_train_state
from sp_gan_tpu_torch.train.step import make_train_step

jcutmix = importlib.import_module("sp_gan_tpu.losses.cutmix")
tcutmix = importlib.import_module("sp_gan_tpu_torch.losses.cutmix")

torch.set_num_threads(2)   # six test workers share the host's cores

KW = dict(np=64, bs=4, nk=8, nz=16, dtype="float32")


@pytest.fixture(scope="module")
def nets():
    """JAX's initial D (params, stats, module) and the port's copy."""
    jcfg = JaxConfig(**KW, donate_state=False)
    jstate, _, jD, _, _ = jcreate(jcfg, jax.random.PRNGKey(0))
    D = Discriminator(Config(**KW), seed=None)
    D.load_state_dict(state_from_jax(jstate.d_params, jstate.d_stats))
    rng = np.random.default_rng(0)
    real = JaxSynthetic(n_items=4, n_points=64, seed=5).data.copy()
    fake = (0.3 * rng.standard_normal(real.shape)).astype(np.float32)
    return jstate, jD, D, real, fake


def jax_d_apply(jstate, jD):
    """D in training mode from the step-start statistics, the mutation
    dropped (the JAX step's `d_only`)."""
    variables = {"params": jstate.d_params, "batch_stats": jstate.d_stats}
    return lambda x: jD.apply(variables, x, train=True,
                              mutable=["batch_stats"])[0]


def port_d_apply(D):
    return lambda x: D(x, train=True)


def close(a, b, tol=2e-4):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


class TestPenalties:
    def test_r1(self, nets):
        jstate, jD, D, real, _ = nets
        theirs = jax.jit(lambda r: jgp.r1_penalty(jax_d_apply(jstate, jD),
                                                  r))(jnp.asarray(real))
        with frozen_running_stats(D):
            ours = r1_penalty(port_d_apply(D), torch.from_numpy(real))
        close(ours.item(), theirs)

    @pytest.mark.parametrize("pairing", [False, True])
    def test_wgan_gp(self, nets, pairing):
        """On JAX's alpha; with the EMD pairing both packages solve with
        the fixed-iteration auction (300 rounds) on their own distances."""
        jstate, jD, D, real, fake = nets
        key = jax.random.PRNGKey(3)
        theirs = jax.jit(lambda r, f: jgp.wgan_gp(
            jax_d_apply(jstate, jD), r, f, key, 10.0,
            emd_pairing=pairing))(jnp.asarray(real), jnp.asarray(fake))
        alpha = np.array(jax.random.uniform(key, (4, 1, 1),
                                            dtype=jnp.float32))
        with frozen_running_stats(D):
            ours = wgan_gp(port_d_apply(D), torch.from_numpy(real),
                           torch.from_numpy(fake), torch.from_numpy(alpha),
                           10.0, emd_pairing=pairing)
        close(ours.item(), theirs)

    def test_pairing_assignment_matches_jax(self, nets):
        """The pairing's assignment (fake to real, 300 rounds) equals the
        JAX solver's on this input."""
        _, _, _, real, fake = nets
        _, theirs = jax.jit(lambda f, r: jemd.emd_auction(f, r, 0.005, 300))(
            jnp.asarray(fake), jnp.asarray(real))
        _, ours = emd_auction(torch.from_numpy(fake), torch.from_numpy(real),
                              0.005, 300)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))

    def test_double_backward_reaches_d(self, nets):
        """The penalty is differentiable in every parameter of D."""
        _, _, D, real, fake = nets
        alpha = torch.full((4, 1, 1), 0.3)
        with frozen_running_stats(D):
            gp = wgan_gp(port_d_apply(D), torch.from_numpy(real),
                         torch.from_numpy(fake), alpha)
        grads = torch.autograd.grad(gp, list(D.parameters()),
                                    allow_unused=True)
        moved = [n for (n, _), g in zip(D.named_parameters(), grads)
                 if g is not None and bool(g.abs().sum() > 0)]
        assert "head4.kernel" in moved and "mlp1.kernel" in moved

    def test_gp_forward_keeps_the_running_stats(self, nets):
        """Inside `frozen_running_stats` D's training forward leaves its
        BatchNorm buffers as they were; outside it moves them."""
        _, _, D, real, fake = nets
        before = [b.clone() for b in D.buffers()]
        with frozen_running_stats(D):
            wgan_gp(port_d_apply(D), torch.from_numpy(real),
                    torch.from_numpy(fake), torch.full((4, 1, 1), 0.5))
        assert all(torch.equal(a, b) for a, b in zip(before, D.buffers()))
        assert all(m.update_running for m in D.modules()
                   if hasattr(m, "update_running"))
        D2 = Discriminator(Config(**KW), seed=1)
        before = [b.clone() for b in D2.buffers()]
        D2(torch.from_numpy(real), train=True)
        assert not all(torch.equal(a, b)
                       for a, b in zip(before, D2.buffers()))


class TestCutMix:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_jax(self, nets, seed, monkeypatch):
        """On JAX's draws and the port's assignment: the mask and map_s
        equal, the mixed clouds within 2e-4."""
        _, _, _, real, fake = nets
        key = jax.random.PRNGKey(seed)
        k_lam, k_anchor, k_flip = jax.random.split(key, 3)
        lam = np.array(jax.random.uniform(k_lam, (4,)))
        anchor = np.array(jax.random.randint(k_anchor, (4,), 0, 64))
        flip = np.array(jax.random.bernoulli(k_flip))
        mixed, map_s, mask = tcutmix.cutmix(
            torch.from_numpy(real), torch.from_numpy(fake),
            torch.from_numpy(lam), torch.from_numpy(anchor).long(),
            torch.from_numpy(flip), emd_iters=50)
        _, ass = emd_auction(torch.from_numpy(real), torch.from_numpy(fake),
                             0.005, 50, True)
        ass_j = jnp.asarray(ass.numpy())
        monkeypatch.setattr(jcutmix, "emd_auction",
                            lambda a, b, eps, it, sc: (None, ass_j))
        jm, js, jk = jcutmix.cutmix.__wrapped__(key, jnp.asarray(real),
                                                jnp.asarray(fake),
                                                emd_iters=50)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(map_s.numpy(), np.asarray(js))
        close(mixed.numpy(), jm)
        assert 0 < mask.sum() < mask.numel() or lam.min() * 64 < 1

    def test_draws(self):
        """lam in [0, 1), anchors in [0, N), one flip for the batch."""
        gen = torch.Generator().manual_seed(0)
        lam, anchor, flip = cutmix_draws(gen, 6, 64)
        assert lam.shape == (6,) and ((lam >= 0) & (lam < 1)).all()
        assert anchor.shape == (6,) and ((anchor >= 0) & (anchor < 64)).all()
        assert flip.shape == () and flip.dtype == torch.bool


# ------------------------------------------------------------- the step
STEPS = {"wgan_gp": dict(gan="wgan", lambda_gp=10.0),
         "gp_mapping": dict(gan="wgan", lambda_gp=10.0, gp_mapping=True),
         "mix": dict(mix=True)}


@pytest.fixture(scope="module", params=sorted(STEPS))
def f32_step(request):
    """One float32 step of each package (tests/test_torch_train_step.py's
    `run_both`, with the port's one-ulp runs of z_g) with a regularizer on;
    the JAX draws and the port's EMD assignments handed over. Under WGAN-GP
    the slopes of D's leaky ReLUs are handed over too: the penalty's
    gradient runs through D's input gradient, where an input within
    rounding of 0 takes the other slope in the other package and moves
    D's gradients by up to 1.4e-2 of a tensor's max-abs (measured here
    without the replay; under `ls` the parent test's tolerances hold
    without it)."""
    name = request.param
    out = base.run_both(dtype="float32", one_ulp=True,
                        replay_slopes=name != "mix", **STEPS[name])
    out["name"] = name
    return out


class TestRegularizedStepParity(base.TestOneStepParity):
    """`tests/test_torch_train_step.py`'s one-step parity at its
    tolerances, for WGAN-GP, WGAN-GP with the EMD pairing and CutMix."""

    def test_g_phase(self, f32_step):
        """The parent's G-phase bounds on G's gradients; g_loss within the
        larger of its 5e-5 relative and 4 times the port's own response to
        one ulp of z_g with every choice the same (the parent's margin over
        its measured response). The WGAN g_loss is minus the mean of four
        logits, a small difference of larger terms: one ulp of z_g moves it
        by up to 1.2e-4 relative here (gp_mapping), and the packages differ
        by 1.3e-4 (wgan_gp) and 7.9e-5."""
        ours, theirs = f32_step["pinned"], f32_step["jax"]
        own = max(abs(u["g_loss"] - f32_step["free"]["g_loss"])
                  / abs(f32_step["free"]["g_loss"])
                  for u, same in f32_step["one_ulp"] if same)
        np.testing.assert_allclose(ours["g_loss"], theirs["g_loss"],
                                   rtol=max(5e-5, 4 * own))
        assert set(ours["g_grads"]) == set(theirs["g_grads"])
        elem, l2 = base.grad_errors(ours["g_grads"], theirs["g_grads"])
        assert elem <= 2e-2 and l2 <= 1e-2, (elem, l2)

    def test_emd_assignments(self, f32_step):
        """The port's EMD calls in the D phase, each handed to the JAX
        step: the pairing once under gp_mapping (the fixed-iteration
        solver, held to JAX's on the same d in tests/test_torch_auction.py
        and above), the alignment once under mix (kernel E's plain
        version, held to the JAX Pallas solver in
        tests/test_torch_auction.py). On the step's clouds the packages' d
        differ in rounding, and 300 unconverged rounds at N=256 end
        elsewhere (29% of the pairs agree here), so the step compares the
        rest of the D phase on one assignment. The pairing is a complete
        map into the real cloud."""
        want = {"wgan_gp": 0, "gp_mapping": 1, "mix": 1}[f32_step["name"]]
        assert len(f32_step["emds"]) == want
        for ass in f32_step["emds"]:
            assert ass.shape == (4, 256) and ass.min() >= 0 \
                and ass.max() < 256


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_on_default_draws(name):
    """Without handed draws the step draws them from the state's
    generator: finite losses, and the same seed gives the same step."""
    cfg = Config(**KW, **STEPS[name])
    losses = []
    for _ in range(2):
        state = create_train_state(cfg, device="cpu")
        step = make_train_step(cfg, np.asarray(
            JaxSynthetic(n_items=1, n_points=64, seed=1).data[0]))
        real = torch.from_numpy(JaxSynthetic(n_items=4, n_points=64,
                                             seed=2).data)
        _, m = step(state, real)
        losses.append((float(m["d_loss"]), float(m["g_loss"])))
    assert np.isfinite(losses).all() and losses[0] == losses[1]
