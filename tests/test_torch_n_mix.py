"""Region-mixed codes (`--n_mix`) and `masked_z` of the PyTorch port against
the JAX package's `sp_gan_tpu/data/noise.py`, and one `--n_mix` training
step against the JAX step, on the CPU.

The packages draw different numbers from one seed, so the mixing is held
on the JAX draws: `sample_z(key, ...)` splits its key in five (z, gate,
z2, anchor, size), the test rebuilds those draws from the key and hands
them to the port's `mix_codes`, and the mixed codes must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as base
from sp_gan_tpu.data import sphere_template as jsphere_template
from sp_gan_tpu.data.noise import masked_z as jmasked_z
from sp_gan_tpu.data.noise import sample_z as jsample_z
from sp_gan_tpu.data.sphere import sphere_sqdist as jsphere_sqdist
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data import (SyntheticDataset, masked_z, mix_codes,
                                   sample_z, sphere_sqdist, sphere_template)
from sp_gan_tpu_torch.train.state import create_train_state
from sp_gan_tpu_torch.train.step import make_train_step

torch.set_num_threads(2)   # six test workers share the host's cores

SIGMA = 0.2
# a start key of the JAX step whose two code keys (D and G phase) both
# open the mixing gate; under the step tests' PRNGKey(0) neither does
MIX_KEY = 11


def jax_draws(key, bs: int, n: int, nz: int, n_rand: bool):
    """The draws of the JAX `sample_z(key, ...)` (`data/noise.py:39-51`),
    as numpy: (z, gate, z2, anchor, u)."""
    _, k_gate, k_z2, k_anchor, k_num = jax.random.split(key, 5)
    z = jsample_z(key, bs, n, nz, SIGMA, n_rand)
    return (np.array(z), bool(jax.random.bernoulli(k_gate, 0.5)),
            np.array(SIGMA * jax.random.normal(k_z2, (bs, 1, nz))),
            np.array(jax.random.randint(k_anchor, (bs,), 0, n)),
            np.array(jax.random.uniform(k_num, (bs,))))


def find_key(gate: bool, floor: bool, bs: int = 8):
    """The first PRNGKey(s) whose gate is `gate` and, with `floor`, whose
    sizes include one under 0.1 (num at its floor)."""
    for s in range(200):
        _, k_gate, _, _, k_num = jax.random.split(jax.random.PRNGKey(s), 5)
        u = np.array(jax.random.uniform(k_num, (bs,)))
        if bool(jax.random.bernoulli(k_gate, 0.5)) == gate \
                and (u.min() < 0.1) == floor:
            return jax.random.PRNGKey(s)
    raise AssertionError("no such key")


class TestMixedCodes:
    @pytest.mark.parametrize("n_rand", [False, True])
    @pytest.mark.parametrize("gate,floor", [(True, False), (True, True),
                                            (False, True)],
                             ids=["gate", "gate_floor", "closed"])
    @pytest.mark.parametrize("n", [256, 2048])
    def test_equal_to_jax_from_its_draws(self, n, gate, floor, n_rand):
        """Equal element for element, at the test size and at the default
        template of 2048 points, each gate state, a size at the 0.1 floor
        and per-point codes."""
        bs, nz = 8, 16
        key = find_key(gate, floor, bs)
        ball = jsphere_template(n)
        z, g, z2, anchor, u = jax_draws(key, bs, n, nz, n_rand)
        assert g == gate and (u.min() < 0.1) == floor
        theirs = np.array(jsample_z(key, bs, n, nz, SIGMA, n_rand,
                                    n_mix=True, sphere=jnp.asarray(ball)))
        ours = mix_codes(torch.from_numpy(z), torch.from_numpy(z2),
                         g, torch.from_numpy(anchor), torch.from_numpy(u),
                         torch.from_numpy(sphere_template(n))).numpy()
        np.testing.assert_array_equal(ours, theirs)
        mixed = (ours != z).any(-1).sum(1)
        if not gate:
            assert not mixed.any()
            return
        # each shape takes z2 at its num nearest points (where z2 != z)
        num = (np.maximum(u, np.float32(0.1)) * n).astype(np.int32)
        assert (mixed == num).all(), (mixed, num)
        assert (num == int(np.float32(0.1) * n))[u < 0.1].all()

    def test_stable_ranks_on_ties(self):
        """A template with repeated points: ties at the size's edge fall
        to the lower index, as `jnp.argsort` (stable) orders them."""
        n, bs, nz = 64, 8, 4
        ball = np.repeat(jsphere_template(n // 4), 4, axis=0)
        key = find_key(True, False, bs)
        z, g, z2, anchor, u = jax_draws(key, bs, n, nz, False)
        theirs = np.array(jsample_z(key, bs, n, nz, SIGMA, n_mix=True,
                                    sphere=jnp.asarray(ball)))
        ours = mix_codes(torch.from_numpy(z), torch.from_numpy(z2), g,
                         torch.from_numpy(anchor), torch.from_numpy(u),
                         torch.from_numpy(ball)).numpy()
        np.testing.assert_array_equal(ours, theirs)

    def test_sample_z_draws_and_mixes(self):
        """The port's own draws: the gate opens in about half the calls,
        each mixed shape takes one second code on a region around its
        anchor, and the codes of n_mix=False are the first draw."""
        n, nz, bs = 256, 16, 4
        sphere = torch.from_numpy(sphere_template(n))
        opened = 0
        for seed in range(40):
            z = sample_z(torch.Generator().manual_seed(seed), bs, n, nz,
                         SIGMA, n_mix=True, sphere=sphere)
            plain = sample_z(torch.Generator().manual_seed(seed), bs, n, nz,
                             SIGMA)
            other = (z != plain).any(-1)
            assert z.shape == (bs, n, nz)
            if other.any():
                opened += 1
                for b in range(bs):
                    codes = z[b][other[b]]
                    assert torch.equal(codes, codes[:1].expand_as(codes))
                    assert int(other[b].sum()) >= int(0.1 * n)
        assert 10 <= opened <= 30
        # without the template there is nothing to mix by, as in JAX
        assert torch.equal(sample_z(torch.Generator().manual_seed(3), bs, n,
                                    nz, SIGMA, n_mix=True),
                           sample_z(torch.Generator().manual_seed(3), bs, n,
                                    nz, SIGMA))

    def test_sphere_sqdist_equal(self):
        ball = jsphere_template(300)
        np.testing.assert_array_equal(sphere_sqdist(ball),
                                      jsphere_sqdist(ball))


class TestMaskedZ:
    def test_one_code_per_label(self):
        rng = np.random.default_rng(0)
        masks = rng.integers(0, 5, (3, 200))
        z = masked_z(torch.Generator().manual_seed(0), masks, 8).numpy()
        assert z.shape == (3, 200, 8)
        for b in range(3):
            codes = {}
            for i, label in enumerate(masks[b]):
                codes.setdefault(label, z[b, i])
                np.testing.assert_array_equal(z[b, i], codes[label])
            assert len({c.tobytes() for c in codes.values()}) == len(codes)
        # the JAX function lays out its codes alike
        jz = np.asarray(jmasked_z(jax.random.PRNGKey(0), masks, 8))
        for b in range(3):
            for label in np.unique(masks[b]):
                assert len(np.unique(jz[b][masks[b] == label], axis=0)) == 1

    def test_scale(self):
        z = masked_z(torch.Generator().manual_seed(1),
                     np.arange(4000)[None] % 2000, 16, sigma=0.5)
        assert abs(float(z.std()) - 0.5) < 0.01


@pytest.fixture(scope="module")
def f32_step():
    """One float32 `--n_mix` step of each package (tests/test_torch_train_
    step.py's `run_both`, with the port's one-ulp runs of z_g). The JAX
    step draws region-mixed codes from its key; the test rebuilds them
    with the JAX `sample_z(..., n_mix=True, sphere=template)`, jitted as
    the step computes it (eager, the codes differ from it by an ulp), and
    hands them to the port. The start key is MIX_KEY, so both phases'
    codes are mixed."""
    orig_create, orig_sample = base.jcreate, base.jsample_z

    def create(cfg, key, *a, **kw):
        state, *rest = orig_create(cfg, key, *a, **kw)
        return (state.replace(rng=jax.random.PRNGKey(MIX_KEY)), *rest)

    def mixed(key, bs, n, nz, nv):
        sphere = jnp.asarray(jsphere_template(n))
        return jax.jit(lambda k: orig_sample(
            k, bs, n, nz, nv, False, True, None, sphere=sphere))(key)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(base, "jcreate", create)
        mp.setattr(base, "jsample_z", mixed)
        out = base.run_both(dtype="float32", n_mix=True, one_ulp=True)
        key = jax.random.PRNGKey(MIX_KEY)
        _, k_zd, k_zg, *_ = jax.random.split(key, 6)
        out["codes"] = [np.array(mixed(kk, 4, 256, 128, 0.2))
                        for kk in (k_zd, k_zg)]
    return out


class TestNMixStepParity(base.TestOneStepParity):
    """`tests/test_torch_train_step.py`'s one-step parity at its
    tolerances, with `--n_mix` codes; the G phase's gradients at the
    larger of its bounds and this start's own conditioning."""

    def test_g_phase(self, f32_step):
        """g_loss within 5e-5 relative. G's gradients within the parent's
        bounds (2e-2 of a tensor's max-abs, 1e-2 relative L2) or, where
        larger, twice the port's own response to one ulp of z_g with
        every discrete choice the same. Those bounds are the G phase's
        conditioning at the parent's start key; at MIX_KEY it is worse,
        with or without mixing: one ulp of z_g moves the port's G
        gradients by up to 2.9e-2 of the max-abs and 1.7e-2 relative L2,
        and the packages differ by 2.5e-2 and 1.6e-2 (without mixing at
        this key, 3.6e-2 and 2.6e-2)."""
        ours, theirs = f32_step["pinned"], f32_step["jax"]
        np.testing.assert_allclose(ours["g_loss"], theirs["g_loss"],
                                   rtol=5e-5)
        own = [base.grad_errors(u["g_grads"], f32_step["free"]["g_grads"])
               for u, same in f32_step["one_ulp"] if same]
        assert own, "no one-ulp run kept every choice"
        elem, l2 = base.grad_errors(ours["g_grads"], theirs["g_grads"])
        assert elem <= max(2e-2, 2 * max(o[0] for o in own)), elem
        assert l2 <= max(1e-2, 2 * max(o[1] for o in own)), l2

    def test_codes_are_mixed(self, f32_step):
        for z in f32_step["codes"]:
            other = (z != z[:, :1]).any(-1)
            assert other.any(axis=1).all()


def test_step_draws_mixed_codes(monkeypatch):
    """Without explicit codes the port's step draws them through
    `sample_z(..., n_mix=True, sphere=template)` in both phases; the same
    seed gives the same step."""
    from sp_gan_tpu_torch.train import step as step_mod
    cfg = Config(np=64, bs=4, nk=8, nz=16, n_mix=True)
    sphere = sphere_template(cfg.np)
    seen = []

    def recording(*a, **kw):
        z = sample_z(*a, **kw)
        seen.append((a[5:], z))
        return z

    monkeypatch.setattr(step_mod, "sample_z", recording)
    losses = []
    for _ in range(2):
        state = create_train_state(cfg, device="cpu")
        step = make_train_step(cfg, sphere)
        real = torch.from_numpy(SyntheticDataset(4, cfg.np, seed=2).data)
        _, m = step(state, real)
        losses.append((float(m["d_loss"]), float(m["g_loss"])))
    assert np.isfinite(losses).all() and losses[0] == losses[1]
    assert len(seen) == 4
    for args, _ in seen:
        assert args[1] is True
        np.testing.assert_array_equal(args[2].numpy(), sphere)
