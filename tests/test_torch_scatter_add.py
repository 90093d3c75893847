"""Kernel H's plain version (`ops/kernels/scatter.py::scatter_add_plain`, a
scatter-add by target) against the JAX package's `scatter_add_pallas`
(interpret mode, jitted, as tests/test_pallas.py runs it), and the rule by
which `scatter_rows`, the neighbor gather's backward, picks kernel H: where
the JAX `scatter_rows` leaves its one-hot contraction for the Pallas kernel
(a one-hot of more than 1 GiB, `sp_gan_tpu/ops/edge.py:66`).

Kernel H itself runs only on a GPU (`cuda` marker); chip_smoke.py holds it
against its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sp_gan_tpu.ops import dispatch as jdispatch
from sp_gan_tpu.ops import edge as jedge
from sp_gan_tpu.ops.pallas import scatter as jscatter
from sp_gan_tpu_torch.ops import edge
from sp_gan_tpu_torch.ops.kernels import scatter
from sp_gan_tpu_torch.ops.kernels import (scatter_add, scatter_add_plain,
                                          scatter_diff_bwd_plain)

torch.set_num_threads(2)   # six test workers share the host's cores


def _inputs(B, S, F, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, F)).astype(np.float32),
            rng.integers(0, n, (B, S)).astype(np.int32))


class TestKernelHPlain:
    """Within 1e-6 of the Pallas kernel (f32 sums in other orders), at
    tests/test_pallas.py's shapes and tiles."""

    @pytest.mark.parametrize("B, S, F, n, t_tile, s_tile", [
        (2, 96, 8, 64, 32, 32), (1, 48, 4, 24, 256, 2048)])
    def test_matches_pallas(self, B, S, F, n, t_tile, s_tile):
        g, idx = _inputs(B, S, F, n)
        ours = scatter_add_plain(torch.from_numpy(g), torch.from_numpy(idx),
                                 n)
        fn = jax.jit(lambda a, b: jscatter.scatter_add_pallas(
            a, b, n, t_tile=t_tile, s_tile=s_tile))
        with pltpu.force_tpu_interpret_mode():
            theirs = np.asarray(fn(jnp.asarray(g), jnp.asarray(idx)))
        assert ours.shape == (B, n, F) and ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("F, dtype", [
        (3, "float32"), (3, "bfloat16"), (64, "float32"), (64, "bfloat16"),
        (128, "float32"), (128, "bfloat16")])
    def test_hard_idx_matches_pallas(self, F, dtype):
        """The inputs that reach kernel H's edge cases, as chip_smoke.py
        holds the kernel on them: a hub (half of cloud 0's sources on one
        target), targets n/2.. with no source, and every 7th entry out of
        range (-1, n, 2^31 - 1, -2^31), which the Pallas kernel's one-hot
        drops. The plain version, on the input with those rows zeroed and
        sent to target 0 (a +0.0 changes no sum), equals it exactly: the
        rows are small integers, so every f32 sum is exact in any order."""
        B, S, n = 2, 256, 64
        rng = np.random.default_rng(5)
        g = rng.integers(-8, 9, (B, S, F)).astype(np.float32)
        idx = rng.integers(0, n // 2, (B, S)).astype(np.int32)
        idx[0, :S // 2] = 3
        bad = np.array([-1, n, 2 ** 31 - 1, -2 ** 31], np.int32)
        idx[:, ::7] = bad[np.arange(idx[:, ::7].size) % 4].reshape(B, -1)
        oob = (idx < 0) | (idx >= n)
        gt = torch.from_numpy(g).to(getattr(torch, dtype))
        ours = scatter_add_plain(gt.masked_fill(torch.from_numpy(oob)[..., None],
                                                0),
                                 torch.from_numpy(np.where(oob, 0, idx)), n)
        fn = jax.jit(lambda a, b: jscatter.scatter_add_pallas(
            a, b, n, t_tile=32, s_tile=64))
        with pltpu.force_tpu_interpret_mode():
            theirs = np.asarray(fn(jnp.asarray(g, getattr(jnp, dtype)),
                                   jnp.asarray(idx)))
        assert (ours[:, n // 2:] == 0).all() and ours[0, 3].abs().max() > 0
        np.testing.assert_array_equal(ours.numpy(), theirs)

    def test_bf16_rows_summed_in_f32(self):
        g, idx = _inputs(2, 256, 16, 32, seed=1)
        gb = torch.from_numpy(g).to(torch.bfloat16)
        ours = scatter_add_plain(gb, torch.from_numpy(idx), 32)
        ref = np.zeros((2, 32, 16), np.float64)
        for b in range(2):
            np.add.at(ref[b], idx[b], gb[b].float().numpy())
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)

    def test_wrapper_takes_plain_version_on_cpu(self):
        g, idx = map(torch.from_numpy, _inputs(2, 40, 8, 16))
        before = scatter_add.launches
        assert torch.equal(scatter_add(g, idx, 16),
                           scatter_add_plain(g, idx, 16))
        assert scatter_add.launches == before

    @pytest.mark.parametrize("call, err", [
        (lambda g, i: scatter_add(g.double(), i, 16), TypeError),
        (lambda g, i: scatter_add(g, i.long(), 16), TypeError),
        (lambda g, i: scatter_add(g, i[:, :-1].contiguous(), 16),
         ValueError),
        (lambda g, i: scatter_add(g[0], i, 16), ValueError),
        (lambda g, i: scatter_add(g, i, 0), ValueError),
        (lambda g, i: scatter_add(g.to("meta"), i.to("meta"), 16),
         ValueError),
    ])
    def test_wrapper_rejects(self, call, err):
        g, idx = map(torch.from_numpy, _inputs(2, 40, 8, 16))
        with pytest.raises(err):
            call(g, idx)


class TestScatterRows:
    @pytest.mark.parametrize("B, S, n, dtype", [
        (1, 1024, 1 << 18, "float32"),        # exactly 1 GiB: one-hot
        (1, 1024, (1 << 18) + 1, "float32"),  # over it: Pallas
        (1, 1024, (1 << 19) + 1, "bfloat16"),
        (1, 1024, 1 << 19, "bfloat16"),
        (2, 64, 64, "float32")])
    def test_kernel_rule_is_jax(self, B, S, n, dtype, monkeypatch):
        """JAX `scatter_rows` takes `scatter_add_pallas` exactly where the
        port's `one_hot_bytes` passes `ONE_HOT_LIMIT`. The JAX one-hot and
        Pallas calls are replaced by stubs that record the branch, so no
        1 GiB tensor is made."""
        taken = []
        monkeypatch.setattr(jdispatch, "pallas_enabled", lambda: True)
        monkeypatch.setattr(jscatter, "scatter_add_pallas", lambda g, i, N: (
            taken.append("pallas"), jnp.zeros((B, N, g.shape[-1])))[1])

        def one_hot(*a, **kw):
            taken.append("one-hot")
            raise StopIteration
        monkeypatch.setattr(jax.nn, "one_hot", one_hot)
        g = jnp.zeros((B, S, 1), getattr(jnp, dtype))
        try:
            jedge.scatter_rows(g, jnp.zeros((B, S), jnp.int32), n)
        except StopIteration:
            pass
        ours = scatter.one_hot_bytes(B, S, n, getattr(torch, dtype)) > \
            scatter.ONE_HOT_LIMIT
        assert taken == (["pallas"] if ours else ["one-hot"])

    def test_on_cpu_is_the_plain_version(self):
        g = torch.randn(2, 32, 5, 8, generator=torch.Generator().manual_seed(0))
        idx = torch.randint(0, 32, (2, 32, 5), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
        before = scatter_add.launches
        got = scatter.scatter_rows(g, idx, 32)
        assert torch.equal(got, scatter_add_plain(g.reshape(2, 160, 8),
                                                  idx.reshape(2, 160), 32))
        assert scatter_add.launches == before

    def test_gather_backward_matches_jax(self):
        """gather_neighbors' backward (the port's scatter_rows) against the
        JAX custom VJP (one-hot contraction): within 1e-6 of the max."""
        rng = np.random.default_rng(3)
        x = rng.standard_normal((2, 64, 8)).astype(np.float32)
        idx = rng.integers(0, 64, (2, 64, 5)).astype(np.int32)
        ct = rng.standard_normal((2, 64, 5, 8)).astype(np.float32)
        xt = torch.from_numpy(x).requires_grad_()
        (edge.gather_neighbors(xt, torch.from_numpy(idx))
         * torch.from_numpy(ct)).sum().backward()
        _, pull = jax.vjp(lambda v: jedge.gather_neighbors(
            v, jnp.asarray(idx)), jnp.asarray(x))
        theirs = np.asarray(pull(jnp.asarray(ct))[0])
        np.testing.assert_allclose(xt.grad.numpy(), theirs, rtol=0,
                                   atol=1e-6 * np.abs(theirs).max())

    def test_kernel_d_plain_unchanged(self):
        """Kernel D's plain version sums the neighbor term with kernel H's
        plain version: on the CPU in ascending source order, central sum
        last, equal to an explicit loop in that order."""
        rng = np.random.default_rng(4)
        dd = rng.standard_normal((1, 16, 3, 4)).astype(np.float32)
        idx = rng.integers(0, 16, (1, 16, 3)).astype(np.int32)
        ref = np.zeros((16, 4), np.float32)
        for q in range(16):
            for j in range(3):
                ref[idx[0, q, j]] += dd[0, q, j]
        central = dd[0, :, 0] + dd[0, :, 1] + dd[0, :, 2]
        got = scatter_diff_bwd_plain(torch.from_numpy(dd),
                                     torch.from_numpy(idx))
        np.testing.assert_array_equal(got[0].numpy(), ref - central)
