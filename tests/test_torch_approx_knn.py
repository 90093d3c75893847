"""The port's banded kNN (`--knn_mode approx`) against the JAX package:
`ops/approx_knn.py`, kernel F's plain version
(`ops/kernels/knn_edge_window.py`), the band normalization of
`edge_diff_features` and the banded edge op under autograd.

Inputs are made with numpy from a seed and go through both packages. The
Pallas kernel `knn_edge_window_pallas` runs in interpret mode, jitted, as
tests/test_approx_knn.py runs it; the XLA functions run on the CPU. Kernel F
itself runs only on a GPU (`cuda` marker); chip_smoke.py holds it against
its plain version there. Indices must match exactly: random f32 data has no
near-ties at these sizes.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sp_gan_tpu.ops import approx_knn as japprox
from sp_gan_tpu.ops import edge as jedge
from sp_gan_tpu.ops.pallas.knn import knn_edge_window_pallas
from sp_gan_tpu_torch.ops import approx_knn, edge
from sp_gan_tpu_torch.ops.kernels import knn_edge_window, knn_edge_window_plain
from sp_gan_tpu_torch.ops.kernels.knn_edge_window import window_geometry

torch.set_num_threads(2)   # six test workers share the host's cores


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def banded_oracle(x, k, W):
    """float64 brute force: the k nearest at circular index distance in
    (0, W], ascending (tests/test_approx_knn.py's oracle)."""
    x = np.asarray(x, np.float64)
    N = x.shape[1]
    d = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    i = np.arange(N)
    off = (i[None, :] - i[:, None]) % N
    off = np.minimum(off, N - off)
    d = np.where((off == 0) | (off > W), np.inf, d)
    return np.argsort(d, axis=-1)[..., :k].astype(np.int32)


def jax_window_pallas(x, k, W, out_dtype, tq, diff_only, mode):
    fn = jax.jit(lambda v: knn_edge_window_pallas(
        v, k, W, out_dtype, tq=tq, diff_only=diff_only, select_mode=mode))
    with pltpu.force_tpu_interpret_mode():
        ee, idx = fn(jnp.asarray(x))
    return np.asarray(ee).astype(np.float32), np.asarray(idx)


class TestWindowSelection:
    @pytest.mark.parametrize("N, W, block", [(64, 5, 8), (64, 16, 256),
                                             (96, 30, 256), (128, 28, 48)])
    def test_matches_jax(self, N, W, block):
        x = _x((2, N, 8), seed=N + W)
        ours = approx_knn.knn_indices_window(torch.from_numpy(x), 5, W,
                                             block=block)
        theirs = japprox.knn_indices_window(jnp.asarray(x), 5, window=W)
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
        np.testing.assert_array_equal(np.sort(ours.numpy(), -1),
                                      np.sort(banded_oracle(x, 5, W), -1))

    def test_block_independent_and_in_band(self):
        x = torch.from_numpy(_x((2, 97, 8), seed=1))     # odd N
        ref = approx_knn.knn_indices_window(x, 5, 6, block=97)
        for block in (1, 7, 32, 256, None):
            assert torch.equal(
                approx_knn.knn_indices_window(x, 5, 6, block=block), ref)
        off = (ref.numpy() - np.arange(97)[None, :, None]) % 97
        off = np.minimum(off, 97 - off)
        assert off.min() >= 1 and off.max() <= 6

    def test_guards(self):
        x = torch.from_numpy(_x((1, 96, 8)))
        with pytest.raises(AssertionError):          # the band would wrap
            approx_knn.knn_indices_window(x, 5, 48)
        with pytest.raises(ValueError):               # the JAX block=0 fault
            approx_knn.knn_indices_window(x, 5, 8, block=0)


class TestCandidates:
    def test_template_candidates_match_jax(self):
        from sp_gan_tpu_torch.data.sphere import sphere_template
        t = sphere_template(128)
        ours = approx_knn.template_candidates(t, 16)
        assert ours.shape == (128, 16) and ours.dtype == torch.int32
        np.testing.assert_array_equal(
            ours.numpy(), np.asarray(japprox.template_candidates(t, 16)))

    @pytest.mark.parametrize("block", [16, 40])
    def test_candidates_match_jax(self, block):
        from sp_gan_tpu_torch.data.sphere import sphere_template
        cand = approx_knn.template_candidates(sphere_template(128), 16)
        x = _x((2, 128, 8), seed=3)
        ours = approx_knn.knn_indices_candidates(torch.from_numpy(x), 4,
                                                 cand, block=block)
        theirs = japprox.knn_indices_candidates(
            jnp.asarray(x), 4, jnp.asarray(cand.numpy()), block=16)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
        for i in range(128):
            assert np.isin(ours.numpy()[:, i], cand.numpy()[i]).all()


class TestKernelFPlain:
    """Kernel F's plain version against knn_edge_window_pallas at
    [2, 256, 16], k=5, W=40, tq=64: indices equal, edges within 1e-6 in
    f32 (measured 0: the one-hot gather is exact) and equal in bf16."""

    @pytest.mark.parametrize("mode, out_dtype, diff_only", list(
        itertools.product(["packed", "exact"], ["float32", "bfloat16"],
                          [True, False])))
    def test_matches_pallas(self, mode, out_dtype, diff_only):
        x = _x((2, 256, 16), seed=5)
        ee, idx = knn_edge_window_plain(torch.from_numpy(x), 5, 40,
                                        getattr(torch, out_dtype), tq=64,
                                        diff_only=diff_only,
                                        select_mode=mode)
        pee, pidx = jax_window_pallas(x, 5, 40, out_dtype, 64, diff_only,
                                      mode)
        assert ee.dtype == getattr(torch, out_dtype)
        assert ee.shape == (2, 256, 5, 16 if diff_only else 32)
        np.testing.assert_array_equal(idx.numpy(), pidx)
        if out_dtype == "float32":
            np.testing.assert_allclose(ee.numpy(), pee, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(ee.float().numpy(), pee)

    def test_band_contract(self):
        """Candidates are exactly the band 0 < |offset| <= W; indices are
        global (mod N)."""
        x = _x((2, 128, 16), seed=6)
        ee, idx = knn_edge_window_plain(torch.from_numpy(x), 4, 16, tq=32)
        np.testing.assert_array_equal(idx.numpy(), banded_oracle(x, 4, 16))
        nbr = x[np.arange(2)[:, None, None], idx.numpy()]
        np.testing.assert_array_equal(ee[..., 16:].numpy(),
                                      nbr - x[:, :, None, :])

    @pytest.mark.parametrize("mode", ["exact", "packed"])
    def test_tile_independent(self, mode):
        """The JAX kernel's tile sets only the packed quantum; at a quantum
        no near-tie reaches, tq=32 and tq=16 give the same neighbors in
        both packages (the JAX test_kernel_tq_independent)."""
        x = _x((2, 128, 16), seed=7)
        got = [knn_edge_window_plain(torch.from_numpy(x), 4, 12, tq=tq,
                                     select_mode=mode)[1].numpy()
               for tq in (32, 16)]
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_array_equal(
            got[0], jax_window_pallas(x, 4, 12, None, 16, False, mode)[1])

    def test_packed_ties_order_by_offset(self):
        """Equal distances order by band position, offset -W first, not by
        global index: on a ring of equal points every candidate ties."""
        x = np.zeros((1, 64, 16), np.float32)
        _, idx = knn_edge_window_plain(torch.from_numpy(x), 4, 8, tq=32,
                                       select_mode="packed")
        np.testing.assert_array_equal(idx[0, 2].numpy(), [58, 59, 60, 61])
        _, pidx = jax_window_pallas(x, 4, 8, None, 32, False, "packed")
        np.testing.assert_array_equal(idx.numpy(), pidx)

    def test_geometry_matches_jax_clamp(self):
        # JAX: tq halved until it divides N, W = min(window, (N - tq) // 2),
        # the packed mask from bit_length(tq + 2W - 1)
        assert window_geometry(8192, 10, 512) == (512, 2047)
        assert window_geometry(384, 4, 512) == (128, 511)
        assert window_geometry(96, 4, 100, tq=64) == (32, 127)
        with pytest.raises(ValueError):
            window_geometry(256, 4, 512)              # W = 0 < k

    def test_wrapper_takes_plain_version_on_cpu(self):
        x = torch.from_numpy(_x((2, 128, 16)))
        before = knn_edge_window.launches
        ee, idx = knn_edge_window(x, 4, 16, torch.bfloat16, tq=32,
                                  diff_only=True, select_mode="packed")
        ref = knn_edge_window_plain(x, 4, 16, torch.bfloat16, tq=32,
                                    diff_only=True, select_mode="packed")
        assert torch.equal(ee, ref[0]) and torch.equal(idx, ref[1])
        assert knn_edge_window.launches == before
        with pytest.raises(TypeError):
            knn_edge_window(x.double(), 4, 16)
        with pytest.raises(ValueError):
            knn_edge_window(x, 4, 16, select_mode="approx")
        with pytest.raises(ValueError):
            knn_edge_window(x.to("meta"), 4, 16)


class TestEdgeDiffFeaturesWindow:
    """`edge_diff_features(window=...)` against the JAX function on the
    CPU, where it selects with the XLA window: exact selection, so the
    fused kernel F's plain version and the unfused plain band both give
    JAX's neighbors."""

    @pytest.mark.parametrize("shape, window", [
        ((2, 384, 16), 48),     # fused (kernel F's plain version)
        ((2, 384, 16), 400),    # W clamped to (N - tq) // 2 = 128
        ((2, 388, 16), 64),     # N % 8 != 0: unfused plain band + gather
        ((2, 384, 8), 64),      # C < 16: unfused
    ])
    def test_matches_jax(self, shape, window, monkeypatch):
        monkeypatch.setenv("SPGAN_KNN_SELECT", "exact")
        x = _x(shape, seed=shape[1] + window)
        for cd, jcd in ((None, None), (torch.bfloat16, jnp.bfloat16)):
            ours = edge.edge_diff_features(torch.from_numpy(x), 5,
                                           out_dtype=cd, window=window)
            theirs = jedge.edge_diff_features(jnp.asarray(x), 5,
                                              out_dtype=jcd, window=window)
            np.testing.assert_array_equal(
                ours.float().numpy(), np.asarray(theirs).astype(np.float32))

    @pytest.mark.parametrize("N, k, window, want", [
        (8192, 10, 512, 512), (16384, 10, 512, 512), (384, 5, 512, 128),
        (388, 5, 512, 192), (256, 4, 512, None), (512, 10, 12, 12),
        (512, 10, 9, None)])
    def test_normalize_window(self, N, k, window, want):
        """The clamp of JAX edge_diff_features (edge.py:249-260); a band
        narrower than k falls back to exact selection."""
        assert edge.normalize_window(N, k, window) == want

    def test_narrow_band_falls_back_to_exact(self):
        x = torch.from_numpy(_x((1, 64, 16), seed=9))
        assert torch.equal(edge.edge_diff_features(x, 4, window=8),
                           edge.edge_diff_features(x, 4))


class TestEdgeDiffWindowGrad:
    """`EdgeDiffWindow` (kernel F forward, kernel D backward; their plain
    versions here) against the VJP of JAX `_knn_edge_diff_window` as it
    runs where Pallas runs (forward `knn_edge_window_pallas`, backward
    `scatter_diff_bwd_pallas`, both in interpret mode) at [2, 512, 16],
    k=5, W=64: indices and edges equal; d_x within 1e-6 of its max-abs
    (f32 sums in other orders)."""

    @pytest.mark.parametrize("mode, out_dtype", list(itertools.product(
        ["packed", "exact"], ["float32", "bfloat16"])))
    def test_matches_jax_vjp(self, mode, out_dtype, monkeypatch):
        from sp_gan_tpu.ops import dispatch as jdispatch
        monkeypatch.setenv("SPGAN_KNN_SELECT", mode)
        monkeypatch.setattr(jdispatch, "pallas_enabled", lambda: True)
        x = _x((2, 512, 16), seed=11)
        g = _x((2, 512, 5, 16), seed=12)
        g = np.array(jnp.asarray(g).astype(out_dtype).astype(jnp.float32))
        xt = torch.from_numpy(x).requires_grad_()
        diff, idx = edge.edge_diff_window(xt, 5, 64,
                                          getattr(torch, out_dtype))
        (diff.float() * torch.from_numpy(g)).sum().backward()

        def vjp(v, ct):
            d, pull = jax.vjp(
                lambda u: jedge._knn_edge_diff_window(u, 5, 64,
                                                      out_dtype)[0], v)
            i = jedge._knn_edge_diff_window(v, 5, 64, out_dtype)[1]
            return d, i, pull(ct.astype(out_dtype))[0]

        with pltpu.force_tpu_interpret_mode():
            jd, ji, jdx = jax.jit(vjp)(jnp.asarray(x), jnp.asarray(g))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(diff.float().detach().numpy(),
                                      np.asarray(jd).astype(np.float32))
        jdx = np.asarray(jdx)
        np.testing.assert_allclose(xt.grad.numpy(), jdx, rtol=0,
                                   atol=1e-6 * np.abs(jdx).max())
