"""The PyTorch port's config, data and ops against the JAX package.

Inputs are made with numpy from a seed and go through both packages. The
kernels' plain PyTorch versions (what the port runs for a CPU tensor) are
held against the Pallas kernels in interpret mode, as tests/test_pallas.py
runs them, and against the XLA functions. The CUDA kernels themselves run
only on a GPU (`cuda` marker); chip_smoke.py holds them against the plain
versions there.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sp_gan_tpu.config import Config as JaxConfig
from sp_gan_tpu.data import sphere as jsphere
from sp_gan_tpu.ops import edge as jedge
from sp_gan_tpu.ops.pairwise import knn_indices as jknn_indices
from sp_gan_tpu.ops.pairwise import pairwise_sqdist as jpairwise_sqdist
from sp_gan_tpu.ops.pallas.edgeblock import edge_tail_pallas
from sp_gan_tpu.ops.pallas.knn import knn_edge_pallas, knn_pallas
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data import noise, sphere
from sp_gan_tpu_torch.ops import edge, pairwise
from sp_gan_tpu_torch.ops.kernels import (_build, edge_tail, edge_tail_plain,
                                          knn, knn_edge, knn_edge_plain,
                                          knn_plain)

torch.set_num_threads(2)   # six test workers share the host's cores


def _x(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def assert_same_up_to_near_ties(idx, ref, x, rel=16 * 2.0 ** -24):
    """idx equal to ref, except where the two picks lie within f32 rounding
    of each other (exact float64 distances within `rel`): there the order
    depends on the order of the f32 operations, and the two JAX paths
    (Pallas kernel and XLA) differ from each other too."""
    idx, ref = np.asarray(idx), np.asarray(ref)
    b, q, j = np.nonzero(idx != ref)
    assert len(b) <= 1e-3 * idx.size, f"{len(b)} of {idx.size} differ"
    x64 = np.asarray(x, np.float64)
    da = ((x64[b, q] - x64[b, idx[b, q, j]]) ** 2).sum(-1)
    dr = ((x64[b, q] - x64[b, ref[b, q, j]]) ** 2).sum(-1)
    assert np.all(np.abs(da - dr) <= rel * np.maximum(da, dr)), \
        "a pick differs beyond f32 rounding"


def _interpret(fn, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        out = fn(*args, **kw)
    return [np.asarray(o) for o in out]


# ---------------------------------------------------------------- config
class TestConfig:
    def test_fields_and_defaults_match_jax(self):
        ours = {f.name: getattr(Config(), f.name)
                for f in dataclasses.fields(Config)}
        theirs = {f.name: getattr(JaxConfig(), f.name)
                  for f in dataclasses.fields(JaxConfig)}
        assert ours == theirs

    def test_reads_jax_json(self):
        jc = JaxConfig(np=512, nk=16, dtype="float32", attn=True,
                       mesh_shape=(2, 2))
        assert dataclasses.asdict(Config.from_json(jc.to_json())) == \
            dataclasses.asdict(jc)

    @pytest.mark.parametrize("dtype", ["mixed_edge", "float32", "bfloat16",
                                       "bfloat16_g", "bfloat16_tail32"])
    def test_dtype_properties(self, dtype):
        ours, theirs = Config(dtype=dtype), JaxConfig(dtype=dtype)
        assert (ours.g_bf16, ours.g_tail_f32, ours.k) == \
            (theirs.g_bf16, theirs.g_tail_f32, theirs.k)

    def test_rejects_unknown_dtype(self):
        with pytest.raises(ValueError):
            Config(dtype="float16")


# ---------------------------------------------------------------- data
class TestSphere:
    @pytest.mark.parametrize("n", [256, 1000, 2048])
    def test_byte_equal_to_jax(self, n):
        np.testing.assert_array_equal(sphere.fibonacci_sphere(n),
                                      jsphere.fibonacci_sphere(n))
        np.testing.assert_array_equal(sphere.sphere_template(n),
                                      jsphere.sphere_template(n))

    def test_xyz_template(self, tmp_path):
        pts = _x((300, 6), seed=1)
        path = tmp_path / "ball.xyz"
        np.savetxt(path, pts)
        got = sphere.sphere_template(256, str(path))
        np.testing.assert_allclose(got, sphere.pc_normalize(pts[:256, :3]),
                                   rtol=1e-6, atol=1e-7)
        with pytest.raises(ValueError):
            sphere.sphere_template(400, str(path))


class TestNoise:
    def _gen(self, seed=0):
        return torch.Generator().manual_seed(seed)

    def test_tiled_codes(self):
        z = noise.sample_z(self._gen(), 512, 8, 16, sigma=0.2)
        assert z.shape == (512, 8, 16)
        assert torch.equal(z, z[:, :1].expand_as(z))
        # 512*16 draws of N(0, 0.2^2): mean and std within 5 sigma of
        # their sampling error
        assert abs(z[:, 0].mean().item()) < 5 * 0.2 / np.sqrt(512 * 16)
        assert abs(z[:, 0].std().item() - 0.2) < 5 * 0.2 / np.sqrt(2 * 8192)

    def test_per_point_codes_and_seeds(self):
        z = noise.sample_z(self._gen(3), 2, 8, 4, n_rand=True)
        assert not torch.equal(z[:, 0], z[:, 1])
        assert torch.equal(z, noise.sample_z(self._gen(3), 2, 8, 4,
                                             n_rand=True))


# ---------------------------------------------------------------- ops
class TestPairwise:
    @pytest.mark.parametrize("shape", [(2, 64, 3), (2, 128, 16)])
    def test_distances_and_knn_match_jax(self, shape):
        x = _x(shape)
        # same f32 formula, other summation order: a few ulps of |x|^2
        np.testing.assert_allclose(
            pairwise.pairwise_sqdist(torch.from_numpy(x),
                                     torch.from_numpy(x)).numpy(),
            np.asarray(jpairwise_sqdist(jnp.asarray(x), jnp.asarray(x))),
            rtol=1e-5, atol=1e-4)
        idx, dist = pairwise.knn_indices(torch.from_numpy(x), 7,
                                         return_dists=True)
        jidx, jdist = jknn_indices(jnp.asarray(x), 7, return_dists=True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(dist.numpy(), np.asarray(jdist),
                                   rtol=1e-5, atol=1e-4)

    def test_stable_mode_matches_jax(self, monkeypatch):
        monkeypatch.setenv("SPGAN_KNN_STABLE", "1")
        x = _x((2, 128, 8), seed=2)
        np.testing.assert_array_equal(
            pairwise.knn_indices(torch.from_numpy(x), 6).numpy(),
            np.asarray(jknn_indices(jnp.asarray(x), 6)))


class TestKnnKernelPlain:
    """Kernel A's plain version against knn_indices (XLA): indices equal.
    Against knn_pallas (interpret mode): indices equal except f32 near-ties,
    where the Pallas kernel also disagrees with knn_indices (one pair at
    [2, 256, 3], exact distances 5e-7 apart); distances within f32
    summation-order noise."""

    @pytest.mark.parametrize("shape", [(2, 256, 3), (2, 256, 16)])
    def test_matches_pallas_and_xla(self, shape):
        x = _x(shape)
        idx, dist = knn_plain(torch.from_numpy(x), 10)
        np.testing.assert_array_equal(
            idx.numpy(), np.asarray(jknn_indices(jnp.asarray(x), 10)))
        pidx, pdist = _interpret(knn_pallas, jnp.asarray(x), 10, tq=64)
        assert_same_up_to_near_ties(idx.numpy(), pidx, x)
        np.testing.assert_allclose(np.sort(dist.numpy(), -1),
                                   np.sort(pdist, -1), rtol=1e-5, atol=1e-4)

    def test_wrapper_takes_plain_version_on_cpu(self):
        x = torch.from_numpy(_x((1, 64, 3)))
        before = knn.launches
        idx, dist = knn(x, 5)
        ref_idx, ref_dist = knn_plain(x, 5)
        assert torch.equal(idx, ref_idx) and torch.equal(dist, ref_dist)
        assert idx.dtype == torch.int32 and knn.launches == before

    @pytest.mark.parametrize("bad, err", [
        (lambda: knn(torch.zeros(1, 8, 3, dtype=torch.float64), 2),
         TypeError),
        (lambda: knn(torch.zeros(1, 3, 8).transpose(1, 2), 2), ValueError),
        (lambda: knn(torch.zeros(8, 3), 2), ValueError),
        (lambda: knn(torch.zeros(1, 8, 3), 8), ValueError),      # k > N-1
        (lambda: knn(torch.zeros(1, 8, 3), 9), ValueError),
        (lambda: knn(torch.zeros(1, 8, 0), 2), ValueError),      # no channel
        (lambda: knn(torch.zeros(1, 8, 3, device="meta"), 2), ValueError),
    ])
    def test_wrapper_rejects(self, bad, err):
        with pytest.raises(err):
            bad()


class TestKnnEdgeKernelPlain:
    """Kernel B's plain version against knn_edge_pallas (interpret mode) at
    [2, 256, 32], k=6, tq=64: indices equal, edge features bit-equal in f32
    and in bf16 (both take the same exact gather and the same roundings)."""

    @pytest.mark.parametrize("mode, out_dtype, diff_only", list(
        itertools.product(["packed", "exact"], ["float32", "bfloat16"],
                          [True, False])))
    def test_matches_pallas(self, mode, out_dtype, diff_only):
        x = _x((2, 256, 32), seed=1)
        ee, idx = knn_edge_plain(torch.from_numpy(x), 6,
                                 getattr(torch, out_dtype), diff_only, mode)
        pee, pidx = _interpret(knn_edge_pallas, jnp.asarray(x), 6, out_dtype,
                               tq=64, diff_only=diff_only, select_mode=mode)
        np.testing.assert_array_equal(idx.numpy(), pidx)
        assert ee.dtype == getattr(torch, out_dtype)
        np.testing.assert_array_equal(ee.float().numpy(),
                                      pee.astype(np.float32))

    def test_wrapper_takes_plain_version_on_cpu(self):
        x = torch.from_numpy(_x((2, 64, 16)))
        before = knn_edge.launches
        ee, idx = knn_edge(x, 4, torch.bfloat16, True, "packed")
        ref = knn_edge_plain(x, 4, torch.bfloat16, True, "packed")
        assert torch.equal(ee, ref[0]) and torch.equal(idx, ref[1])
        assert knn_edge.launches == before

    def test_wrapper_rejects(self):
        x = torch.zeros(1, 16, 16)
        with pytest.raises(TypeError):
            knn_edge(x, 4, torch.float16)
        with pytest.raises(ValueError):
            knn_edge(x, 4, select_mode="approx")


def tail_inputs(C, F2, F, k=10, B=1, N=64, seed=0):
    """Kernel C's inputs at EdgeBlock widths: edges, folded weights with
    scale rows in [0.5, 1.5], and the conv_out kernel and bias."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def aff(w):
        return np.stack([rng.uniform(0.5, 1.5, w), n(w, scale=0.2)]) \
            .astype(np.float32)

    return [n(B, N, k, 2 * C), n(C, F2, scale=C ** -0.5), aff(F2),
            n(F2, F, scale=F2 ** -0.5), aff(F), n(2 * C, F,
                                                  scale=(2 * C) ** -0.5),
            aff(F), n(k, F, F, scale=(k * F) ** -0.5), n(1, F, scale=0.1)]


def _tail(C=3, F2=32, F=64):
    return [torch.from_numpy(a) for a in tail_inputs(C, F2, F, k=4, N=16)]


class TestEdgeTailKernelPlain:
    """Kernel C's plain version against edge_tail_pallas (interpret mode)
    at both EdgeBlocks' widths: f32 matmuls summed in other orders, measured
    2.1e-7 on outputs up to 0.45; 1e-5 relative plus 1e-6 allowed."""

    @pytest.mark.parametrize("C, F2, F", [(3, 32, 64), (64, 64, 128)])
    def test_matches_pallas(self, C, F2, F):
        args = tail_inputs(C, F2, F)
        ours = edge_tail_plain(*map(torch.from_numpy, args), k=10)
        with pltpu.force_tpu_interpret_mode():
            ref = edge_tail_pallas(*map(jnp.asarray, args), k=10, tq=64)
        assert ours.shape == (1, 64, F) and ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)

    def test_wrapper_takes_plain_version_on_cpu(self):
        args = _tail()
        before = edge_tail.launches
        assert torch.equal(edge_tail(*args, k=4, neg=0.2),
                           edge_tail_plain(*args, k=4, neg=0.2))
        assert edge_tail.launches == before

    @pytest.mark.parametrize("call, err", [
        (lambda a: edge_tail(a[0].double(), *a[1:], k=4), TypeError),
        (lambda a: edge_tail(a[0].transpose(2, 3).contiguous()
                             .transpose(2, 3), *a[1:], k=4), ValueError),
        (lambda a: edge_tail(a[0], a[1][:, :28], *a[2:], k=4), ValueError),
        (lambda a: edge_tail(*a[:8], a[8][0], k=4), ValueError),
        (lambda a: edge_tail(a[0].to("meta"), *a[1:], k=4), ValueError),
        (lambda a: edge_tail(*a, k=5), ValueError),
        (lambda a: edge_tail(*_tail(3, 16, 32), k=4), ValueError),
    ])
    def test_wrapper_rejects(self, call, err):
        with pytest.raises(err):
            call(_tail())


class TestEdgeOps:
    def test_gather_and_features_with_idx(self):
        x = _x((2, 64, 8))
        idx = np.asarray(jknn_indices(jnp.asarray(x), 5))
        tx, tidx = torch.from_numpy(x), torch.from_numpy(idx.copy())
        np.testing.assert_array_equal(
            edge.gather_neighbors(tx, tidx).numpy(),
            np.asarray(jedge.gather_neighbors(jnp.asarray(x),
                                              jnp.asarray(idx))))
        np.testing.assert_array_equal(
            edge.edge_features(tx, 5, idx=tidx).numpy(),
            np.asarray(jedge.edge_features(jnp.asarray(x), 5,
                                           idx=jnp.asarray(idx))))
        got = edge.edge_diff_features(tx, 5, idx=tidx,
                                      out_dtype=torch.bfloat16)
        ref = jedge.edge_diff_features(jnp.asarray(x), 5,
                                       idx=jnp.asarray(idx),
                                       out_dtype=jnp.bfloat16)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref).astype(np.float32))

    @pytest.mark.parametrize("shape", [(2, 64, 3), (2, 64, 32)])
    def test_knn_paths_match_jax_xla(self, shape, monkeypatch):
        """C=3 selects with kernel A, C=32 runs kernel B; in exact mode both
        equal the JAX package's XLA path (knn_indices + gather), exactly."""
        monkeypatch.setenv("SPGAN_KNN_SELECT", "exact")
        x = _x(shape, seed=4)
        ee, idx = edge.edge_features(torch.from_numpy(x), 6, return_idx=True)
        jee, jidx = jedge.edge_features(jnp.asarray(x), 6, return_idx=True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(ee.numpy(), np.asarray(jee))
        diff = edge.edge_diff_features(torch.from_numpy(x), 6,
                                       out_dtype=torch.bfloat16)
        jdiff = jedge.edge_diff_features(jnp.asarray(x), 6,
                                         out_dtype=jnp.bfloat16)
        np.testing.assert_array_equal(diff.float().numpy(),
                                      np.asarray(jdiff).astype(np.float32))

    @pytest.mark.parametrize("shape, k, fused", [
        ((1, 2048, 3), 10, False), ((1, 2048, 16), 10, True),
        ((1, 100, 32), 10, False), ((1, 8200, 16), 10, False),
        ((1, 64, 129), 10, False), ((1, 64, 32), 33, False)])
    def test_fused_eligibility(self, shape, k, fused):
        assert edge.use_fused_knn_edge(torch.empty(shape, device="meta"),
                                       k) == fused

    def test_select_mode_env(self, monkeypatch):
        assert edge.knn_select_mode() == "packed"
        monkeypatch.setenv("SPGAN_KNN_SELECT", "nope")
        with pytest.raises(ValueError):
            edge.knn_select_mode()

    def test_window_not_ported(self):
        """The band (`--knn_mode approx`) is ported since; at N=64 the
        window normalizes to W=0 < k, which means exact selection, as in
        the JAX package (tests/test_torch_approx_knn.py holds the band)."""
        x = torch.from_numpy(_x((1, 64, 16), seed=5))
        assert edge.normalize_window(64, 4, 8) is None
        assert torch.equal(edge.edge_diff_features(x, 4, window=8),
                           edge.edge_diff_features(x, 4))


# ---------------------------------------------------------------- build
class TestBuild:
    @staticmethod
    def _fake_nvcc(tmp_path, body):
        bindir = tmp_path / "cuda" / "bin"
        bindir.mkdir(parents=True)
        nvcc = bindir / "nvcc"
        nvcc.write_text("#!/bin/sh\n" + body)
        nvcc.chmod(0o755)
        return tmp_path / "cuda"

    def test_no_nvcc_raises(self, tmp_path, monkeypatch):
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "nvcc")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()

    def test_failed_compile_raises_with_stderr(self, tmp_path, monkeypatch):
        home = self._fake_nvcc(tmp_path, "echo 'error: bad kernel' >&2\n"
                                         "exit 2\n")
        monkeypatch.setenv("CUDA_HOME", str(home))
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        with pytest.raises(RuntimeError, match="bad kernel"):
            _build.build()
        assert list((tmp_path / "build").iterdir()) == []

    def test_builds_once_per_source_hash(self, tmp_path, monkeypatch):
        # the fake compiler writes its -o argument and counts its calls
        home = self._fake_nvcc(
            tmp_path, 'while [ "$1" != "-o" ]; do shift; done\n'
                      'echo lib > "$2"\necho x >> "$0.calls"\n')
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        (csrc / "a.cu").write_text("// one\n")
        monkeypatch.setenv("CUDA_HOME", str(home))
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build, "CSRC_DIR", csrc)
        first = _build.build()
        assert first.exists() and _build.build() == first
        (csrc / "a.cu").write_text("// two\n")
        second = _build.build()
        assert second != first and second.exists()
        # per build one compile for the one source and one link
        calls = (home / "bin" / "nvcc.calls").read_text().split()
        assert len(calls) == 2 * 2
        assert sorted(p.name for p in (tmp_path / "build").iterdir()) == \
            sorted([first.name, second.name])


@pytest.mark.cuda
class TestOnCard:
    def test_kernels_match_plain_versions(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (kernels have no CPU mode)")
        x = torch.from_numpy(_x((2, 256, 32))).cuda()
        for mode, cd, diff_only in itertools.product(
                ["packed", "exact"], [torch.float32, torch.bfloat16],
                [True, False]):
            ee, idx = knn_edge(x, 6, cd, diff_only, mode)
            ree, ridx = knn_edge_plain(x, 6, cd, diff_only, mode)
            assert torch.equal(idx, ridx) and torch.equal(ee, ree)
        idx, dist = knn(x[:, :, :3].contiguous(), 10)
        ridx, rdist = knn_plain(x[:, :, :3].contiguous(), 10)
        assert torch.equal(idx, ridx) and torch.equal(dist, rdist)
        torch.backends.cuda.matmul.allow_tf32 = False
        for widths in ((3, 32, 64), (64, 64, 128)):
            args = [torch.from_numpy(a).cuda() for a in tail_inputs(*widths)]
            torch.testing.assert_close(edge_tail(*args, k=10),
                                       edge_tail_plain(*args, k=10),
                                       rtol=1e-4, atol=1e-5)
