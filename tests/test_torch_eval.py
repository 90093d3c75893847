"""The port's evaluation package (`sp_gan_tpu_torch/eval` and the evaluate
CLI) against the JAX package's on the CPU; the protocol with EMD and
`Trainer.evaluate` are in tests/test_torch_eval_protocol.py.

Tolerances: the Chamfer matrices differ by the two packages' f32 orders
of the distance (the port folds the channels, JAX runs a HIGHEST matmul):
within 1e-5 relative. Statistics computed from the same matrices or the
same clouds (COV, MMD, 1-NN, JSD, F-score, per-class) are equal. The EMD
matrices come from two near-optimal assignments on distances that differ
in the last bit: each pair's matching may part at a near-tie, so the EMD
columns are held to a bound derived from the n * eps optimality of both
(tests/test_torch_eval_protocol.py). The DGCNN extractor within 2e-4 (it
sums in other orders, and its kNN may swap a near-tie neighbor), FPD
within 1e-3 relative.
"""

import importlib.util
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_gan_tpu.data import SyntheticDataset as JaxSynthetic
from sp_gan_tpu.eval import fpd as jfpd
from sp_gan_tpu.eval import metrics as jm
from sp_gan_tpu.eval.dgcnn import DGCNNFeat as JaxDGCNN
from sp_gan_tpu_torch import eval as pe
from sp_gan_tpu_torch import evaluate as port_cli
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.eval import fpd as pfpd
from sp_gan_tpu_torch.eval import metrics as pm
from sp_gan_tpu_torch.eval.dgcnn import DGCNNFeat
from sp_gan_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)   # six test workers share the host's cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "runs", "fpd_dgcnn_synth.pkl")
STATS = os.path.join(ROOT, "runs", "fpd_stats_synth.npz")
HELDOUT = os.path.join(ROOT, "runs", "heldout_ref.npy")


def shapes(seed, S, n=64):
    """Clouds of a few shape families, normalized to radius 1."""
    ds = JaxSynthetic(n_items=S, n_points=n, seed=seed).data
    c = ds - ds.mean(1, keepdims=True)
    return (c / np.linalg.norm(c, axis=-1).max(1)[:, None, None]) \
        .astype(np.float32)


def cd_close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)


class TestMetrics:
    @pytest.mark.parametrize("col_chunk", [0, 2])
    def test_pairwise_cd_matrix(self, col_chunk):
        g, r = shapes(0, 6), shapes(1, 4)
        want = np.asarray(jm.pairwise_cd_matrix(jnp.asarray(g),
                                                jnp.asarray(r)))
        got = pm.pairwise_cd_matrix(torch.from_numpy(g), r,
                                    col_chunk=col_chunk)
        assert got.shape == (6, 4) and got.dtype == np.float32
        cd_close(got, want)

    def test_statistics_on_the_same_matrices(self):
        rng = np.random.default_rng(2)
        gg, gt, tt = (rng.random(s).astype(np.float32)
                      for s in ((7, 7), (7, 5), (5, 5)))
        assert pm.coverage(gt) == jm.coverage(gt)
        assert pm.mmd(gt) == jm.mmd(gt)
        assert pm.knn_two_sample(gg, gt, tt) == jm.knn_two_sample(gg, gt, tt)
        labels = np.array([0, 1, 1, 2, 2])
        assert pm.per_class_metrics(gt, labels, 3) == \
            jm.per_class_metrics(gt, labels, 3)

    def test_per_class_guards_an_empty_class(self):
        gt = np.random.default_rng(3).random((4, 3))
        out = pm.per_class_metrics(gt, np.array([0, 0, 2]), 3)
        assert all(np.isnan(out["class1"][k])
                   for k in ("MMD-CD", "COV-CD", "COV-CD-within"))
        assert out["class1"]["gen_share"] == 0.0

    def test_jsd_and_f_score(self):
        g, r = shapes(4, 5, 128), shapes(5, 5, 128)
        assert pm.jsd(0.5 * g, 0.5 * r) == jm.jsd(0.5 * g, 0.5 * r)
        with pytest.warns(UserWarning, match="outside"):
            assert pm.jsd(g, r) == jm.jsd(g, r, warn=False)
        for thr in (0.001, 0.01):
            np.testing.assert_array_equal(
                pm.f_score(g, r, thr),
                jm.f_score(jnp.asarray(g), jnp.asarray(r), thr))

    def test_compute_all_metrics(self):
        """Without EMD: CD and JSD columns within 1e-5, COV and 1-NN
        equal (tests/test_torch_eval_protocol.py has the EMD columns)."""
        g, r = shapes(6, 6) * 0.9, shapes(7, 6)
        want = jm.compute_all_metrics(g, r, normalize=True)
        got = pe.compute_all_metrics(g, r, normalize=True, device="cpu")
        assert set(got) == set(want)
        for k in ("MMD-CD", "JSD"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
        for k in ("COV-CD", "1NN-CD", "jsd_scale"):
            assert got[k] == want[k], k

    def test_emd_matrix_solves_in_chunks(self, monkeypatch):
        """Pairs go to the solver in row-major chunks of
        `emd_pairs_per_call`; the matrix does not depend on the chunk."""
        g, r = shapes(8, 5), shapes(9, 3)
        whole = pm.pairwise_emd_matrix(g, r, 0.01, 40)
        assert pm.emd_pairs_per_call(3, 64, 64, row_batch=8) == 24
        assert pm.emd_pairs_per_call(200, 2048, 2048) == 256
        monkeypatch.setattr(pm, "EMD_CHUNK_BYTES", 2 * 64 * 64 * 4)
        assert pm.emd_pairs_per_call(3, 64, 64) == 2
        np.testing.assert_array_equal(pm.pairwise_emd_matrix(g, r, 0.01, 40),
                                      whole)
        with pytest.raises(NotImplementedError):
            pm.pairwise_emd_matrix(g, r, mesh=object())


class TestFPD:
    def test_dgcnn_with_the_repo_extractor(self):
        with open(WEIGHTS, "rb") as f:
            blob = pickle.load(f)
        variables = {k: blob[k] for k in ("params", "batch_stats")}
        x = (np.random.default_rng(0).standard_normal((4, 256, 3)) * 0.3) \
            .astype(np.float32)
        jd = JaxDGCNN(k=blob["k"], feat_dims=blob["feat_dims"])
        want = np.asarray(jax.jit(lambda v, p: jd.apply(v, p))(
            variables, jnp.asarray(x)))
        fpd = pfpd.fpd_from_weights(WEIGHTS, device="cpu")
        assert not fpd.random_features
        np.testing.assert_allclose(fpd.activations(x), want, rtol=0,
                                   atol=2e-4)

    def test_frechet_distance_equal(self):
        rng = np.random.default_rng(1)
        a, b = rng.standard_normal((2, 40, 8))
        sa, sb = (pfpd.activation_statistics(v) for v in (a, b))
        assert pfpd.frechet_distance(*sa, *sb) == \
            jfpd.frechet_distance(*sa, *sb)

    def test_fpd_against_the_stats_file(self):
        """24 held-out shapes at 256 points through both extractors, FPD
        against runs/fpd_stats_synth.npz."""
        clouds = np.load(HELDOUT, mmap_mode="r")[:24, ::8].astype(np.float32)
        with open(WEIGHTS, "rb") as f:
            blob = pickle.load(f)
        jf = jfpd.FPD({k: blob[k] for k in ("params", "batch_stats")},
                      k=blob["k"], feat_dims=blob["feat_dims"])
        want = jf(clouds, stats_path=STATS)
        got = pfpd.fpd_from_weights(WEIGHTS, device="cpu")(
            clouds, stats_path=STATS)
        np.testing.assert_allclose(got, want, rtol=1e-3)

    def test_random_features_and_save(self, tmp_path):
        fpd = pe.FPD(k=8, feat_dims=32, device="cpu")
        assert fpd.random_features
        x = shapes(2, 6)
        a = fpd.activations(x)
        assert a.shape == (6, 32) and np.isfinite(a).all()
        np.testing.assert_array_equal(
            a, pe.FPD(k=8, feat_dims=32, device="cpu").activations(x))
        fpd.save_statistics(x, str(tmp_path / "s.npz"))
        mu, sigma = pfpd.load_stats(str(tmp_path / "s.npz"))
        assert mu.shape == (32,) and sigma.shape == (32, 32)
        assert fpd(x, stats_path=str(tmp_path / "s.npz")) == \
            pytest.approx(0.0, abs=1e-6)
        with pytest.raises(NotImplementedError, match="utilities and compat"):
            pe.FPD.from_torch("x.pth")
        # anything but a pickle of flax variables is the reference format
        (tmp_path / "ref.pkl").write_bytes(b"PK\x03\x04 a torch zip")
        with open(tmp_path / "sd.pkl", "wb") as f:
            pickle.dump({"model_state": {}}, f)
        for name in ("ref.pkl", "sd.pkl"):
            with pytest.raises(NotImplementedError):
                pfpd.fpd_from_weights(str(tmp_path / name), device="cpu")

    def test_dgcnn_parameter_names_are_the_flax_paths(self):
        with open(WEIGHTS, "rb") as f:
            blob = pickle.load(f)
        names = set(DGCNNFeat(seed=None).state_dict())
        flat = {f"{layer}.{leaf}" for tree in ("params", "batch_stats")
                for layer, leaves in blob[tree].items() for leaf in leaves}
        assert names == flat


def run_jax_cli(argv, monkeypatch, capsys, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "root_evaluate", os.path.join(ROOT, "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setenv("SPGAN_JAX_CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(sys, "argv", ["evaluate.py", *argv])
    mod.main()
    return json.loads(capsys.readouterr().out)


class TestCli:
    def test_keys_equal_the_jax_cli(self, tmp_path, monkeypatch, capsys):
        np.save(tmp_path / "g.npy", shapes(10, 5))
        np.save(tmp_path / "r.npy", shapes(11, 5))
        argv = ["--gen", str(tmp_path / "g.npy"), "--ref",
                str(tmp_path / "r.npy"), "--emd", "--emd_iters", "300",
                "--fpd", "--fpd_weights", WEIGHTS]
        got = port_cli.main([*argv, "--device", "cpu"])
        assert json.loads(capsys.readouterr().out) == got
        want = run_jax_cli(argv, monkeypatch, capsys, tmp_path)
        assert set(got) == set(want)
        assert got["FPD_note"] == want["FPD_note"]
        for k in ("MMD-CD", "JSD"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)

    def test_defaults_to_cuda(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        np.save(tmp_path / "g.npy", shapes(10, 2))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_cli.main(["--gen", str(tmp_path / "g.npy"), "--ref",
                           str(tmp_path / "g.npy")])
        with pytest.raises(NotImplementedError):
            port_cli.main(["--gen", "x", "--ref", "y", "--mesh_points", "2"])

    def test_from_a_checkpoint(self, tmp_path, capsys):
        cfg = Config(np=64, bs=4, nk=8, nz=16, log_dir=str(tmp_path),
                     max_epoch=1, steps_per_epoch=1, data_root=str(tmp_path))
        tr = Trainer(cfg, device="cpu")
        tr.train()
        tr.close()
        np.save(tmp_path / "r.npy", shapes(12, 4))
        out = port_cli.main(["--log_dir", str(tmp_path), "--n", "4", "--ref",
                             str(tmp_path / "r.npy"), "--device", "cpu"])
        assert set(out) == {"JSD", "jsd_scale", "COV-CD", "MMD-CD", "1NN-CD"}
