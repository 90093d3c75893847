"""The metric protocol with EMD and `Trainer.evaluate` of the port against
the JAX package's on the CPU (tolerances as in tests/test_torch_eval.py).
The JAX side runs its EMD through the Pallas block Gauss-Seidel kernel in
interpret mode, the solver that kernel E and its plain version port."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import sp_gan_tpu.ops.dispatch as jdispatch
from sp_gan_tpu.config import Config as JaxConfig
from sp_gan_tpu.data import SyntheticDataset as JaxSynthetic
from sp_gan_tpu.eval import metrics as jm
from sp_gan_tpu.train import Trainer as JaxTrainer
from sp_gan_tpu_torch import eval as pe
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.eval import metrics as pm
from sp_gan_tpu_torch.train.trainer import Trainer
from test_torch_eval import STATS, WEIGHTS, shapes

torch.set_num_threads(2)   # six test workers share the host's cores


def test_compute_all_metrics_with_emd(monkeypatch):
    """S=4, N=64 at the test regime (eps 0.002, 10000 iterations), JAX
    with Pallas patched on. CD and JSD columns within 1e-5. EMD: each
    pair's squared-distance sum lies within n * eps of the optimum in both
    packages, so per pair their mean L2 costs differ by at most
    sqrt(2 eps) (the mean of sqrt(a_i) moves by at most
    sqrt(mean |a_i - b_i|)); MMD-EMD is held to that, the discrete COV
    and 1-NN columns equal."""
    g = shapes(6, 4) * 0.9
    r = shapes(7, 4)
    monkeypatch.setattr(jdispatch, "pallas_enabled", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        want = jm.compute_all_metrics(g, r, normalize=True, use_emd=True)
    got = pe.compute_all_metrics(g, r, normalize=True, use_emd=True,
                                 device="cpu")
    assert set(got) == set(want)
    for k in ("MMD-CD", "JSD"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    for k in ("COV-CD", "1NN-CD", "jsd_scale", "COV-EMD", "1NN-EMD"):
        assert got[k] == want[k], k
    assert abs(got["MMD-EMD"] - want["MMD-EMD"]) <= np.sqrt(2 * 0.002)


class TestTrainerEvaluate:
    """`Trainer.evaluate` of both packages on the same fixed clouds (each
    trainer's sampler replaced by one that returns them), the same
    training data and so the same reference draw."""

    @pytest.fixture(scope="class")
    def records(self, tmp_path_factory):
        kw = dict(np=64, bs=4, nk=8, nz=16, eval_every=1, eval_size=6,
                  ema=True, fpd_weights=WEIGHTS, fpd_stats=STATS)
        fixed = {"ema": shapes(20, 6) * 0.8, "raw": shapes(21, 6) * 0.7}
        data = JaxSynthetic(n_items=16, n_points=64, seed=3)
        out = {}
        jd = str(tmp_path_factory.mktemp("jax"))
        jtr = JaxTrainer(JaxConfig(**kw, log_dir=jd, donate_state=False),
                         dataset=data)
        jtr.sample_fn = lambda st, z: jnp.asarray(fixed["ema"][:z.shape[0]])
        jtr.sample_raw = lambda st, z: jnp.asarray(fixed["raw"][:z.shape[0]])
        out["jax"] = jtr.evaluate(1, 3)
        pd = str(tmp_path_factory.mktemp("port"))
        cfg = Config(**kw, log_dir=pd)
        tr = Trainer(cfg, dataset=data, device="cpu")
        tr.sample_fn = lambda st, z: torch.from_numpy(
            fixed["ema"][:z.shape[0]])
        tr.sample_raw = lambda st, z: torch.from_numpy(
            fixed["raw"][:z.shape[0]])
        out["port"] = tr.evaluate(1, 3)
        first = out["port"]["ema"]["MMD-CD"]
        tr.sample_fn = lambda st, z: torch.from_numpy(
            fixed["raw"][:z.shape[0]])
        out["again"] = tr.evaluate(2, 6)
        tr.close()
        out.update(dir=pd, cfg=cfg, first=first)
        return out

    def test_metrics_equal_the_jax_ones(self, records):
        got, want = records["port"], records["jax"]
        assert set(got) == set(want)
        assert (got["epoch"], got["step"], got["jsd_scale"]) == (1, 3, 0.5)
        for variant in ("ema", "raw"):
            a, b = got[variant], want[variant]
            assert set(a) == set(b)
            for k in ("MMD-CD", "JSD"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5)
            for k in ("COV-CD", "1NN-CD"):
                assert a[k] == b[k], (variant, k)
            np.testing.assert_allclose(a["FPD"], b["FPD"], rtol=1e-3)

    def test_eval_jsonl_and_best(self, records):
        d = records["dir"]
        lines = [json.loads(s) for s in open(os.path.join(d, "eval.jsonl"))]
        assert [r["epoch"] for r in lines] == [1, 2]
        best = json.load(open(os.path.join(d, "best.json")))
        assert best["variant"] == "ema" and best["metric"] == "MMD-CD"
        want_epoch = 2 if records["again"]["ema"]["MMD-CD"] < \
            records["first"] else 1
        assert best["epoch"] == want_epoch
        assert best["value"] == min(records["first"],
                                    records["again"]["ema"]["MMD-CD"])
        assert os.path.exists(os.path.join(d, "ckpt_best.pkl"))
        log = open(os.path.join(d, "log_train.txt")).read()
        assert "EVAL epoch=1 step=3 [ema]" in log

    def test_restore_reads_best(self, records):
        cfg = dataclasses.replace(records["cfg"], restore=True)
        tr = Trainer(cfg, dataset=JaxSynthetic(n_items=16, n_points=64,
                                               seed=3), device="cpu")
        tr.close()
        assert tr._best == json.load(open(os.path.join(records["dir"],
                                                       "best.json")))

    def test_eval_emd_columns(self, tmp_path):
        cfg = Config(np=64, bs=4, nk=8, nz=16, eval_size=4, eval_emd=True,
                     log_dir=str(tmp_path), track_best=False)
        tr = Trainer(cfg, dataset=JaxSynthetic(n_items=8, n_points=64),
                     device="cpu", logs=False)
        rec = tr.eval_metrics(torch.from_numpy(shapes(22, 4)))
        for k in ("MMD-EMD", "COV-EMD", "1NN-EMD"):
            assert np.isfinite(rec[k]), k
        want = pm.pairwise_emd_matrix(shapes(22, 4), tr.eval_reference())
        assert rec["MMD-EMD"] == pm.mmd(want)


def test_train_evaluates_every_eval_every_epochs(tmp_path):
    """`--eval_every 2` over three epochs: one record, after epoch 2, at
    that epoch's step count."""
    cfg = Config(np=64, bs=4, nk=8, nz=16, eval_every=2, eval_size=4,
                 max_epoch=3, steps_per_epoch=1, log_dir=str(tmp_path),
                 data_root=str(tmp_path))
    tr = Trainer(cfg, dataset=JaxSynthetic(n_items=8, n_points=64),
                 device="cpu")
    tr.train()
    tr.close()
    lines = [json.loads(s) for s in open(tmp_path / "eval.jsonl")]
    assert [(r["epoch"], r["step"]) for r in lines] == [(2, 2)]
    assert set(lines[0]) == {"epoch", "step", "jsd_scale", "raw"}
    assert json.load(open(tmp_path / "best.json"))["epoch"] == 2
