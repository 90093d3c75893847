"""The PyTorch port's training CLI, data, state and trainer, on the CPU:
flags and synthetic data against the JAX package's, the schedule, EMA and
nan guard, checkpoints that serving reads, and `--restore`."""

import dataclasses
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from sp_gan_tpu.config import parse_args as jparse_args
from sp_gan_tpu.data import h5 as jh5
from sp_gan_tpu.train.state import make_lr_schedule
from sp_gan_tpu_torch import bench
from sp_gan_tpu_torch.config import Config, parse_args
from sp_gan_tpu_torch.data import h5
from sp_gan_tpu_torch.manipulate import from_checkpoint
from sp_gan_tpu_torch.train import __main__ as train_cli
from sp_gan_tpu_torch.train.checkpoint import (latest_checkpoint,
                                               load_checkpoint,
                                               load_generator,
                                               save_checkpoint)
from sp_gan_tpu_torch.train.state import (create_train_state, ema_update,
                                          lr_at)
from sp_gan_tpu_torch.train.step import make_train_step
from sp_gan_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)   # six test workers share the host's cores

TINY = dict(np=64, bs=4, nk=8, nz=16)


# ---------------------------------------------------------------- CLI, data
class TestArgs:
    @pytest.mark.parametrize("argv", [
        [],
        ["--np", "256", "--bs", "4", "--no-pool_commute", "--ema",
         "--dtype", "float32", "--steps_per_epoch", "3"],
        ["--mesh_shape", "2", "2", "--mesh_axes", "data", "points",
         "--lr_g", "2e-4", "--gan", "hinge", "--template", "ball.xyz",
         "--no-donate_state", "--steps_per_call", "4", "--use_pallas"],
    ])
    def test_matches_jax_parse_args(self, argv):
        assert dataclasses.asdict(parse_args(argv)) == \
            dataclasses.asdict(jparse_args(argv))

    def test_cli_defaults_to_cuda(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(["--log_dir", str(tmp_path / "run"), "--np", "64"])


class TestData:
    @pytest.mark.parametrize("n_items, n_points, seed", [(24, 256, 0),
                                                          (5, 100, 7)])
    def test_synthetic_byte_equal(self, n_items, n_points, seed):
        a = h5.SyntheticDataset(n_items, n_points, seed).data
        b = jh5.SyntheticDataset(n_items, n_points, seed).data
        assert a.tobytes() == b.tobytes()

    def test_multiclass_byte_equal(self):
        a = h5.SyntheticMultiClassDataset(9, 128, 3)
        b = jh5.SyntheticMultiClassDataset(9, 128, 3)
        assert a.data.tobytes() == b.data.tobytes()
        np.testing.assert_array_equal(a.labels, b.labels)

    def test_h5_matches_jax(self, tmp_path):
        h5py = pytest.importorskip("h5py")
        os.makedirs(tmp_path / "32")
        rng = np.random.default_rng(0)
        for cat in ("chair", "table"):
            with h5py.File(tmp_path / "32" / f"{cat}.h5", "w") as f:
                f["poisson_32"] = rng.standard_normal((5, 32, 3))
        for kw in (dict(choice="Chair"), dict(choice="x", con=True)):
            a = h5.H5Dataset(str(tmp_path), n_points=32, scale=0.8, **kw)
            b = jh5.H5Dataset(str(tmp_path), n_points=32, scale=0.8, **kw)
            np.testing.assert_array_equal(a.data, b.data)

    def test_missing_h5py_is_missing_data(self, tmp_path, monkeypatch):
        monkeypatch.setitem(sys.modules, "h5py", None)
        with pytest.raises(OSError, match="h5py"):
            h5.load_h5(str(tmp_path / "x.h5"))
        cfg = Config(**TINY, log_dir=str(tmp_path / "run"),
                     data_root=str(tmp_path))
        tr = Trainer(cfg, device="cpu")
        tr.close()
        assert isinstance(tr.dataset, h5.SyntheticDataset)
        assert len(tr.dataset) == 240
        log = (tmp_path / "run" / "log_train.txt").read_text()
        assert "using synthetic data" in log


# ---------------------------------------------------------------- state
class TestState:
    @pytest.mark.parametrize("decay", [False, True])
    def test_lr_schedule_matches_jax(self, decay):
        cfg = Config(lr_decay=decay, lr_decay_feq=3, lr_decay_rate=0.5)
        from sp_gan_tpu.config import Config as JaxConfig
        sched = make_lr_schedule(JaxConfig(lr_decay=decay, lr_decay_feq=3,
                                           lr_decay_rate=0.5), 1e-3, 7)
        for step in (0, 6, 7, 20, 21, 63, 100):
            want = sched(step) if callable(sched) else sched
            assert lr_at(cfg, 1e-3, step, 7) == pytest.approx(float(want))

    def test_ema(self):
        a, b = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
        ea = [p.detach().clone() for p in a.parameters()]
        ema_update(a, b, 0.9)
        for e, x, p in zip(a.parameters(), ea, b.parameters()):
            torch.testing.assert_close(e, 0.9 * x + 0.1 * p)

    def test_nan_guard_skips_the_update(self):
        cfg = Config(**TINY, nan_guard=True)
        st = create_train_state(cfg, device="cpu")
        with torch.no_grad():
            st.D.head4.bias.fill_(float("nan"))
        d0 = [p.detach().clone() for p in st.D.parameters()]
        g0 = [p.detach().clone() for p in st.G.parameters()]
        step = make_train_step(cfg, np.zeros((cfg.np, 3), np.float32) + 0.1)
        real = torch.from_numpy(h5.SyntheticDataset(4, cfg.np).data)
        st, m = step(st, real)
        assert not torch.isfinite(m["d_loss"])
        for a, b in zip(d0, st.D.parameters()):
            assert torch.equal(a, b) or torch.isnan(a).all()
        assert all(torch.equal(a, b) for a, b in zip(g0, st.G.parameters()))
        assert not st.d_opt.state and not st.g_opt.state
        assert st.step == 1

    @pytest.mark.parametrize("kw", [dict(n_mix=True)])
    def test_emd_paths_not_ported(self, kw):
        with pytest.raises(NotImplementedError):
            make_train_step(Config(**TINY, **kw), np.zeros((64, 3)))

    @pytest.mark.parametrize("kw", [dict(gan="wgan"), dict(mix=True)])
    def test_emd_paths_take_a_step(self, kw):
        """WGAN-GP (gan=wgan with the default lambda_gp 10) and CutMix
        build and take one finite step on the CPU."""
        cfg = Config(**TINY, **kw)
        st = create_train_state(cfg, device="cpu")
        step = make_train_step(cfg, np.zeros((cfg.np, 3), np.float32) + 0.1)
        real = torch.from_numpy(h5.SyntheticDataset(4, cfg.np).data)
        st, m = step(st, real)
        assert all(np.isfinite(float(v)) for v in m.values())
        assert st.step == 1

    def test_per_shard_batchnorm_not_ported(self):
        """Per-shard statistic groups wait for the data-parallel slice."""
        cfg = Config(**TINY, bn_stats="per_shard", mesh_shape=(2,))
        assert cfg.bn_groups == 2
        with pytest.raises(NotImplementedError):
            make_train_step(cfg, np.zeros((64, 3)))
        make_train_step(Config(**TINY, bn_stats="per_shard"),
                        np.zeros((64, 3)))       # one shard is one group


# ---------------------------------------------------------------- trainer
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A two-epoch CPU run (3 steps an epoch, snapshots every epoch) and
    its third epoch resumed from the second's checkpoint."""
    d = str(tmp_path_factory.mktemp("run"))
    cfg = Config(**TINY, log_dir=d, max_epoch=2, snapshot=1,
                 steps_per_epoch=3, ema=True, data_root=d)
    tr = Trainer(cfg, device="cpu")
    tr.train()
    tr.close()
    resumed = Trainer(dataclasses.replace(cfg, restore=True), device="cpu")
    return tr, resumed, cfg


class TestTrainer:
    def test_writes_checkpoints_and_logs(self, trained):
        tr, _, cfg = trained
        assert latest_checkpoint(cfg.log_dir).endswith("ckpt_epoch_2.pkl")
        assert os.path.exists(os.path.join(cfg.log_dir, "ckpt_epoch_1.pkl"))
        assert tr.state.step == 6
        log = open(os.path.join(cfg.log_dir, "log_train.txt")).read()
        assert "Epoch: [ 2]" in log and "d_loss" in log
        with open(os.path.join(cfg.log_dir, "config.json")) as f:
            assert Config.from_json(f.read()) == cfg

    def test_checkpoint_layout_is_the_jax_one(self, trained):
        _, _, cfg = trained
        with open(latest_checkpoint(cfg.log_dir), "rb") as f:
            blob = pickle.load(f)
        assert blob["epoch"] == 2 and set(blob) == {"state", "epoch",
                                                    "torch"}
        st = blob["state"]
        assert int(st["step"]) == 6
        assert st["g_params"]["edge2"]["conv_w1"]["kernel"].shape == (64, 64)
        assert st["d_stats"]["bn_fc2"]["var"].dtype == np.float32
        assert set(st["g_ema"]) == set(st["g_params"])

    def test_serving_reads_the_checkpoint(self, trained):
        tr, _, cfg = trained
        path = latest_checkpoint(cfg.log_dir)
        man = from_checkpoint(path, cfg, use_ema=True, device="cpu")
        z = man.sample_codes(3, seed=4)
        np.testing.assert_allclose(
            man.forward(z), tr.sample_fn(tr.state, z).numpy(),
            rtol=1e-5, atol=1e-5)
        params, _ = load_generator(path)
        got = dict(tr.state.G.named_parameters())["tail3.kernel"]
        np.testing.assert_array_equal(params["tail3"]["kernel"],
                                      got.detach().numpy())

    def test_restore_resumes_at_the_next_epoch(self, trained):
        tr, resumed, _ = trained
        assert resumed.start_epoch == 3 and resumed.state.step == 6
        for a, b in zip(tr.state.G.state_dict().values(),
                        resumed.state.G.state_dict().values()):
            assert torch.equal(a, b)
        for a, b in zip(tr.state.g_ema.parameters(),
                        resumed.state.g_ema.parameters()):
            assert torch.equal(a, b)
        sa, sb = tr.state.d_opt.state_dict(), resumed.state.d_opt.state_dict()
        for k in sa["state"]:
            assert torch.equal(sa["state"][k]["exp_avg"],
                               sb["state"][k]["exp_avg"])
        resumed.train(max_epoch=3)
        resumed.close()
        assert resumed.state.step == 9

    def test_generate(self, trained):
        tr, _, cfg = trained
        out = tr.generate(5, seed=1, batch=2)
        assert out.shape == (5, cfg.np, 3) and np.isfinite(out).all()
        np.testing.assert_array_equal(out, tr.generate(5, seed=1, batch=2))

    def test_time_steps_runs_the_training_steps(self, tmp_path, capsys):
        """`time_steps` (the benchmark's loop) takes the batches `train`
        takes, in the same order, and with `logs=False` writes and prints
        nothing."""
        cfg = Config(**TINY, log_dir=str(tmp_path / "a"), max_epoch=1,
                     steps_per_epoch=3, data_root=str(tmp_path))
        a = Trainer(cfg, device="cpu")
        a.train()
        a.close()
        capsys.readouterr()
        quiet = dataclasses.replace(cfg, log_dir=str(tmp_path / "b"))
        b = Trainer(quiet, device="cpu", logs=False)
        run = b.time_steps(2, warmup=1)
        assert not os.path.exists(quiet.log_dir)
        assert capsys.readouterr().out == ""
        assert len(run["metrics"]) == 3 and run["steps_per_sec"] > 0
        for p, q in zip(a.state.G.parameters(), b.state.G.parameters()):
            assert torch.equal(p, q)

    def test_checkpoint_round_trip(self, tmp_path):
        cfg = Config(**TINY)
        a = create_train_state(cfg, device="cpu")
        a.step = 11
        path = save_checkpoint(str(tmp_path), a, 4, cfg)
        b = create_train_state(dataclasses.replace(cfg, seed=5),
                               device="cpu")
        assert load_checkpoint(path, b) == 4 and b.step == 11
        for x, y in zip(a.D.state_dict().values(), b.D.state_dict().values()):
            assert torch.equal(x, y)
        assert torch.equal(a.gen.get_state(), b.gen.get_state())


class TestCli:
    def test_trains_on_cpu(self, tmp_path, capsys):
        d = str(tmp_path / "run")
        train_cli.main(["--device", "cpu", "--np", "64", "--bs", "4",
                        "--nk", "8", "--nz", "16", "--max_epoch", "1",
                        "--steps_per_epoch", "2", "--log_dir", d,
                        "--data_root", str(tmp_path)])
        assert os.path.exists(os.path.join(d, "ckpt_epoch_1.pkl"))
        assert "Epoch: [ 1]" in capsys.readouterr().out

    def test_bench_prints_one_json_line(self, capsys):
        bench.main(["--device", "cpu", "--np", "64", "--bs", "4", "--nk",
                    "8", "--steps", "2", "--warmup", "1"])
        line = capsys.readouterr().out.strip().splitlines()[-1]
        rec = json.loads(line)
        assert set(rec) == {"metric", "value", "unit", "points_per_sec",
                            "cd_evals_per_sec_96x96", "emd_evals_per_sec_b16",
                            "emd_metric_solves_per_sec", "device"}
        assert rec["unit"] == "steps/s" and rec["device"] == "cpu"
        assert rec["value"] > 0
