"""The trainer's remaining parts in the PyTorch port, on the CPU: the native
host gather (`sp_gan_tpu_torch/native`) and `epoch_batches` against the
JAX package's, bit for bit; the augmentations' pure functions fed the JAX
package's own draws; the watchdog; tracing; and the Trainer with
`--augment`, `--save`, `--watchdog_secs`, the source snapshot and the
streaming path above the device-data line (monkeypatched down to a few KB).
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_gan_tpu import native as jnative
from sp_gan_tpu.data import augment as jaug
from sp_gan_tpu.data import h5 as jh5
from sp_gan_tpu_torch import native
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data import augment as aug
from sp_gan_tpu_torch.data import h5
from sp_gan_tpu_torch.data.prefetch import prefetch_to_device
from sp_gan_tpu_torch.train import trainer as trainer_mod
from sp_gan_tpu_torch.train.trainer import Trainer
from sp_gan_tpu_torch.utils import Watchdog, annotate, trace
from sp_gan_tpu_torch.viz.io import load_xyz

torch.set_num_threads(2)   # six test workers share the host's cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(np=32, bs=4, nk=8, nz=16)


def tiny_dataset(n_items: int = 12):
    return h5.SyntheticDataset(n_items=n_items, n_points=TINY["np"])


def assemble_batch_plain(data: np.ndarray, idx: np.ndarray,
                         seed: int) -> np.ndarray:
    """numpy version of `native.assemble_batch`: the same clouds, each
    shuffled by `np.random.default_rng(seed)` (other permutations than the
    C++ xorshift's)."""
    rng = np.random.default_rng(seed)
    return np.stack([data[j][rng.permutation(data.shape[1])] for j in idx])


# ------------------------------------------------------------------ native
class TestNative:
    def test_assemble_batch_equals_jax(self):
        assert jnative._load() is not None, "the JAX package's g++ build"
        data = h5.SyntheticDataset(n_items=20, n_points=300, seed=1).data
        for idx, seed in (([3, 0, 19, 7, 7, 11], 5), ([2], 0),
                          (list(range(20)), 2 ** 63 - 1)):
            idx = np.asarray(idx, np.int64)
            got = native.assemble_batch(data, idx, seed)
            assert got.tobytes() == jnative.assemble_batch(data, idx,
                                                           seed).tobytes()
            # each cloud is its source's points in another order; the numpy
            # version draws other orders of the same clouds
            plain = assemble_batch_plain(data, idx, seed)
            for a, b, j in zip(got, plain, idx):
                for pc in (a, b):
                    np.testing.assert_array_equal(
                        np.unique(pc, axis=0), np.unique(data[j], axis=0))

    def test_assemble_batch_checks_idx(self):
        data = np.zeros((4, 8, 3), np.float32)
        with pytest.raises(IndexError):
            native.assemble_batch(data, np.array([4]), 1)
        with pytest.raises(ValueError):
            native.assemble_batch(data[..., :2], np.array([0]), 1)

    def test_epoch_batches_equal_jax(self):
        ours = h5.SyntheticDataset(n_items=22, n_points=64, seed=3)
        ref = jh5.SyntheticDataset(n_items=22, n_points=64, seed=3)
        r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
        for _ in range(2):                       # two epochs, one rng
            a = list(ours.epoch_batches(r1, 5))
            b = list(ref.epoch_batches(r2, 5))
            assert len(a) == len(b) == 4
            for x, y in zip(a, b):
                assert x.tobytes() == y.tobytes()
        assert r1.integers(1 << 30) == r2.integers(1 << 30)

    def test_xyz_round_trip(self, tmp_path):
        rng = np.random.default_rng(0)
        pc = rng.standard_normal((257, 3)).astype(np.float32)
        path = str(tmp_path / "a.xyz")
        assert native.save_xyz_fast(path, pc) == 257
        back = native.parse_xyz(path)
        np.testing.assert_allclose(back, pc, atol=5e-7)
        np.testing.assert_array_equal(
            back, np.loadtxt(path, ndmin=2).astype(np.float32))
        np.testing.assert_array_equal(native.parse_xyz(path, max_rows=10),
                                      back[:10])
        with pytest.raises(FileNotFoundError):
            native.parse_xyz(str(tmp_path / "missing.xyz"))

    @pytest.mark.parametrize("cols", [3, 6])
    def test_load_xyz_reads_as_before(self, tmp_path, cols):
        rng = np.random.default_rng(cols)
        pc = rng.uniform(-1, 1, (100, cols))
        path = str(tmp_path / "b.xyz")
        np.savetxt(path, pc, fmt="%.6f")
        got = load_xyz(path)
        assert got.dtype == np.float32 and got.shape == (100, cols)
        np.testing.assert_array_equal(
            got, np.loadtxt(path, ndmin=2).astype(np.float32))

    @pytest.mark.parametrize("text", [
        "x y z\n1 2 3\n4 5 6\n",          # a header row
        "1 2 3\n4 5\n7 8 9\n",            # a short row
        "1 2 3\n4 5 6 7\n",                # a long row
        "1 2 3\n4 nan? 6\n7 8 9\n",       # an unparsable field
        "1 2 3\n4 5 6\n7 8",               # a truncated last row
    ])
    def test_load_xyz_raises_on_a_malformed_file(self, tmp_path, text):
        from sp_gan_tpu_torch.data import sphere
        path = tmp_path / "bad.xyz"
        path.write_text(text)
        with pytest.raises(ValueError):
            np.loadtxt(str(path), ndmin=2)
        with pytest.raises(ValueError, match="not a table"):
            load_xyz(str(path))
        with pytest.raises(ValueError, match="not a table"):
            sphere.sphere_template(2, str(path))

    def test_template_reads_as_jax(self, tmp_path):
        from sp_gan_tpu.data import sphere as jsphere
        from sp_gan_tpu_torch.data import sphere
        path = str(tmp_path / "ball.xyz")
        np.savetxt(path, np.random.default_rng(2).standard_normal((300, 6)))
        assert sphere.sphere_template(256, path).tobytes() == \
            jsphere.sphere_template(256, path).tobytes()

    def test_builds_into_the_build_directory(self):
        path = native.build()
        assert path.parent == native.BUILD_DIR
        assert str(native.BUILD_DIR).startswith(os.path.join(ROOT, "build"))
        assert not [f for f in os.listdir(os.path.dirname(native.SRC))
                    if f.endswith(".so")]


# ----------------------------------------------------------------- augment
def cloud(seed=0, B=3, N=50):
    return np.random.default_rng(seed).standard_normal(
        (B, N, 3)).astype(np.float32)


def tt(a) -> torch.Tensor:
    """A tensor of its own from a numpy or JAX array."""
    return torch.tensor(np.asarray(a))


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=1e-6)


class TestAugment:
    key = jax.random.PRNGKey(7)

    def test_normalize(self):
        pc = 3.0 * cloud() + 1.0
        close(aug.normalize_point_cloud(torch.from_numpy(pc)),
              jaug.normalize_point_cloud(pc))

    def test_rotate_y(self):
        pc = cloud()
        angles = jax.random.uniform(self.key, (3,), minval=0.0,
                                    maxval=2.0 * jnp.pi)
        close(aug.rotate_y(torch.from_numpy(pc), tt(angles)),
              jaug.rotate_y_batch(self.key, pc))

    def test_scale(self):
        pc = cloud()
        s = jax.random.uniform(self.key, (3, 1, 1), minval=0.8, maxval=1.25)
        close(aug.scale(torch.from_numpy(pc), tt(s)),
              jaug.scale_batch(self.key, pc))

    def test_augment_splits_the_key_as_jax(self):
        pc = cloud(1)
        k1, k2 = jax.random.split(self.key)
        angles = jax.random.uniform(k1, (3,), minval=0.0,
                                    maxval=2.0 * jnp.pi)
        s = jax.random.uniform(k2, (3, 1, 1), minval=0.8, maxval=1.25)
        close(aug.augment(torch.from_numpy(pc), tt(angles), tt(s)),
              jaug.augment_batch(self.key, pc, True))

    def test_shuffle_points(self):
        pc = cloud(2)
        perm = np.stack([np.asarray(jax.random.permutation(k, pc.shape[1]))
                         for k in jax.random.split(self.key, pc.shape[0])])
        close(aug.shuffle_points(torch.from_numpy(pc), tt(perm).long()),
              jaug.shuffle_points_batch(self.key, pc))

    def test_jitter(self):
        pc = cloud(3)
        normal = jax.random.normal(self.key, pc.shape)
        close(aug.jitter(torch.from_numpy(pc), tt(normal)),
              jaug.jitter_batch(self.key, pc))

    def test_translate(self):
        pc = cloud(4)
        t = jax.random.uniform(self.key, (3, 1, 3), minval=-0.1, maxval=0.1)
        close(aug.translate(torch.from_numpy(pc), tt(t)),
              jaug.translate_batch(self.key, pc))

    def test_rotate_perturbation(self):
        pc = cloud(5)
        ang = jnp.clip(0.06 * jax.random.normal(self.key, (3, 3)),
                       -0.18, 0.18)
        close(aug.rotate_perturbation(torch.from_numpy(pc), tt(ang)),
              jaug.rotate_perturbation_batch(self.key, pc))

    def test_point_dropout(self):
        pc = cloud(6)
        kr, ku = jax.random.split(self.key)
        ratio = jax.random.uniform(kr, (3, 1)) * 0.875
        drop = jax.random.uniform(ku, (3, pc.shape[1])) <= ratio
        close(aug.point_dropout(torch.from_numpy(pc), tt(drop)),
              jaug.random_point_dropout(self.key, pc))

    def test_wrappers_draw_from_their_generator(self):
        pc = torch.from_numpy(cloud(8))
        norms = pc.norm(dim=-1)
        for fn in (aug.rotate_y_batch, aug.scale_batch, aug.augment_batch,
                   aug.shuffle_points_batch, aug.jitter_batch,
                   aug.translate_batch, aug.rotate_perturbation_batch,
                   aug.random_point_dropout):
            a = fn(torch.Generator().manual_seed(1), pc)
            assert torch.equal(a, fn(torch.Generator().manual_seed(1), pc))
            assert a.shape == pc.shape and not torch.equal(a, pc)
        rot = aug.rotate_y_batch(torch.Generator().manual_seed(2), pc)
        torch.testing.assert_close(rot.norm(dim=-1), norms)
        ratio = aug.scale_batch(torch.Generator().manual_seed(3), pc) \
            .norm(dim=-1) / norms
        assert ((ratio >= 0.8 - 1e-6) & (ratio <= 1.25 + 1e-6)).all()
        assert aug.augment_batch(torch.Generator(), pc, False) is pc


# --------------------------------------------------------- watchdog, trace
class TestWatchdog:
    def test_fires_when_stale(self):
        fired = []
        dog = Watchdog(0.2, on_timeout=fired.append, poll_s=0.05).start()
        time.sleep(0.6)
        assert dog.fired
        assert len(fired) == 1 and fired[0] > 0.2
        dog.stop()

    def test_beats_keep_it_alive(self):
        fired = []
        dog = Watchdog(0.3, on_timeout=fired.append, poll_s=0.05).start()
        for _ in range(6):
            time.sleep(0.1)
            dog.beat()
        assert not dog.fired and not fired
        dog.stop()
        time.sleep(0.3)
        assert not dog.fired

    def test_fires_once(self):
        fired = []
        dog = Watchdog(0.1, on_timeout=fired.append, poll_s=0.03).start()
        time.sleep(0.5)
        assert len(fired) == 1
        dog.stop()

    def test_default_action_exits_42(self):
        code = textwrap.dedent("""
            import time
            from sp_gan_tpu_torch.utils.watchdog import Watchdog
            Watchdog(0.3, poll_s=0.05).start()
            time.sleep(30)
        """)
        run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=60)
        assert run.returncode == 42
        assert "[watchdog]" in run.stdout


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        with annotate("spgan_marker"):
            torch.ones(8).sum()
    (path,) = tmp_path.iterdir()
    assert "spgan_marker" in path.read_text()
    assert "traceEvents" in json.loads(path.read_text())


def test_prefetch_on_the_cpu_yields_in_order():
    batches = [np.full((2, 3, 3), i, np.float32) for i in range(5)]
    got = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert [int(b[0, 0, 0]) for b in got] == list(range(5))
    assert all(b.dtype == torch.float32 for b in got)


# ----------------------------------------------------------------- trainer
def test_trainer_completes_with_watchdog(tmp_path):
    cfg = Config(**TINY, max_epoch=1, steps_per_epoch=2, snapshot=1,
                 log_dir=str(tmp_path), watchdog_secs=120)
    tr = Trainer(cfg, dataset=tiny_dataset(), device="cpu")
    assert tr._dog is not None and not tr._dog.fired
    tr.train()
    assert (tmp_path / "ckpt_epoch_1.pkl").exists()
    assert tr._dog._stop.is_set() and not tr._dog.fired
    tr.close()


def test_dropped_trainer_stops_its_watchdog(tmp_path):
    """A trainer collected without close() leaves no armed watchdog."""
    import gc
    cfg = Config(**TINY, log_dir=str(tmp_path), watchdog_secs=120)
    tr = Trainer(cfg, dataset=tiny_dataset(), device="cpu", logs=False)
    dog = tr._dog
    tr.time_steps(1)
    del tr
    gc.collect()
    assert dog._stop.is_set() and not dog.fired


class TestStreaming:
    def test_batches_are_epoch_batches(self, tmp_path, monkeypatch):
        ds = tiny_dataset()
        monkeypatch.setattr(trainer_mod, "DEVICE_DATA_BYTES",
                            ds.data.nbytes - 1)
        cfg = Config(**TINY, steps_per_epoch=2, seed=5,
                     log_dir=str(tmp_path))
        tr = Trainer(cfg, dataset=ds, device="cpu", logs=False)
        assert tr.data is None
        seen = []
        step = tr.train_step

        def spy(state, real):
            seen.append(real.clone())
            return step(state, real)
        tr.train_step = spy
        tr.time_steps(4)
        # each epoch is cut to steps_per_epoch of epoch_batches
        rng = np.random.default_rng(5)
        want = []
        for _ in range(2):
            gen = ds.epoch_batches(rng, 4)
            want += [next(gen) for _ in range(2)]
            # the prefetcher drew one batch ahead before the cut
            next(gen)
        assert len(seen) == 4
        for a, b in zip(seen, want):
            assert a.numpy().tobytes() == b.tobytes()

    @pytest.mark.parametrize("streaming", [False, True])
    def test_augment_runs_and_logs(self, tmp_path, monkeypatch, streaming):
        ds = tiny_dataset()
        if streaming:
            monkeypatch.setattr(trainer_mod, "DEVICE_DATA_BYTES", 4096)
        cfg = Config(**TINY, max_epoch=2, steps_per_epoch=2, snapshot=2,
                     log_dir=str(tmp_path), augment=True, log_every=1)
        tr = Trainer(cfg, dataset=ds, device="cpu")
        assert (tr.data is None) == streaming
        tr.train()
        tr.close()
        log = (tmp_path / "log_train.txt").read_text()
        assert log.count("Epoch:") == 2 and "nan" not in log
        assert (tmp_path / "ckpt_epoch_2.pkl").exists()

    def test_device_batch_is_shuffled_then_augmented(self, tmp_path):
        cfg = Config(**TINY, augment=True, log_dir=str(tmp_path))
        tr = Trainer(cfg, dataset=tiny_dataset(), device="cpu", logs=False)
        idx = np.array([3, 1, 4, 0])
        got = tr.batch(idx, torch.Generator().manual_seed(11))
        g = torch.Generator().manual_seed(11)
        want = aug.augment_batch(g, aug.shuffle_points_batch(
            g, torch.from_numpy(tr.dataset.data[idx])))
        assert torch.equal(got, want)


class TestSaveAndSnapshot:
    def test_save_writes_grid_and_xyz(self, tmp_path):
        pytest.importorskip("matplotlib")
        cfg = Config(**TINY, save=True, log_dir=str(tmp_path))
        tr = Trainer(cfg, dataset=tiny_dataset(), device="cpu")
        assert tr.fix_z.shape == (64, TINY["np"], TINY["nz"])
        tr.dump_samples(1, 20)
        tr.close()
        assert (tmp_path / "plot" / "20.png").stat().st_size > 0
        xyz = sorted((tmp_path / "plot" / "sample").glob("*/*_step_20.xyz"))
        assert len(xyz) == 64
        pc = load_xyz(str(xyz[0]))
        assert pc.shape == (TINY["np"], 3)
        assert np.abs(np.linalg.norm(pc, axis=1).max() - 0.75) < 1e-5

    def test_save_without_matplotlib_raises_at_once(self, tmp_path,
                                                    monkeypatch):
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        cfg = Config(**TINY, save=True, watchdog_secs=5,
                     log_dir=str(tmp_path / "run"))
        with pytest.raises(RuntimeError, match="matplotlib"):
            Trainer(cfg, dataset=tiny_dataset(), device="cpu")
        assert not (tmp_path / "run").exists()

    def test_snapshot_written_once(self, tmp_path):
        cfg = Config(**TINY, max_epoch=1, steps_per_epoch=1,
                     log_dir=str(tmp_path))
        Trainer(cfg, dataset=tiny_dataset(), device="cpu").close()
        snap = tmp_path / "src_snapshot" / "sp_gan_tpu_torch"
        mine = snap / "train" / "trainer.py"
        assert mine.read_bytes() == open(trainer_mod.__file__, "rb").read()
        assert (snap / "native" / "spgan_native.cpp").exists()
        assert not list(snap.rglob("__pycache__"))
        assert not list(snap.rglob("*.so"))
        mine.write_text("# the code the run started with\n")
        cfg.restore = True
        Trainer(cfg, dataset=tiny_dataset(), device="cpu").close()
        assert mine.read_text() == "# the code the run started with\n"

    def test_no_snapshot_without_logs(self, tmp_path):
        cfg = Config(**TINY, log_dir=str(tmp_path / "run"))
        Trainer(cfg, dataset=tiny_dataset(), device="cpu", logs=False)
        assert not (tmp_path / "run").exists()
