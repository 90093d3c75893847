"""The training loop, the port of `sp_gan_tpu/train/trainer.py`: dataset
choice, the epoch loop over a numpy permutation, meters and
`log_train.txt`, throughput lines, snapshots every `cfg.snapshot` epochs,
`--restore` from the newest checkpoint of `log_dir`, and `generate`.
`time_steps` runs and times steps on the same batches for the benchmark
(`sp_gan_tpu_torch.bench`) and chip_smoke.py.

The dataset lives on the device; each step gathers its batch there and
shuffles every cloud's points with the trainer's `torch.Generator` (the JAX
package's on-device data path). Not ported yet: in-loop evaluation and
FPD (`eval_every`), `track_best`, the watchdog, warm start from named
checkpoints (`--pretrain_model_G`), sample dumps (`--save`), augmentation
(`--augment`) and the source snapshot.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data import H5Dataset, SyntheticDataset, sample_z
from sp_gan_tpu_torch.data.sphere import sphere_template
from sp_gan_tpu_torch.device import resolve_device
from sp_gan_tpu_torch.train.checkpoint import (latest_checkpoint,
                                               load_checkpoint,
                                               save_checkpoint)
from sp_gan_tpu_torch.train.state import create_train_state, param_count
from sp_gan_tpu_torch.train.step import make_sample_fn, make_train_step
from sp_gan_tpu_torch.utils import AverageValueMeter, StepTimer

METRICS = ("d_loss", "g_loss", "real_acc", "fake_acc")


def synthetic_dataset(cfg: Config) -> SyntheticDataset:
    """The trainer's data when no ShapeNet h5 files are found."""
    return SyntheticDataset(n_items=max(240, cfg.bs * 8), n_points=cfg.np)


class Trainer:
    """Trains on `device` (default cuda; raises without a GPU unless given
    device="cpu"). With `logs=False` it writes nothing under `log_dir` and
    prints nothing (a benchmark's run)."""

    def __init__(self, cfg: Config, dataset=None, device=None,
                 logs: bool = True):
        for flag in ("augment", "save"):
            if getattr(cfg, flag):
                raise NotImplementedError(f"--{flag} is not ported yet")
        if cfg.eval_every:
            raise NotImplementedError("in-loop evaluation (--eval_every) is "
                                      "not ported yet")
        if cfg.restore and cfg.pretrain_model_G:
            raise NotImplementedError("warm start from --pretrain_model_G "
                                      "is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._log_fout = None
        if logs:
            os.makedirs(cfg.log_dir, exist_ok=True)
            self._log_fout = open(os.path.join(cfg.log_dir, "log_train.txt"),
                                  "a" if cfg.restore else "w")
            with open(os.path.join(cfg.log_dir, "args.txt"), "w") as f:
                f.write(cfg.to_json())

        if dataset is not None:
            self.dataset = dataset
        else:
            try:
                self.dataset = H5Dataset(cfg.data_root, cfg.choice, cfg.np,
                                         cfg.scale, cls=cfg.cls, con=cfg.con)
            except OSError as e:       # FileNotFoundError, or no h5py
                self.log(f"H5 data unavailable ({e}); using synthetic data")
                self.dataset = synthetic_dataset(cfg)
        self.steps_per_epoch = cfg.steps_per_epoch or max(
            1, len(self.dataset) // cfg.bs)
        self.data = torch.as_tensor(np.asarray(self.dataset.data, np.float32),
                                    device=self.device)

        self.sphere = sphere_template(cfg.np, cfg.template)
        self.state = create_train_state(cfg, self.steps_per_epoch,
                                        self.device)
        self.log(f"# generator parameters: {param_count(self.state.G)}")
        self.log(f"# discriminator parameters: {param_count(self.state.D)}")
        self.train_step = make_train_step(cfg, self.sphere)
        self.sample_fn = make_sample_fn(cfg, self.sphere, use_ema=cfg.ema)
        self.start_epoch = 1
        if cfg.restore:
            path = latest_checkpoint(cfg.log_dir)
            if path:
                epoch = load_checkpoint(path, self.state)
                self.start_epoch = epoch + 1
                self.log(f"[*] restored {path} (epoch {epoch})")

    def log(self, msg: str) -> None:
        if self._log_fout is None:
            return
        self._log_fout.write(msg + "\n")
        self._log_fout.flush()
        print(msg, flush=True)

    def close(self) -> None:
        if self._log_fout is not None:
            self._log_fout.close()

    def batch(self, idx: np.ndarray, gen: torch.Generator) -> torch.Tensor:
        """The clouds `idx` [bs], each with its points in a random order."""
        real = self.data[torch.as_tensor(idx, device=self.device)]
        B, N, _ = real.shape
        perm = torch.rand(B, N, generator=gen, device=self.device).argsort(1)
        return torch.gather(real, 1, perm[..., None].expand(B, N, 3))

    def _epochs(self):
        """Endless epochs, each an iterator over its batches: a numpy
        permutation of the dataset (seeded by `cfg.seed`) cut to
        `steps_per_epoch` batches, each cloud's points shuffled by a
        `torch.Generator` seeded by `cfg.seed + 3`."""
        cfg = self.cfg
        rng_np = np.random.default_rng(cfg.seed)
        shuffle = torch.Generator(device=self.device).manual_seed(cfg.seed + 3)
        while True:
            order = rng_np.permutation(len(self.dataset))
            n_steps = min(len(order) // cfg.bs, self.steps_per_epoch)
            yield (self.batch(order[s * cfg.bs:(s + 1) * cfg.bs], shuffle)
                   for s in range(n_steps))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time_steps(self, steps: int, warmup: int = 0,
                   before: Optional[Callable[[], None]] = None) -> dict:
        """Runs `warmup`, then `steps` training steps on the batches
        `train` draws, and times the latter on the host clock with the
        device synchronized at both ends; `before()` runs right before
        them. Returns ms_per_step, steps_per_sec, points_per_sec and
        `metrics`, each step's metrics as floats."""
        batches = itertools.chain.from_iterable(self._epochs())
        metrics = []
        for i in range(warmup + steps):
            if i == warmup:
                self._sync()
                if before is not None:
                    before()
                t0 = time.perf_counter()
            self.state, m = self.train_step(self.state, next(batches))
            metrics.append(m)                  # read after the clock stops
        self._sync()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        return {"ms_per_step": ms, "steps_per_sec": 1e3 / ms,
                "points_per_sec": 1e3 / ms * self.cfg.bs * self.cfg.np,
                "metrics": [{k: float(v) for k, v in m.items()}
                            for m in metrics]}

    def train(self, max_epoch: Optional[int] = None):
        """Runs epochs `start_epoch..max_epoch` and writes the final
        checkpoint; returns the state."""
        cfg = self.cfg
        max_epoch = max_epoch or cfg.max_epoch
        epochs = self._epochs()
        meters = {k: AverageValueMeter() for k in METRICS}
        timer = StepTimer(points_per_step=cfg.bs * cfg.np, window=50)
        t_start = time.time()
        for epoch in range(self.start_epoch, max_epoch + 1):
            for m in meters.values():
                m.reset()
            metrics = None
            for real in next(epochs):
                self.state, metrics = self.train_step(self.state, real)
                rate = timer.tick()
                if rate:
                    self.log("throughput: %.2f steps/s, %.0f pts/s, "
                             "%.1f ms/step" % (rate["steps_per_sec"],
                                               rate["points_per_sec"],
                                               rate["ms_per_step"]))
                if self.state.step % cfg.log_every == 0:
                    for k in METRICS:
                        meters[k].update(float(metrics[k]))
            if meters["d_loss"].count == 0 and metrics is not None:
                # an epoch shorter than log_every: report its last step
                for k in METRICS:
                    meters[k].update(float(metrics[k]))
            dt = time.time() - t_start
            self.log("Epoch: [%2d] time: %2dm %2ds d_loss: %.8f, "
                     "g_loss: %.8f" % (epoch, dt / 60, dt % 60,
                                       meters["d_loss"].avg,
                                       meters["g_loss"].avg))
            self.log("real_acc: %f  fake_acc: %f"
                     % (meters["real_acc"].avg, meters["fake_acc"].avg))
            if epoch % cfg.snapshot == 0:
                save_checkpoint(cfg.log_dir, self.state, epoch, cfg)
        save_checkpoint(cfg.log_dir, self.state, max_epoch, cfg)
        return self.state

    def generate(self, n: int, seed: int = 0, batch: int = 64) -> np.ndarray:
        """n clouds [n, N, 3] in eval mode (EMA weights with `--ema`), from
        codes drawn by a generator seeded with `seed`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        outs = []
        for lo in range(0, n, batch):
            z = sample_z(gen, min(batch, n - lo), self.cfg.np, self.cfg.nz,
                         self.cfg.nv, self.cfg.n_rand)
            outs.append(self.sample_fn(self.state, z).cpu().numpy())
        return np.concatenate(outs, axis=0)
