"""The training loop, the port of `sp_gan_tpu/train/trainer.py`: dataset
choice, the epoch loop over a numpy permutation, meters and
`log_train.txt`, throughput lines, snapshots every `cfg.snapshot` epochs,
`--restore` from the newest checkpoint of `log_dir` or, with
`--pretrain_model_G` (and `--pretrain_model_D`), a warm start from named
files (reference `.pth` or this project's `.pkl`), and `generate`.
`time_steps` runs and times steps on the same batches for the benchmark
(`sp_gan_tpu_torch.bench`) and chip_smoke.py. `--eval_every` runs
`evaluate`, the in-loop metric protocol (`eval.jsonl`, and `ckpt_best.pkl`
with `best.json` under `track_best`).

The dataset lives on the device; each step gathers its batch there and
shuffles every cloud's points with the trainer's `torch.Generator` (the JAX
package's on-device data path). Not ported yet: the watchdog, sample dumps
(`--save`), augmentation (`--augment`) and the source snapshot.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from sp_gan_tpu_torch.compat import load_reference_checkpoint, state_from_jax
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data import H5Dataset, SyntheticDataset, sample_z
from sp_gan_tpu_torch.data.sphere import sphere_template
from sp_gan_tpu_torch.device import resolve_device
from sp_gan_tpu_torch.eval.fpd import (activation_statistics,
                                       fpd_from_weights, frechet_distance,
                                       load_stats)
from sp_gan_tpu_torch.eval.metrics import (coverage, jsd, knn_two_sample, mmd,
                                           pairwise_cd_matrix,
                                           pairwise_emd_matrix)
from sp_gan_tpu_torch.manipulate import normalize_point_cloud
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
        self.sample_raw = (make_sample_fn(cfg, self.sphere, use_ema=False)
                           if cfg.ema else self.sample_fn)
        self.start_epoch = 1
        if cfg.restore and cfg.pretrain_model_G:
            # --restore with named files warm-starts from them
            self.start_epoch = self._warm_start(cfg.pretrain_model_G,
                                                cfg.pretrain_model_D) + 1
        elif cfg.restore:
            path = latest_checkpoint(cfg.log_dir)
            if path:
                epoch = load_checkpoint(path, self.state)
                self.start_epoch = epoch + 1
                self.log(f"[*] restored {path} (epoch {epoch})")
        # the best in-loop MMD-CD so far; best.json carries it across runs
        self._best = {"value": float("inf")}
        best_path = os.path.join(cfg.log_dir, "best.json")
        if cfg.restore and os.path.exists(best_path):
            with open(best_path) as f:
                self._best = json.load(f)
            self.log(f"[*] best-so-far {self._best.get('metric', 'MMD-CD')}="
                     f"{self._best['value']:.5f} "
                     f"(epoch {self._best.get('epoch')})")
        # in-loop evaluation state, made on the first `evaluate`
        self._eval_ref = self._eval_tt = self._eval_tt_emd = None
        self._fpd = self._fpd_ref_stats = None

    def _warm_start(self, g_path: str, d_path: Optional[str] = None) -> int:
        """`--restore --pretrain_model_G <f> [--pretrain_model_D <f>]`:
        loads named files instead of the newest snapshot and returns their
        epoch. A path that does not exist as given is taken under
        `log_dir`. A `.pth` is a reference checkpoint, read through
        `compat.load_reference_checkpoint` into G (and D), with the Adams'
        state fresh and, with `--ema`, the EMA copy set to the loaded G; any
        other file is a checkpoint of this project (`load_checkpoint`: the
        whole state)."""
        cfg = self.cfg

        def resolve(p):
            under = os.path.join(cfg.log_dir, p) if p else p
            if p and not os.path.exists(p) and os.path.exists(under):
                return under
            return p

        g_path, d_path = resolve(g_path), resolve(d_path)
        if not g_path.endswith(".pth"):
            epoch = load_checkpoint(g_path, self.state)
            self.log(f"[*] restored {g_path} (epoch {epoch})")
            return epoch
        (g_params, g_stats), d, epoch = load_reference_checkpoint(
            g_path, cfg, d_path)
        st = self.state
        st.G.load_state_dict(state_from_jax(g_params, g_stats), strict=True)
        if d is not None:
            st.D.load_state_dict(state_from_jax(*d), strict=True)
        if st.g_ema is not None:
            st.g_ema.load_state_dict(st.G.state_dict())
        self.log(f"[*] warm-start from reference checkpoint {g_path}"
                 + (f" + {d_path}" if d_path else "") + f" (epoch {epoch})")
        return epoch

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
            if cfg.eval_every and epoch % cfg.eval_every == 0:
                self.evaluate(epoch, self.state.step)
            if epoch % cfg.snapshot == 0:
                save_checkpoint(cfg.log_dir, self.state, epoch, cfg)
        save_checkpoint(cfg.log_dir, self.state, max_epoch, cfg)
        return self.state

    def eval_reference(self) -> torch.Tensor:
        """The in-loop reference: `eval_size` training clouds drawn with
        `np.random.default_rng(seed + 999)`, each normalized to radius 1;
        drawn once, with their CD matrix."""
        if self._eval_ref is None:
            cfg = self.cfg
            n = min(cfg.eval_size, len(self.dataset))
            rng = np.random.default_rng(cfg.seed + 999)
            idx = np.sort(rng.choice(len(self.dataset), n, replace=False))
            ref = torch.as_tensor(np.asarray(self.dataset.data[idx],
                                             np.float32), device=self.device)
            self._eval_ref = normalize_point_cloud(ref)
            self._eval_tt = pairwise_cd_matrix(self._eval_ref,
                                               self._eval_ref)
        return self._eval_ref

    def eval_metrics(self, gen: torch.Tensor) -> dict:
        """MMD-CD, COV-CD, 1NN-CD and JSD (0.5-scaled clouds) of normalized
        clouds `gen` against the in-loop reference; FPD with
        `--fpd_weights`, the EMD columns (the training regime, eps 0.005
        and 50 block-round sweeps: kernel E on CUDA) with `--eval_emd`."""
        cfg = self.cfg
        ref = self.eval_reference()
        gg = pairwise_cd_matrix(gen, gen)
        gt = pairwise_cd_matrix(gen, ref)
        m = {"MMD-CD": mmd(gt), "COV-CD": coverage(gt),
             "1NN-CD": knn_two_sample(gg, gt, self._eval_tt),
             "JSD": jsd(0.5 * gen, 0.5 * ref, warn=False)}
        if cfg.fpd_weights:
            # the FPD column is monitoring: a degenerate sqrtm (few samples,
            # a high-dimensional covariance) must not end the run
            try:
                m["FPD"] = self._inloop_fpd(gen)
            except Exception as e:  # noqa: BLE001
                self.log(f"[eval] in-loop FPD failed: {e!r}")
                m["FPD"] = float("nan")
        if cfg.eval_emd:
            if self._eval_tt_emd is None:
                self._eval_tt_emd = pairwise_emd_matrix(ref, ref)
            gg_e = pairwise_emd_matrix(gen, gen)
            gt_e = pairwise_emd_matrix(gen, ref)
            m.update({"MMD-EMD": mmd(gt_e), "COV-EMD": coverage(gt_e),
                      "1NN-EMD": knn_two_sample(gg_e, gt_e,
                                                self._eval_tt_emd)})
        return m

    def _inloop_fpd(self, gen: torch.Tensor) -> float:
        """FPD of normalized clouds through the extractor of
        `--fpd_weights`, against `--fpd_stats` or the in-loop reference."""
        if self._fpd is None:
            self._fpd = fpd_from_weights(self.cfg.fpd_weights, self.device)
            self._fpd_ref_stats = (
                load_stats(self.cfg.fpd_stats) if self.cfg.fpd_stats
                else activation_statistics(
                    self._fpd.activations(self.eval_reference())))
        mu1, s1 = activation_statistics(self._fpd.activations(gen))
        return frechet_distance(mu1, s1, *self._fpd_ref_stats)

    def evaluate(self, epoch: int, global_step: int) -> dict:
        """In-loop evaluation: `eval_size` clouds generated from codes of a
        `torch.Generator` seeded with `seed + 777` (32 at a time), for the
        raw and, with `--ema`, the EMA weights, each normalized and scored
        by `eval_metrics`. Appends the record to `log_dir/eval.jsonl`;
        with `track_best`, a lower MMD-CD (EMA, else raw) rewrites
        `ckpt_best.pkl` and `best.json`."""
        cfg = self.cfg
        n = self.eval_reference().shape[0]
        record = {"epoch": epoch, "step": int(global_step), "jsd_scale": 0.5}
        variants = ([("ema", self.sample_fn), ("raw", self.sample_raw)]
                    if cfg.ema else [("raw", self.sample_fn)])
        for name, fn in variants:
            gen = torch.Generator(device=self.device).manual_seed(
                cfg.seed + 777)
            outs = [fn(self.state, sample_z(gen, min(32, n - lo), cfg.np,
                                            cfg.nz, cfg.nv, cfg.n_rand))
                    for lo in range(0, n, 32)]
            m = self.eval_metrics(normalize_point_cloud(torch.cat(outs)[:n]))
            record[name] = m
            self.log("EVAL epoch=%d step=%d [%s] " % (epoch, global_step, name)
                     + " ".join(f"{k}={v:.5f}" for k, v in m.items()))
        if self._log_fout is not None:
            with open(os.path.join(cfg.log_dir, "eval.jsonl"), "a") as f:
                f.write(json.dumps(record) + "\n")
        if cfg.track_best:
            variant = "ema" if cfg.ema else "raw"
            v = float(record[variant]["MMD-CD"])
            if v < self._best.get("value", float("inf")):
                self._best = {"metric": "MMD-CD", "variant": variant,
                              "value": v, "epoch": epoch,
                              "step": int(global_step)}
                if self._log_fout is not None:
                    save_checkpoint(cfg.log_dir, self.state, epoch, cfg,
                                    filename="ckpt_best.pkl")
                    tmp = os.path.join(cfg.log_dir, "best.json.tmp")
                    with open(tmp, "w") as f:
                        json.dump(self._best, f)
                    os.replace(tmp, os.path.join(cfg.log_dir, "best.json"))
                self.log(f"[best] new best {variant} MMD-CD={v:.5f} "
                         f"-> ckpt_best.pkl (epoch {epoch})")
        return record

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
