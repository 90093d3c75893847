"""Benchmark of the port: G+D training steps per second at the reference's
default configuration (bs=24, N=2048, `Config()` defaults), the port's
counterpart of the JAX package's `bench.py`.

    python -m sp_gan_tpu_torch.bench [--steps 20] [--warmup 3]

Times `Trainer.time_steps` on the trainer's synthetic data, with weights
drawn from `--seed`. Prints ONE JSON line: {"metric", "value", "unit",
"points_per_sec", "device"}. Runs on the GPU (raises without one) unless
given `--device cpu` with smaller `--np`/`--bs`/`--nk`. The JAX package's
CD/EMD throughput fields wait for the metric slice, and no baseline is
read: `bench_baseline.json` is a TPU number.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--np", type=int, default=2048)
    p.add_argument("--bs", type=int, default=24)
    p.add_argument("--nk", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    import torch

    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.train.trainer import Trainer, synthetic_dataset

    cfg = Config(np=args.np, bs=args.bs, nk=args.nk, seed=args.seed)
    tr = Trainer(cfg, dataset=synthetic_dataset(cfg), device=args.device,
                 logs=False)
    r = tr.time_steps(args.steps, args.warmup)
    dev = tr.device
    print(json.dumps({
        "metric": f"G+D train steps/sec (bs={cfg.bs}, {cfg.np} pts)",
        "value": round(r["steps_per_sec"], 3),
        "unit": "steps/s",
        "points_per_sec": round(r["points_per_sec"]),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }))


if __name__ == "__main__":
    main()
