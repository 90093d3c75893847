"""CLI: generate shapes from a checkpoint to .npy, on the GPU by default.

    python -m sp_gan_tpu_torch.generate --log_dir runs/campaign_horizon \\
        --ckpt runs/keep/campaign_horizon_best.pkl --n 128 --out samples.npy

`--log_dir` holds the run's `config.json` (and, without `--ckpt`, its
`ckpt_epoch_*.pkl`). `--device cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--log_dir", required=True)
    p.add_argument("--ckpt", default=None, help="explicit checkpoint path")
    p.add_argument("--ema", action="store_true",
                   help="use the checkpoint's EMA generator weights")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="samples.npy")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.manipulate import from_checkpoint
    from sp_gan_tpu_torch.train.checkpoint import latest_checkpoint

    with open(os.path.join(args.log_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    ckpt = args.ckpt or latest_checkpoint(args.log_dir)
    if not ckpt:
        raise SystemExit(f"no checkpoint in {args.log_dir}")
    man = from_checkpoint(ckpt, cfg, use_ema=args.ema, device=args.device)
    pcs = man.generate(args.n, seed=args.seed)
    np.save(args.out, pcs)
    print(f"saved {pcs.shape} -> {args.out}")


if __name__ == "__main__":
    main()
