"""CLI: train SP-GAN with the PyTorch port, on the GPU by default.

    python -m sp_gan_tpu_torch.train --choice Chair --bs 24 --np 2048 \\
        --data_root data
    python -m sp_gan_tpu_torch.train --device cpu --np 256 --bs 4 --nk 8 \\
        --max_epoch 2 --log_dir /tmp/run

Every flag of the JAX package's `train.py` is accepted (`--help`); the
JAX-only ones have no effect. Without ShapeNet files under `--data_root`
(or without h5py) the trainer logs that and trains on synthetic shapes.
"""

from __future__ import annotations

import dataclasses
import os
import time


def main(argv=None) -> None:
    from sp_gan_tpu_torch.config import build_argparser, config_from_namespace
    p = build_argparser()
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    cfg = config_from_namespace(args)
    if cfg.log_dir == "log":        # timestamped, like the JAX CLI
        stamp = time.strftime("%Y%m%d-%H%M")
        cfg = dataclasses.replace(
            cfg, log_dir=os.path.join("log", f"{stamp}-{cfg.choice}"))
    from sp_gan_tpu_torch.train.trainer import Trainer
    trainer = Trainer(cfg, device=args.device)
    try:
        trainer.train()
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
