"""CLI: export a checkpoint of this project (`.pkl`, written by either
package) as reference-format PyTorch `.pth` files, with no JAX import. The
outputs load into the reference's `Generation/Generator.py` and
`Discriminator.py` modules with `load_state_dict(strict=True)`; the port's
trainer warm-starts from them (`--restore --pretrain_model_G G.pth`).

    python -m sp_gan_tpu_torch.export_torch --log_dir runs/run --ema --out G.pth
    python -m sp_gan_tpu_torch.export_torch --log_dir runs/run \\
        --out G.pth --out_d D.pth

A file conversion: it reads numpy trees and writes CPU tensors, on no
device.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="export a checkpoint as reference-format .pth files")
    p.add_argument("--log_dir", required=True)
    p.add_argument("--ckpt", default=None, help="explicit .pkl path "
                   "(default: latest in log_dir)")
    p.add_argument("--ema", action="store_true",
                   help="export the EMA generator weights")
    p.add_argument("--out", default="G.pth")
    p.add_argument("--out_d", default=None,
                   help="also export the discriminator to this path")
    args = p.parse_args(argv)

    from sp_gan_tpu_torch.compat import save_reference_checkpoint
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                   read_checkpoint)

    with open(os.path.join(args.log_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    ckpt = args.ckpt or latest_checkpoint(args.log_dir)
    if not ckpt:
        raise SystemExit(f"no checkpoint in {args.log_dir}")
    state, epoch = read_checkpoint(ckpt)
    g_params = state["g_params"]
    if args.ema:
        if state.get("g_ema") is None:
            raise SystemExit(f"{ckpt} holds no EMA weights "
                             "(trained without --ema)")
        g_params = state["g_ema"]
    save_reference_checkpoint(
        args.out, g_params, state["g_stats"], cfg, epoch=epoch,
        d_path=args.out_d,
        d_params=state["d_params"] if args.out_d else None,
        d_stats=state["d_stats"] if args.out_d else None)
    print(f"exported {ckpt} (epoch {epoch}"
          f"{', EMA' if args.ema else ''}) -> {args.out}"
          + (f" + {args.out_d}" if args.out_d else ""))


if __name__ == "__main__":
    main()
