"""CLI: the reference evaluation protocol (JSD, COV-CD, MMD-CD, 1NN-CD,
optional EMD variants and FPD) between generated and reference clouds, on
the GPU by default; the port of the root `evaluate.py`.

    python -m sp_gan_tpu_torch.evaluate --gen samples.npy --ref ref.npy
    python -m sp_gan_tpu_torch.evaluate --log_dir log/run --n 200 \\
        --ref runs/heldout_ref.npy --emd --fpd \\
        --fpd_weights runs/fpd_dgcnn_synth.pkl
    python -m sp_gan_tpu_torch.evaluate --device cpu --gen g.npy --ref r.npy

Prints the JAX CLI's JSON keys. `--device cpu` runs on the CPU (kernel E's
plain version solves the EMD there). `--fpd_weights` takes a flax
variables pickle (a locally trained extractor, noted as such in
`FPD_note`) or the reference's torch DGCNN state dict (no note). The
point-sharded EMD (`--mesh_points`) is not ported.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gen", default=None, help=".npy of generated clouds")
    p.add_argument("--log_dir", default=None, help="generate from checkpoint")
    p.add_argument("--ckpt", default=None,
                   help="specific checkpoint file (default: newest in "
                        "--log_dir)")
    p.add_argument("--ema", action="store_true",
                   help="generate with the checkpoint's EMA weights")
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--ref", required=True,
                   help=".npy/.h5 of reference clouds")
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--emd", action="store_true", help="include EMD metrics")
    p.add_argument("--emd_iters", type=int, default=10000,
                   help="auction iterations (reference test regime: 10000 "
                        "at eps=0.002; fewer underestimate EMD)")
    p.add_argument("--fpd", action="store_true", help="include FPD (random-"
                   "feature unless --fpd_weights are given)")
    p.add_argument("--fpd_stats", default=None)
    p.add_argument("--jsd_scale", type=float, default=0.5,
                   help="scale clouds by this before the JSD voxel "
                        "histogram, which covers [-0.5, 0.5]")
    p.add_argument("--mesh_points", type=int, default=0,
                   help="point-sharded EMD (not ported)")
    p.add_argument("--fpd_weights", default=None,
                   help="DGCNN extractor: a flax variables pickle with its "
                        "k and feat_dims, or the reference's torch state "
                        "dict")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    return p


def load_ref(path: str) -> np.ndarray:
    if path.endswith(".h5"):
        import h5py
        with h5py.File(path, "r") as f:
            return f[next(iter(f.keys()))][:]
    return np.load(path)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.mesh_points:
        raise NotImplementedError("--mesh_points (the point-sharded EMD) is "
                                  "not ported")
    from sp_gan_tpu_torch.device import resolve_device
    from sp_gan_tpu_torch.eval import FPD, compute_all_metrics
    from sp_gan_tpu_torch.eval.fpd import fpd_from_weights

    device = resolve_device(args.device)
    if args.gen:
        gen = np.load(args.gen)
    else:
        if not args.log_dir:
            raise SystemExit("need --gen or --log_dir")
        from sp_gan_tpu_torch.config import Config
        from sp_gan_tpu_torch.manipulate import from_checkpoint
        from sp_gan_tpu_torch.train.checkpoint import latest_checkpoint
        with open(os.path.join(args.log_dir, "config.json")) as f:
            cfg = Config.from_json(f.read())
        ckpt = args.ckpt or latest_checkpoint(args.log_dir)
        if not ckpt:
            raise SystemExit(f"no checkpoint in {args.log_dir}")
        man = from_checkpoint(ckpt, cfg, use_ema=args.ema, device=device)
        gen = man.generate(args.n)
    ref = load_ref(args.ref)

    n = min(len(gen), len(ref))
    metrics = compute_all_metrics(gen[:n], ref[:n], normalize=args.normalize,
                                  use_emd=args.emd, emd_iters=args.emd_iters,
                                  jsd_scale=args.jsd_scale, device=device)
    if args.fpd:
        if args.fpd_weights:
            fpd = fpd_from_weights(args.fpd_weights, device=device)
            if fpd.local_extractor:
                metrics["FPD_note"] = ("locally-trained DGCNN extractor — "
                                       "not comparable to the reference's "
                                       "ShapeNet FPD")
        else:
            fpd = FPD(device=device)
        metrics["FPD"] = fpd(gen[:n], ref[:n] if not args.fpd_stats else None,
                             stats_path=args.fpd_stats)
        if fpd.random_features:
            metrics["FPD_note"] = "random-feature DGCNN (no trained weights)"
    print(json.dumps(metrics, indent=2, default=float))
    return metrics


if __name__ == "__main__":
    main()
