"""Benchmark of the port: G+D training steps per second at the reference's
default configuration (bs=24, N=2048, `Config()` defaults), the port's
counterpart of the JAX package's `bench.py`.

    python -m sp_gan_tpu_torch.bench [--steps 20] [--warmup 3]
    python -m sp_gan_tpu_torch.bench --np 8192 --bs 4 --knn_mode approx \
        --knn_window 512        # the N=8192 campaign's step
    python -m sp_gan_tpu_torch.bench --fused_train   # the fused EdgeBlock
                                # in both phases (--fused_dphase: D's only)

Times `Trainer.time_steps` on the trainer's synthetic data, with weights
drawn from `--seed`; then, as the JAX package's bench does, the metric
protocol's throughput at N = `--np`: a 96x96 CD matrix of random clouds
(`cd_evals_per_sec_96x96`), the fixed-iteration EMD on 16 pairs of
training clouds at eps 0.005 and 50 iterations (`emd_evals_per_sec_b16`)
and the scaled EMD (kernel E on CUDA) on 8 pairs at eps 0.002 and 10000
iterations (`emd_metric_solves_per_sec`). Prints ONE JSON line: {"metric",
"value", "unit", "points_per_sec", the three rates, "device"}. Runs on the
GPU (raises without one) unless given `--device cpu` with smaller
`--np`/`--bs`/`--nk`. No baseline is read: `bench_baseline.json` is a TPU
number.
"""

from __future__ import annotations

import argparse
import json
import time


def metric_rates(data, dev, seed: int) -> dict:
    """CD evaluations, fixed-iteration EMD evaluations and scaled EMD
    solves per second, each over a few calls timed on the host clock (every
    call returns to the host)."""
    import torch

    from sp_gan_tpu_torch.eval.metrics import pairwise_cd_matrix
    from sp_gan_tpu_torch.ops.emd import emd_auction

    def per_sec(calls, work):
        t = time.perf_counter()
        for fn in calls:
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return len(calls) * work / (time.perf_counter() - t)

    gen = torch.Generator(device=dev).manual_seed(seed)
    clouds = torch.randn(96, data.shape[1], 3, generator=gen, device=dev)
    pairwise_cd_matrix(clouds[:2], clouds[:2])               # warm-up
    a, g8, r8 = data[:16], data[:8], data[8:16]
    cd = [lambda: pairwise_cd_matrix(clouds, clouds),
          lambda: pairwise_cd_matrix(clouds + 1e-6, clouds),
          lambda: pairwise_cd_matrix(clouds, clouds + 1e-6)]
    emd = [lambda: emd_auction(a, a, 0.005, 50),
           lambda: emd_auction(a + 1e-6, a, 0.005, 50),
           lambda: emd_auction(a, a + 1e-6, 0.005, 50)]
    emd_m = [lambda: emd_auction(g8, r8, 0.002, 10000, True),
             lambda: emd_auction(r8, g8, 0.002, 10000, True)]
    return {"cd_evals_per_sec_96x96": round(per_sec(cd, 96 * 96), 1),
            "emd_evals_per_sec_b16": round(per_sec(emd, 16), 1),
            "emd_metric_solves_per_sec": round(per_sec(emd_m, 8), 2)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--np", type=int, default=2048)
    p.add_argument("--bs", type=int, default=24)
    p.add_argument("--nk", type=int, default=20)
    p.add_argument("--knn_mode", default="exact", choices=("exact", "approx"))
    p.add_argument("--knn_window", type=int, default=512)
    p.add_argument("--fused_train", action="store_true",
                   help="fused train-mode EdgeBlock in both phases")
    p.add_argument("--fused_dphase", action="store_true",
                   help="fused train-mode EdgeBlock in the D phase")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    import torch

    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.train.trainer import Trainer, synthetic_dataset

    cfg = Config(np=args.np, bs=args.bs, nk=args.nk, seed=args.seed,
                 knn_mode=args.knn_mode, knn_window=args.knn_window,
                 fused_train=args.fused_train, fused_dphase=args.fused_dphase)
    tr = Trainer(cfg, dataset=synthetic_dataset(cfg), device=args.device,
                 logs=False)
    r = tr.time_steps(args.steps, args.warmup)
    dev = tr.device
    rates = metric_rates(tr.data, dev, args.seed)
    print(json.dumps({
        "metric": f"G+D train steps/sec (bs={cfg.bs}, {cfg.np} pts"
                  + (f", approx kNN W={cfg.knn_window}"
                     if cfg.knn_mode == "approx" else "")
                  + (", fused_train" if cfg.fused_train else "")
                  + (", fused_dphase" if cfg.fused_dphase else "") + ")",
        "value": round(r["steps_per_sec"], 3),
        "unit": "steps/s",
        "points_per_sec": round(r["points_per_sec"]),
        **rates,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }))


if __name__ == "__main__":
    main()
