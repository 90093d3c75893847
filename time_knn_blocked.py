"""Times the port's exact kNN kernels on the card, each on the same saved
inputs, and the paths that run them end to end:

- kernel G (`sp_gan_tpu_torch/ops/kernels/knn_blocked.py`), with kernel A
  beside it, at the two kNN calls of a P2 request (16 shapes at N = 16384,
  k = 10): "G C=3 template" (EdgeConv1's call, the sphere template 16
  times), "G C=64 randn" (EdgeConv2's shape on seeded normal draws) and "G
  C=64 features" (the 64-channel features a P2 request hands EdgeConv2's
  kNN);
- kernel A (`knn.py`) at a serving request's EdgeConv1 call ("A serve",
  the template 64 times, [64, 2048, 3]), and A through kernel G's route at
  that shape ("G at A's shape", which times G's C <= 4 pass there);
- kernel B (`knn_edge.py`) at a serving request's EdgeConv2 call ("B
  serve", f32 concat edges of [64, 2048, 64]) and at the default training
  step's first call ("B train", bf16 diffs of [24, 2048, 64]), each on the
  features and with the arguments the path hands it;
- a serving request (64 shapes at `Config()`, the median of 10 after a
  warm-up) through `Manipulator.generate`, and the default and
  --fused_train (F1) steps through `Trainer.time_steps` (3 warm-up steps,
  then three runs of 20 timed steps: their median, and each run), weights
  and codes from a fixed seed; and each one's device-busy ms (the
  profiler's device time over 5 requests or steps, divided by 5).

The inputs are recorded from `Manipulator.generate` and a `Trainer` step
(seeded weights, codes and batches). Every kernel's outputs are held to the
saving run's bit for bit, and G's to kernel A's, so a checkout that picks
other neighbours is caught. To compare two checkouts on one card, make the
inputs once and time each checkout on them, in one machine, in the order
parent, change, change, parent:

    python3 time_knn_blocked.py --save build/knn_inputs.pt
    python3 time_knn_blocked.py --root OTHER_CHECKOUT --load build/knn_inputs.pt
    python3 time_knn_blocked.py --load build/knn_inputs.pt

`--root` is the checkout whose `sp_gan_tpu_torch` is timed (by default the
one holding this script). `--no_paths` skips the end-to-end part. Prints
the card's `nvidia-smi` name and power limit, then one JSON line. Needs a
CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
N, B, K = 16384, 16, 10
SEED = 0


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn()` over `reps` runs, each timed with CUDA
    events after one warm-up run (as chip_smoke.py times)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def host_ms(fn, reps: int) -> float:
    """Median host milliseconds of `fn()` ending in a synchronize, over
    `reps` runs after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def device_ms(fn, reps: int = 5) -> float:
    """Device-busy ms of one `fn()`: the profiler's device time of `reps`
    calls (after one warm-up call), summed over every kernel, divided by
    `reps`. The profiler can lose a profile's first launches late in a
    process (`chip_smoke.py`'s `profile_call`), so each attempt idles for
    a lead and launches a marker kernel first, and is made again with a
    longer lead until the marker is recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    for lead in (0.1, 1.0, 5.0, 20.0):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(lead)
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if any("spin_kernel" in e.key for e in rows):
            return sum(e.self_device_time_total for e in rows
                       if "spin_kernel" not in e.key) / 1e3 / reps
    raise RuntimeError("the profiler recorded no marker launch")


def p2_inputs() -> dict:
    """Kernel G's inputs at a P2 request's two calls."""
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.data.sphere import sphere_template
    from sp_gan_tpu_torch.manipulate import Manipulator
    from sp_gan_tpu_torch.nn.generator import Generator
    from sp_gan_tpu_torch.ops import dispatch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = Config(np=N)
    man = Manipulator(cfg, Generator(cfg, seed=SEED), device="cuda")
    seen = {}
    real = dispatch.knn_blocked

    def record(x, k):
        seen.setdefault(x.shape[-1], x.clone())
        return real(x, k)
    with mock.patch.object(dispatch, "knn_blocked", record):
        man.generate(B, seed=SEED + 1000, batch=B)
    return {"G C=3 template": torch.as_tensor(sphere_template(N), device=dev)
            [None].expand(B, -1, -1).contiguous(),
            "G C=64 randn": torch.randn(B, N, 64, generator=gen, device=dev),
            "G C=64 features": seen[64].contiguous()}


def edge_calls(run) -> list:
    """(x, k, out_dtype, diff_only, select_mode) of each kernel B call that
    `run()` makes, x cloned."""
    from sp_gan_tpu_torch.ops import edge
    calls, real = [], edge.knn_edge

    def record(x, k, out_dtype=None, diff_only=False, select_mode="exact"):
        calls.append((x.clone(), k, out_dtype, diff_only, select_mode))
        return real(x, k, out_dtype, diff_only, select_mode)
    with mock.patch.object(edge, "knn_edge", record):
        run()
    return calls


def path_inputs() -> dict:
    """Kernel A's and B's inputs at a serving request and at the default
    training step, as those paths hand them over."""
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.data.sphere import sphere_template
    from sp_gan_tpu_torch.manipulate import Manipulator
    from sp_gan_tpu_torch.nn.generator import Generator
    from sp_gan_tpu_torch.train.trainer import Trainer, synthetic_dataset
    cfg = Config()
    man = Manipulator(cfg, Generator(cfg, seed=SEED), device="cuda")
    serve = edge_calls(lambda: man.generate(64, seed=SEED + 1000, batch=64))
    tr = Trainer(Config(seed=SEED), dataset=synthetic_dataset(cfg),
                 device="cuda", logs=False)
    train = edge_calls(lambda: tr.time_steps(1))
    del man, tr
    return {"A serve": torch.as_tensor(sphere_template(cfg.np),
                                       device="cuda")[None]
            .expand(64, -1, -1).contiguous(),
            "B serve": serve[0], "B train": train[0]}


def end_to_end() -> dict:
    """ms of a serving request and of a default and an F1 step (host
    clock), and their device-busy ms."""
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.manipulate import Manipulator
    from sp_gan_tpu_torch.nn.generator import Generator
    from sp_gan_tpu_torch.train.trainer import Trainer, synthetic_dataset
    res = {}
    cfg = Config()
    man = Manipulator(cfg, Generator(cfg, seed=SEED), device="cuda")
    req = lambda: man.generate(64, seed=SEED, batch=64)
    res["serve request"] = host_ms(req, 10)
    res["serve request, device"] = device_ms(req)
    del man
    for label, kw in (("default step", {}),
                      ("F1 step", dict(fused_train=True))):
        cfg = Config(seed=SEED, **kw)
        tr = Trainer(cfg, dataset=synthetic_dataset(cfg), device="cuda",
                     logs=False)
        runs = [tr.time_steps(20, 3 if i == 0 else 0)["ms_per_step"]
                for i in range(3)]
        res[label] = statistics.median(runs)
        res[label + " runs"] = runs
        res[label + ", device"] = device_ms(lambda: tr.time_steps(1))
        del tr
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose sp_gan_tpu_torch is timed")
    ap.add_argument("--save", help="make the inputs and save them here")
    ap.add_argument("--load", help="time on the inputs saved here")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no_paths", action="store_true",
                    help="time the kernels only")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_knn_blocked: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sp_gan_tpu_torch.ops.kernels import _build
    from sp_gan_tpu_torch.ops.kernels.knn import knn
    from sp_gan_tpu_torch.ops.kernels.knn_blocked import knn_blocked
    from sp_gan_tpu_torch.ops.kernels.knn_edge import knn_edge
    _build.library()
    if args.load:
        inputs = torch.load(args.load)
    else:
        inputs = {**p2_inputs(), **path_inputs()}
        if args.save:
            torch.save({n: (v.cpu() if torch.is_tensor(v)
                            else (v[0].cpu(),) + tuple(v[1:]))
                        for n, v in inputs.items()}, args.save)
    calls, outs = {}, {}
    for name, v in inputs.items():
        if name.startswith("B"):
            x, k, cd, diff_only, mode = v
            x = x.cuda()
            fn = lambda: knn_edge(x, k, cd, diff_only, mode)
            calls[name] = dict(shape=list(x.shape), out_dtype=str(cd),
                               diff_only=diff_only, select_mode=mode)
        else:
            x, k = v.cuda(), K
            fn = lambda: (knn_blocked if name.startswith("G") else knn)(x, k)
            calls[name] = dict(shape=list(x.shape))
        outs[name] = [t.cpu() for t in fn()]
        calls[name]["ms"] = cuda_ms(fn, args.reps)
        if name.startswith("G") or name == "A serve":
            ai, ad = knn(x, K)
            gi, gd = knn_blocked(x, K)
            calls[name]["g_differs_from_a"] = (int((gi != ai).sum())
                                               + int((gd != ad).sum()))
            calls[name]["a_ms" if name.startswith("G") else "g_ms"] = \
                cuda_ms(lambda: (knn if name.startswith("G")
                                 else knn_blocked)(x, K), args.reps)
        del x
    torch.cuda.empty_cache()
    res = {"root": os.path.abspath(args.root), "calls": calls}
    if not args.no_paths:
        res["end_to_end"] = end_to_end()
    # outputs of this checkout beside the saved ones, when there are any
    ref_path = args.load + ".out" if args.load else None
    if ref_path and os.path.exists(ref_path):
        ref = torch.load(ref_path)
        res["differ_from_saved"] = {
            n: sum(int((a != b).sum()) for a, b in zip(o, ref[n]))
            for n, o in outs.items()}
    elif args.save:
        torch.save(outs, args.save + ".out")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps(res))
    if any(c.get("g_differs_from_a") for c in calls.values()):
        raise SystemExit("kernel G differs from kernel A")
    if any(res.get("differ_from_saved", {}).values()):
        raise SystemExit("an output differs from the saved run's")


if __name__ == "__main__":
    main()
