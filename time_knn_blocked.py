"""Times the port's kNN kernels and kernel D on the card, each on the same
saved inputs, and the paths that run them end to end:

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
- kernel F (`knn_edge_window.py`) at the N=8192 approx campaign's (P1)
  step's first call ("F P1", bf16 diffs of [4, 8192, 64] at W = 512);
- kernel D (`scatter.py::scatter_diff_bwd`) at its three calls: the
  default step's ("D default", d_diff [24, 2048, 10, 64]), F1's ("D F1",
  the neighbour half of d_ee [24, 2048, 10, 128]: handed over at its row
  stride where the checkout's kernel D takes one, `row_stride`, else as
  the contiguous copy the checkout's path makes, the copy timed with it;
  "D F1 copy" times D on the copy in both) and P1's ("D P1", [4, 8192,
  10, 64] on kernel F's indices);
- a serving request (64 shapes at `Config()`, the median of 10 after a
  warm-up) through `Manipulator.generate`, and the default, --fused_train
  (F1) and P1 steps through `Trainer.time_steps` (3 warm-up steps, then
  three runs of 20 timed steps: their median, and each run), weights and
  codes from a fixed seed; and each one's device-busy ms (the profiler's
  device time over 5 requests or steps, divided by 5).

The inputs are recorded from `Manipulator.generate` and `Trainer` steps
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
# the N=8192 approx campaign's step (P1), as chip_smoke.py runs it
CAMPAIGN_N8192 = dict(np=8192, bs=4, nk=20, knn_mode="approx",
                      knn_window=512, ema=True)


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


def window_calls(run) -> list:
    """(x, k, window, out_dtype, diff_only, select_mode) of each kernel F
    call that `run()` makes, x cloned."""
    from sp_gan_tpu_torch.ops import edge
    calls, real = [], edge.knn_edge_window

    def record(x, k, window, out_dtype=None, tq=256, diff_only=False,
               select_mode="exact"):
        calls.append((x.clone(), k, window, out_dtype, diff_only,
                      select_mode))
        return real(x, k, window, out_dtype, tq, diff_only, select_mode)
    with mock.patch.object(edge, "knn_edge_window", record):
        run()
    return calls


def diff_calls(run) -> list:
    """(d_diff, idx) of each kernel D call that `run()` makes, copied
    (d_diff contiguous)."""
    from sp_gan_tpu_torch.ops import edge
    calls, real = [], edge.scatter_diff_bwd

    def record(d, idx):
        calls.append((d.contiguous().clone(), idx.clone()))
        return real(d, idx)
    with mock.patch.object(edge, "scatter_diff_bwd", record):
        run()
    return calls


def trainer(**kw):
    """A Trainer of Config(seed=SEED, **kw) on synthetic data."""
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.train.trainer import Trainer, synthetic_dataset
    cfg = Config(seed=SEED, **kw)
    return Trainer(cfg, dataset=synthetic_dataset(cfg), device="cuda",
                   logs=False)


def path_inputs() -> dict:
    """Kernel A's, B's, F's and D's inputs at a serving request and at the
    default, F1 and P1 training steps, as those paths hand them over."""
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.data.sphere import sphere_template
    from sp_gan_tpu_torch.manipulate import Manipulator
    from sp_gan_tpu_torch.nn.generator import Generator
    cfg = Config()
    man = Manipulator(cfg, Generator(cfg, seed=SEED), device="cuda")
    serve = edge_calls(lambda: man.generate(64, seed=SEED + 1000, batch=64))
    del man
    tr = trainer()
    train = []
    d_default = diff_calls(lambda: train.extend(edge_calls(
        lambda: tr.time_steps(1))))
    d_f1 = diff_calls(lambda: trainer(fused_train=True).time_steps(1))
    tr = trainer(**CAMPAIGN_N8192)
    p1 = []
    d_p1 = diff_calls(lambda: p1.extend(window_calls(
        lambda: tr.time_steps(1))))
    del tr
    return {"A serve": torch.as_tensor(sphere_template(cfg.np),
                                       device="cuda")[None]
            .expand(64, -1, -1).contiguous(),
            "B serve": serve[0], "B train": train[0], "F P1": p1[0],
            "D default": d_default[0], "D F1": d_f1[0], "D P1": d_p1[0]}


def end_to_end() -> dict:
    """ms of a serving request and of a default, an F1 and a P1 step (host
    clock), and their device-busy ms."""
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.manipulate import Manipulator
    from sp_gan_tpu_torch.nn.generator import Generator
    res = {}
    cfg = Config()
    man = Manipulator(cfg, Generator(cfg, seed=SEED), device="cuda")
    req = lambda: man.generate(64, seed=SEED, batch=64)
    res["serve request"] = host_ms(req, 10)
    res["serve request, device"] = device_ms(req)
    del man
    for label, kw in (("default step", {}),
                      ("F1 step", dict(fused_train=True)),
                      ("P1 step", CAMPAIGN_N8192)):
        tr = trainer(**kw)
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
    from sp_gan_tpu_torch.ops.kernels import scatter
    from sp_gan_tpu_torch.ops.kernels.knn_edge import knn_edge
    from sp_gan_tpu_torch.ops.kernels.knn_edge_window import knn_edge_window
    _build.library()
    if args.load:
        inputs = torch.load(args.load)
    else:
        inputs = {**p2_inputs(), **path_inputs()}
        if args.save:
            torch.save({n: (v.cpu() if torch.is_tensor(v) else tuple(
                t.cpu() if torch.is_tensor(t) else t for t in v))
                for n, v in inputs.items()}, args.save)
    # D F1's neighbour half: in place at its row stride where this
    # checkout's kernel D takes one, else the contiguous copy its path makes
    strided = hasattr(scatter, "row_stride")
    if "D F1" in inputs:
        inputs["D F1 copy"] = inputs["D F1"]
    calls, outs = {}, {}
    for name, v in inputs.items():
        if name.startswith("B"):
            x, k, cd, diff_only, mode = v
            x = x.cuda()
            fn = lambda: knn_edge(x, k, cd, diff_only, mode)
            calls[name] = dict(shape=list(x.shape), out_dtype=str(cd),
                               diff_only=diff_only, select_mode=mode)
        elif name.startswith("F"):
            x, k, window, cd, diff_only, mode = v
            x = x.cuda()
            fn = lambda: knn_edge_window(x, k, window, cd,
                                         diff_only=diff_only,
                                         select_mode=mode)
            calls[name] = dict(shape=list(x.shape), window=window,
                               out_dtype=str(cd), diff_only=diff_only,
                               select_mode=mode)
        elif name.startswith("D"):
            x, idx = v[0].cuda(), v[1].cuda()
            calls[name] = dict(shape=list(x.shape), dtype=str(x.dtype))
            if name == "D F1":
                C = x.shape[-1]
                full = torch.cat([torch.zeros_like(x), x], -1)
                half = full[..., C:] if strided else None
                fn = ((lambda: (scatter.scatter_diff_bwd(half, idx),))
                      if strided else
                      (lambda: (scatter.scatter_diff_bwd(
                          full[..., C:].contiguous(), idx),)))
                calls[name]["row_stride"] = 2 * C if strided else C
            else:
                fn = lambda: (scatter.scatter_diff_bwd(x, idx),)
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
