"""Times kernel C's f32 mode (`edge_tail` on f32 edges) and kernel I
(`edge_train_stats2` on bf16 edges) on the card, each on the same inputs,
and the paths that run them end to end:

- C serve edge1, edge2: the two calls of a serving request (64 shapes at
  `Config()`), on the edges that request hands kernel C;
- C P2 edge1, edge2: the same at P2 (16 shapes at N = 16384);
- I: the --fused_train step's EdgeConv2 (bf16 edges [24, 2048, 10, 128]
  from kernel B on seeded features, the block's weights and the affine of
  its own batch statistics);
- serving and P2 requests through `Manipulator.generate` (the median of
  10 and 5 after a warm-up), and the --fused_train (F1) and
  --fused_dphase (F2) steps through `Trainer.time_steps` (3 warm-up steps,
  then three runs of 20 timed steps: their median, and each run), weights
  and codes from a fixed seed; and each one's device-busy ms (the sum of
  the profiler's device time over 5 requests or steps, divided by 5). A
  step's host time moves by several ms from run to run at 25-40% device
  idle on a shared host, more than kernel I's gain (about 2 ms a step);
  its device-busy time does not carry the host's gaps.

The edges are recorded from `Manipulator.generate` (seeded weights and
codes). Each kernel's output is also held against the change's run on the
same inputs: C's f32 gate (|err| <= 1e-5 + 1e-4 |out|) and I within 5e-3
relative L2, so a checkout that computes something else is caught. To
compare two checkouts on one card, make the inputs once and time each
checkout on them, in one machine, in the order parent, change, change,
parent:

    python3 time_edge_tail.py --save build/c_inputs.pt
    python3 time_edge_tail.py --root OTHER_CHECKOUT --load build/c_inputs.pt
    python3 time_edge_tail.py --load build/c_inputs.pt

`--root` is the checkout whose `sp_gan_tpu_torch` is timed (by default the
one holding this script). Prints the card's `nvidia-smi` name and power
limit, then one JSON line. Needs a CUDA device.
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
    return statistics.median(times)


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


def request_tails(np_: int, shapes: int) -> dict:
    """{edge1, edge2: kernel C's arguments} of a request of `shapes` shapes
    at N = np_."""
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.manipulate import Manipulator
    from sp_gan_tpu_torch.nn import fused_eval
    from sp_gan_tpu_torch.nn.generator import Generator
    cfg = Config(np=np_)
    man = Manipulator(cfg, Generator(cfg, seed=SEED), device="cuda")
    tails, real = {}, fused_eval.edge_tail

    def record(*targs, k, neg):
        tails.setdefault(f"edge{len(tails) + 1}",
                         tuple(t.clone().cpu() for t in targs))
        return real(*targs, k=k, neg=neg)
    with mock.patch.object(fused_eval, "edge_tail", record), \
            torch.inference_mode():
        man.generate(shapes, seed=SEED + 1000, batch=shapes)
    return tails


def stats_inputs() -> tuple:
    """Kernel I's arguments (ee, w1, a1, w2) at the --fused_train step's
    EdgeConv2."""
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.nn.generator import Generator
    from sp_gan_tpu_torch.ops import edgeblock_train as ebt
    from sp_gan_tpu_torch.ops.kernels.knn_edge import knn_edge
    cfg = Config(seed=SEED)
    block = Generator(cfg, seed=SEED).cuda().edge2
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(cfg.bs, cfg.np, 64, generator=gen, device="cuda")
    with torch.no_grad():
        ee = knn_edge(x, cfg.k, torch.bfloat16, False, "packed")[0]
        p = {n: t.detach().float() for n, t in
             ebt.block_params(block).items()}
        a1 = ebt._fold_all(p, ebt.edge_block_train_stats(p, ee, cfg.k),
                           1e-5)[0]
        w1, w2 = ebt._weights(p)[:2]
    return tuple(t.cpu() for t in (ee, w1, a1, w2))


def make_inputs() -> dict:
    return {"serve": request_tails(2048, 64),
            "p2": request_tails(16384, 16), "stats": stats_inputs()}


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


def end_to_end() -> dict:
    """ms of a serving request, a P2 request and an F1 and F2 step (host
    clock), and their device-busy ms."""
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.manipulate import Manipulator
    from sp_gan_tpu_torch.nn.generator import Generator
    from sp_gan_tpu_torch.train.trainer import Trainer, synthetic_dataset
    res = {}
    for label, np_, shapes, reps in (("serve request", 2048, 64, 10),
                                     ("P2 request", 16384, 16, 5)):
        cfg = Config(np=np_)
        man = Manipulator(cfg, Generator(cfg, seed=SEED), device="cuda")
        req = lambda: man.generate(shapes, seed=SEED, batch=shapes)
        res[label] = host_ms(req, reps)
        res[label + ", device"] = device_ms(req)
        del man
    for label, kw in (("F1 step", dict(fused_train=True)),
                      ("F2 step", dict(fused_dphase=True))):
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
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_edge_tail: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sp_gan_tpu_torch.ops.kernels import _build
    from sp_gan_tpu_torch.ops.kernels.edgeblock import edge_tail
    from sp_gan_tpu_torch.ops.kernels.edgeblock_train import edge_train_stats2
    _build.library()
    if args.load:
        inputs = torch.load(args.load)
    else:
        inputs = make_inputs()
        if args.save:
            torch.save(inputs, args.save)
    k = inputs["serve"]["edge1"][0].shape[2]
    calls, outs = {}, {}
    for req in ("serve", "p2"):
        for name, targs in inputs[req].items():
            targs = [t.cuda() for t in targs]
            outs[f"C {req} {name}"] = edge_tail(*targs, k=k).cpu()
            calls[f"C {req} {name}"] = dict(
                ee=list(targs[0].shape),
                ms=cuda_ms(lambda: edge_tail(*targs, k=k), args.reps))
            del targs
    sargs = [t.cuda() for t in inputs["stats"]]
    outs["I"] = edge_train_stats2(*sargs, k).cpu()
    calls["I"] = dict(ee=list(sargs[0].shape),
                      ms=cuda_ms(lambda: edge_train_stats2(*sargs, k),
                                 args.reps))
    del sargs, inputs
    torch.cuda.empty_cache()
    res = {"root": os.path.abspath(args.root), "calls": calls,
           "end_to_end": end_to_end()}
    # outputs of this checkout beside the saved ones, when there are any
    ref_path = args.load + ".out" if args.load else None
    if ref_path and os.path.exists(ref_path):
        ref = torch.load(ref_path)
        dev = {}
        for name, out in outs.items():
            if name == "I":
                dev[name] = float((out - ref[name]).norm() / ref[name].norm())
                ok = dev[name] <= 5e-3
            else:
                excess = (out - ref[name]).abs() - (
                    1e-5 + 1e-4 * ref[name].abs())
                dev[name] = float(excess.max())
                ok = dev[name] <= 0
            if not ok:
                raise SystemExit(f"time_edge_tail: {name} differs from the "
                                 f"saved run: {dev[name]}")
        res["against_saved"] = dev
    elif args.save:
        torch.save(outs, args.save + ".out")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
