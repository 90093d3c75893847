"""Times kernel G (`sp_gan_tpu_torch/ops/kernels/knn_blocked.py`), with
kernel A beside it, at the two kNN calls of a P2 request (a request of 16
shapes at N = 16384, k = 10) on the card, each on the same inputs:

- C=3 template:    EdgeConv1's call, the sphere template 16 times;
- C=64 randn:      EdgeConv2's shape on normal draws (seeded);
- C=64 features:   the 64-channel features a P2 request hands EdgeConv2's
                   kNN, recorded from `Manipulator.generate` (seeded
                   weights and codes).

It also checks that G and A agree bit for bit on each input. To compare two
checkouts on one card, make the inputs once and time each checkout on
them, in one machine, in the order parent, change, change, parent:

    python3 time_knn_blocked.py --save build/g_inputs.pt
    python3 time_knn_blocked.py --root OTHER_CHECKOUT --load build/g_inputs.pt
    python3 time_knn_blocked.py --load build/g_inputs.pt

`--root` is the checkout whose `sp_gan_tpu_torch` is timed (by default the
one holding this script). Prints the card's `nvidia-smi` name and power
limit, then one JSON line. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
N, B, K = 16384, 16, 10


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


def make_inputs(seed: int) -> dict:
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.data.sphere import sphere_template
    from sp_gan_tpu_torch.manipulate import Manipulator
    from sp_gan_tpu_torch.nn.generator import Generator
    from sp_gan_tpu_torch.ops import dispatch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = Config(np=N)
    man = Manipulator(cfg, Generator(cfg, seed=seed), device="cuda")
    seen = {}
    real = dispatch.knn_blocked

    def record(x, k):
        seen.setdefault(x.shape[-1], x.clone())
        return real(x, k)
    dispatch.knn_blocked = record
    try:
        man.generate(B, seed=seed + 1000, batch=B)
    finally:
        dispatch.knn_blocked = real
    return {"C=3 template": torch.as_tensor(sphere_template(N), device=dev)
            [None].expand(B, -1, -1).contiguous(),
            "C=64 randn": torch.randn(B, N, 64, generator=gen, device=dev),
            "C=64 features": seen[64].contiguous()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose sp_gan_tpu_torch is timed")
    ap.add_argument("--save", help="make the inputs and save them here")
    ap.add_argument("--load", help="time on the inputs saved here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_knn_blocked: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from sp_gan_tpu_torch.ops.kernels import _build
    from sp_gan_tpu_torch.ops.kernels.knn import knn
    from sp_gan_tpu_torch.ops.kernels.knn_blocked import knn_blocked
    _build.library()
    if args.load:
        inputs = {n: x.cuda() for n, x in torch.load(args.load).items()}
    else:
        inputs = make_inputs(args.seed)
        if args.save:
            torch.save({n: x.cpu() for n, x in inputs.items()}, args.save)
    calls = {}
    for name, x in inputs.items():
        gi, gd = knn_blocked(x, K)
        ai, ad = knn(x, K)
        calls[name] = dict(
            shape=list(x.shape),
            g_ms=cuda_ms(lambda: knn_blocked(x, K), args.reps),
            a_ms=cuda_ms(lambda: knn(x, K), args.reps),
            differ_from_a=int((gi != ai).sum()) + int((gd != ad).sum()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"root": os.path.abspath(args.root), "calls": calls}))
    if any(c["differ_from_a"] for c in calls.values()):
        raise SystemExit("kernel G differs from kernel A")


if __name__ == "__main__":
    main()
