"""Times the port's kernel O (the Jacobi EMD auction, both modes), kernel N
(the Chamfer nearest neighbours) and kernel E (the block Gauss-Seidel
auction, whose row scan kernel O shares) on the card, each on the same
saved inputs:

- "O jacobi" and "O packed": `jacobi_auction` at [4, 2048, 2048] in the
  metric protocol's regime (eps 0.002, 10000 iterations, 4 phases), d
  between normalized synthetic shapes as chip_smoke.py draws them; the
  launch's ms (CUDA events, median of --reps after a warm-up), the rounds
  of each pair and the microseconds a round of the pair with the most;
- "E": `auction` (blockgs) on the same d and regime, its block-rounds and
  microseconds a block-round;
- "N": `chamfer_nn` at [64, 2048, 3] on two sets of normalized synthetic
  shapes (`chamfer_directed`'s fused call); ms of one call with the card
  idle before it (as chip_smoke.py times it, the wrapper's host time
  included) and ms a call when calls follow each other.

Every output is held to the saving run's bit for bit, so a checkout that
computes another assignment or other neighbours is caught. To compare two
checkouts on one card, make the inputs once and time each checkout on
them, in one machine, in the order parent, change, change, parent:

    python3 time_auction_chamfer.py --save build/o_inputs.pt
    python3 time_auction_chamfer.py --root OTHER_CHECKOUT --load build/o_inputs.pt
    python3 time_auction_chamfer.py --load build/o_inputs.pt

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

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
PROTOCOL = (0.002, 10000, 4)
AUCTION_SHAPE = (4, 2048)        # pairs, points
CHAMFER_SHAPE = (64, 2048)       # clouds, points


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


def back_to_back_ms(fn, reps: int) -> float:
    """Milliseconds a call of `fn()` when `reps` calls follow each other
    between two CUDA events (after one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def make_inputs() -> dict:
    """d for the auctions and the two sets of clouds for the Chamfer call,
    drawn from SEED on the card."""
    import torch
    from sp_gan_tpu_torch.data import SyntheticDataset
    from sp_gan_tpu_torch.manipulate import normalize_point_cloud
    from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist

    def shapes(count, n, seed):
        return normalize_point_cloud(torch.as_tensor(
            SyntheticDataset(count, n, seed=seed).data, device="cuda"))

    B, n = AUCTION_SHAPE
    pcs = shapes(2 * B, n, SEED + 11)
    Bc, nc = CHAMFER_SHAPE
    clouds = shapes(2 * Bc, nc, SEED + 7)
    return {"d": pairwise_sqdist(pcs[:B], pcs[B:]),
            "x": clouds[:Bc].contiguous(), "y": clouds[Bc:].contiguous()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose sp_gan_tpu_torch is timed")
    ap.add_argument("--save", help="make the inputs and save them here")
    ap.add_argument("--load", help="time on the inputs saved here")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_auction_chamfer: no CUDA device")
    from sp_gan_tpu_torch.ops.kernels import _build
    from sp_gan_tpu_torch.ops.kernels.auction import auction
    from sp_gan_tpu_torch.ops.kernels.auction_jacobi import jacobi_auction
    from sp_gan_tpu_torch.ops.kernels.chamfer import chamfer_nn
    _build.library()
    if args.load:
        inputs = {k: v.cuda() for k, v in torch.load(args.load).items()}
    else:
        inputs = make_inputs()
        if args.save:
            torch.save({k: v.cpu() for k, v in inputs.items()}, args.save)
    d, x, y = inputs["d"], inputs["x"], inputs["y"]
    calls, outs = {}, {}
    for mode in ("jacobi", "packed"):
        fn = lambda: jacobi_auction(d, *PROTOCOL, mode=mode)
        out = fn()
        outs[f"O {mode}"] = [t.cpu() for t in out]
        ms = cuda_ms(fn, args.reps)
        rounds = out[1].tolist()
        calls[f"O {mode}"] = dict(shape=list(d.shape), ms=ms, rounds=rounds,
                                  bidders=out[2].tolist(),
                                  us_per_round=1e3 * ms / max(rounds))
    fn = lambda: auction(d, *PROTOCOL)
    out = fn()
    outs["E"] = [t.cpu() for t in out]
    ms = cuda_ms(fn, args.reps)
    calls["E"] = dict(shape=list(d.shape), ms=ms,
                      block_rounds=out[1].tolist(),
                      us_per_block_round=1e3 * ms / max(out[1].tolist()))
    fn = lambda: chamfer_nn(x, y)
    outs["N"] = [t.cpu() for t in fn()]
    calls["N"] = dict(shape=list(x.shape), ms=cuda_ms(fn, 20 * args.reps),
                      back_to_back_ms=back_to_back_ms(fn, 20 * args.reps))
    res = {"root": os.path.abspath(args.root), "calls": calls}
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
    if any(res.get("differ_from_saved", {}).values()):
        raise SystemExit("an output differs from the saved run's")


if __name__ == "__main__":
    main()
