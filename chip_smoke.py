#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--ckpt PATH]

Phases, in order; any failure raises and the script exits nonzero:

1. device   - needs torch.cuda; prints the card's name and power limit.
2. build    - compiles the CUDA kernels (sp_gan_tpu_torch/csrc) with nvcc.
3. kernels  - each kernel against its plain PyTorch version on the card at
              the serving shapes.
4. serve    - the full-width generator (Config() defaults; weights drawn
              from --seed, or read from --ckpt) serves two requests of 64
              shapes through Manipulator.generate, which takes the fused
              eval path; every kernel must have launched as often as that
              path launches it. A small input is also checked against the
              CPU run of the port, and one more request runs under
              torch.profiler for the device time by kernel.
5. timings  - median kernel times (CUDA events) beside their plain
              versions and the card's bound for the same work.

The last lines are the kernels JSON, the card's name and power limit, and
`{"ok": true, "device": {...}}`. Needs no file outside the sources.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# published H100 SXM peaks (NVIDIA data sheet) for the bound column
F32_FLOPS = 67e12          # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


# kernel launches per request of the fused eval path: EdgeConv1 selects
# with kernel A, EdgeConv2 with kernel B, and each runs its tail as kernel C
PER_REQUEST = {"knn": 1, "knn_edge": 1, "edge_tail": 2}


def log(*a) -> None:
    print(*a, flush=True)


class Phases:
    def __init__(self):
        self.t0 = time.perf_counter()

    def start(self, name: str) -> None:
        self.name, self.t = name, time.perf_counter()
        log(f"[phase {name}] start at {self.t - self.t0:.1f} s")

    def end(self) -> None:
        now = time.perf_counter()
        log(f"[phase {self.name}] done in {now - self.t:.2f} s "
            f"(total {now - self.t0:.1f} s)")


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn()` over `reps` runs, each timed with CUDA
    events after one warm-up run."""
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


def check_knn(x, k):
    """Kernel A against its plain version: indices equal, distances within
    1e-5 relative (both run the same f32 operations, so they are expected
    to be bit-identical)."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.knn import knn, knn_plain
    idx, dist = knn(x, k)
    torch.cuda.synchronize()
    idx_p, dist_p = knn_plain(x, k)
    if not torch.equal(idx, idx_p):
        raise AssertionError(
            f"knn: {(idx != idx_p).sum().item()} indices differ")
    err = (dist - dist_p).abs().max().item()
    rel = ((dist - dist_p).abs() / dist_p.abs().clamp_min(1e-30)).max().item()
    if rel > 1e-5:
        raise AssertionError(f"knn: dist rel err {rel}")
    return {"agree": 1.0, "max_abs_err": err}


def check_knn_edge(x, k):
    """Kernel B against its plain version in both selection modes, both
    output types and both forms. The contract of the JAX package's packed
    test (tests/test_pallas.py, TestKnnEdgePacked): index agreement >= 0.995,
    every disagreement a near-tie within N * 2^-24 * 4 relative; where the
    indices agree the edge features must be equal exactly."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.knn_edge import (knn_edge,
                                                       knn_edge_plain)
    from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist
    n = x.shape[1]
    d = None
    worst = {"agree": 1.0, "max_abs_err": 0.0}
    for mode in ("packed", "exact"):
        for cd in (torch.bfloat16, torch.float32):
            for diff_only in (True, False):
                ee, idx = knn_edge(x, k, cd, diff_only, mode)
                torch.cuda.synchronize()
                ee_p, idx_p = knn_edge_plain(x, k, cd, diff_only, mode)
                same = idx == idx_p
                agree = same.float().mean().item()
                tag = f"knn_edge[{mode}, {str(cd)[6:]}, diff_only={diff_only}]"
                if agree < 0.995:
                    raise AssertionError(f"{tag}: index agreement {agree}")
                if not bool(same.all()):
                    if d is None:
                        d = pairwise_sqdist(x, x)
                    b, q, j = torch.nonzero(~same, as_tuple=True)
                    de = d[b, q, idx_p[b, q, j].long()]
                    dk = d[b, q, idx[b, q, j].long()]
                    bound = n * 2.0 ** -24 * 4 * de.clamp_min(1e-6) + 1e-7
                    if bool(((dk - de).abs() > bound).any()):
                        raise AssertionError(f"{tag}: a non-near-tie flip")
                rows = same[..., None].expand_as(ee)
                diff = (ee.float() - ee_p.float()).abs()[rows]
                err = diff.max().item() if diff.numel() else 0.0
                if err != 0.0:
                    raise AssertionError(f"{tag}: edge features differ by "
                                         f"{err} where indices agree")
                log(f"  {tag}: agree {agree}, max_abs_err {err}")
                worst["agree"] = min(worst["agree"], agree)
                worst["max_abs_err"] = max(worst["max_abs_err"], err)
    return worst


def check_small_reference(seed: int) -> None:
    """The port on the card against the port on the CPU (plain kernels,
    CPU matmuls) at B=2, N=256 in float32. The dense layers round
    differently on the two devices, which can flip a near-tie neighbor in
    the feature-space kNN; so the check asks that 99% of the points agree
    within 1e-3 and the median within 1e-5."""
    import numpy as np
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.manipulate import Manipulator
    from sp_gan_tpu_torch.nn.generator import Generator
    cfg = Config(np=256, dtype="float32")
    z = np.random.default_rng(seed).standard_normal(
        (2, 1, cfg.nz)).astype(np.float32) * cfg.nv
    z = np.broadcast_to(z, (2, cfg.np, cfg.nz))
    out_gpu = Manipulator(cfg, Generator(cfg, seed=seed),
                          device="cuda").forward(z)
    out_cpu = Manipulator(cfg, Generator(cfg, seed=seed),
                          device="cpu").forward(z)
    err = np.abs(out_gpu - out_cpu).max(axis=-1)           # [B, N]
    p99, med = np.quantile(err, 0.99), np.median(err)
    log(f"  small reference (N=256, f32): cuda vs cpu max {err.max():.3g}, "
        f"p99 {p99:.3g}, median {med:.3g}")
    if not (np.isfinite(out_gpu).all() and p99 <= 1e-3 and med <= 1e-5):
        raise AssertionError("cuda output disagrees with the cpu reference")


def tail_args(block, ee):
    """Kernel C's arguments for EdgeBlock `block` on edges `ee`, as the
    fused eval path builds them."""
    from sp_gan_tpu_torch.nn.fused_eval import fold_bn
    w1, a1 = fold_bn(block.conv_w1, block.bn_w1)
    w2, a2 = fold_bn(block.conv_w2, block.bn_w2)
    wx, ax = fold_bn(block.conv_x, block.bn_x)
    return (ee, w1, a1, w2, a2, wx, ax,
            block.out_kernel.detach().float().contiguous(),
            block.out_bias.detach()[None].float().contiguous())


def check_edge_tail(args, k):
    """Kernel C against its plain version (TF32 off): |err| <= 1e-5 +
    1e-4 |plain|. The two sum the same f32 products in other orders (up to
    1280 terms in conv_out) and take exp from different libraries."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.edgeblock import (edge_tail,
                                                        edge_tail_plain)
    out = edge_tail(*args, k=k)
    torch.cuda.synchronize()
    ref = edge_tail_plain(*args, k=k)
    err = (out - ref).abs()
    if not bool(torch.isfinite(out).all()) or \
            bool((err > 1e-5 + 1e-4 * ref.abs()).any()):
        raise AssertionError(f"edge_tail: max abs err {err.max().item()} "
                             f"on outputs up to {ref.abs().max().item()}")
    return {"max_abs_err": err.max().item(),
            "max_abs_out": ref.abs().max().item()}


def bound(flops: float, nbytes: float):
    """(bound ms, what bounds it) from f32 operations and bytes moved."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def profile_request(man, seed: int) -> dict:
    """Device time by kernel of one request of 64 shapes under
    torch.profiler, and the device's idle share of its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        man.generate(64, seed=seed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[2])
    busy = sum(ms for _, _, ms in rows)
    log(f"  profiled request: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms, idle {100 * (1 - busy / wall_ms):.1f}%")
    for name, count, ms in rows[:12]:
        log(f"    {ms:8.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} "
            f"{name[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms,
            "top": [{"name": n[:120], "count": c, "ms": ms}
                    for n, c, ms in rows[:12]]}


def main() -> None:
    ap = argparse.ArgumentParser(description="GPU smoke test of the port")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generator's random weights and codes")
    ap.add_argument("--ckpt", default=None,
                    help="optional JAX checkpoint to serve instead of "
                    "random weights (Config() architecture)")
    args = ap.parse_args()
    ph = Phases()

    # ---------------------------------------------------------------- 1
    ph.start("device")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to test")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"  {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"nvidia-smi: {smi}")
    dev = torch.device("cuda")
    ph.end()

    # ---------------------------------------------------------------- 2
    ph.start("build")
    from sp_gan_tpu_torch.ops.kernels import _build
    t = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"  nvcc build {time.perf_counter() - t:.2f} s -> "
        f"{os.path.relpath(lib_path, HERE)}")
    ph.end()

    # ---------------------------------------------------------------- 3
    ph.start("kernels")
    import numpy as np
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.data.sphere import sphere_template
    from sp_gan_tpu_torch.manipulate import Manipulator, from_checkpoint
    from sp_gan_tpu_torch.nn.generator import Generator
    from sp_gan_tpu_torch.ops import kernels
    from sp_gan_tpu_torch.ops.edge import edge_features
    cfg = Config()
    k, B = cfg.k, 64
    if args.ckpt:
        man = from_checkpoint(args.ckpt, cfg, device="cuda")
        log(f"  weights from {args.ckpt}")
    else:
        man = Manipulator(cfg, Generator(cfg, seed=args.seed), device="cuda")
        log(f"  weights drawn from seed {args.seed} (Config() full width)")
    if not man.fused:
        raise AssertionError("Config() must be served by the fused path")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    # EdgeConv1's input: the template, broadcast over the batch
    x_a = torch.as_tensor(sphere_template(cfg.np), device=dev)[None] \
        .expand(B, -1, -1).contiguous()
    x_b = torch.randn(B, cfg.np, 64, generator=gen, device=dev)
    res_a = check_knn(x_a, k)
    log(f"  knn [{B}, {cfg.np}, 3] k={k}: {res_a}")
    res_b = check_knn_edge(x_b, k)
    with torch.inference_mode():
        tails = {
            "edge1": tail_args(man.G.edge1, edge_features(x_a, k)),
            "edge2": tail_args(man.G.edge2, edge_features(x_b, k))}
        res_c = {}
        for name, targs in tails.items():
            res_c[name] = check_edge_tail(targs, k)
            log(f"  edge_tail[{name}, ee {list(targs[0].shape)}]: "
                f"{res_c[name]}")
    ph.end()

    # ---------------------------------------------------------------- 4
    ph.start("serve")
    man.generate(64, seed=args.seed + 1000)          # warm-up request
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    pcs = man.generate(128, seed=args.seed)           # two requests of 64
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    launches = kernels.launch_counts()
    log(f"  generate(128): {serve_s * 1e3 / 2:.2f} ms per request of 64 "
        f"shapes; launches {launches}")
    if pcs.shape != (128, cfg.np, 3) or not np.isfinite(pcs).all():
        raise AssertionError(f"bad output: shape {pcs.shape}, "
                             f"finite {np.isfinite(pcs).all()}")
    for name, per in PER_REQUEST.items():
        if launches[name] != 2 * per:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"two requests, expected {2 * per}")
    radius = np.sqrt((pcs ** 2).sum(-1)).max(axis=1)
    if not np.allclose(radius, 1.0, atol=1e-4):
        raise AssertionError("normalized clouds must reach radius 1")
    check_small_reference(args.seed)
    prof = profile_request(man, args.seed)
    log(json.dumps({"serve": {"ms_per_request": serve_s * 1e3 / 2,
                              "launches": launches, "profile": prof}}))
    ph.end()

    # ---------------------------------------------------------------- 5
    ph.start("timings")
    from sp_gan_tpu_torch.ops.kernels.edgeblock import (edge_tail,
                                                        edge_tail_plain)
    from sp_gan_tpu_torch.ops.kernels.knn import knn, knn_plain
    from sp_gan_tpu_torch.ops.kernels.knn_edge import (knn_edge,
                                                       knn_edge_plain)
    N, C = cfg.np, x_b.shape[-1]
    rows = []
    # kernel A at [64, 2048, 3]
    a_ms = cuda_ms(lambda: knn(x_a, k), 50)
    a_plain = cuda_ms(lambda: knn_plain(x_a, k), 10)
    a_bound, a_by = bound(2 * B * N * N * 3, B * N * 3 * 4 + 2 * B * N * k * 4)
    x_a1 = x_a[:1].contiguous()
    log(f"  knn at batch 1 [1, {N}, 3] (the unfused path): "
        f"{cuda_ms(lambda: knn(x_a1, k), 50):.4f} ms")
    rows.append(dict(
        name="knn", route="cuda", source="sp_gan_tpu_torch/csrc/knn.cu",
        replaces="sp_gan_tpu/ops/pallas/knn.py:515 (knn_pallas, "
                 "_knn_kernel :24)",
        launches=launches["knn"], agree=res_a["agree"],
        max_abs_err=res_a["max_abs_err"], max_err=res_a["max_abs_err"],
        ms=a_ms, plain_ms=a_plain, bound_ms=a_bound, bound_by=a_by,
        library_ms=None, shape=[B, N, 3]))
    # kernel B at [64, 2048, 64] -> f32 [central, nbr - central], packed
    serve_b = dict(out_dtype=torch.float32, diff_only=False,
                   select_mode="packed")
    b_ms = cuda_ms(lambda: knn_edge(x_b, k, **serve_b), 20)
    b_plain = cuda_ms(lambda: knn_edge_plain(x_b, k, **serve_b), 5)
    b_bound, b_by = bound(2 * B * N * N * C, B * N * C * 4
                          + B * N * k * 2 * C * 4 + B * N * k * 4)
    rows.append(dict(
        name="knn_edge", route="cuda",
        source="sp_gan_tpu_torch/csrc/knn_edge.cu",
        replaces="sp_gan_tpu/ops/pallas/knn.py:313 (knn_edge_pallas, "
                 "_knn_edge_kernel :177)",
        launches=launches["knn_edge"], agree=res_b["agree"],
        max_abs_err=res_b["max_abs_err"], max_err=res_b["max_abs_err"],
        ms=b_ms, plain_ms=b_plain, bound_ms=b_bound, bound_by=b_by,
        library_ms=None, shape=[B, N, C]))
    for mode in ("exact", "packed"):
        for cd in (torch.float32, torch.bfloat16):
            ms = cuda_ms(lambda: knn_edge(x_b, k, cd, True, mode), 20)
            log(f"  knn_edge[{mode}, {str(cd)[6:]}, diff_only]: {ms:.3f} ms")
    # kernel C at both call sites of one request
    calls = {}
    for name, targs in tails.items():
        ee, w1, w2 = targs[0], targs[1], targs[3]
        _, _, _, c2 = ee.shape
        f2, f = w1.shape[1], w2.shape[1]
        flops = 2 * B * N * k * (c2 // 2 * f2 + f2 * f + c2 * f + f * f)
        nbytes = 4 * (ee.numel() + sum(t.numel() for t in targs[1:])
                      + B * N * f)
        c_bound, c_by = bound(flops, nbytes)
        calls[name] = dict(
            ee=list(ee.shape), F2=f2, F=f,
            ms=cuda_ms(lambda: edge_tail(*targs, k=k), 20),
            plain_ms=cuda_ms(lambda: edge_tail_plain(*targs, k=k), 10),
            bound_ms=c_bound, bound_by=c_by,
            max_abs_err=res_c[name]["max_abs_err"])
        log(f"  edge_tail[{name}]: {calls[name]}")
    rows.append(dict(
        name="edge_tail", route="cuda",
        source="sp_gan_tpu_torch/csrc/edgeblock.cu",
        replaces="sp_gan_tpu/ops/pallas/edgeblock.py:102 (edge_tail_pallas,"
                 " _edge_tail_kernel :28)",
        launches=launches["edge_tail"],
        max_abs_err=max(c["max_abs_err"] for c in calls.values()),
        max_err=max(c["max_abs_err"] for c in calls.values()),
        ms=sum(c["ms"] for c in calls.values()),
        plain_ms=sum(c["plain_ms"] for c in calls.values()),
        bound_ms=sum(c["bound_ms"] for c in calls.values()),
        bound_by=calls["edge2"]["bound_by"], library_ms=None,
        per="one request: the edge1 and the edge2 call", calls=calls))
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound); no single "
            "PyTorch call computes this function, so library_ms is null")
    ph.end()

    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
