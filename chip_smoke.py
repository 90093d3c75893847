#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--ckpt PATH] [--step_seeds 3]

Phases, in order; any failure raises and the script exits nonzero:

1. device   - needs torch.cuda; prints the card's name and power limit.
2. build    - compiles the CUDA kernels (sp_gan_tpu_torch/csrc) with nvcc.
3. kernels  - each kernel against its plain PyTorch version on the card at
              the serving and training shapes, and the autograd edge op
              (kernel B forward, kernel D backward) against a plain
              autograd graph.
4. serve    - the full-width generator (Config() defaults; weights drawn
              from --seed, or read from --ckpt) serves two requests of 64
              shapes through Manipulator.generate, which takes the fused
              eval path; every kernel must have launched as often as that
              path launches it. A small input is also checked against the
              CPU run of the port, and one more request runs under
              torch.profiler for the device time by kernel.
5. train    - training steps at Config() defaults (bs=24, N=2048, weights
              from --seed) through Trainer.time_steps on the trainer's
              synthetic data: 3 warm-up steps, then 10 timed steps whose
              kernel launches must be those of the default step; finite
              losses, moved weights; small steps (N=256, bs=4, float32) on
              the card against the same steps on the CPU, seed after seed
              until --step_seeds of them compared G's gradients; one more
              step under torch.profiler.
6. timings  - median kernel times (CUDA events) beside their plain
              versions and the card's bound for the same work.

The last lines are the kernels JSON, the card's name and power limit, and
`{"ok": true, "device": {...}}`. Needs no file outside the sources.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
PER_REQUEST = {"knn": 1, "knn_edge": 1, "edge_tail": 2,
               "scatter_diff_bwd": 0}
# kernel launches per default training step: EdgeConv2's kNN and diff
# edges (kernel B) in the D phase and in the G phase, and their backward
# (kernel D) in the G phase; EdgeConv1 runs on the template's run-constant
# edges, and sampling (kernels A and C) is not part of the step
PER_STEP = {"knn": 0, "knn_edge": 2, "edge_tail": 0, "scatter_diff_bwd": 1}
WARMUP_STEPS, TIMED_STEPS = 3, 10
# dense biases that feed a training-mode BatchNorm: their exact gradient is
# zero, so they are compared on the scale of their layer's kernel gradient
PRE_BN_BIAS = re.compile(r"(^|\.)(conv_w1|conv_w2|conv_x|global1|global2|"
                         r"mlp\d|fc2)\.bias$")


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


def check_knn_edge(x, k, forms=None):
    """Kernel B against its plain version in each (selection mode, output
    type, diff_only) of `forms`, by default all eight. The contract of the
    JAX package's packed test (tests/test_pallas.py, TestKnnEdgePacked):
    index agreement >= 0.995, every disagreement a near-tie within
    N * 2^-24 * 4 relative; where the indices agree the edge features must
    be equal exactly."""
    import itertools

    import torch
    from sp_gan_tpu_torch.ops.kernels.knn_edge import (knn_edge,
                                                       knn_edge_plain)
    from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist
    n = x.shape[1]
    d = None
    worst = {"agree": 1.0, "max_abs_err": 0.0}
    for mode, cd, diff_only in forms or itertools.product(
            ("packed", "exact"), (torch.bfloat16, torch.float32),
            (True, False)):
        ee, idx = knn_edge(x, k, cd, diff_only, mode)
        torch.cuda.synchronize()
        ee_p, idx_p = knn_edge_plain(x, k, cd, diff_only, mode)
        same = idx == idx_p
        agree = same.float().mean().item()
        tag = (f"knn_edge[{mode}, {str(cd)[6:]}, diff_only={diff_only}, "
               f"{list(x.shape)}]")
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


def profile_call(fn, label: str) -> dict:
    """Device time by kernel of one call of `fn` under torch.profiler, and
    the device's idle share of its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[2])
    busy = sum(ms for _, _, ms in rows)
    log(f"  profiled {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms, idle {100 * (1 - busy / wall_ms):.1f}%")
    for name, count, ms in rows[:12]:
        log(f"    {ms:8.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} "
            f"{name[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms,
            "top": [{"name": n[:120], "count": c, "ms": ms}
                    for n, c, ms in rows[:12]]}


def check_scatter(idx, gen) -> dict:
    """Kernel D against its plain version at idx's shape with C=64, in bf16
    and f32. Two launches must be bit-identical, and the kernel within
    1e-6 max|d_x| of the plain version run on CPU copies of the same
    inputs, which sums in the kernel's order (ascending source, central
    sum last). The plain version on the card (index_add_ with atomics, in
    no fixed order) is logged beside it."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.scatter import (scatter_diff_bwd,
                                                      scatter_diff_bwd_plain)
    B, N, k = idx.shape
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        dd = torch.randn(B, N, k, 64, generator=gen, device=idx.device).to(dt)
        a, b = scatter_diff_bwd(dd, idx), scatter_diff_bwd(dd, idx)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"scatter_diff_bwd[{dt}]: two launches "
                                 "differ")
        ref = scatter_diff_bwd_plain(dd.cpu(), idx.cpu())
        err = (a.cpu() - ref).abs().max().item()
        scale = ref.abs().max().item()
        card = (a - scatter_diff_bwd_plain(dd, idx)).abs().max().item()
        log(f"  scatter_diff_bwd[{str(dt)[6:]}, {list(dd.shape)}]: "
            f"max_abs_err {err} vs the plain version on the cpu (limit "
            f"{1e-6 * scale:.3g}), {card} vs the plain version on the card; "
            "bit-identical over two launches")
        if not err <= 1e-6 * scale:
            raise AssertionError(f"scatter_diff_bwd[{dt}]: error {err}")
        worst = max(worst, err)
    return {"max_abs_err": worst, "deterministic": True}


def check_edge_op(x, k, gen) -> dict:
    """The autograd edge op (kernel B forward, kernel D backward) against
    a plain autograd graph on CPU copies: gather by the kernel's indices
    (kernel B's selection is checked against its plain version above),
    `nbr - central` rounded as kernel B rounds it in the forward and
    differentiated in f32 (index backward, sum over k). Edges must be
    equal and d_x within 1e-6 max|d_x|."""
    import torch
    from sp_gan_tpu_torch.ops.edge import edge_diff_fused
    worst = 0.0
    for cd in (torch.bfloat16, torch.float32):
        xg = x.detach().clone().requires_grad_()
        diff, idx = edge_diff_fused(xg, k, cd)
        # the edges' cotangent arrives in their own type
        g = torch.randn(diff.shape, generator=gen, device=x.device) \
            .to(cd).float()
        (diff.float() * g).sum().backward()
        torch.cuda.synchronize()
        xc = x.detach().cpu().requires_grad_()
        nbr = xc[torch.arange(x.shape[0])[:, None, None], idx.cpu().long()]
        exact = nbr - xc[:, :, None, :]
        fwd = (nbr.to(cd) - xc.to(cd)[:, :, None, :]).float()
        ((fwd.detach() + exact - exact.detach()) * g.cpu()).sum().backward()
        if not torch.equal(diff.float().cpu(), fwd.detach()):
            raise AssertionError(f"edge op[{cd}]: edges differ")
        err = (xg.grad.cpu() - xc.grad).abs().max().item()
        scale = xc.grad.abs().max().item()
        log(f"  edge op[{str(cd)[6:]}]: edges equal, d_x max_abs_err {err} "
            f"(limit {1e-6 * scale:.3g})")
        if not err <= 1e-6 * scale:
            raise AssertionError(f"edge op[{cd}]: d_x error {err}")
        worst = max(worst, err)
    return {"max_abs_err": worst}


def small_step(device, cfg, G0, D0, sphere, real, z_d, z_g, pinned=None):
    """One training step of copies of G0 and D0 on `device`, recording
    EdgeConv2's inputs and selections, the max pools' inputs, both
    phases' gradients, the D-phase fakes, the G-phase fakes and D right
    after its Adam step. With `pinned` (a record of another run), the
    D phase takes that run's fakes and D takes its weights right after
    D's Adam step, so that each phase here sees the other run's inputs."""
    import copy

    import torch
    from sp_gan_tpu_torch.ops import edge as edge_mod
    from sp_gan_tpu_torch.train import step as step_mod
    from sp_gan_tpu_torch.train.state import create_train_state
    G, D = copy.deepcopy(G0), copy.deepcopy(D0)
    state = create_train_state(cfg, device=device, G=G, D=D)
    rec = {"knn": [], "pools": [], "grads": [], "fakes": []}
    fused, apply = edge_mod.edge_diff_fused, step_mod._apply

    def recording_fused(x, k, out_dtype=None):
        diff, idx = fused(x, k, out_dtype)
        rec["knn"].append((x.detach().cpu(), idx.cpu()))
        return diff, idx

    def recording_apply(opt, params, grads, lr, nan_guard):
        rec["grads"].append([g.detach().cpu() for g in grads])
        apply(opt, params, grads, lr, nan_guard)
        if opt is state.d_opt:
            rec["d_after"] = [p.detach().cpu().clone()
                              for p in D.parameters()]
            if pinned is not None:
                with torch.no_grad():
                    for p, v in zip(D.parameters(), pinned["d_after"]):
                        p.copy_(v)

    def fakes(m, a, out):
        rec["fakes"].append(out.detach().cpu())
        if pinned is not None and len(rec["fakes"]) == 1:
            return pinned["fakes"][0].to(out.device)      # the D phase's

    G.register_forward_hook(fakes)
    G.adain2.register_forward_hook(
        lambda m, a, out: rec["pools"].append(out.detach().float().cpu()))
    D.bn_fc2.register_forward_pre_hook(
        lambda m, a: rec["pools"].append(a[0].detach().float().cpu()))
    edge_mod.edge_diff_fused, step_mod._apply = recording_fused, \
        recording_apply
    try:
        step = step_mod.make_train_step(cfg, sphere)
        state, m = step(state, torch.as_tensor(real, device=device),
                        torch.as_tensor(z_d, device=device),
                        torch.as_tensor(z_g, device=device))
    finally:
        edge_mod.edge_diff_fused, step_mod._apply = fused, apply
    rec["loss"] = {k: float(m[k]) for k in ("d_loss", "g_loss")}
    rec["g_params"] = [p.detach().cpu() for p in G.parameters()]
    rec["stats"] = [b.detach().cpu() for b in
                    list(G.buffers()) + list(D.buffers())]
    rec["names"] = ([n for n, _ in D.named_parameters()],
                    [n for n, _ in G.named_parameters()])
    return rec


def rel_max(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def grads_worst(names, ours, ref) -> dict:
    """The largest elementwise error over each tensor's max-abs (for a
    bias that feeds a training BatchNorm, whose exact gradient is 0, over
    its kernel's) and the largest relative L2 error, with their tensors."""
    worst = {"elem": (0.0, ""), "l2": (0.0, "")}
    for name, a, b in zip(names, ours, ref):
        scale = float(b.abs().max())
        if PRE_BN_BIAS.search(name):
            kern = ref[names.index(name[:-4] + "kernel")]
            scale = max(scale, float(kern.abs().max()))
        else:
            worst["l2"] = max(worst["l2"], (float((a - b).norm())
                                            / float(b.norm()), name))
        worst["elem"] = max(worst["elem"],
                            (float((a - b).abs().max()) / scale, name))
    return worst


def check_small_step(seed: int) -> dict:
    """One float32 step at N=256, bs=4, nk=8 on the card against the same
    step (same weights, batch and codes) of the port on the CPU. Each CPU
    phase takes the card's inputs: the D phase the card's fakes, the G
    phase the card's D after its Adam step (Adam turns a near-zero
    gradient's rounding noise into +-lr). Then d_loss within 1e-5 and
    g_loss within 5e-5 relative, weights after the step within
    2 lr + 2e-6 and running statistics within 2e-4, as in
    tests/test_torch_train_step.py. The gradients are held to the step's
    conditioning between the two devices, which is looser than between
    the port and JAX on one CPU: cuBLAS and the CPU's f32 products round
    differently, BatchNorm over 4 shapes amplifies that to 2e-5 to 8e-5 of
    the generated clouds, and leaky ReLU inputs within rounding of 0 take
    the other slope, which moves single elements by up to their size.
    Over seeds 0-25 on the H100 the worst readings were: D's gradients
    5.2e-2 of a tensor's max-abs and 8.9e-3 relative L2, G's 2.4e-1 and
    3.8e-2; they are held to twice that, 1e-1 and 2e-2 (D), 5e-1 and 8e-2
    (G). The relative L2 is the check of the bulk; the elementwise limit
    catches a wrong sign or scale of a tensor's largest entries.

    D's pools in the D phase see the same inputs on both devices up to D's
    own rounding; a flip there must lie where the channel's inputs agree
    within 1e-3 of its max-abs, and as it moves a column of D's gradients,
    they are then not compared ("d_flips"). The generator's selections
    (EdgeConv2's kNN, then the global pool, then in the G phase D's pool
    of the fakes) form a chain in each phase: the first flip of a chain
    must lie where the devices' inputs to it agree within 1e-3 of their
    max-abs, and the later ones follow from it. Such a flip moves G's
    statistics, fakes and gradient columns, so then only the D phase is
    compared ("g_flips") and the caller takes another seed."""
    import numpy as np
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.data import SyntheticDataset, sphere_template
    from sp_gan_tpu_torch.nn import Discriminator, Generator
    cfg = Config(np=256, bs=4, nk=8, dtype="float32")
    G0, D0 = Generator(cfg, seed=seed), Discriminator(cfg, seed=seed + 1)
    rng = np.random.default_rng(seed)
    z_d, z_g = (np.broadcast_to(rng.standard_normal((4, 1, cfg.nz)) * cfg.nv,
                                (4, cfg.np, cfg.nz)).astype(np.float32)
                for _ in range(2))
    real = SyntheticDataset(4, cfg.np, seed=seed).data
    sphere = sphere_template(cfg.np)
    card = small_step("cuda", cfg, G0, D0, sphere, real, z_d, z_g)
    cpu = small_step("cpu", cfg, G0, D0, sphere, real, z_d, z_g,
                     pinned=card)
    res = {"seed": seed, "fake2": rel_max(card["fakes"][1],
                                          cpu["fakes"][1]),
           "d_flips": 0, "g_flips": 0, "flip_input_err": 0.0, "fail": []}
    def flips(what, i):
        """(flipped entries, the inputs' disagreement over their max-abs)
        of selection `i`: EdgeConv2's kNN in the D, G phase (0, 1); the
        pools of G, D on the real batch, D on the fakes (D phase: 0, 1, 2)
        and of G, D (G phase: 3, 4)."""
        if what == "knn":
            (x, a), (xc, b) = card["knn"][i], cpu["knn"][i]
        else:
            x, xc = card["pools"][i], cpu["pools"][i]
            a, b = x.argmax(1), xc.argmax(1)
        return int((a != b).sum()), rel_max(x, xc)

    for i in (1, 2):            # D's pools on inputs both devices share
        ha, hb = card["pools"][i], cpu["pools"][i]
        ia, ib = ha.argmax(1), hb.argmax(1)
        if not torch.equal(ia, ib):
            res["d_flips"] += int((ia != ib).sum())
            b, c = torch.nonzero(ia != ib, as_tuple=True)
            chan = ((ha - hb).abs().amax(1) / hb.abs().amax(1))[b, c].max()
            if float(chan) > 1e-3:
                res["fail"].append(f"D's pool {i} flips where its inputs "
                                   f"differ by {float(chan)} of the "
                                   "channel's max-abs")
    # the generator's selections in each phase, in the order they run: a
    # flip changes the inputs of the later ones, so the first flip of each
    # chain must be a near-tie
    for chain in ((("knn", 0), ("pool", 0)),
                  (("knn", 1), ("pool", 3), ("pool", 4))):
        first = True
        for what, i in chain:
            n, err = flips(what, i)
            if n:
                res["g_flips"] += n
                if first:
                    res["flip_input_err"] = max(res["flip_input_err"], err)
                first = first and not n
    if res["flip_input_err"] > 1e-3:
        res["fail"].append(f"a selection flips where its inputs differ by "
                           f"{res['flip_input_err']} of their max-abs")
    d_ok, g_ok = not res["d_flips"], not res["g_flips"]
    ok = True
    for key, rel, always in (("d_loss", 1e-5, True), ("g_loss", 5e-5, g_ok)):
        if always:
            a, b = card["loss"][key], cpu["loss"][key]
            res[key] = abs(a - b) / abs(b)
            ok &= res[key] <= rel
    lr2 = 2 * cfg.lr_g + 2e-6
    for what, xs, ys, tol, always in (
            ("d_after", card["d_after"], cpu["d_after"], lr2, True),
            ("g_params", card["g_params"], cpu["g_params"], lr2, g_ok),
            ("stats", card["stats"], cpu["stats"], 2e-4, g_ok)):
        if always:
            res[what] = max(float((x - y).abs().max())
                            for x, y in zip(xs, ys))
            ok &= res[what] <= tol
    for phase, tag, elem, l2, always in ((0, "d_grads", 1e-1, 2e-2, d_ok),
                                         (1, "g_grads", 5e-1, 8e-2, g_ok)):
        if always:
            res[tag] = grads_worst(card["names"][phase],
                                   card["grads"][phase], cpu["grads"][phase])
            ok &= res[tag]["elem"][0] <= elem and res[tag]["l2"][0] <= l2
    if not ok:
        res["fail"].append("beyond the step-parity tolerances")
    log(f"  small step (N=256, bs=4, f32) cuda vs cpu: {res}"
        + ("" if d_ok else "; D's gradients not compared (flips in D)")
        + ("" if g_ok else "; only the D phase compared (flips in G)"))
    return res


def check_small_steps(seed: int, need: int) -> list:
    """`check_small_step` from `seed` on, one seed after another, until
    `need` seeds had D's and `need` seeds G's gradients compared (at most
    4 * need + 4 seeds: G's were compared in 9 of seeds 0-25), then fails
    if any seed failed or too few were compared. Every seed's readings are
    logged first."""
    runs = []

    def compared(tag):
        return sum(tag in r for r in runs)

    for s in range(seed, seed + 4 * need + 4):
        runs.append(check_small_step(s))
        if min(compared("d_grads"), compared("g_grads")) >= need:
            break
    failed = [(r["seed"], r["fail"]) for r in runs if r["fail"]]
    if failed:
        raise AssertionError(f"small step: cuda and cpu disagree: {failed}")
    if min(compared("d_grads"), compared("g_grads")) < need:
        raise AssertionError(f"small step: gradients compared in fewer "
                             f"than {need} of {len(runs)} seeds")
    return runs


def train_phase(seed: int, step_seeds: int) -> dict:
    """Default training steps on the card through `Trainer.time_steps`
    (the trainer's batches: a device-resident gather and a per-cloud point
    shuffle each step); see the module docstring."""
    import numpy as np
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.ops import kernels
    from sp_gan_tpu_torch.train.trainer import Trainer, synthetic_dataset
    cfg = Config(seed=seed)
    tr = Trainer(cfg, dataset=synthetic_dataset(cfg), device="cuda",
                 logs=False)
    start = [p.detach().clone() for p in
             list(tr.state.G.parameters()) + list(tr.state.D.parameters())]
    run = tr.time_steps(TIMED_STEPS, WARMUP_STEPS,
                        before=kernels.reset_launch_counts)
    launches = kernels.launch_counts()
    losses = [[m[k] for k in ("d_loss", "g_loss")] for m in run["metrics"]]
    log(f"  {TIMED_STEPS} timed steps: {run['ms_per_step']:.3f} ms/step;"
        f" launches {launches}; d_loss, g_loss first {losses[0]}, last "
        f"{losses[-1]}")
    for name, per in PER_STEP.items():
        if launches[name] != per * TIMED_STEPS:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{TIMED_STEPS} steps, expected "
                                 f"{per * TIMED_STEPS}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite losses {losses}")
    now = list(tr.state.G.parameters()) + list(tr.state.D.parameters())
    moved = sum(not torch.equal(a, b) for a, b in zip(start, now))
    if moved != len(now):
        raise AssertionError(f"only {moved} of {len(now)} weight tensors "
                             "moved")
    small = check_small_steps(seed, step_seeds)
    prof = profile_call(lambda: tr.time_steps(1), "training step")
    return {"ms_per_step": run["ms_per_step"],
            "steps_per_sec": run["steps_per_sec"],
            "points_per_sec": run["points_per_sec"],
            "launches": launches,
            "launches_per_step": {k: v / TIMED_STEPS
                                  for k, v in launches.items()},
            "small_step": small, "profile": prof}


def main() -> None:
    ap = argparse.ArgumentParser(description="GPU smoke test of the port")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generator's random weights and codes")
    ap.add_argument("--ckpt", default=None,
                    help="optional JAX checkpoint to serve instead of "
                    "random weights (Config() architecture)")
    ap.add_argument("--step_seeds", type=int, default=3,
                    help="seeds whose small card step must have G's "
                    "gradients compared with the CPU's")
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
    # the training shape: EdgeConv2's input at bs=24
    x_t = torch.randn(cfg.bs, cfg.np, 64, generator=gen, device=dev)
    res_bt = check_knn_edge(x_t, k, [("packed", torch.bfloat16, True),
                                     ("exact", torch.bfloat16, True)])
    _, idx_t = kernels.knn_edge(x_t, k, torch.bfloat16, True, "packed")
    res_d = check_scatter(idx_t, gen)
    res_op = check_edge_op(x_t, k, gen)
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
    prof = profile_call(lambda: man.generate(64, seed=args.seed),
                        "request of 64 shapes")
    log(json.dumps({"serve": {"ms_per_request": serve_s * 1e3 / 2,
                              "launches": launches, "profile": prof}}))
    ph.end()

    # ---------------------------------------------------------------- 5
    ph.start("train")
    train = train_phase(args.seed, args.step_seeds)
    log(json.dumps({"train": {k: train[k] for k in (
        "ms_per_step", "steps_per_sec", "points_per_sec", "launches",
        "launches_per_step", "small_step", "profile")}}))
    ph.end()

    # ---------------------------------------------------------------- 6
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
        library_ms=None, shape=[B, N, 3], path="serve"))
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
        library_ms=None, shape=[B, N, C], path="serve"))
    for mode in ("exact", "packed"):
        for cd in (torch.float32, torch.bfloat16):
            ms = cuda_ms(lambda: knn_edge(x_b, k, cd, True, mode), 20)
            log(f"  knn_edge[{mode}, {str(cd)[6:]}, diff_only]: {ms:.3f} ms")
    # kernel B at the training shape [24, 2048, 64] -> bf16 diffs, packed
    Bt = x_t.shape[0]
    train_b = dict(out_dtype=torch.bfloat16, diff_only=True,
                   select_mode="packed")
    tb_bound, tb_by = bound(2 * Bt * N * N * C, Bt * N * C * 4
                            + Bt * N * k * C * 2 + Bt * N * k * 4)
    rows.append(dict(
        name="knn_edge", route="cuda",
        source="sp_gan_tpu_torch/csrc/knn_edge.cu",
        replaces="sp_gan_tpu/ops/pallas/knn.py:313 (knn_edge_pallas, "
                 "_knn_edge_kernel :177)",
        launches=train["launches"]["knn_edge"],
        launches_per_step=train["launches_per_step"]["knn_edge"],
        agree=res_bt["agree"], max_abs_err=res_bt["max_abs_err"],
        max_err=res_bt["max_abs_err"],
        ms=cuda_ms(lambda: knn_edge(x_t, k, **train_b), 20),
        plain_ms=cuda_ms(lambda: knn_edge_plain(x_t, k, **train_b), 5),
        bound_ms=tb_bound, bound_by=tb_by, library_ms=None,
        shape=[Bt, N, C], path="train"))
    # kernel D at the training shape: d_diff [24, 2048, 10, 64] bf16
    dd_t = torch.randn(Bt, N, k, C, generator=gen,
                       device=dev).to(torch.bfloat16)
    d_bound, d_by = bound(Bt * N * C * (2 * k + 1),
                          dd_t.numel() * 2 + idx_t.numel() * 4
                          + Bt * N * C * 4)

    def index_add_central():
        # for reference: the neighbor term by one index_add_, then the
        # central sum, which is what the plain version computes
        g = dd_t.float()
        out = torch.zeros(Bt * N, C, device=dev)
        tgt = idx_t.long() + N * torch.arange(Bt, device=dev)[:, None, None]
        out.index_add_(0, tgt.reshape(-1), g.reshape(-1, C))
        return out.reshape(Bt, N, C) - g.sum(2)
    log(f"  index_add_ + central sum at d_diff {list(dd_t.shape)}: "
        f"{cuda_ms(index_add_central, 20):.4f} ms")
    rows.append(dict(
        name="scatter_diff_bwd", route="cuda",
        source="sp_gan_tpu_torch/csrc/scatter.cu",
        replaces="sp_gan_tpu/ops/pallas/scatter.py:189 "
                 "(scatter_diff_bwd_pallas, _diff_bwd_kernel :125)",
        launches=train["launches"]["scatter_diff_bwd"],
        launches_per_step=train["launches_per_step"]["scatter_diff_bwd"],
        max_abs_err=res_d["max_abs_err"], max_err=res_d["max_abs_err"],
        edge_op_max_abs_err=res_op["max_abs_err"],
        ms=cuda_ms(lambda: kernels.scatter_diff_bwd(dd_t, idx_t), 50),
        plain_ms=cuda_ms(lambda: kernels.scatter_diff_bwd_plain(dd_t, idx_t),
                         20),
        bound_ms=d_bound, bound_by=d_by, library_ms=None,
        shape=[Bt, N, k, C], path="train"))
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
        per="one request: the edge1 and the edge2 call", calls=calls,
        path="serve"))
    for r in rows:
        log(f"  {r['name']} ({r['path']}): {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.3f} ms, "
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
