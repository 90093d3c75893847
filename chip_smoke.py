#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--ckpt PATH] [--step_seeds 3]

Phases, in order; any failure raises and the script exits nonzero:

1. device   - needs torch.cuda; prints the card's name and power limit.
2. build    - compiles the CUDA kernels (sp_gan_tpu_torch/csrc) with nvcc.
3. kernels  - each kernel against its plain PyTorch version on the card at
              the serving and training shapes; kernels A and B (the
              selection engine of csrc/knn_filter.cuh) bit for bit and
              twice alike, A also against kernel G, B in all eight forms,
              also on hard inputs at N=2048 (an integer grid, a cloud far
              from the origin, one point repeated, one point perturbed by
              an ulp or two, and for B the packed quantum cloud); the
              autograd edge op
              (kernel B forward, kernel D backward) against a plain
              autograd graph; kernel C's f32 mode (three TF32 products
              a product on the tensor cores) at both serving calls
              within 1e-5 + 1e-4 relative of its plain version and
              twice alike, also on the serving edges offset by +10 and
              scaled by 10; kernel F at the N=8192 campaign's shape,
              kernel G at N=16384 against kernel A and its plain version,
              bit for bit and twice alike, on the template, normal
              draws and hard inputs (an integer grid at C = 64 and 3,
              a cloud far from the origin, one point repeated),
              kernel H at the N=16384 approx step's shape and on a hard
              idx (a hub of in-degree over 4096, targets with no source,
              entries out of range; f32 and bf16, F = 3, 64, 128).
3b. last_kernels - kernel M (the concat edges' backward under
              SPGAN_EDGE_BWD=pallas) at d_ee [24, 2048, 10, 128] bf16 and
              f32 against its plain version on the CPU (1e-6 relative L2;
              bit-identical over two launches); chamfer_directed at
              [64, 2048, 3] (kernel N once, kernel H twice in the
              backward) with kernel N bit-equal to its plain version and
              the gradients bit-equal to the plain backward on the CPU,
              and at [24, 2048, 3] the dense route with no launch; kernel
              N also on hard inputs (duplicated points, a grid, x = y, a
              repeated point) and at C = 8 with N != M, bit-equal and
              twice alike; kernel O through auction(mode="jacobi"|"packed")
              at [4, 2048, 2048] in the metric regime, bit-equal to its
              plain version (assignments, rounds, bidders), twice alike
              and within N * eps of kernel E's cost, and on hard inputs:
              kernel E's tie-heavy pairs, [2, 256, 258] (scalar loads)
              and [40, 256, 256] (B * 4 above the SMs: no cluster).
4. serve    - the full-width generator (Config() defaults; weights drawn
              from --seed, or read from --ckpt) serves two requests of 64
              shapes through Manipulator.generate, which takes the fused
              eval path; every kernel must have launched as often as that
              path launches it. A small input is also checked against the
              CPU run of the port, and one more request runs under
              torch.profiler for the device time by kernel.
4b. manipulate - the nine manipulation routines on the same Manipulator
              with the CLI's arguments (`manipulate.run_routine`): each
              one's ms a call, its launches from counts of 0 (a fused
              forward PER_REQUEST; style_interpolate, the unfused eval
              path at B=1, kernels A and B once a step and C never),
              shapes and finiteness; rows whose codes no edit touched
              equal to `forward` of those codes within 1e-5 (and
              style_interpolate at alpha 0 to `Generator.forward`); then
              part_exchange, style_interpolate (3 steps) and a 2 x 3
              part_interpolate_detail on the card against the CPU on the
              same CPU-drawn codes in float32 (99% of the points within
              1e-3, the median within MANIPULATE_MEDIAN).
4c. checkpoints - the generator and a discriminator written as reference
              `.pth` files and read back into fresh modules, bit-equal; a
              Trainer warm-started from them (`--restore
              --pretrain_model_G/_D`) generating 64 shapes bit-equal to the
              Manipulator's, then one step with finite losses;
              `FPD.from_torch` on a reference-layout DGCNN state dict
              drawn from the seed.
5. train    - training steps at Config() defaults (bs=24, N=2048, weights
              from --seed) through Trainer.time_steps on the trainer's
              synthetic data: 3 warm-up steps, then 10 timed steps whose
              kernel launches must be those of the default step; finite
              losses, moved weights; small steps (N=256, bs=4, float32) on
              the card against the same steps on the CPU, seed after seed
              until --step_seeds of them compared G's gradients; one more
              step under torch.profiler.
5b. fused_train - kernels I-L (the fused train-mode EdgeBlock's statistics
              sweep and backward sweeps) and kernel C's bf16 mode against
              their plain versions at the default step's EdgeConv2 (bf16
              edges [24, 2048, 10, 128]) and at a small f32 shape, I-L
              and C's bf16 mode bit-identical over two launches; kernel
              B's concat bf16 form;
              the fused block under autograd against a plain autograd
              oracle on 24 draws, each held against the oracle on kernels
              J-L's own leaky ReLU slopes, the slope flips counted; 3 + 10
              --fused_train steps (per step B twice, I twice, C twice, J,
              K, L and D once) and 3 + 10
              --fused_dphase steps (B twice, I, C and D once), each
              profiled once (the --fused_train profile names the share of
              the step of J, K, L and C on the tensor cores, by part);
              small fused steps on the card against the CPU.
5c. regularizers - 2 + 5 steps at Config() width for each of
              REGULARIZERS: --fused_train with SPGAN_EDGE_BWD=pallas (M
              once a step, D never), --gan wgan --lambda_gp 10 with and
              without --gp_mapping, --mix (kernel E once a step) and
              --n_mix (R4: region-mixed codes, the default step's
              launches; its small steps on mixed codes), each
              with its launch counts, one profiled step and small steps on
              the card against the CPU.
6. metrics  - kernel E (the EMD auction) against its plain version on the
              card, bit for bit, at [4, 2048, 2048] and [2, 4096, 4096] in
              the protocol regime (eps 0.002, 10000 iterations, 4 phases)
              and the training regime (eps 0.005, 50, 1 phase), at R3's
              [24, 2048, 2048] and on hard inputs (tie-heavy pairs, [4,
              256, 256] at block width 16, M not a multiple of 4), each
              also bit-identical over two launches; its time per
              block-round of the slowest pair and that round's split; at
              N=256 its cost within N * eps of scipy's optimum; then the
              metric protocol, `compute_all_metrics(use_emd=True)`, on
              METRIC_CLOUDS generated clouds (normalized) against as
              many synthetic reference clouds at N=2048, and on 2 against
              2 synthetic clouds at N=4096, whose kernel launches must be
              those its batching implies; one launch of the protocol's
              own size ([256, 2048, 2048]) held against the plain version
              as above and timed by block-round; the protocol at S=4,
              N=256 on the card against the CPU; FPD with a seeded DGCNN;
              one more protocol run at half the clouds under
              torch.profiler.
7. largen_train - the N=8192 `--knn_mode approx` campaign's step
              (CAMPAIGN_N8192) through Trainer.time_steps on synthetic data:
              3 warm-up and 10 timed steps whose launches must be kernel F
              twice and kernel D once a step; small approx steps (N=384)
              on the card against the CPU; one profiled step.
8. largen_serve - generation at N=16384 (Config(np=16384), weights from
              --seed): two requests of 16 shapes through
              Manipulator.generate, each launching kernel G and kernel C
              twice; shapes, finiteness, radius; the card against the CPU
              at B=1; kernel G bit-equal to kernel A and its plain
              version on the 64-channel features the request hands it;
              kernel C's f32 mode on the edges the request hands it, as
              in phase 3; one profiled request, G's and C's launches
              named by pass.
9. largen_train_16k - approx training at N=16384, bs=2: a few steps whose
              EdgeConv2 band is plain PyTorch and whose gather backward is
              kernel H, once a step.
9b. trainer_parts - at Config() width, 3 + 10 steps on device data with
              and without --augment (the first under --watchdog_secs 120)
              and streamed from a host dataset of 45,000 clouds (1.1 GB,
              above the trainer's 1 GiB line) through the native gather and
              `prefetch_to_device`, with and without --augment: each with
              the default step's launches, ms a step against the
              device-data step's, 5 more steps profiled, and for the stream
              less than half the dataset's bytes left on the card; the
              prefetcher's batches equal to the host's; a subprocess whose
              second step stalls under --watchdog_secs 2 exits with 42;
              --save refused naming matplotlib where it is missing (one
              dump of 64 .xyz files and the PNG where it is present); the
              source snapshot written once and kept on --restore.
9c. emd_large - `emd_auction(scaled=True)` on one pair at N = M = 20,480
              (1.68 GB, past kernel E's 1 GiB line: `auction_scaled_jacobi`)
              in the protocol regime: seconds, rounds, distinct items, peak
              memory, every row within eps of its best item (float64), and
              if the rounds ended before the cap a bijection within N * eps
              of the dual; the same d run to its end (cap 100,000): a
              bijection, dual gap at most N * eps; at N = 16,384 (the
              line) kernel E through the route and `auction_scaled_jacobi`
              on the same d, both bijections, costs within N * eps;
              `auction_scaled_jacobi` at [2, 512, 512] on the card and on
              the CPU, assignments, prices and rounds equal.
9d. legacy  - the point-network layer library (plain PyTorch, no kernel)
              at the published widths of LEGACY: PointNet++ SSG's two set
              abstractions, MSG, feature propagation from 128 to 2048
              points, PointConv, the PointTransformer layer with its
              backward (B=24, N=2048); the expansion penalty with its
              backward (B=8, N=8192, 16 primitives of 512) and MDS on its
              cloud; the four reference losses: each call's card ms (CUDA
              events) and CPU seconds; floats, running statistics and
              gradients card against CPU within LEGACY_TOL (the modules
              with BatchNorm at the full batch, the rest on the first
              LEGACY_ROWS clouds); FPS, MDS, ball query, kNN, the MST
              assignment and the Chamfer matches equal or parted only at
              a near-tie (the first divergence and its gap reported);
              shape_preserving_loss's gradients against f64 on each
              side's matches.
9e. parallel - over a one-rank NCCL group (a FileStore in a temporary
              directory): the data-parallel step (`make_train_step` with a
              (1,) data mesh) at Config() width, PARALLEL_STEPS steps from
              the same state and batches as the one-device step, its
              losses and gradients held to the train phase's step-parity
              bounds, kernels B and D launched as the default step
              launches them; the point-sharded step on a (1, 1) mesh at
              PARALLEL_16K (N 16384, bs 2), one step beside the one-device
              step, finite losses and the EdgeConv2 picks that differ
              counted, then each phase of the
              one-device step on the sharded run's inputs (d_loss within
              1e-5, g_loss within PARALLEL_16K_LOSS_TOL), and the
              point-sharded sampler at N 16384 against the one-device
              sampler (float32; 99% within PARALLEL_SAMPLE_P99, the
              median within MANIPULATE_MEDIAN); the point-sharded
              protocol (PARALLEL_PROTOCOL: 4 x 4 clouds of 2048 points)
              within PARALLEL_PROTOCOL_TOL of kernel E's, and its auction
              equal to `auction_scaled_jacobi` on a pair, a bijection.
              With two
              cards or more, that many NCCL ranks run the data-parallel
              step against the one-card step; else the line `parallel
              multi-card: not run (1 card)`.
9f. wide_k - kernels A, G, B and F past k = 32 (lists of 64, slice
              21): at k = 33, 40 and 64 each bit-equal to its plain
              version and twice alike on normal draws at the paths' shapes
              (A on the template [64, 2048, 3], B at serving's and the
              training step's shapes, F at P1's, G at a P2 request's) and
              on the hard inputs of phase 3 (knn_hard with the quantum
              cloud, the quantum band in all eight forms of F,
              knn_blocked_hard), F also at k = 2W; B's, F's and G's
              margins swept at k = 40; k = 65 refused by every wrapper,
              naming the limit; kernel D bit-equal at the --nk 80 step's
              call; at --nk 80: the default Config through Trainer.train
              (3 steps) and Trainer.time_steps, P1 (CAMPAIGN_N8192), each
              with its launches (B or F twice, D once a step), finite
              losses and one profiled step; style_interpolate at N=2048
              (A, B once a step) and N=16384 (G twice a step), the path
              that takes A and G past k = 32 before kernel C does; small
              --nk 80 steps against the CPU with EdgeConv2's selections
              pinned; ptxas's registers and spills of every KM = 64
              instantiation; the k = 40 rows of the kernels line.
10. timings - median kernel times (CUDA events) beside their plain
              versions, the card's bound for the same work and, where one
              PyTorch call computes the same function, that call's time;
              kernel C's f32 mode at both calls of a serving request and
              of a P2 request (its bound the route's own work: three TF32
              products at the TF32 peak, the f32 FMA bound beside it; its
              serving call split by launch from the serving profile);
              I-L and C's bf16 mode at the --fused_train step's shape (I,
              J, K, L and C also split by launch, from the profiled
              --fused_train step: tile pass, d_u product, wout's bf16
              pair, weight-gradient products, contraction, reductions); M,
              N and O at the shapes of phase 3b; kernel H pass by pass
              (the profiler's device time of each of its kernels); kernel G
              on the template, normal draws and P2's own features, and
              its filter's margin swept from the wrapper's down to none on
              the 64-channel inputs (none must break the offset cloud);
              kernels A and B with the pairs they fold exactly
              (`refined`) and their bounds by route, B's margin swept
              the same way in packed mode.

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
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# published H100 SXM peaks (NVIDIA data sheet) for the bound column
F32_FLOPS = 67e12          # f32 outside the tensor cores, an FMA as two
F32_OPS = F32_FLOPS / 2    # f32 instructions that are not FMAs (sub, max)
TF32_FLOPS = 495e12        # dense TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12


# the port's kernels A to O by wrapper name (sp_gan_tpu_torch.ops.kernels)
KERNEL_NAMES = ("knn", "knn_edge", "edge_tail", "scatter_diff_bwd", "auction",
                "knn_edge_window", "knn_blocked", "scatter_add",
                "edge_train_stats2", "edge_train_bwd1", "edge_train_bwd2",
                "edge_train_bwd3", "edge_scatter_bwd", "chamfer_nn",
                "jacobi_auction")


def per(**launches) -> dict:
    """Launches of every kernel on a path, 0 where not given."""
    return {name: launches.get(name, 0) for name in KERNEL_NAMES}


# kernel launches per request of the fused eval path: EdgeConv1 selects
# with kernel A, EdgeConv2 with kernel B, and each runs its tail as kernel C
PER_REQUEST = per(knn=1, knn_edge=1, edge_tail=2)
# kernel launches per default training step: EdgeConv2's kNN and diff
# edges (kernel B) in the D phase and in the G phase, and their backward
# (kernel D) in the G phase; EdgeConv1 runs on the template's run-constant
# edges, and sampling (kernels A and C) is not part of the step
PER_STEP = per(knn_edge=2, scatter_diff_bwd=1)
# the N=8192 approx campaign (runs/campaign_n8192_approx/config.json): the
# fields of its training step that differ from Config()
CAMPAIGN_N8192 = dict(np=8192, bs=4, nk=20, knn_mode="approx",
                      knn_window=512, ema=True)
# per step of it: EdgeConv2's banded kNN and diff edges (kernel F) in both
# phases and their backward (kernel D) in the G phase
PER_STEP_APPROX = per(knn_edge_window=2, scatter_diff_bwd=1)
# per request of 16 shapes at N=16384: above 8192 points both EdgeConvs
# select with kernel G; both tails run as kernel C
SERVE_16K, REQUEST_16K = 16384, 16
PER_REQUEST_16K = per(knn_blocked=2, edge_tail=2)
# per approx step at N=16384, bs=2: above 8192 points the band is plain
# PyTorch and the gather's backward (a 10.7 GB one-hot in JAX) kernel H, in
# the G phase
TRAIN_16K = dict(np=16384, bs=2, knn_mode="approx")
PER_STEP_16K = per(scatter_add=1)
STEPS_16K = 3
# per --fused_train step: EdgeConv2's concat edges (kernel B) and the fused
# forward (kernel I, then kernel C in bf16 mode) in each phase; the three
# backward sweeps (J, K, L) and the concat edges' backward (kernel D) in
# the G phase
PER_STEP_FUSED = per(knn_edge=2, edge_train_stats2=2, edge_tail=2,
                     edge_train_bwd1=1, edge_train_bwd2=1, edge_train_bwd3=1,
                     scatter_diff_bwd=1)
# per --fused_dphase step: the fused forward in the D phase (kernel B's
# concat edges, I, C); the default G phase (kernel B's diff edges, D)
PER_STEP_DPHASE = per(knn_edge=2, edge_train_stats2=1, edge_tail=1,
                      scatter_diff_bwd=1)
# EdgeConv2's conv biases feed train-mode BatchNorms: the fused backward
# gives them exactly zero gradient, so Adam leaves them in place
FUSED_STILL = ("edge2.conv_w1.bias", "edge2.conv_w2.bias",
               "edge2.conv_x.bias")
# per --fused_train step under SPGAN_EDGE_BWD=pallas: kernel M takes kernel
# D's place as the backward of EdgeConv2's concat edges
PER_STEP_FUSED_M = {**PER_STEP_FUSED, "scatter_diff_bwd": 0,
                    "edge_scatter_bwd": 1}
# the WGAN critic loss mean(D(fake)) - mean(D(real)) gives D's last bias
# exactly zero gradient, and the penalty does not depend on it
WGAN_STILL = ("D.head4.bias",)
# the D phase's regularizers and the concat edges' kernel M backward at
# Config() width: label -> (flags, environment, kernel launches per step,
# weights that must stay); CutMix runs kernel E once a step (one phase,
# eps 0.005, 50 rounds), the EMD pairing of --gp_mapping is plain PyTorch
REGULARIZERS = {
    "--fused_train, SPGAN_EDGE_BWD=pallas": (
        dict(fused_train=True), {"SPGAN_EDGE_BWD": "pallas"},
        PER_STEP_FUSED_M, FUSED_STILL),
    "--gan wgan --lambda_gp 10": (
        dict(gan="wgan", lambda_gp=10.0), {}, PER_STEP, WGAN_STILL),
    "--gan wgan --lambda_gp 10 --gp_mapping": (
        dict(gan="wgan", lambda_gp=10.0, gp_mapping=True), {}, PER_STEP,
        WGAN_STILL),
    "--mix": (dict(mix=True), {}, per(knn_edge=2, scatter_diff_bwd=1,
                                      auction=1), ()),
    # R4: region-mixed codes in both phases; the mixing is PyTorch on the
    # template's rows, so the step's kernels are the default step's
    "--n_mix": (dict(n_mix=True), {}, PER_STEP, ()),
}
# the manipulation routines with the CLI's defaults (steps 6, the mask
# region_mask(ball, 0, N // 3)): routine -> (fused forwards a call, shapes
# a call); style_interpolate runs no fused forward but one
# Generator.forward at B=1 a step, each launching PER_STYLE_STEP
MANIPULATE = {"correspondence": (1, 4), "interpolate": (1, 6),
              "part_interpolate": (1, 6), "style_interpolate": (0, 6),
              "part_interpolate_detail": (6, 30), "part_edit": (1, 5),
              "part_flip": (1, 8), "part_exchange": (1, 4),
              "edit_interpolate": (1, 6)}
MANIPULATE_STEPS = 6
# the median of the card-against-CPU gap of those routines at N=2048:
# 1e-5 holds at N=256 (check_small_reference); at N=2048 the medians read
# 7.2e-6 (part_exchange), 8.3e-6 (style_interpolate) and 1.6e-5 (the
# 2 x 3 part_interpolate_detail) on the H100, where near-tie neighbour
# swaps move the global max pool of some shapes (their max gaps 9e-3 to
# 6.6e-2); held to twice the largest, as P2's median is held to twice its
# own
MANIPULATE_MEDIAN = 3.2e-5
# per step of style_interpolate (the unfused eval path at B=1):
# EdgeConv1 selects with kernel A and gathers in PyTorch (3 channels),
# EdgeConv2 runs kernel B's diff-only form; no tail kernel
PER_STYLE_STEP = per(knn=1, knn_edge=1)
# kernel N's path: chamfer_directed above B * N * M = 128 Mi takes it, at
# [24, 2048, 3] it computes the dense minima
CHAMFER_FUSED, CHAMFER_DENSE = (64, 2048, 3), (24, 2048, 3)
# published H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet): the
# bound of the bf16-mode matmuls
BF16_FLOPS = 989e12
# the small approx steps compared card against CPU: N=384 bands at W=48
SMALL_APPROX = dict(np=384, knn_mode="approx", knn_window=48)
# the metric protocol's two regimes: (eps, iters, eps-scaling phases)
PROTOCOL = (0.002, 10000, 4)
TRAIN_REGIME = (0.005, 50, 1)
# clouds of each side of the metric protocol's run at N=2048
METRIC_CLOUDS = 64
WARMUP_STEPS, TIMED_STEPS = 3, 10
# the regularizers phase's: its time follows the host more than its work
# (ROADMAP "Machines"), and five configurations share it
REG_WARMUP_STEPS, REG_TIMED_STEPS = 2, 5
# the point-network layer library (legacy phase) at published widths:
# PointNet++ SSG's two set abstractions, its MSG layer and its feature
# propagation from 128 to 2048 points (Common/pointnet_util.py), PointConv
# (Common/pointconv_util.py), the PointTransformer layer
# (Generation/modules.py:1602), MSN's expansion penalty (16 primitives of
# 512 points) and minimum-density sampling of 1024 points of its cloud,
# and the reference losses at their defaults (shape_preserving_loss k 20)
LEGACY_B, LEGACY_N = 24, 2048
LEGACY = {
    "sa": (dict(npoint=512, radius=0.2, nsample=32, mlp=(64, 64, 128)),
           dict(npoint=128, radius=0.4, nsample=64, mlp=(128, 128, 256))),
    "msg": dict(npoint=512, radii=(0.1, 0.2, 0.4), nsamples=(16, 32, 128),
                mlps=((32, 32, 64), (64, 64, 128), (64, 96, 128))),
    "fp": dict(mlp=(256, 128)),
    "pointconv": dict(npoint=512, nsample=32, mlp=(64, 64, 128),
                      bandwidth=0.1),
    "pt": dict(dim=64, k=16),
    "expansion": dict(B=8, N=8192, P=512, alpha=1.5),
    "mds": 1024,
    "sp_k": 20,
}
# card against CPU in the legacy phase: float outputs, running statistics
# and gradients within LEGACY_TOL of the CPU's largest entry (the two sum
# in other orders: cuBLAS against the CPU's GEMMs, parallel reductions);
# an integer output may part from the CPU's only where the two choices'
# f64 keys lie within NEAR_TIE of each other (relative)
LEGACY_TOL = 1e-4
NEAR_TIE = 1e-5
# clouds of the batch compared card against CPU where the clouds of a
# call do not meet (no BatchNorm): the CPU's share of the phase
LEGACY_ROWS = 6
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


def ptxas_report(text: str, width: int = 80) -> list:
    """One line per kernel of nvcc's `-Xptxas -v` report: its (mangled)
    name, cut to `width` characters, registers, stack frame and spill
    bytes."""
    out, name, spill = [], "?", ""
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spill = (f"stack {m.group(1)}, spill {m.group(2)}/{m.group(3)} "
                     "bytes")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name[:width]}: {m.group(1)} registers, {spill}")
    return out


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Median milliseconds of `fn()` over `reps` runs, each timed with CUDA
    events after one warm-up run (none with `warmup` False, for a plain
    version of seconds whose operations ran before)."""
    import torch
    if warmup:
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


def cuda_ms_back_to_back(fn, reps: int) -> float:
    """Milliseconds of `fn()` on the device when calls follow each other:
    CUDA events around `reps` calls (after one warm-up), divided by
    `reps`, so that the wrapper's host time hides behind the card's."""
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


def check_knn(x, k, label: str = ""):
    """Kernel A against its plain version and against kernel G (one code
    path: csrc/knn.cu on csrc/knn_filter.cuh), and against
    itself over two launches: indices and distances bit-equal (all compute
    the same FMA-free f32 distances and order them alike; the tensor-core
    filter above 4 channels only chooses which keys get that
    computation)."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.knn import knn, knn_plain
    from sp_gan_tpu_torch.ops.kernels.knn_blocked import knn_blocked
    idx, dist = knn(x, k)
    idx2, dist2 = knn(x, k)
    idx_g, dist_g = knn_blocked(x, k)
    torch.cuda.synchronize()
    idx_p, dist_p = knn_plain(x, k)
    tag = f"knn[{label}{list(x.shape)}, k={k}]"
    res = {"vs_plain": int((idx != idx_p).sum()) + int((dist != dist_p).sum()),
           "vs_g": int((idx != idx_g).sum()) + int((dist != dist_g).sum()),
           "vs_again": int((idx != idx2).sum()) + int((dist != dist2).sum()),
           "max_abs_err": (dist - dist_p).abs().max().item()}
    log(f"  {tag}: {res}")
    if res["vs_plain"] or res["vs_g"] or res["vs_again"]:
        raise AssertionError(f"{tag}: not bit-equal ({res})")
    return {"agree": 1.0, **res}


def check_knn_edge(x, k, forms=None, label: str = ""):
    """Kernel B against its plain version in each (selection mode, output
    type, diff_only) of `forms`, by default all eight, and against itself
    over two launches: indices and edge features bit-equal (both select on
    the same FMA-free f32 distances; the tensor-core filter above 4
    channels only chooses which keys get that computation, and both write
    the edges with the same roundings)."""
    import itertools

    import torch
    from sp_gan_tpu_torch.ops.kernels.knn_edge import (knn_edge,
                                                       knn_edge_plain)
    worst = {"agree": 1.0, "max_abs_err": 0.0, "vs_plain": 0, "vs_again": 0}
    for mode, cd, diff_only in forms or itertools.product(
            ("packed", "exact"), (torch.bfloat16, torch.float32),
            (True, False)):
        ee, idx = knn_edge(x, k, cd, diff_only, mode)
        ee2, idx2 = knn_edge(x, k, cd, diff_only, mode)
        torch.cuda.synchronize()
        ee_p, idx_p = knn_edge_plain(x, k, cd, diff_only, mode)
        tag = (f"knn_edge[{label}{mode}, {str(cd)[6:]}, diff_only="
               f"{diff_only}, {list(x.shape)}]")
        vs_plain = int((idx != idx_p).sum()) + int((ee != ee_p).sum())
        vs_again = int((idx != idx2).sum()) + int((ee != ee2).sum())
        err = (ee.float() - ee_p.float()).abs().max().item()
        log(f"  {tag}: {vs_plain} entries differ from the plain version, "
            f"{vs_again} between two launches")
        if vs_plain or vs_again:
            raise AssertionError(f"{tag}: not bit-equal")
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
    return worst


def quantum_cloud(n: int):
    """[1, n, 16] on the card: point 1000 at e1, every other point at -e1 +
    delta e2, so that every distance from point 1000 lies in one packed
    quantum [4, 4 + 2^-10) at n = 2048 and its packed top-k are the lowest
    columns, which its block walks last (tests/test_torch_knn_select.py
    shows that a filter comparing with the k-th distance, not tau_q, drops
    them)."""
    import torch
    x = torch.zeros(1, n, 16, device="cuda")
    x[0, :, 0] = -1.0
    delta2 = torch.full((n,), 0.5 * 2.0 ** -10, device="cuda")
    delta2[896:1024] = 1e-6 * (1 + torch.arange(128, device="cuda") / 128)
    delta2[:64] = 0.9 * 2.0 ** -10
    x[0, :, 1] = delta2.sqrt()
    x[0, 1000] = 0.0
    x[0, 1000, 0] = 1.0
    return x


def knn_hard(seed: int, n: int, k: int):
    """Kernels A and B on the inputs where a filter that broke its contract
    would show, at the serving request's N: an integer grid round(4 randn)
    (many exact ties), randn + 1000 (the margin then covers every
    distance), one point repeated (every distance 0), one point perturbed
    by an ulp or two (distances on both sides of 0; the packed key clamps
    those below), and for B the quantum cloud. B in all eight forms, A at
    C = 3 and C = 64. Draws from a generator of its own. Returns the
    checks' results and the 64-channel inputs, by name."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(b, c):
        return torch.randn(b, n, c, generator=gen, device="cuda")

    def near(c):
        point = (100 * r(1, c)[:, :1]).expand(2, n, c)
        ulps = torch.randint(-2, 3, (2, n, c), generator=gen,
                             device="cuda")
        return (point + ulps * torch.finfo(torch.float32).eps
                * point.abs()).contiguous()
    cases = {"grid": torch.round(4 * r(4, 64)),
             "offset": r(2, 64) + 1000,
             "repeat": r(1, 64)[:, :1].expand(2, n, 64).contiguous(),
             "near": near(64), "quantum": quantum_cloud(n)}
    res = {"B": {label: check_knn_edge(x, k, label=label + ", ")
                 for label, x in cases.items()},
           "A": {label: check_knn(x, k, label + ", ")
                 for label, x in (("grid", cases["grid"]),
                                  ("grid3", torch.round(4 * r(4, 3))),
                                  ("repeat3", r(1, 3)[:, :1]
                                   .expand(2, n, 3).contiguous()),
                                  ("near3", near(3)))}}
    return res, cases


# the margins of the filter (kernels B and F) that margin_sweep tries: the
# wrappers' (2^-12), smaller ones down to 2^-24, and none
SWEEP_MU = [2.0 ** -e for e in range(12, 25, 2)] + [0.0]


def margin_sweep(name: str, inputs: dict, launch, plain) -> dict:
    """A selection kernel on the engine's filter (B or F) launched with the
    filter's margin mu from SWEEP_MU (nu the wrapper's, 0 with mu = 0),
    `launch(x, mu, nu)` and `plain(x)` giving its and its plain version's
    indices, each input against the plain version's: the entries that
    differ at each mu, and the smallest mu at which every input, and at
    every larger mu, stayed bit-equal. The control: with mu = nu = 0 the
    cloud far from the origin ("offset") must differ."""
    from sp_gan_tpu_torch.ops.kernels.knn import FILTER_NU
    ref = {label: plain(x) for label, x in inputs.items()}
    differ = []
    for mu in SWEEP_MU:
        row = {label: int((launch(x, mu, FILTER_NU if mu else 0.0)
                           != ref[label]).sum())
               for label, x in inputs.items()}
        differ.append(row)
        log(f"  {name} packed margin mu={mu:.4g}: indices differing from "
            f"the plain version {row}")
    smallest = None
    for mu, row in zip(SWEEP_MU, differ):
        if any(row.values()):
            break
        smallest = mu
    log(f"  {name}: smallest margin exact on every input {smallest}")
    if not differ[-1]["offset"]:
        raise AssertionError(f"{name} with no margin equals its plain "
                             "version on the offset cloud: the check cannot "
                             "see a margin that fails")
    if any(differ[0].values()):
        raise AssertionError(f"{name} differs from its plain version at "
                             "the wrapper's margin")
    return {"mu": SWEEP_MU, "differ": differ, "smallest_exact_mu": smallest}


def b_margin_sweep(inputs: dict, k: int) -> dict:
    """Kernel B in packed mode (bf16 diffs, the training form) through
    `margin_sweep`."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.knn_edge import _launch, knn_edge_plain
    form = (torch.bfloat16, True, "packed")
    return margin_sweep(
        "knn_edge", inputs, lambda x, mu, nu: _launch(x, k, *form, mu, nu)[1],
        lambda x: knn_edge_plain(x, k, *form)[1])


def select_bound(pairs: int, B: int, N: int, C: int, nbytes: float,
                 keys: int = None):
    """(bound ms, what bounds it) of a selection of kernels A, B, G or F by
    its route: above 4 channels the three TF32 products of every pair on
    the tensor cores (channels padded to 16), each query against `keys`
    keys (N, or F's band of 2 W + 1), and for every pair it folds exactly
    (`pairs`, counted by the kernel) 2 C + 3 f32 operations that are not
    FMAs; `nbytes` moved once."""
    cp = -(-C // 16) * 16
    keys = N if keys is None else keys
    t_ops = (pairs * (2 * C + 3) / F32_OPS
             + (3 * 2 * B * N * keys * cp / TF32_FLOPS if C > 4 else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


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
    """Kernel C in f32 mode against its plain version (TF32 off): |err| <=
    1e-5 + 1e-4 |plain|, and two launches bit-identical. At the serving
    and P2 widths it runs on the tensor cores, each product as three TF32
    products (hi hi + hi lo + lo hi, each operand's lo its rounding error),
    which carry about 22 of an operand's bits; it sums in other orders
    than the plain version and takes exp from another library."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.edgeblock import (edge_tail,
                                                        edge_tail_plain)
    out, again = edge_tail(*args, k=k), edge_tail(*args, k=k)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError("edge_tail: two launches differ")
    ref = edge_tail_plain(*args, k=k)
    err = (out - ref).abs()
    excess = (err - (1e-5 + 1e-4 * ref.abs())).max().item()
    if not bool(torch.isfinite(out).all()) or excess > 0:
        raise AssertionError(f"edge_tail: max abs err {err.max().item()} "
                             f"on outputs up to {ref.abs().max().item()}")
    return {"max_abs_err": err.max().item(),
            "max_abs_out": ref.abs().max().item(), "gate_excess": excess}


# the hard inputs of kernel C's f32 mode: the serving edges offset by +10
# (the centre half far from 0) and scaled by 10 (the relative part of the
# gate binds), as tests/test_torch_edge_tail.py draws them
TAIL_HARD = {"offset +10": (10.0, 1.0), "scaled x10": (0.0, 10.0)}


def check_edge_tail_hard(tails: dict, k) -> dict:
    """check_edge_tail on each call's edges moved as TAIL_HARD says."""
    import torch
    res = {}
    for name, targs in tails.items():
        for label, (offset, scale) in TAIL_HARD.items():
            with torch.no_grad():
                ee = (targs[0] * scale + offset).contiguous()
            res[f"{name}, {label}"] = check_edge_tail((ee, *targs[1:]), k)
            log(f"  edge_tail[{name}, {label}]: {res[f'{name}, {label}']}")
            del ee
    return res


def bound(flops: float, nbytes: float, rate: float = F32_FLOPS):
    """(bound ms, what bounds it) from f32 operations at `rate` and bytes
    moved."""
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


# the launches of kernels J, K, L and C in bf16 mode
# (csrc/edgeblock_train_tc.cu) by the part of the entry point each runs;
# the tile, weight-gradient and sum kernels name their kernel by the pass
# number of their first template argument
TC_PARTS = {"tile": "tile pass", "du_gemm": "d_u product",
            "round": "bf16 rounding", "split": "wout's bf16 pair",
            "wg_gemm": "weight-gradient products",
            "tail_gemm": "contraction with wout", "sum": "reductions"}
TC_PASSES = {"0": "I", "1": "J", "2": "K", "3": "L", "4": "C"}
TC_OWN = {"du_gemm": "J", "round": "J", "split": "C", "tail_gemm": "C"}


# the launches of kernel C in f32 mode on the tensor cores
# (csrc/edgeblock_tf32.cu) by part
TF_PARTS = {"tile": "tile pass", "transpose": "wout transposed",
            "tail_gemm": "contraction with wout"}


def tf_part(name: str):
    """"C (f32): <part>" of a launch of kernel C's f32 mode on the tensor
    cores, else None."""
    m = re.search(r"\btf_(tile|transpose|tail_gemm)_kernel", name)
    return f"C (f32): {TF_PARTS[m.group(1)]}" if m else None


def tc_part(name: str):
    """"<kernel>: <part>" of a kernel's launch if it is one of I's, J's,
    K's, L's or C's in bf16 mode, else None."""
    m = re.search(r"\btc_(tile|du_gemm|round|split|wg_gemm|tail_gemm|sum)"
                  r"_kernel(<(\d+))?", name)
    if not m:
        return None
    part = m.group(1)
    return f"{TC_OWN.get(part) or TC_PASSES[m.group(3)]}: {TC_PARTS[part]}"


# idle seconds before the marker launch of each attempt of profile_call
# idle leads before a profile's marker kernel; in a run of this script
# on the H100 every profile after the first lost its marker at leads of
# 0.1 and 1.0 s and recorded it at 5 s, which made two attempts of every
# profile wasted work (about 3 s a profile, 14 profiles)
PROFILE_LEADS_S = (5.0, 20.0)


def profile_call(fn, label: str, group=None, expect=()) -> dict:
    """Device time by kernel of one call of `fn` under torch.profiler, and
    the device's idle share of its wall time; with `group` (a kernel's
    name -> a label or None), also the device time of each label.

    On the H100 machine, from about 80 s into this script on, the trace
    lost the launches of a profile's first moments: P2's request lost the
    first launches of its kNN, which a profile early in a process
    records. An idle lead of up to 5 s before the first launch avoided
    it. So each attempt idles for a lead,
    launches a marker kernel (`torch.cuda._sleep`, "spin_kernel", left out
    of the figures), then calls `fn`; an attempt that did not record the
    marker, or a kernel whose name holds a string of `expect`, is made
    again with the next lead, and after the last one the call raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for lead in PROFILE_LEADS_S:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(lead)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        lost = [m for m in ("spin_kernel",) + tuple(expect)
                if not any(m in n for n in names)]
        if not lost:
            break
        log(f"  profile of {label} after a lead of {lead} s recorded no "
            f"{lost}")
    else:
        raise AssertionError(f"profile of {label}: no record of {lost}")
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and "spin_kernel" not in e.key), key=lambda r: -r[2])
    busy = sum(ms for _, _, ms in rows)
    log(f"  profiled {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms, idle {100 * (1 - busy / wall_ms):.1f}%")
    for name, count, ms in rows[:12]:
        log(f"    {ms:8.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} "
            f"{name[:90]}")
    res = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall_ms,
           "top": [{"name": n[:120], "count": c, "ms": ms}
                   for n, c, ms in rows[:12]]}
    if group is not None:
        res["groups"] = {}
        for name, _, ms in rows:
            g = group(name)
            if g is not None:
                res["groups"][g] = res["groups"].get(g, 0.0) + ms
        log("    by group: " + ", ".join(
            f"{g} {ms:.3f} ms" for g, ms in res["groups"].items()))
    return res


def diff_bwd_reference(d_diff, idx):
    """Kernel D's function on CPU copies, entries of idx outside [0, N)
    dropped (their rows zeroed and sent to target 0: +0.0 changes no f32
    sum that starts at +0.0), every row's central sum kept; where idx is in
    range it is `scatter_diff_bwd_plain`, which sums in the kernel's order
    (ascending source, central sum last)."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.scatter import (scatter_add_plain,
                                                      scatter_diff_bwd_plain)
    g, idx = d_diff.cpu().float(), idx.cpu()
    B, N, k, C = g.shape
    oob = (idx < 0) | (idx >= N)
    if not oob.any():
        return scatter_diff_bwd_plain(g, idx)
    central = g[:, :, 0]
    for j in range(1, k):
        central = central + g[:, :, j]
    return scatter_add_plain(
        g.masked_fill(oob[..., None], 0.0).reshape(B, N * k, C),
        idx.masked_fill(oob, 0).reshape(B, N * k), N) - central


def hold_diff_bwd(tag: str, dd, idx) -> float:
    """Kernel D bit-equal (torch.equal) to `diff_bwd_reference` and to
    itself over two launches; returns the largest |d_x| difference from
    the plain version on the card (index_add_ with atomics, in no fixed
    order), logged beside it, where idx is in range."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.scatter import (scatter_diff_bwd,
                                                      scatter_diff_bwd_plain)
    a, b = scatter_diff_bwd(dd, idx), scatter_diff_bwd(dd, idx)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{tag}: two launches differ")
    if not torch.equal(a.cpu(), diff_bwd_reference(dd, idx)):
        raise AssertionError(f"{tag}: not bit-equal to the plain version "
                             "on the cpu")
    N = idx.shape[1]
    card = ((a - scatter_diff_bwd_plain(dd, idx)).abs().max().item()
            if bool(((idx >= 0) & (idx < N)).all()) else None)
    log(f"  {tag}: bit-equal to the plain version on the cpu and over two "
        f"launches; {card} from the plain version on the card")
    return card


def check_scatter(idx, gen) -> dict:
    """Kernel D against its plain version at idx's shape with C=64, in bf16
    and f32 (`hold_diff_bwd`): bit-equal to the plain version run on CPU
    copies of the same inputs and to itself over two launches."""
    import torch
    B, N, k = idx.shape
    for dt in (torch.bfloat16, torch.float32):
        dd = torch.randn(B, N, k, 64, generator=gen, device=idx.device).to(dt)
        hold_diff_bwd(f"scatter_diff_bwd[{str(dt)[6:]}, {list(dd.shape)}]",
                      dd, idx)
    return {"max_abs_err": 0.0, "deterministic": True}


def check_scatter_hard(gen) -> dict:
    """Kernel D on an idx that reaches its edge cases: [2, 2048, 10] with
    targets drawn from the first 1024 (the rest get no source), cloud 0's
    first 9000 sources on target 5 (in-degree over 9000), every 97th entry
    out of range (-1, N, 2^31 - 1, -2^31); d_diff in f32 and bf16 at C =
    3, 64 and 128, and a neighbour half at a row stride of 2C. Bit-equal
    to `diff_bwd_reference`, twice alike."""
    import torch
    B, N, k = 2, 2048, 10
    dev = gen.device
    idx = torch.randint(0, N // 2, (B, N * k), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[0, :9000] = 5
    bad = torch.tensor([-1, N, 2 ** 31 - 1, -2 ** 31], dtype=torch.int32,
                       device=dev)
    idx[:, ::97] = bad[torch.arange(idx[:, ::97].numel(), device=dev)
                       % 4].reshape(B, -1)
    idx = idx.reshape(B, N, k)
    res = []
    for C in (3, 64, 128):
        for dt in (torch.float32, torch.bfloat16):
            dd = torch.randn(B, N, k, C, generator=gen, device=dev).to(dt)
            hold_diff_bwd(f"scatter_diff_bwd hard[{str(dt)[6:]}, C={C}]", dd,
                          idx)
            res.append(f"{str(dt)[6:]}/C={C}")
    half = torch.randn(B, N, k, 128, generator=gen, device=dev)[..., 64:]
    hold_diff_bwd("scatter_diff_bwd hard[float32, half of 128]", half, idx)
    return {"bit_equal": res + ["float32/half of 128"],
            "in_degree_max": int((idx[0] == 5).sum()),
            "out_of_range": int(((idx < 0) | (idx >= N)).sum())}


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


def hold(tag, out, ref, l2_tol, again=None) -> dict:
    """A kernel's outputs against its plain version's: finite, each within
    `l2_tol` in relative L2 and at most 1e-4 of its elements farther than
    1e-2 of the tensor's max-abs (a leaky ReLU input within rounding of 0
    takes the other slope in one of the two, which moves that element's
    gradient by its size); with `again` (a second launch's outputs),
    bit-identical to it."""
    import torch
    worst = {"rel_l2": 0.0, "max_abs_err": 0.0, "rel_max": 0.0, "far": 0.0}
    for i, (a, r) in enumerate(zip(out, ref)):
        if again is not None and not torch.equal(a, again[i]):
            raise AssertionError(f"{tag}[{i}]: two launches differ")
        a, r = a.float(), r.float()
        err = (a - r).abs()
        scale = r.abs().max().item()
        res = {"rel_l2": (err.norm() / r.norm().clamp_min(1e-30)).item(),
               "max_abs_err": err.max().item(),
               "rel_max": err.max().item() / max(scale, 1e-30),
               "far": (err > 1e-2 * scale).float().mean().item()}
        if not (bool(torch.isfinite(a).all()) and res["rel_l2"] <= l2_tol
                and res["far"] <= 1e-4):
            raise AssertionError(f"{tag}[{i}]: {res} (limit {l2_tol})")
        for key in worst:
            worst[key] = max(worst[key], res[key])
    log(f"  {tag}: {worst}" + ("; bit-identical over two launches"
                               if again is not None else ""))
    return worst


def train_kernel_inputs(block, x, k, cd, gen) -> dict:
    """The arguments kernels I-L and C take at EdgeConv2 of the fused
    forward: the concat edges of x from kernel B in `cd`, the block's
    weights, the affines of the edges' batch statistics and a random d_out
    (J), then J's sums and d_u (K, L) and K's s1 (L) from the plain
    versions."""
    import torch
    from sp_gan_tpu_torch.ops import edgeblock_train as ebt
    from sp_gan_tpu_torch.ops.kernels import edgeblock_train as kt
    from sp_gan_tpu_torch.ops.kernels.knn_edge import knn_edge
    with torch.no_grad():
        ee = knn_edge(x, k, cd, False, "packed")[0]
        p = {n: t.detach().float() for n, t in
             ebt.block_params(block).items()}
        stats = ebt.edge_block_train_stats(p, ee, k)
        a1, a2, ax, gb2x, gb1 = ebt._fold_all(p, stats, 1e-5)
        w1, w2, wx, wout = ebt._weights(p)
        B, N, _ = x.shape
        d_out = torch.randn(B, N, w2.shape[1], generator=gen,
                            device=x.device)
        sums, _, _, d_u = kt.edge_train_bwd1_plain(
            ee, d_out, w1, a1, w2, a2, wx, ax, gb2x, wout, k)
        s1 = kt.edge_train_bwd2_plain(ee, d_u, w1, a1, w2, a2, wx, ax, gb2x,
                                      sums, gb1, k)[0]
    return dict(ee=ee, w1=w1, a1=a1, w2=w2, a2=a2, wx=wx, ax=ax, gb2x=gb2x,
                gb1=gb1, wout=wout, bout=p["out_bias"][None].contiguous(),
                d_out=d_out, sums=sums, d_u=d_u, s1=s1, k=k)


def train_kernel_calls(a: dict) -> dict:
    """{kernel: (wrapper, plain version, arguments)} of I-L and C."""
    from sp_gan_tpu_torch.ops.kernels import edgeblock_train as kt
    from sp_gan_tpu_torch.ops.kernels.edgeblock import (edge_tail,
                                                        edge_tail_plain)
    chain = (a["w1"], a["a1"], a["w2"], a["a2"], a["wx"], a["ax"])
    return {
        "edge_train_stats2": (kt.edge_train_stats2,
                              kt.edge_train_stats2_plain,
                              (a["ee"], a["w1"], a["a1"], a["w2"], a["k"])),
        "edge_tail": (edge_tail, edge_tail_plain,
                      (a["ee"], *chain, a["wout"], a["bout"], a["k"])),
        "edge_train_bwd1": (kt.edge_train_bwd1, kt.edge_train_bwd1_plain,
                            (a["ee"], a["d_out"], *chain, a["gb2x"],
                             a["wout"], a["k"])),
        "edge_train_bwd2": (kt.edge_train_bwd2, kt.edge_train_bwd2_plain,
                            (a["ee"], a["d_u"], *chain, a["gb2x"], a["sums"],
                             a["gb1"], a["k"])),
        "edge_train_bwd3": (kt.edge_train_bwd3, kt.edge_train_bwd3_plain,
                            (a["ee"], a["d_u"], *chain, a["gb2x"], a["sums"],
                             a["gb1"], a["s1"], a["k"])),
    }


# Kernel C's contraction in bf16 mode (out - bout) against its plain
# version's, in relative L2. wout as a bf16 pair keeps about 16 bits;
# rounded to one bf16 it puts about 2^-9 on each term, which the 5e-3 of
# the other bf16 outputs would not see.
TAIL_PAIR_TOL = 5e-4


def check_wout_pair(a: dict, out, ref) -> dict:
    """Kernel C's bf16 contraction within TAIL_PAIR_TOL of its plain
    version's, and the control, the plain version with wout rounded to one
    bf16, beyond it: the limit tells the pair from a single bf16."""
    from sp_gan_tpu_torch.ops.kernels.edgeblock import edge_tail_plain
    chain = (a["w1"], a["a1"], a["w2"], a["a2"], a["wx"], a["ax"])
    bout, ref = a["bout"], ref - a["bout"]
    single = edge_tail_plain(a["ee"], *chain, a["wout"].bfloat16().float(),
                             bout, a["k"])
    rel = lambda t: ((t - bout - ref).norm() / ref.norm()).item()
    res = {"rel_l2": rel(out), "single_bf16_rel_l2": rel(single),
           "limit": TAIL_PAIR_TOL}
    log(f"  edge_tail contraction (wout as a bf16 pair): {res}")
    if not res["rel_l2"] <= TAIL_PAIR_TOL < res["single_bf16_rel_l2"]:
        raise AssertionError(f"edge_tail: wout pair {res}")
    return res


def check_train_kernels(a: dict, l2_tol: float, label: str) -> dict:
    """I-L and kernel C against their plain versions on the same inputs
    (TF32 off); each bit-identical over two launches (fixed-order sums, no
    float atomics), C's bf16 contraction also by `check_wout_pair`. See
    `hold`."""
    import torch
    res = {}
    for name, (fn, plain, args) in train_kernel_calls(a).items():
        out, again = fn(*args), fn(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        as_list = lambda t: [t] if torch.is_tensor(t) else list(t)
        res[name] = hold(f"{name}[{label}]", as_list(out), as_list(ref),
                         l2_tol, as_list(again))
        if name == "edge_tail" and a["ee"].dtype == torch.bfloat16:
            res["wout_pair"] = check_wout_pair(a, out, ref)
    return res


def torch_edge_block_oracle(block, ee, k, neg=0.01, eps=1e-5, slopes=None,
                            pre=None):
    """Plain autograd train-mode EdgeBlock on the edge tensor, two-pass
    variance: the oracle of tests/test_edgeblock_train_fused.py
    (`xla_block_from_ee`), in torch. The three leaky ReLUs take their
    slopes from `slopes` (masks of where the input counts as >= 0) if
    given; `pre` (a list) receives their inputs."""
    import torch
    C2 = ee.shape[-1]
    masks = iter(slopes or ())

    def bn(h, norm):
        mean = h.mean(dim=(0, 1, 2))
        var = ((h - mean) ** 2).mean(dim=(0, 1, 2))
        return (h - mean) * torch.rsqrt(var + eps) * norm.scale + norm.bias

    def lrelu(v):
        if pre is not None:
            pre.append(v.detach())
        return torch.where(next(masks) if slopes else v >= 0, v, neg * v)
    h1 = ee[..., C2 // 2:] @ block.conv_w1.kernel + block.conv_w1.bias
    y1 = lrelu(bn(h1, block.bn_w1))
    h2 = y1 @ block.conv_w2.kernel + block.conv_w2.bias
    w = torch.softmax(lrelu(bn(h2, block.bn_w2)), dim=2)
    hx = ee @ block.conv_x.kernel + block.conv_x.bias
    u = lrelu(bn(hx, block.bn_x)) * w
    return torch.einsum("bnkc,kco->bno", u, block.out_kernel) \
        + block.out_bias


def kernel_slopes(block, ee, stats, neg=0.01, eps=1e-5) -> list:
    """Where the three leaky ReLU inputs are >= 0 as kernels J, K and L
    compute them (their gradients take these slopes): each product a chain
    of f32 FMAs over the input channels in ascending order from 0
    (`rows_dot` of csrc/edgeblock_train.cu), then p = fma(h, scale, shift)
    with the batch statistics folded by `_fold_all`, as the kernels take
    them. An FMA is taken in f64 (the product of two f32 exact, the sum
    rounded to f64, then to f32), which is the f32 FMA up to a double
    rounding (about 2^-29 of the operations)."""
    import torch
    from sp_gan_tpu_torch.ops import edgeblock_train as ebt
    f = {n: t.detach().float() for n, t in ebt.block_params(block).items()}
    a1, a2, ax, _, _ = ebt._fold_all(f, stats, eps)
    C2 = ee.shape[-1]
    rows = ee.reshape(-1, C2)

    def chain(x, W, a):
        W = W.double()
        h = torch.zeros(x.shape[0], W.shape[1], device=x.device)
        for i in range(W.shape[0]):
            h = (x[:, i, None].double() * W[i] + h).float()
        return (h.double() * a[0].double() + a[1]).float()
    p1 = chain(rows[:, C2 // 2:], f["conv_w1.kernel"], a1)
    p2 = chain(torch.where(p1 >= 0, p1, neg * p1), f["conv_w2.kernel"], a2)
    px = chain(rows, f["conv_x.kernel"], ax)
    return [(p >= 0).reshape(*ee.shape[:-1], -1) for p in (p1, p2, px)]


def fused_block_draw(block, ee, ct, k) -> dict:
    """`FusedEdgeBlock` under autograd against the oracle on one draw of
    edges and cotangent: the output's error over its max-abs, the conv
    biases' gradients, the leaky ReLU inputs that take another slope in
    the oracle than in kernels J-L ("flips", per ReLU, as gp_flips counts
    them; `kernel_slopes`) and the largest flipped input over its
    tensor's max-abs; then each parameter gradient's error over its
    max-abs and d_ee's relative L2 against the oracle ("grads", "d_ee");
    each gradient's error against the oracle on the kernels' slopes
    ("grads_replayed"), and d_ee with that oracle's ("_d_ee")."""
    import torch
    from sp_gan_tpu_torch.ops import edgeblock_train as ebt
    params = [p for _, p in block.named_parameters()]
    names = [n for n, _ in block.named_parameters()]
    e1 = ee.clone().requires_grad_()
    out, stats = ebt.fused_edge_block(ebt.block_params(block), e1, k)
    grads = torch.autograd.grad((out * ct).sum(), params + [e1])
    pre = []
    e2 = ee.clone().requires_grad_()
    ref = torch_edge_block_oracle(block, e2, k, pre=pre)
    ref_grads = torch.autograd.grad((ref * ct).sum(), params + [e2])
    with torch.no_grad():
        slopes = kernel_slopes(block, ee, {b: tuple(t.detach() for t in v)
                                           for b, v in stats.items()})
    flipped = [(h >= 0) != m for h, m in zip(pre, slopes)]
    res = {"out": ((out - ref).abs().max() / ref.abs().max()).item(),
           "flips": [int(f.sum()) for f in flipped],
           "flip_margin": max([float(h[f].abs().max() / h.abs().max())
                               for h, f in zip(pre, flipped) if f.any()],
                              default=0.0),
           "bias_grads_zero": all(
               not bool(g.any()) for n, g in zip(names, grads)
               if n.startswith("conv") and n.endswith("bias")),
           "grads": {}, "grads_replayed": {}}
    e3 = ee.clone().requires_grad_()
    rep = torch_edge_block_oracle(block, e3, k, slopes=slopes)
    rep_grads = torch.autograd.grad((rep * ct).sum(), params + [e3])
    for name, g, r, r2 in zip(names, grads, ref_grads, rep_grads):
        if not (name.startswith("conv") and name.endswith("bias")):
            res["grads"][name] = ((g - r).abs().max()
                                  / r.abs().max()).item()
            res["grads_replayed"][name] = ((g - r2).abs().max()
                                           / r2.abs().max()).item()
    res["d_ee"] = ((grads[-1] - ref_grads[-1]).norm()
                   / ref_grads[-1].norm()).item()
    res["_d_ee"] = (grads[-1], rep_grads[-1])
    torch.cuda.synchronize()
    return res


def check_fused_block_autograd(block, x, k, gen, draws: int = 24) -> dict:
    """`FusedEdgeBlock` (kernels I, C forward; J, K, L backward) under
    autograd on f32 concat edges against the plain autograd oracle on the
    card (TF32 off), `fused_block_draw` on `draws` draws of edges and
    cotangent (the first from x and gen, the rest from a generator of
    their own). A leaky ReLU input within rounding of 0 may take the other
    slope in kernels J-L than in the oracle (a flip), which moves a
    gradient by up to 1.1e-2 of its max-abs (measured at [4, 2048] on the
    H100). Every draw: the output within 1e-4 of its max-abs, the conv
    biases' gradients exactly zero, every flip at an input within 1e-5 of
    its tensor's max-abs, and against the oracle on the kernels' own
    slopes every parameter gradient within 1e-4 of its max-abs and d_ee
    held by `hold` at 1e-5 relative L2 (measured on draws without flips:
    the output
    2.1e-6, the gradients up to 1.2e-6, d_ee 3.3e-7). A draw without flips
    is that same comparison against the oracle itself; the check needs at
    least one, as the step checks take another seed after a pool flip."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.knn_edge import knn_edge
    ct = torch.randn(*x.shape[:2], block.fout, generator=gen,
                     device=x.device)
    own = torch.Generator(device=x.device).manual_seed(1234)
    rows = []
    for i in range(draws):
        if i:
            x = torch.randn(x.shape, generator=own, device=x.device)
            ct = torch.randn(ct.shape, generator=own, device=x.device)
        ee = knn_edge(x, k, torch.float32, False, "packed")[0]
        r = fused_block_draw(block, ee, ct, k)
        d_ee = r.pop("_d_ee")
        rows.append(r)
        log(f"  fused block autograd vs oracle [{list(ee.shape)}, f32], "
            f"draw {i}: out {r['out']:.3g}, flips {r['flips']} (within "
            f"{r['flip_margin']:.3g} of max-abs); gradients "
            f"{max(r['grads'].values()):.3g}, d_ee {r['d_ee']:.3g}; on the "
            f"kernels' slopes {max(r['grads_replayed'].values()):.3g}")
        bad = {n: e for n, e in r["grads_replayed"].items()
               if not e <= 1e-4}
        if not (r["out"] <= 1e-4 and r["bias_grads_zero"] and not bad
                and r["flip_margin"] <= 1e-5):
            raise AssertionError(
                f"fused block, draw {i}: out {r['out']}, conv bias "
                f"gradients zero {r['bias_grads_zero']}, gradient errors "
                f"on the kernels' slopes {bad}, flips {r['flips']} within "
                f"{r['flip_margin']} of max-abs")
        r["d_ee_replayed"] = hold(f"fused block d_ee, draw {i}, on the "
                                  "kernels' slopes", [d_ee[0]], [d_ee[1]],
                                  1e-5)["rel_l2"]
    plain = [r for r in rows if not sum(r["flips"])]
    log(f"  fused block autograd: {len(rows) - len(plain)} of {len(rows)} "
        f"draws with flips ({sum(sum(r['flips']) for r in rows)} inputs, "
        f"within {max(r['flip_margin'] for r in rows):.3g} of max-abs; "
        f"gradients up to {max(max(r['grads'].values()) for r in rows):.3g} "
        "from the oracle, up to "
        f"{max(max(r['grads_replayed'].values()) for r in rows):.3g} from "
        "it on the kernels' slopes)")
    if not plain:
        raise AssertionError(f"fused block: no draw of {draws} without a "
                             "leaky ReLU flip")
    return {"draws": rows, "without_flips": len(plain)}


def fused_train_phase(seed: int, step_seeds: int, gen) -> dict:
    """Kernels I-L and C's bf16 mode against their plain versions at the
    default training shape (bf16 edges: relative L2 within 5e-3; measured
    on the H100 3e-7 for I, 4.4e-5 for C, 1.8e-4 to 6.1e-4 for J-L, where
    the two sum orders straddle a bf16 rounding point and an operand moves
    by a bf16 ulp; J, K, L and C sum on the tensor cores; C's contraction
    within 5e-4, which wout rounded to one bf16 would miss) and at a small
    f32 shape (1e-5; measured at most 6.4e-7), kernel B's concat bf16
    form, the fused block under autograd against a plain oracle, then 3 +
    10 --fused_train and --fused_dphase steps at Config() defaults with
    their launch counts and one profiled step each, and small fused steps
    on the card against the CPU.
    Returns the readings and the default-shape inputs (for the timings)."""
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.nn.generator import Generator
    cfg = Config(seed=seed)
    G = Generator(cfg, seed=seed).cuda()
    k = cfg.k
    x = torch.randn(cfg.bs, cfg.np, 64, generator=gen, device="cuda")
    res = {"concat_bf16": check_knn_edge(x, k,
                                         [("packed", torch.bfloat16, False)])}
    full = train_kernel_inputs(G.edge2, x, k, torch.bfloat16, gen)
    res["full"] = check_train_kernels(full, 5e-3, f"{cfg.bs}x{cfg.np} bf16")
    small = train_kernel_inputs(G.edge2, x[:2, :256].contiguous(), k,
                                torch.float32, gen)
    res["small"] = check_train_kernels(small, 1e-5, "2x256 f32")
    res["autograd"] = check_fused_block_autograd(
        G.edge2, x[:4].contiguous(), k, gen)
    del small
    tr, res["fused_train"] = timed_training(
        Config(seed=seed, fused_train=True), TIMED_STEPS, WARMUP_STEPS,
        PER_STEP_FUSED, "--fused_train step", FUSED_STILL)
    # the tensor-core launches of I, C (two calls each), J, K and L (one
    # call each) in the profiled step, by part
    prof = res["fused_train"]["profile"] = profile_call(
        lambda: tr.time_steps(1), "--fused_train step", tc_part)
    prof["tc_split_ms"] = {}
    for key, ms in prof["groups"].items():
        kern, part = key.split(": ")
        prof["tc_split_ms"].setdefault(kern, {})[part] = ms
    prof["tc_share"] = {kern: sum(parts.values()) / prof["wall_ms"]
                        for kern, parts in prof["tc_split_ms"].items()}
    log("  kernels I, J, K, L and C's share of the profiled --fused_train "
        "step: " + ", ".join(
            f"{kern} {sum(parts.values()):.3f} ms ({100 * share:.1f}% of "
            f"{prof['wall_ms']:.3f} ms wall, "
            f"{100 * sum(parts.values()) / prof['device_busy_ms']:.1f}% of "
            "device busy)"
            for (kern, parts), share in zip(prof["tc_split_ms"].items(),
                                            prof["tc_share"].values())))
    del tr
    tr, res["fused_dphase"] = timed_training(
        Config(seed=seed, fused_dphase=True), TIMED_STEPS, WARMUP_STEPS,
        PER_STEP_DPHASE, "--fused_dphase step")
    res["fused_dphase"]["profile"] = profile_call(
        lambda: tr.time_steps(1), "--fused_dphase step", tc_part)
    del tr
    res["small_step"] = check_small_steps(seed, step_seeds,
                                          dict(fused_train=True))
    return res, full


def small_step(device, cfg, G0, D0, sphere, real, z_d, z_g, pinned=None,
               draws=None, pin_knn=False):
    """One training step of copies of G0 and D0 on `device` (the
    regularizers' `draws` handed to it), recording
    EdgeConv2's inputs and selections, the max pools' inputs, both
    phases' gradients, the D-phase fakes, the G-phase fakes and D right
    after its Adam step. With `pinned` (a record of another run), the
    D phase takes that run's fakes and D takes its weights right after
    D's Adam step, so that each phase here sees the other run's inputs.
    With `pin_knn` as well, EdgeConv2's diff edges (kernel B's or F's op)
    take the other run's selections (its plain versions' edge rounding and
    kernel D's backward), while its own are recorded."""
    import copy

    import torch
    from sp_gan_tpu_torch.ops import edge as edge_mod
    from sp_gan_tpu_torch.train import step as step_mod
    from sp_gan_tpu_torch.train.state import create_train_state
    from sp_gan_tpu_torch.nn import discriminator as disc_mod
    from sp_gan_tpu_torch.nn import fused_train as ft_mod
    G, D = copy.deepcopy(G0), copy.deepcopy(D0)
    state = create_train_state(cfg, device=device, G=G, D=D)
    rec = {"knn": [], "pools": [], "grads": [], "fakes": [], "lrelu": []}
    fused, window = edge_mod.edge_diff_fused, edge_mod.edge_diff_window
    concat, adain = edge_mod.edge_concat_fused, ft_mod._adain
    gft = step_mod.generator_forward_train
    apply = step_mod._apply
    lrelu = disc_mod.lrelu

    def recording_lrelu(x, slope):
        """D's leaky ReLUs (six a forward), recording their inputs."""
        rec["lrelu"].append(x.detach().float().cpu())
        return lrelu(x, slope)

    def recording(op, pin=False):
        """EdgeConv2's fused op (kernel B's diff or, on the fused train
        path, concat form, or kernel F's on the band of knn_mode approx),
        recording its input and selection; with `pin`, the diff form
        returns the pinned run's selection instead."""
        def run(x, *args):
            diff, idx = op(x, *args)
            rec["knn"].append((x.detach().cpu(), idx.cpu()))
            if pin:
                idx = pinned["knn"][len(rec["knn"]) - 1][1].to(idx.device)
                diff = PinnedEdgeDiff.apply(x, idx, diff.dtype)
            return diff, idx
        return run

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

    def recording_gft(*a, **kw):
        """The fused train-mode forward, with `fakes` as its hook."""
        out = gft(*a, **kw)
        res = fakes(None, None, out)
        return out if res is None else res

    def recording_adain(p, x, style):
        """The fused forward's AdaIN: G's pool input after adain2."""
        out = adain(p, x, style)
        if p is G.adain2:
            rec["pools"].append(out.detach().float().cpu())
        return out

    G.register_forward_hook(fakes)
    G.adain2.register_forward_hook(
        lambda m, a, out: rec["pools"].append(out.detach().float().cpu()))
    D.bn_fc2.register_forward_pre_hook(
        lambda m, a: rec["pools"].append(a[0].detach().float().cpu()))
    edge_mod.edge_diff_fused = recording(fused, pin_knn)
    edge_mod.edge_diff_window = recording(window, pin_knn)
    edge_mod.edge_concat_fused = recording(concat)
    ft_mod._adain = recording_adain
    step_mod.generator_forward_train = recording_gft
    step_mod._apply = recording_apply
    disc_mod.lrelu = recording_lrelu
    try:
        step = step_mod.make_train_step(cfg, sphere)
        state, m = step(state, torch.as_tensor(real, device=device),
                        torch.as_tensor(z_d, device=device),
                        torch.as_tensor(z_g, device=device),
                        {k: torch.as_tensor(v, device=device)
                         for k, v in (draws or {}).items()})
    finally:
        edge_mod.edge_diff_fused, edge_mod.edge_diff_window = fused, window
        edge_mod.edge_concat_fused, ft_mod._adain = concat, adain
        step_mod.generator_forward_train = gft
        step_mod._apply = apply
        disc_mod.lrelu = lrelu
    rec["loss"] = {k: float(m[k]) for k in ("d_loss", "g_loss")}
    rec["g_params"] = [p.detach().cpu() for p in G.parameters()]
    rec["stats"] = [b.detach().cpu() for b in
                    list(G.buffers()) + list(D.buffers())]
    rec["names"] = ([n for n, _ in D.named_parameters()],
                    [n for n, _ in G.named_parameters()])
    return rec


class PinnedEdgeDiff:
    """`nbr - central` at given indices, differentiable in x as the diff
    edges are (`ops.edge.EdgeDiff`: the plain edge rounding forward,
    kernel D or its plain version backward), for `small_step`'s pinned
    selections. Made on first use: chip_smoke.py imports no torch at
    module level."""

    _fn = None

    @classmethod
    def apply(cls, x, idx, dtype):
        if cls._fn is None:
            import torch
            from sp_gan_tpu_torch.ops.kernels import scatter_diff_bwd
            from sp_gan_tpu_torch.ops.kernels.knn_edge import edges_from_idx

            class Fn(torch.autograd.Function):
                @staticmethod
                def forward(ctx, x, idx, dtype):
                    ctx.save_for_backward(idx)
                    ctx.dtype = x.dtype
                    return edges_from_idx(x.detach().float(), idx, dtype,
                                          True)

                @staticmethod
                def backward(ctx, d):
                    (idx,) = ctx.saved_tensors
                    return (scatter_diff_bwd(d.contiguous(), idx)
                            .to(ctx.dtype), None, None)
            cls._fn = Fn
        return cls._fn.apply(x, idx, dtype)


def rel_max(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def grads_worst(names, ours, ref) -> dict:
    """The largest elementwise error over each tensor's max-abs (for a
    bias that feeds a training BatchNorm, whose exact gradient is 0, over
    its kernel's) and the largest relative L2 error, with their tensors."""
    def over(err: float, scale: float) -> float:
        # a gradient that is exactly zero (WGAN's last bias) must stay so
        return err / scale if scale else (0.0 if not err else float("inf"))

    worst = {"elem": (0.0, ""), "l2": (0.0, "")}
    for name, a, b in zip(names, ours, ref):
        scale = float(b.abs().max())
        if PRE_BN_BIAS.search(name):
            kern = ref[names.index(name[:-4] + "kernel")]
            scale = max(scale, float(kern.abs().max()))
        else:
            worst["l2"] = max(worst["l2"], (over(float((a - b).norm()),
                                                 float(b.norm())), name))
        worst["elem"] = max(worst["elem"],
                            (over(float((a - b).abs().max()), scale), name))
    return worst


def check_small_step(seed: int, cfg_kw=None, pin_knn: bool = False) -> dict:
    """One float32 step at N=256, bs=4, nk=8 (or `cfg_kw`) on the card
    against the same
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
    compared ("g_flips") and the caller takes another seed.

    Under WGAN-GP the penalty is a function of D's input gradient, so a
    leaky ReLU input of D's forward on the interpolates that lies within
    rounding of 0 and takes the other slope on the other device moves
    d_loss itself (by 1.3e-4 relative on the H100, seed 4 of
    --gp_mapping): such a flip must lie within 1e-3 of its tensor's
    max-abs, and then d_loss and D's gradients are not compared
    ("gp_flips") and the caller takes another seed.

    With knn_mode approx (SMALL_APPROX) the G phase is far worse
    conditioned: on the CPU one ulp of the real batch moves the JAX step's
    G gradients by up to 0.42 of a tensor's max-abs and 0.36 relative L2
    (tests/test_torch_approx_train.py). So G's gradients are then held to
    the larger of the bounds above and the CPU step's own response to one
    ulp of z_g up and down, measured here ("g_own").

    With n_mix both phases take region-mixed codes (`mix_codes` on draws
    from the seed's rng, the gate open), the same on both devices.

    With `pin_knn` the CPU's EdgeConv2 takes the card's selections in both
    phases (`small_step`): its own are still compared, each flip must lie
    where the devices' inputs agree within 1e-3 of their max-abs
    ("knn_pinned_flips"), and the chains start at the global pool. At
    --nk 80 (40 of 256 points) the G phase's kNN parts the devices in
    every seed of 0-7 on the H100, so only pinned can G's gradients be
    compared there."""
    import numpy as np
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.data import SyntheticDataset, sphere_template
    from sp_gan_tpu_torch.nn import Discriminator, Generator
    cfg = Config(**{**dict(np=256, bs=4, nk=8, dtype="float32"),
                    **(cfg_kw or {})})
    G0, D0 = Generator(cfg, seed=seed), Discriminator(cfg, seed=seed + 1)
    rng = np.random.default_rng(seed)
    z_d, z_g = (np.broadcast_to(rng.standard_normal((4, 1, cfg.nz)) * cfg.nv,
                                (4, cfg.np, cfg.nz)).astype(np.float32)
                for _ in range(2))
    real = SyntheticDataset(4, cfg.np, seed=seed).data
    sphere = sphere_template(cfg.np)
    # WGAN-GP's alpha and CutMix's lam, anchor and flip, the same on both
    # devices; D's forwards on their inputs add pools to the D phase
    draws = {"alpha": rng.uniform(size=(4, 1, 1)).astype(np.float32),
             "lam": rng.uniform(size=4).astype(np.float32),
             "anchor": rng.integers(0, cfg.np, 4),
             "flip": np.array(rng.uniform() < 0.5)}
    if cfg.n_mix:
        # --n_mix: both phases' codes region-mixed by `mix_codes` from numpy
        # draws (gate open, a second code, an anchor and a size per shape)
        from sp_gan_tpu_torch.data.noise import mix_codes
        z_d, z_g = (mix_codes(
            torch.from_numpy(z), torch.from_numpy(
                (rng.standard_normal((4, 1, cfg.nz)) * cfg.nv)
                .astype(np.float32)), True,
            torch.from_numpy(rng.integers(0, cfg.np, 4)),
            torch.from_numpy(rng.uniform(size=4).astype(np.float32)),
            torch.from_numpy(sphere)).numpy() for z in (z_d, z_g))
    regs = int(cfg.gan == "wgan" and cfg.lambda_gp > 0) + int(cfg.mix)
    card = small_step("cuda", cfg, G0, D0, sphere, real, z_d, z_g,
                      draws=draws)
    cpu = small_step("cpu", cfg, G0, D0, sphere, real, z_d, z_g,
                     pinned=card, draws=draws, pin_knn=pin_knn)
    res = {"seed": seed, "knn_mode": cfg.knn_mode,
           "fake2": rel_max(card["fakes"][1], cpu["fakes"][1]),
           "d_flips": 0, "g_flips": 0, "gp_flips": 0, "flip_input_err": 0.0,
           "fail": []}
    if pin_knn:
        res["knn_pinned_flips"] = 0
    if cfg.gan == "wgan" and cfg.lambda_gp > 0:
        # D's third forward of the D phase is the penalty's; D runs
        # 2 + regs forwards in the D phase and one in the G phase
        per = len(cpu["lrelu"]) // (3 + regs)
        for a, b in zip(card["lrelu"][2 * per:3 * per],
                        cpu["lrelu"][2 * per:3 * per]):
            flip = (a >= 0) != (b >= 0)
            res["gp_flips"] += int(flip.sum())
            if bool(flip.any()) and float(b[flip].abs().max()) \
                    > 1e-3 * float(b.abs().max()):
                res["fail"].append("a leaky ReLU of the penalty's D forward "
                                   "flips away from 0")
    g_bounds = (5e-1, 8e-2)
    if cfg.knn_mode == "approx":
        own = [grads_worst(cpu["names"][1], small_step(
            "cpu", cfg, G0, D0, sphere, real, z_d,
            (z_g * (1 + eps)).astype(np.float32), pinned=card,
            draws=draws)["grads"][1],
            cpu["grads"][1]) for eps in (2.0 ** -23, -2.0 ** -23)]
        res["g_own"] = (max(o["elem"][0] for o in own),
                        max(o["l2"][0] for o in own))
        g_bounds = tuple(max(a, b) for a, b in zip(g_bounds, res["g_own"]))
    def flips(what, i):
        """(flipped entries, the inputs' disagreement over their max-abs)
        of selection `i`: EdgeConv2's kNN in the D, G phase (0, 1); the
        pools of G, D on the real batch, D on the fakes, D on the
        regularizers' inputs (D phase: 0, 1, 2, then 3 to 2 + regs) and
        of G, D (G phase: 3 + regs, 4 + regs)."""
        if what == "knn":
            (x, a), (xc, b) = card["knn"][i], cpu["knn"][i]
        else:
            x, xc = card["pools"][i], cpu["pools"][i]
            a, b = x.argmax(1), xc.argmax(1)
        return int((a != b).sum()), rel_max(x, xc)

    for i in range(1, 3 + regs):    # D's pools on inputs both devices share
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
                  (("knn", 1), ("pool", 3 + regs), ("pool", 4 + regs))):
        first = True
        for what, i in chain:
            n, err = flips(what, i)
            if n and pin_knn and what == "knn":
                # the CPU went on with the card's picks: a near-tie each
                res["knn_pinned_flips"] += n
                res["flip_input_err"] = max(res["flip_input_err"], err)
                continue
            if n:
                res["g_flips"] += n
                if first:
                    res["flip_input_err"] = max(res["flip_input_err"], err)
                first = first and not n
    if res["flip_input_err"] > 1e-3:
        res["fail"].append(f"a selection flips where its inputs differ by "
                           f"{res['flip_input_err']} of their max-abs")
    d_ok = not (res["d_flips"] or res["gp_flips"])
    g_ok = not res["g_flips"]
    ok = True
    for key, rel, always in (("d_loss", 1e-5, not res["gp_flips"]),
                             ("g_loss", 5e-5, g_ok)):
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
                                         (1, "g_grads", *g_bounds, g_ok)):
        if always:
            res[tag] = grads_worst(card["names"][phase],
                                   card["grads"][phase], cpu["grads"][phase])
            ok &= res[tag]["elem"][0] <= elem and res[tag]["l2"][0] <= l2
    if not ok:
        res["fail"].append("beyond the step-parity tolerances")
    log(f"  small step (N={cfg.np}, bs=4, f32) cuda vs cpu: {res}"
        + ("" if d_ok else "; D's gradients not compared (flips in D)")
        + ("; d_loss not compared (a flip in the penalty's D forward)"
           if res["gp_flips"] else "")
        + ("" if g_ok else "; only the D phase compared (flips in G)"))
    return res


def check_small_steps(seed: int, need: int, cfg_kw=None,
                      tries: int = 0, pin_knn: bool = False) -> list:
    """`check_small_step` from `seed` on, one seed after another, until
    `need` seeds had D's and `need` seeds G's gradients compared (at most
    `tries` seeds, by default 4 * need + 4: G's were compared in 9 of
    seeds 0-25), then fails if any seed failed or too few were compared.
    Every seed's readings are logged first."""
    runs = []

    def compared(tag):
        return sum(tag in r for r in runs)

    for s in range(seed, seed + (tries or 4 * need + 4)):
        runs.append(check_small_step(s, cfg_kw, pin_knn))
        if min(compared("d_grads"), compared("g_grads")) >= need:
            break
    failed = [(r["seed"], r["fail"]) for r in runs if r["fail"]]
    if failed:
        raise AssertionError(f"small step: cuda and cpu disagree: {failed}")
    if min(compared("d_grads"), compared("g_grads")) < need:
        raise AssertionError(f"small step: gradients compared in fewer "
                             f"than {need} of {len(runs)} seeds")
    return runs


def timed_training(cfg, steps: int, warmup: int, expected: dict,
                   label: str, still=(), dataset=None):
    """`warmup`, then `steps` training steps of `cfg` on the card through
    `Trainer.time_steps` (the trainer's batches: up to 1 GiB of data a
    device-resident gather and a per-cloud point shuffle each step, above
    it the host stream), weights from cfg.seed, on `dataset` (default the
    trainer's synthetic data), from launch counts of 0: each kernel must
    have launched `expected` times a step, the losses must be finite and
    every weight tensor must move but those named in `still`, which must
    not (their gradient is exactly zero; D's weights are named
    "D.<name>"). Returns the trainer and the timings."""
    import numpy as np
    import torch
    from sp_gan_tpu_torch.ops import kernels
    from sp_gan_tpu_torch.train.trainer import Trainer, synthetic_dataset
    if dataset is None:
        dataset = synthetic_dataset(cfg)
    tr = Trainer(cfg, dataset=dataset, device="cuda", logs=False)
    start = [p.detach().clone() for p in
             list(tr.state.G.parameters()) + list(tr.state.D.parameters())]
    run = tr.time_steps(steps, warmup, before=kernels.reset_launch_counts)
    launches = kernels.launch_counts()
    losses = [[m[k] for k in ("d_loss", "g_loss")] for m in run["metrics"]]
    log(f"  {label}: {steps} timed steps, {run['ms_per_step']:.3f} ms/step;"
        f" launches {launches}; d_loss, g_loss first {losses[0]}, last "
        f"{losses[-1]}")
    for name, n in expected.items():
        if launches[name] != n * steps:
            raise AssertionError(f"{label}: {name} launched {launches[name]} "
                                 f"times in {steps} steps, expected "
                                 f"{n * steps}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: non-finite losses {losses}")
    now = list(tr.state.G.parameters()) + list(tr.state.D.parameters())
    names = ([n for n, _ in tr.state.G.named_parameters()]
             + [f"D.{n}" for n, _ in tr.state.D.named_parameters()])
    wrong = [n for n, a, b in zip(names, start, now)
             if torch.equal(a, b) != (n in still)]
    if wrong:
        raise AssertionError(f"{label}: weight tensors that moved where "
                             f"they should not, or stayed where they "
                             f"should move: {wrong}")
    return tr, {"ms_per_step": run["ms_per_step"],
                "steps_per_sec": run["steps_per_sec"],
                "points_per_sec": run["points_per_sec"],
                "launches": launches,
                "launches_per_step": {k: v / steps
                                      for k, v in launches.items()}}


def train_phase(seed: int, step_seeds: int, cfg_kw=None, expected=PER_STEP,
                small_kw=None, label: str = "default training step") -> dict:
    """Training steps on the card (`timed_training`, 3 + 10 steps of
    Config(**cfg_kw)), small steps on the card against the CPU
    (`check_small_steps` with `small_kw`) and one profiled step; see the
    module docstring."""
    from sp_gan_tpu_torch.config import Config
    cfg = Config(seed=seed, **(cfg_kw or {}))
    tr, res = timed_training(cfg, TIMED_STEPS, WARMUP_STEPS, expected, label)
    small = check_small_steps(seed, step_seeds, small_kw)
    prof = profile_call(lambda: tr.time_steps(1), label)
    return {**res, "small_step": small, "profile": prof}


def check_knn_edge_window(x, k, window, forms=None, label: str = "") -> dict:
    """Kernel F against its plain version on the card in each (selection
    mode, output type, diff_only) of `forms`, by default the P1 form
    (packed, bf16 diffs) and two others, and against itself over two
    launches: indices and edges bit-equal (the tensor-core filter above 4
    channels only chooses which band keys get the exact f32 fold, and both
    write the edges with the same roundings)."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.knn_edge_window import (
        knn_edge_window, knn_edge_window_plain)
    worst = {"agree": 1.0, "max_abs_err": 0.0, "vs_plain": 0, "vs_again": 0}
    for mode, cd, diff_only in forms or (("packed", torch.bfloat16, True),
                                         ("exact", torch.bfloat16, True),
                                         ("packed", torch.float32, False)):
        kw = dict(out_dtype=cd, diff_only=diff_only, select_mode=mode)
        ee, idx = knn_edge_window(x, k, window, **kw)
        ee2, idx2 = knn_edge_window(x, k, window, **kw)
        torch.cuda.synchronize()
        ee_p, idx_p = knn_edge_window_plain(x, k, window, **kw)
        tag = (f"knn_edge_window[{label}{mode}, {str(cd)[6:]}, diff_only="
               f"{diff_only}, {list(x.shape)}, window={window}]")
        bad_idx = int((idx != idx_p).sum())
        vs_plain = bad_idx + int((ee != ee_p).sum())
        vs_again = int((idx != idx2).sum()) + int((ee != ee2).sum())
        err = (ee.float() - ee_p.float()).abs().max().item()
        log(f"  {tag}: {vs_plain} entries differ from the plain version, "
            f"{vs_again} between two launches")
        if vs_plain or vs_again:
            raise AssertionError(f"{tag}: not bit-equal")
        worst["agree"] = min(worst["agree"], 1 - bad_idx / idx.numel())
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
    return worst


def quantum_band_cloud(n: int, copies: int):
    """[copies, n, 16] on the card, each the cloud laid along the band of
    query 1000 at W = 512 (F's low mask at n = 2048 is 2^11 - 1): the
    query at e1, every other point at -e1 + delta e2, so that its band
    distances lie in one packed quantum [4, 4 + 2^-10) and its packed
    top-k are the lowest band positions, rows 488 .. 497, which its block
    walks last, after its own queries' rows (896 .. 1023, delta^2 ~ 1e-6).
    Enough copies make the slice one chunk, as P1's
    (tests/test_torch_knn_select.py shows that a filter comparing with the
    k-th distance, not tau_q, drops them)."""
    import torch
    x = torch.zeros(1, n, 16, device="cuda")
    x[0, :, 0] = -1.0
    delta2 = torch.full((n,), 0.5 * 2.0 ** -10, device="cuda")
    delta2[896:1024] = 1e-6 * (1 + torch.arange(128, device="cuda") / 128)
    delta2[488:498] = 0.9 * 2.0 ** -10
    x[0, :, 1] = delta2.sqrt()
    x[0, 1000] = 0.0
    x[0, 1000, 0] = 1.0
    return x.repeat(copies, 1, 1)


def f_margin_sweep(inputs: dict, k: int, window: int) -> dict:
    """Kernel F in packed mode (bf16 diffs, P1's form) through
    `margin_sweep`."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.knn_edge_window import (
        _launch, knn_edge_window_plain)
    return margin_sweep(
        "knn_edge_window", inputs,
        lambda x, mu, nu: _launch(x, k, window, torch.bfloat16, 256, True,
                                  "packed", mu, nu)[1],
        lambda x: knn_edge_window_plain(x, k, window, torch.bfloat16,
                                        diff_only=True,
                                        select_mode="packed")[1])


def check_knn_blocked(x, k, label: str = "") -> dict:
    """Kernel G against kernel A at x's shape (one code path, with launch
    counts of their own) and against its plain version on the
    first two clouds, and against itself over two launches: indices and
    distances bit-equal (the three compute the same f32 distances and
    order them alike; the tensor-core filter only chooses which keys get
    that computation)."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.knn import knn
    from sp_gan_tpu_torch.ops.kernels.knn_blocked import (knn_blocked,
                                                          knn_blocked_plain)
    idx, dist = knn_blocked(x, k)
    idx2, dist2 = knn_blocked(x, k)
    idx_a, dist_a = knn(x, k)
    torch.cuda.synchronize()
    x2 = x[:2].contiguous()
    idx_p, dist_p = knn_blocked_plain(x2, k)
    tag = f"knn_blocked[{label}{list(x.shape)}, k={k}]"
    res = {"vs_knn": int((idx != idx_a).sum()) + int((dist != dist_a).sum()),
           "vs_plain": int((idx[:2] != idx_p).sum())
           + int((dist[:2] != dist_p).sum()),
           "vs_again": int((idx != idx2).sum()) + int((dist != dist2).sum()),
           "max_abs_err": (dist[:2] - dist_p).abs().max().item()}
    log(f"  {tag}: {res['vs_knn']} entries differ from kernel A, "
        f"{res['vs_plain']} from the plain version at B=2, "
        f"{res['vs_again']} between two launches")
    if res["vs_knn"] or res["vs_plain"] or res["vs_again"]:
        raise AssertionError(f"{tag}: not bit-equal ({res})")
    return res


def knn_blocked_hard(seed: int, k: int = 10):
    """Kernel G on the inputs where a filter that broke its contract would
    show, at P2's N: an integer grid round(4 randn) at C = 64 and C = 3
    (many exact ties), randn + 1000 at B = 2 (the margin then covers every
    distance, so the filter must keep every key) and one point repeated.
    Draws from a generator of its own. Returns the checks' results and the
    inputs, by name."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = SERVE_16K

    def r(b, c):
        return torch.randn(b, n, c, generator=gen, device="cuda")
    cases = {"grid": torch.round(4 * r(4, 64)),
             "grid3": torch.round(4 * r(4, 3)),
             "offset": r(2, 64) + 1000,
             "repeat": r(1, 64)[:, :1].expand(2, n, 64).contiguous(),
             "repeat3": r(1, 3)[:, :1].expand(2, n, 3).contiguous()}
    res = {label: check_knn_blocked(x, k, label + ", ")
           for label, x in cases.items()}
    return res, cases


# the margins of kernel G's filter that g_margin_sweep tries: the wrapper's
# (2^-12), smaller ones down to 2^-24, and none
G_SWEEP_MU = [2.0 ** -e for e in range(12, 25, 2)] + [0.0]


def g_margin_sweep(inputs: dict, k: int) -> dict:
    """Kernel G launched with the filter's margin mu from G_SWEEP_MU (nu the
    wrapper's, 0 with mu = 0) on 64-channel inputs, each against kernel A:
    the entries that differ at each mu, and the smallest mu at which every
    input, and at every larger mu, stayed bit-equal. The control: with mu =
    nu = 0 the cloud far from the origin ("offset") must differ, or the
    bit-equality checks could not see a margin that the card's TF32 sums
    break."""
    from sp_gan_tpu_torch.ops.kernels.knn import knn
    from sp_gan_tpu_torch.ops.kernels.knn_blocked import FILTER_NU, _launch
    ref = {name: knn(x, k) for name, x in inputs.items()}
    differ = []
    for mu in G_SWEEP_MU:
        row = {}
        for name, x in inputs.items():
            i, d = _launch(x, k, mu, FILTER_NU if mu else 0.0)
            row[name] = (int((i != ref[name][0]).sum())
                         + int((d != ref[name][1]).sum()))
        differ.append(row)
        log(f"  knn_blocked margin mu={mu:.4g}: entries differing from "
            f"kernel A {row}")
    smallest = None
    for mu, row in zip(G_SWEEP_MU, differ):
        if any(row.values()):
            break
        smallest = mu
    log(f"  knn_blocked: smallest margin exact on every input {smallest}")
    if not differ[-1]["offset"]:
        raise AssertionError("kernel G with no margin equals kernel A on the "
                             "offset cloud: the check cannot see a margin "
                             "that fails")
    if any(differ[0].values()):
        raise AssertionError("kernel G differs from kernel A at the "
                             "wrapper's margin")
    return {"mu": G_SWEEP_MU, "differ": differ, "smallest_exact_mu": smallest}


# kernel G's launches (csrc/knn.cu on csrc/knn_filter.cuh) by pass
G_PASSES = {"knn_filter_kernel": "G: filter pass (C > 4)",
            "knn_exact_kernel": "G: exact pass (C <= 4)",
            "knn_norms_kernel": "G: norms", "knn_merge_kernel": "G: merge"}


def g_pass(name: str):
    """"G: <pass>" of a launch of kernel G, else None."""
    for kern, label in G_PASSES.items():
        if kern in name:
            return label
    return None


def check_scatter_add(g, idx, n) -> dict:
    """Kernel H against its plain version run on CPU copies of the same
    inputs, which sums in the kernel's order (ascending source): within
    1e-6 max|out|; two launches bit-identical. The plain version on the
    card (index_add_ with atomics, in no fixed order) is logged beside
    it."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.scatter import (scatter_add,
                                                      scatter_add_plain)
    a, b = scatter_add(g, idx, n), scatter_add(g, idx, n)
    torch.cuda.synchronize()
    tag = f"scatter_add[{str(g.dtype)[6:]}, g {list(g.shape)}, n={n}]"
    if not torch.equal(a, b):
        raise AssertionError(f"{tag}: two launches differ")
    ref = scatter_add_plain(g.cpu(), idx.cpu(), n)
    err = (a.cpu() - ref).abs().max().item()
    scale = ref.abs().max().item()
    card = (a - scatter_add_plain(g, idx, n)).abs().max().item()
    log(f"  {tag}: max_abs_err {err} vs the plain version on the cpu "
        f"(limit {1e-6 * scale:.3g}), {card} vs the plain version on the "
        "card; bit-identical over two launches")
    if not err <= 1e-6 * scale:
        raise AssertionError(f"{tag}: error {err}")
    return {"max_abs_err": err, "deterministic": True}


def check_scatter_add_hard(gen) -> dict:
    """Kernel H on an idx that reaches its edge cases: [2, 20480] sources
    into n = 2048 targets drawn from the first 1024 (the rest get no
    source), cloud 0's first 4096 sources all on target 5 (in-degree over
    4096), every 97th entry out of range (-1, n, 2^31 - 1, -2^31); g in f32
    and bf16 at F = 3, 64 and 128. The reference is the plain version on
    CPU copies with the out-of-range rows zeroed and sent to target 0 (a
    +0.0 changes no f32 sum that starts at +0.0), which is the kernel's
    function; the kernel must equal it exactly, two launches
    bit-identically."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.scatter import (scatter_add,
                                                      scatter_add_plain)
    B, S, n = 2, 20480, 2048
    dev = gen.device
    idx = torch.randint(0, n // 2, (B, S), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[0, :4096] = 5
    bad = torch.tensor([-1, n, 2 ** 31 - 1, -2 ** 31], dtype=torch.int32,
                       device=dev)
    idx[:, ::97] = bad[torch.arange(idx[:, ::97].numel(), device=dev)
                       % 4].reshape(B, -1)
    oob = (idx < 0) | (idx >= n)
    res = {}
    for F in (3, 64, 128):
        for dt in (torch.float32, torch.bfloat16):
            g = torch.randn(B, S, F, generator=gen, device=dev).to(dt)
            a, b = scatter_add(g, idx, n), scatter_add(g, idx, n)
            torch.cuda.synchronize()
            tag = f"scatter_add hard[{str(dt)[6:]}, F={F}]"
            if not torch.equal(a, b):
                raise AssertionError(f"{tag}: two launches differ")
            ref = scatter_add_plain(g.masked_fill(oob[..., None], 0).cpu(),
                                    idx.masked_fill(oob, 0).cpu(), n)
            err = (a.cpu() - ref).abs().max().item()
            if err != 0.0:
                raise AssertionError(f"{tag}: {err} from the plain version")
            res[f"{str(dt)[6:]}/F={F}"] = err
    log(f"  scatter_add on the hard idx [{B}, {S}] -> n={n} (in-degree "
        f"{int((idx[0] == 5).sum())} at target 5, {int(oob.sum())} entries "
        f"out of range): 0.0 from the plain version and bit-identical over "
        f"two launches at {list(res)}")
    return res


def scatter_pass_figures(g, idx, n) -> dict:
    """Kernel H's launch taken apart at g's shape: the device time of each
    of its four passes (hist, place, sort, sum: one kernel each), a mean
    over ten launches under torch.profiler; the launch's own time (CUDA
    events, median of 50) and the rest of it, the wrapper's host time and
    the gaps between the passes; and the in-degrees of idx (max, p99 and
    mean over the targets of every cloud)."""
    from sp_gan_tpu_torch.ops.kernels.scatter import scatter_add
    prof = profile_call(lambda: [scatter_add(g, idx, n) for _ in range(10)],
                        "kernel H x10 (device time by pass)")
    # each pass's mean over the launches the profiler recorded (it may
    # miss some of the ten)
    passes = {}
    for name in ("hist", "place", "sort", "sum"):
        got = [r for r in prof["top"] if f"{name}_kernel" in r["name"]]
        passes[name] = (sum(r["ms"] for r in got)
                        / max(1, sum(r["count"] for r in got)))
    launch = cuda_ms(lambda: scatter_add(g, idx, n), 50)
    res = {"pass_device_ms": passes, "launch_ms": launch,
           "rest_ms": launch - sum(passes.values()),
           "in_degree": in_degrees(idx, n)}
    log(f"  kernel H's passes at g {list(g.shape)}, n={n} (device time a "
        "launch): " + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items())
        + f"; the launch {launch:.4f} ms, of which {res['rest_ms']:.4f} ms "
        f"host and gaps; in-degree {res['in_degree']}")
    return res


def in_degrees(idx, n: int) -> dict:
    """Max, p99 and mean in-degree of idx [B, S...] over the n targets of
    every cloud (entries outside [0, n) left out)."""
    import torch
    B = idx.shape[0]
    ix = idx.reshape(B, -1)
    ok = (ix >= 0) & (ix < n)
    tgt = (ix.long() + n * torch.arange(B, device=idx.device)[:, None])[ok]
    deg = torch.bincount(tgt, minlength=B * n).float()
    return {"max": int(deg.max()), "p99": float(torch.quantile(deg, 0.99)),
            "mean": float(deg.mean())}


def diff_pass_figures(dd, idx, label: str) -> dict:
    """Kernel D's launch taken apart at one of its calls: the device time
    of each kernel it launches (its four CSR passes: hist, place, sort,
    sum), a mean over ten launches under torch.profiler; the launch's own
    time (CUDA events, median of 50) and the rest of it, the wrapper's host
    time and the gaps between its kernels; and the in-degrees of idx."""
    from sp_gan_tpu_torch.ops.kernels.scatter import scatter_diff_bwd
    prof = profile_call(lambda: [scatter_diff_bwd(dd, idx)
                                 for _ in range(10)],
                        f"kernel D x10 at {label} (device time by kernel)",
                        expect=("sum_kernel",))
    # each kernel's mean over the launches the profiler recorded (it may
    # miss some of the ten)
    passes = {}
    for r in prof["top"]:
        m = re.search(r"\w+_kernel\b", r["name"])
        name = m.group(0) if m else r["name"][:60]
        passes[name] = passes.get(name, 0.0) + r["ms"] / max(1, r["count"])
    launch = cuda_ms(lambda: scatter_diff_bwd(dd, idx), 50)
    res = {"shape": list(dd.shape), "row_stride": dd.stride(2),
           "dtype": str(dd.dtype)[6:], "pass_device_ms": passes,
           "launch_ms": launch, "rest_ms": launch - sum(passes.values()),
           "in_degree": in_degrees(idx, idx.shape[1])}
    log(f"  kernel D at {label}, d_diff {list(dd.shape)} (row stride "
        f"{dd.stride(2)}): device time a launch " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in passes.items())
        + f"; the launch {launch:.4f} ms, of which {res['rest_ms']:.4f} ms "
        f"host and gaps; in-degree {res['in_degree']}")
    return res


def largen_serve_phase(seed: int) -> dict:
    """Generation at N=16384 (P2): two requests of REQUEST_16K shapes
    through Manipulator.generate from launch counts of 0, each launching
    kernel G and kernel C twice and nothing else; normalized clouds of the
    right shape, finite, at radius 1; the card against the CPU at B=1, as
    `check_small_reference`: 99% of the points within 1e-3, the median
    within 1.2e-4, twice the median this check read on the H100 (5.83e-5;
    1e-5 holds at N=256). Kernel G equals its plain version bit for bit
    (kernels phase); the gap comes from the dense layers, which round
    differently on the two devices, and the near-tie neighbor swaps they
    cause among the 163,840 picks of each EdgeConv, which move the global
    max pool and with it every point; one profiled request."""
    import numpy as np
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.manipulate import Manipulator
    from sp_gan_tpu_torch.nn.generator import Generator
    from sp_gan_tpu_torch.ops import dispatch, kernels
    cfg = Config(np=SERVE_16K)
    man = Manipulator(cfg, Generator(cfg, seed=seed), device="cuda")
    if not man.fused:
        raise AssertionError("Config(np=16384) must be served by the fused "
                             "path")
    B = REQUEST_16K
    # warm-up, recording the 64-channel features the request hands kernel G
    # and the arguments of its two calls of kernel C
    from sp_gan_tpu_torch.nn import fused_eval
    seen, tails = {}, {}
    real, real_tail = dispatch.knn_blocked, fused_eval.edge_tail

    def record(x, k):
        seen.setdefault(x.shape[-1], x.clone())
        return real(x, k)

    def record_tail(*targs, k, neg):
        tails.setdefault(f"edge{len(tails) + 1}",
                         tuple(t.clone() for t in targs))
        return real_tail(*targs, k=k, neg=neg)
    with mock.patch.object(dispatch, "knn_blocked", record), \
            mock.patch.object(fused_eval, "edge_tail", record_tail):
        man.generate(B, seed=seed + 1000, batch=B)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    pcs = man.generate(2 * B, seed=seed, batch=B)          # two requests
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / 2
    launches = kernels.launch_counts()
    log(f"  generate({2 * B}, batch={B}) at N={cfg.np}: {ms:.2f} ms per "
        f"request of {B} shapes; launches {launches}")
    for name, n in PER_REQUEST_16K.items():
        if launches[name] != 2 * n:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"two requests, expected {2 * n}")
    if pcs.shape != (2 * B, cfg.np, 3) or not np.isfinite(pcs).all():
        raise AssertionError(f"bad output: shape {pcs.shape}, "
                             f"finite {np.isfinite(pcs).all()}")
    radius = np.sqrt((pcs ** 2).sum(-1)).max(axis=1)
    if not np.allclose(radius, 1.0, atol=1e-4):
        raise AssertionError("normalized clouds must reach radius 1")
    z = np.random.default_rng(seed).standard_normal(
        (1, 1, cfg.nz)).astype(np.float32) * cfg.nv
    z = np.broadcast_to(z, (1, cfg.np, cfg.nz))
    t = time.perf_counter()
    out_cpu = Manipulator(cfg, Generator(cfg, seed=seed),
                          device="cpu").forward(z)
    cpu_s = time.perf_counter() - t
    err = np.abs(man.forward(z) - out_cpu).max(axis=-1)
    p99, med = np.quantile(err, 0.99), np.median(err)
    log(f"  N={cfg.np}, B=1: cuda vs cpu max {err.max():.3g}, p99 "
        f"{p99:.3g}, median {med:.3g} (cpu {cpu_s:.1f} s)")
    if not (p99 <= 1e-3 and med <= 1.2e-4):
        raise AssertionError("cuda output disagrees with the cpu reference")
    features = check_knn_blocked(seen[64], cfg.k, "P2 features, ")
    tail = {}
    for name, targs in tails.items():
        tail[name] = check_edge_tail(targs, cfg.k)
        log(f"  edge_tail[{name} at P2, ee {list(targs[0].shape)}]: "
            f"{tail[name]}")
    prof = profile_call(lambda: man.generate(B, seed=seed, batch=B),
                        f"request of {B} shapes at N={cfg.np}",
                        lambda n: g_pass(n) or tf_part(n),
                        expect=tuple(G_PASSES)[:3])
    return {"ms_per_request": ms, "launches": launches,
            "cpu_check": {"max": float(err.max()), "p99": float(p99),
                          "median": float(med)},
            "knn_blocked_features": features, "edge_tail": tail,
            "profile": prof}, seen[64], tails


def auction_pairs_clouds(n: int, clouds: int, seed: int):
    """[clouds, n, 3] normalized synthetic shapes on the card."""
    import torch
    from sp_gan_tpu_torch.data import SyntheticDataset
    from sp_gan_tpu_torch.manipulate import normalize_point_cloud
    return normalize_point_cloud(torch.as_tensor(SyntheticDataset(
        clouds, n, seed=seed).data, device="cuda"))


def auction_pairs(n: int, pairs: int, seed: int):
    """d [pairs, n, n] on the card between normalized synthetic shapes."""
    from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist
    pcs = auction_pairs_clouds(n, 2 * pairs, seed)
    return pairwise_sqdist(pcs[:pairs], pcs[pairs:])


def check_auction(d, regime, block_w: int = 64, label: str = "") -> dict:
    """Kernel E against its plain version on the card: assignments,
    block-rounds and bidders bit-equal (the two run the same f32 operations
    in the same order) and bit-identical over two launches; a pair whose
    cap was not spent must be a bijection. Returns the rounds, the
    bidders, the plain version's wall time, the mismatches, the largest
    gap of a pair's matched cost and the kernel's assignment."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.auction import (auction, auction_plain,
                                                      block_width)
    eps, iters, phases = regime
    B, N, M = d.shape
    asg, rounds, bids = auction(d, eps, iters, phases, block_w=block_w)
    again = auction(d, eps, iters, phases, block_w=block_w)
    torch.cuda.synchronize()
    t = time.perf_counter()
    asg_p, rounds_p, bids_p = auction_plain(d, eps, iters, phases,
                                            block_w=block_w)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    tag = (f"auction[{label}{list(d.shape)}, w {block_width(N, block_w)}, "
           f"eps {eps}, iters {iters}, {phases} ph]")
    if not all(torch.equal(x, y) for x, y in zip((asg, rounds, bids),
                                                  again)):
        raise AssertionError(f"{tag}: two launches differ")
    mismatches = int((asg != asg_p).sum())

    def cost(a):
        return d.gather(2, a.long()[..., None]).sum((1, 2))
    cost_err = float((cost(asg) - cost(asg_p)).abs().max())
    if not (mismatches == 0 and torch.equal(rounds, rounds_p)
            and torch.equal(bids, bids_p)):
        raise AssertionError(
            f"{tag}: {mismatches} assignments (cost gap {cost_err}), rounds "
            f"{rounds.tolist()} vs {rounds_p.tolist()} and bidders "
            f"{bids.tolist()} vs {bids_p.tolist()} differ from the plain "
            "version")
    cap = iters * (N // block_width(N, block_w))
    spent = [int(r) >= cap for r in rounds.tolist()]
    for b in range(B):
        if not spent[b] and torch.unique(asg[b]).numel() != N:
            raise AssertionError(f"{tag}: pair {b} converged without a "
                                 "bijection")
    log(f"  {tag}: bit-equal to the plain version ({mismatches} mismatches, "
        f"cost gap {cost_err}), bit-identical over two launches; "
        f"block-rounds {rounds.tolist()} (cap {cap}, "
        f"spent {spent}), bidders {bids.tolist()}; plain version "
        f"{plain_ms:.0f} ms")
    return {"rounds": rounds.tolist(), "bidders": bids.tolist(), "cap": cap,
            "cap_spent": spent, "plain_ms": plain_ms,
            "mismatches": mismatches, "max_abs_err": cost_err, "asg": asg}


def check_auction_optimum(seed: int) -> dict:
    """At N=256 (protocol regime) each pair's cost within N * eps of
    scipy's linear_sum_assignment optimum."""
    from scipy.optimize import linear_sum_assignment
    eps = PROTOCOL[0]
    d = auction_pairs(256, 4, seed)
    res = check_auction(d, PROTOCOL)
    dn = d.cpu().double().numpy()
    gaps = []
    for b in range(d.shape[0]):
        r, c = linear_sum_assignment(dn[b])
        got = dn[b][range(256), res["asg"][b].cpu().numpy()].sum()
        gaps.append(float(got - dn[b][r, c].sum()))
    log(f"  auction at N=256: cost minus the optimum {gaps} (limit "
        f"{256 * eps})")
    if max(gaps) > 256 * eps + 1e-5:
        raise AssertionError(f"auction: cost beyond N * eps of the optimum "
                             f"{gaps}")
    return {"gaps": gaps, "limit": 256 * eps}


def check_auction_hard(seed: int) -> dict:
    """Kernel E on inputs that reach its edge cases, each held as
    `check_auction` holds it: a tie-heavy pair of clouds on a coarse grid
    (many duplicated points, so ties in d and in the bids) at [2, 2048,
    2048] in the training regime and [2, 1024, 1024] in the protocol
    regime; [4, 256, 256] at block_w 16 (w below 64) and [2, 256, 258] (M
    not a multiple of 4) in both regimes."""
    import torch
    from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist
    res = {}
    for n, regime in ((2048, TRAIN_REGIME), (1024, PROTOCOL)):
        pcs = torch.round(auction_pairs_clouds(n, 4, seed + 31) * 4) / 4
        d = pairwise_sqdist(pcs[:2], pcs[2:])
        dup = n - torch.unique(pcs[0], dim=0).shape[0]
        log(f"  tie-heavy pair at N={n}: {dup} of {n} points of cloud 0 "
            "duplicated")
        res[f"ties/{n}"] = check_auction(d, regime, label="ties ")
    for shape, block_w in (((4, 256, 256), 16), ((2, 256, 258), 64)):
        B, N, M = shape
        pcs = auction_pairs_clouds(M, 2 * B, seed + 37)
        d = pairwise_sqdist(pcs[:B, :N].contiguous(), pcs[B:])
        for name, regime in (("protocol", PROTOCOL), ("train", TRAIN_REGIME)):
            res[f"{list(shape)}/{name}"] = check_auction(d, regime, block_w)
    return {k: {f: v[f] for f in ("rounds", "bidders", "mismatches")}
            for k, v in res.items()}


def auction_round_figures(d, regime, label: str, checked: dict,
                          reps: int = 3) -> dict:
    """Kernel E at d in `regime`, which `check_auction` returned `checked`
    for: the launch's time (CUDA events, median of `reps`), the
    block-rounds of its pairs, the rows that bid a round, the time per
    block-round of the slowest pair (launch ms / rounds_max), which the
    launch cannot beat however many pairs run beside it, and that pair's
    round split by part in SM cycles (`launch_e(prof=)`)."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.auction import (auction, block_width,
                                                      launch_e)
    rounds, bids = checked["rounds"], checked["bidders"]
    ms = cuda_ms(lambda: auction(d, *regime), reps)
    w = block_width(d.shape[1], 64)
    # the slowest pair's clock cycles by part of its rounds
    prof = torch.zeros(d.shape[0], 4, dtype=torch.int64, device=d.device)
    launch_e(d, *regime, 8.0, w, prof=prof)
    cyc = prof[max(range(len(rounds)), key=rounds.__getitem__)].tolist()
    parts = dict(zip(("loads_and_columns", "warp_merges", "wait_b1",
                      "merge_resolve_pick"),
                     [c / max(1, sum(cyc)) for c in cyc]))
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip()
    b_ms, b_by = auction_bound(d, bids)
    res = {"shape": list(d.shape), "regime": list(regime), "ms": ms,
           "round_shares": parts,
           "cycles_per_round": sum(cyc) / max(rounds), "sm_clock": clock,
           "scan_share": 1 - parts["merge_resolve_pick"],
           "rounds_max": max(rounds), "rounds_mean": sum(rounds) / len(rounds),
           "bidders_per_round": sum(bids) / sum(rounds),
           "us_per_round": 1e3 * ms / max(rounds), "bound_ms": b_ms,
           "bound_by": b_by}
    log(f"  kernel E at {label} {list(d.shape)}: {ms:.3f} ms, block-rounds "
        f"max {max(rounds)}, mean {res['rounds_mean']:.0f}, "
        f"{res['bidders_per_round']:.2f} bidders a round; "
        f"{res['us_per_round']:.3f} us per block-round of the slowest pair, "
        f"{res['cycles_per_round']:.0f} SM cycles a round (SM clock {clock} "
        f"after the run), {100 * res['scan_share']:.1f}% of them in the row "
        "scans "
        f"({', '.join(f'{k} {100 * v:.1f}%' for k, v in parts.items())}); "
        f"bound {b_ms:.3f} ms by {b_by} ({100 * b_ms / ms:.3g}% of bound)")
    return res


def auction_bound(d, bidders) -> tuple:
    """Kernel E's bound: each row that bids in a round scans its M columns
    (a subtract, a compare and a max per element, none of them an FMA), and
    the function reads d once and writes the assignment, the rounds and the
    bidders. The forced pass's scans are left out, which only lowers it."""
    B, N, M = d.shape
    elements = sum(bidders) * M
    return bound(3 * elements, 4 * B * N * M + 4 * B * N + 12 * B, F32_OPS)


def protocol_run(gen, ref) -> dict:
    """`compute_all_metrics(use_emd=True)` on the card from launch counts
    of 0: the metrics must be finite and in range, and kernel E the only
    kernel launched, as often as the protocol's batching implies."""
    import numpy as np
    import torch
    from sp_gan_tpu_torch.eval import compute_all_metrics
    from sp_gan_tpu_torch.eval.metrics import emd_pairs_per_call
    from sp_gan_tpu_torch.ops import kernels
    S, N = gen.shape[0], gen.shape[1]
    per = emd_pairs_per_call(S, N, N)
    expected = 3 * -(-S * S // per)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    m = compute_all_metrics(gen, ref, normalize=True, use_emd=True,
                            device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = kernels.launch_counts()
    solves = 3 * S * S
    log(f"  compute_all_metrics(S={S}, N={N}, use_emd): {m}")
    log(f"  wall {wall:.2f} s, {solves / wall:.1f} EMD solves/s; launches "
        f"{launches}, kernel E expected {expected} ({per} pairs a call)")
    if launches != {**{k: 0 for k in launches}, "auction": expected}:
        raise AssertionError(f"protocol launches {launches}, expected "
                             f"{expected} of kernel E and none else")
    for k, v in m.items():
        if not np.isfinite(v):
            raise AssertionError(f"protocol: {k} = {v}")
    for k in ("COV-CD", "1NN-CD", "COV-EMD", "1NN-EMD"):
        if not 0 <= m[k] <= 1:
            raise AssertionError(f"protocol: {k} = {m[k]} outside [0, 1]")
    if not (m["MMD-CD"] > 0 and m["MMD-EMD"] > 0):
        raise AssertionError("protocol: MMD must be positive")
    return {"metrics": m, "wall_s": wall, "solves_per_sec": solves / wall,
            "launches": launches, "expected_launches": expected,
            "pairs_per_call": per}


def metrics_phase(man, seed: int) -> dict:
    """Kernel E's checks, the metric protocol on the card, its CPU
    cross-check, FPD and a profile; see the module docstring."""
    import numpy as np
    import torch
    from sp_gan_tpu_torch.data import SyntheticDataset
    from sp_gan_tpu_torch.eval import FPD, compute_all_metrics
    out = {"checks": {}}
    for n, pairs in ((2048, 4), (4096, 2)):
        d = auction_pairs(n, pairs, seed + n)
        for name, regime in (("protocol", PROTOCOL),
                             ("train", TRAIN_REGIME)):
            res = check_auction(d, regime)
            out["checks"][f"{n}/{name}"] = {
                k: res[k] for k in ("rounds", "bidders", "cap", "cap_spent",
                                    "plain_ms", "mismatches",
                                    "max_abs_err")}
        out[n] = auction_round_figures(d, PROTOCOL, f"[{pairs}, {n}]",
                                       out["checks"][f"{n}/protocol"])
        out[n].update(
            plain_ms=out["checks"][f"{n}/protocol"]["plain_ms"],
            max_abs_err=max(out["checks"][f"{n}/{r}"]["max_abs_err"]
                            for r in ("protocol", "train")),
            mismatches=sum(out["checks"][f"{n}/{r}"]["mismatches"]
                           for r in ("protocol", "train")))
        del d
    out["optimum"] = check_auction_optimum(seed)
    # R3's launch: 24 pairs in the training regime (--mix runs it on the
    # real and fake clouds of a step)
    d = auction_pairs(2048, 24, seed + 24)
    out["checks"]["r3"] = {k: v for k, v in check_auction(
        d, TRAIN_REGIME, label="R3 ").items() if k != "asg"}
    out["r3"] = auction_round_figures(d, TRAIN_REGIME, "R3's shape",
                                      out["checks"]["r3"])
    del d
    out["hard"] = check_auction_hard(seed)

    # the metric protocol: METRIC_CLOUDS generated clouds against as many
    # reference clouds at N=2048, then 2 against 2 at N=4096
    S = METRIC_CLOUDS
    gen = man.generate(S, seed=seed + 7)
    ref = SyntheticDataset(S, gen.shape[1], seed=seed + 8).data
    run = protocol_run(gen, ref)
    big = SyntheticDataset(4, 4096, seed=seed + 11).data
    out["protocol_4096"] = protocol_run(big[:2], big[2:])
    per = run["pairs_per_call"]

    # one launch the size the protocol makes (its gen-by-ref pairs): held
    # against the plain version bit for bit (the variant of kernel E that
    # only more pairs than SMs take), then timed alone, with the bound of
    # the rows its pairs' rounds scanned
    from sp_gan_tpu_torch.manipulate import normalize_point_cloud
    from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist
    pairs = torch.arange(min(per, S * S), device="cuda")
    d = pairwise_sqdist(
        normalize_point_cloud(torch.as_tensor(gen, device="cuda"))[pairs // S],
        torch.as_tensor(ref, device="cuda")[pairs % S])
    out["checks"]["launch"] = {k: v for k, v in check_auction(
        d, PROTOCOL, label="protocol launch ").items() if k != "asg"}
    out["launch"] = auction_round_figures(d, PROTOCOL, "one protocol launch",
                                          out["checks"]["launch"], reps=2)
    out["launch"]["plain_ms"] = out["checks"]["launch"]["plain_ms"]
    del d

    # the same protocol at S=4, N=256 on the card and on the CPU
    small = [SyntheticDataset(4, 256, seed=seed + s).data for s in (9, 10)]
    card = compute_all_metrics(*small, normalize=True, use_emd=True,
                               device="cuda")
    cpu = compute_all_metrics(*small, normalize=True, use_emd=True,
                              device="cpu")
    log(f"  protocol at S=4, N=256: card {card}, cpu {cpu}")
    for k in cpu:
        if not np.isclose(card[k], cpu[k], rtol=1e-5, atol=0):
            raise AssertionError(f"protocol: card {k}={card[k]} vs cpu "
                                 f"{cpu[k]}")

    # FPD with a DGCNN drawn from the seed, on the same clouds
    t = time.perf_counter()
    fpd = FPD(seed=seed, device="cuda")(gen, ref)
    log(f"  FPD (random-feature DGCNN, k=40, 1024 dims): {fpd:.4f} in "
        f"{time.perf_counter() - t:.2f} s")
    if not np.isfinite(fpd):
        raise AssertionError(f"FPD = {fpd}")
    half = S // 2
    prof = profile_call(lambda: compute_all_metrics(
        gen[:half], ref[:half], normalize=True, use_emd=True,
        device="cuda"), f"compute_all_metrics(S={half}, use_emd)")
    out.update(run, small=card, fpd=fpd, profile=prof)
    return out

def check_edge_scatter_bwd(idx, gen) -> dict:
    """Kernel M against its plain version at the --fused_train step's
    EdgeConv2 (d_ee [B, N, k, 128], C = 64), in bf16 and f32: two launches
    bit-identical, and within 1e-6 relative L2 of the plain version run on
    CPU copies of the same inputs, which sums in the kernel's order
    (ascending source, central sum last). The plain version on the card
    (index_add_ with atomics, in no fixed order) is logged beside it.
    Returns the readings and the bf16 d_ee (for the timings)."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.scatter import (edge_scatter_bwd,
                                                      edge_scatter_bwd_plain)
    B, N, k = idx.shape
    res = {"max_abs_err": 0.0, "rel_l2": 0.0, "deterministic": True}
    for dt in (torch.float32, torch.bfloat16):
        d_ee = torch.randn(B, N, k, 128, generator=gen,
                           device=idx.device).to(dt)
        a, b = edge_scatter_bwd(d_ee, idx), edge_scatter_bwd(d_ee, idx)
        torch.cuda.synchronize()
        tag = f"edge_scatter_bwd[{str(dt)[6:]}, d_ee {list(d_ee.shape)}]"
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: two launches differ")
        ref = edge_scatter_bwd_plain(d_ee.cpu(), idx.cpu())
        err = (a.cpu() - ref).abs().max().item()
        rel = ((a.cpu() - ref).norm() / ref.norm()).item()
        card = edge_scatter_bwd_plain(d_ee, idx)
        card_rel = ((a - card).norm() / card.norm()).item()
        log(f"  {tag}: relative L2 {rel} (max abs {err}) vs the plain "
            f"version on the cpu (limit 1e-6), {card_rel} vs the plain "
            "version on the card; bit-identical over two launches")
        if not rel <= 1e-6:
            raise AssertionError(f"{tag}: relative L2 error {rel}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["rel_l2"] = max(res["rel_l2"], rel)
    return res, d_ee


def chamfer_clouds(B: int, n: int, seed: int):
    """Two sets of B normalized synthetic shapes of n points on the card,
    the clouds the metric protocol compares."""
    import torch
    from sp_gan_tpu_torch.data import SyntheticDataset
    from sp_gan_tpu_torch.manipulate import normalize_point_cloud
    pcs = normalize_point_cloud(torch.as_tensor(SyntheticDataset(
        2 * B, n, seed=seed).data, device="cuda"))
    return pcs[:B].contiguous(), pcs[B:].contiguous()


def check_chamfer(seed: int, gen) -> dict:
    """`ops.dispatch.chamfer_directed` forward and backward at
    CHAMFER_FUSED, from launch counts of 0: kernel N once (its backward's
    scatter kernel H twice) and nothing else. Kernel N's four outputs
    bit-equal to its plain version on the card (the same f32 fold); the
    gradients bit-equal to the plain backward (`nn_backward` with
    `scatter_add_plain`) on CPU copies, which scatters in kernel H's
    order, and bit-identical over two runs; the plain backward on the card
    (index_add_ with atomics) logged beside it. At CHAMFER_DENSE the dense
    route runs, launching nothing, with the kernel's distances. Returns
    the readings and the clouds (for the timings)."""
    import torch
    from sp_gan_tpu_torch.ops import kernels
    from sp_gan_tpu_torch.ops.chamfer import nn_backward
    from sp_gan_tpu_torch.ops.dispatch import chamfer_directed
    from sp_gan_tpu_torch.ops.kernels.scatter import scatter_add_plain
    B, n, _ = CHAMFER_FUSED
    x, y = chamfer_clouds(B, n, seed + 7)
    w1 = torch.randn(B, n, generator=gen, device="cuda")
    w2 = torch.randn(B, n, generator=gen, device="cuda")

    def run():
        xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
        d1, d2 = chamfer_directed(xg, yg)
        ((d1 * w1).sum() + (d2 * w2).sum()).backward()
        return d1.detach(), d2.detach(), xg.grad, yg.grad

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    first = run()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = per(chamfer_nn=1, scatter_add=2)
    if launches != want:
        raise AssertionError(f"chamfer_directed{list(x.shape)}: launches "
                             f"{launches}, expected {want}")
    again = run()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("chamfer_directed: two runs differ")
    out = kernels.chamfer_nn(x, y)
    plain = kernels.chamfer_nn_plain(x, y)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, plain)):
        raise AssertionError("chamfer_nn: kernel and plain version differ")
    if not (torch.equal(first[0], out[0]) and torch.equal(first[1], out[2])):
        raise AssertionError("chamfer_directed: distances are not kernel N's")
    _, i1, _, i2 = (t.cpu() for t in out)
    ref = nn_backward(x.cpu(), y.cpu(), i1, i2, w1.cpu(), w2.cpu(),
                      scatter_add_plain)
    card = nn_backward(x, y, out[1], out[3], w1, w2, scatter_add_plain)
    card_err = max((a - b).abs().max().item()
                   for a, b in zip(first[2:], card))
    if not all(torch.equal(a.cpu(), b) for a, b in zip(first[2:], ref)):
        err = max((a.cpu() - b).abs().max().item()
                  for a, b in zip(first[2:], ref))
        raise AssertionError(f"chamfer_directed: gradients differ from the "
                             f"plain backward on the cpu by {err}")
    log(f"  chamfer_directed{list(x.shape)}: launches {launches}; kernel N "
        "bit-equal to its plain version (distances and indices), gradients "
        "bit-equal to the plain backward on the cpu and over two runs, "
        f"{card_err} from the plain backward on the card")
    Bd = CHAMFER_DENSE[0]
    kernels.reset_launch_counts()
    d1, d2 = chamfer_directed(x[:Bd], y[:Bd])
    torch.cuda.synchronize()
    dense = kernels.launch_counts()
    if any(dense.values()):
        raise AssertionError(f"chamfer_directed{list(CHAMFER_DENSE)}: the "
                             f"dense route launched {dense}")
    if not (torch.equal(d1, out[0][:Bd]) and torch.equal(d2, out[2][:Bd])):
        raise AssertionError("chamfer_directed: the dense route's distances "
                             "differ from kernel N's")
    log(f"  chamfer_directed{list(CHAMFER_DENSE)}: dense route, no launch, "
        "distances equal to kernel N's")
    return {"launches": launches, "max_abs_err": 0.0,
            "plain_backward_on_card_err": card_err}, (x, y)


def check_jacobi_auction(d, regime) -> dict:
    """Kernel O in both modes through `auction(mode=...)` from launch
    counts of 0 (kernel O once, nothing else), against its plain version
    on the card: assignments, rounds and bidders bit-equal (the same f32
    and int32 operations). A pair whose cap was not spent must be a
    bijection; each pair's matched cost within N * eps of kernel E's on
    the same d (both solve to within N * eps of the optimum); two
    launches alike. Returns, per mode, the readings and the plain
    version's wall time."""
    import torch
    from sp_gan_tpu_torch.ops import kernels
    eps, iters, phases = regime
    B, N, M = d.shape

    def cost(a):
        return d.gather(2, a.long()[..., None]).sum((1, 2))
    e_cost = cost(kernels.auction(d, eps, iters, phases)[0])
    out = {}
    for mode in ("jacobi", "packed"):
        tag = f"auction[{mode}, {list(d.shape)}, eps {eps}, {iters}, " \
              f"{phases} ph]"
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        asg, rounds, bids = kernels.auction(d, eps, iters, phases,
                                            mode=mode)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        if launches != per(jacobi_auction=1):
            raise AssertionError(f"{tag}: launches {launches}")
        again = kernels.auction(d, eps, iters, phases, mode=mode)
        if not all(torch.equal(x, y) for x, y in zip((asg, rounds, bids),
                                                      again)):
            raise AssertionError(f"{tag}: two launches differ")
        t = time.perf_counter()
        asg_p, rounds_p, bids_p = kernels.jacobi_auction_plain(
            d, eps, iters, phases, mode=mode)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        mismatches = int((asg != asg_p).sum())
        if not (mismatches == 0 and torch.equal(rounds, rounds_p)
                and torch.equal(bids, bids_p)):
            raise AssertionError(
                f"{tag}: {mismatches} assignments, rounds {rounds.tolist()} "
                f"vs {rounds_p.tolist()}, bidders {bids.tolist()} vs "
                f"{bids_p.tolist()} differ from the plain version")
        spent = [int(r) >= iters for r in rounds.tolist()]
        for b in range(B):
            if not spent[b] and torch.unique(asg[b]).numel() != N:
                raise AssertionError(f"{tag}: pair {b} converged without a "
                                     "bijection")
        gap = (cost(asg) - e_cost).abs().tolist()
        log(f"  {tag}: bit-equal to the plain version and twice alike; "
            f"rounds "
            f"{rounds.tolist()} (cap {iters}, spent {spent}), bidders "
            f"{bids.tolist()}; cost minus kernel E's {gap} (limit "
            f"{N * eps}); plain version {plain_ms:.0f} ms")
        if max(gap) > N * eps:
            raise AssertionError(f"{tag}: cost beyond N * eps of kernel E's")
        out[mode] = {"launches": launches["jacobi_auction"],
                     "rounds": rounds.tolist(), "bidders": bids.tolist(),
                     "cap_spent": spent, "cost_gap_to_e": gap,
                     "plain_ms": plain_ms, "mismatches": mismatches,
                     "max_abs_err": 0.0}
    return out


def hold_jacobi_auction(d, regime, label: str) -> dict:
    """Kernel O in both modes on d: assignments, rounds and bidders
    bit-equal to its plain version and twice alike."""
    import torch
    from sp_gan_tpu_torch.ops import kernels
    out = {}
    for mode in ("jacobi", "packed"):
        tag = f"auction[{mode}, {label}{list(d.shape)}, {regime}]"
        got = kernels.jacobi_auction(d, *regime, mode=mode)
        again = kernels.jacobi_auction(d, *regime, mode=mode)
        want = kernels.jacobi_auction_plain(d, *regime, mode=mode)
        mismatches = int((got[0] != want[0]).sum())
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(
                f"{tag}: {mismatches} assignments, rounds "
                f"{got[1].tolist()} vs {want[1].tolist()}, bidders "
                f"{got[2].tolist()} vs {want[2].tolist()} differ from the "
                "plain version")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{tag}: two launches differ")
        log(f"  {tag}: bit-equal to the plain version and twice alike; "
            f"rounds {got[1].tolist()[:8]}, bidders {got[2].tolist()[:8]}"
            f"{' ...' if d.shape[0] > 8 else ''}")
        out[mode] = {"rounds": got[1].tolist(), "bidders": got[2].tolist(),
                     "mismatches": mismatches}
    return out


def check_jacobi_auction_hard(seed: int) -> dict:
    """Kernel O (`hold_jacobi_auction`) on inputs that reach its edge
    cases: `check_auction_hard`'s tie-heavy pairs (clouds on a coarse
    grid) at [2, 2048, 2048] in the training regime and [2, 1024, 1024] in
    the protocol regime; [2, 256, 258] (M not a multiple of 4: scalar
    loads, one block a pair) and [40, 256, 256] (B * 4 above the card's
    132 SMs: no cluster), in the protocol regime."""
    from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist
    import torch
    res = {}
    for n, regime in ((2048, TRAIN_REGIME), (1024, PROTOCOL)):
        pcs = torch.round(auction_pairs_clouds(n, 4, seed + 31) * 4) / 4
        d = pairwise_sqdist(pcs[:2], pcs[2:])
        res[f"ties/{n}"] = hold_jacobi_auction(d, regime, "ties ")
    pcs = auction_pairs_clouds(258, 4, seed + 37)
    d = pairwise_sqdist(pcs[:2, :256].contiguous(), pcs[2:])
    res["[2, 256, 258]"] = hold_jacobi_auction(d, PROTOCOL, "scalar ")
    res["[40, 256, 256]"] = hold_jacobi_auction(
        auction_pairs(256, 40, seed + 41), PROTOCOL, "no cluster ")
    return res


def check_chamfer_hard(seed: int) -> dict:
    """Kernel N on inputs with many equal distances, N and M not multiples
    of its tiles: duplicated points, an integer grid, x = y, one point
    repeated; and at C = 8 with N != M. All four outputs bit-equal to the
    plain version and twice alike."""
    import torch
    from sp_gan_tpu_torch.ops import kernels
    g = torch.Generator(device="cuda").manual_seed(seed + 43)
    x, y = chamfer_clouds(2, 1000, seed + 47)
    dup_x, dup_y = x.clone(), y[:, :700].clone()
    dup_x[:, 500:] = dup_x[:, :500]
    dup_y[:, 350:] = dup_y[:, :350]
    grid = torch.randint(-6, 7, (2, 1500, 3), generator=g, device="cuda",
                         dtype=torch.int64).float() * 0.125
    rep_x, rep_y = x.clone(), y[:, :513].clone()
    rep_x[:, 100:900] = rep_x[:, 7:8]
    rep_y[:, 30:400] = rep_y[:, 3:4]
    cases = {"duplicated": (dup_x, dup_y),
             "grid": (grid[:, :900].contiguous(), grid[:, 900:].contiguous()),
             "x=y": (x, x.clone()), "repeated": (rep_x, rep_y),
             "C=8, N != M": (torch.randn(3, 700, 8, generator=g,
                                         device="cuda"),
                             torch.randn(3, 333, 8, generator=g,
                                         device="cuda"))}
    res = {}
    for name, (a, b) in cases.items():
        got, again = kernels.chamfer_nn(a, b), kernels.chamfer_nn(a, b)
        want = kernels.chamfer_nn_plain(a, b)
        diff = [int((u != v).sum()) for u, v in zip(got, want)]
        if any(diff):
            raise AssertionError(f"chamfer_nn[{name}]: (d1, i1, d2, i2) "
                                 f"differ from the plain version in {diff}")
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            raise AssertionError(f"chamfer_nn[{name}]: two launches differ")
        log(f"  chamfer_nn[{name}, {list(a.shape)}, {list(b.shape)}]: "
            "bit-equal to the plain version and twice alike")
        res[name] = {"shape": [list(a.shape), list(b.shape)],
                     "mismatches": diff}
    return res


def last_kernels_phase(seed: int, idx_t, gen) -> dict:
    """Kernels M, N and O against their plain versions at the shapes of
    their paths (see `check_edge_scatter_bwd`, `check_chamfer`,
    `check_jacobi_auction`; O at [4, 2048, 2048] in the metric regime) and
    N and O on hard inputs (`check_chamfer_hard`,
    `check_jacobi_auction_hard`). Returns the readings and the inputs for
    the timings."""
    res, ins = {}, {}
    res["edge_scatter_bwd"], ins["d_ee"] = check_edge_scatter_bwd(idx_t, gen)
    res["chamfer"], ins["clouds"] = check_chamfer(seed, gen)
    res["chamfer_hard"] = check_chamfer_hard(seed)
    ins["d"] = auction_pairs(2048, 4, seed + 11)
    res["jacobi_auction"] = check_jacobi_auction(ins["d"], PROTOCOL)
    res["jacobi_auction_hard"] = check_jacobi_auction_hard(seed)
    return res, ins


def regularizers_phase(seed: int) -> dict:
    """For each of REGULARIZERS at Config() width: REG_WARMUP_STEPS warm-up
    and REG_TIMED_STEPS timed training steps with their launch counts
    (`timed_training`), one
    profiled step, and a small step on the card against the CPU
    (`check_small_steps`, one seed with both phases compared)."""
    from sp_gan_tpu_torch.config import Config
    res = {}
    for label, (kw, env, expected, still) in REGULARIZERS.items():
        with mock.patch.dict(os.environ, env):
            tr, run = timed_training(Config(seed=seed, **kw),
                                     REG_TIMED_STEPS, REG_WARMUP_STEPS,
                                     expected, label, still)
            run["profile"] = profile_call(lambda: tr.time_steps(1), label)
            del tr
            # G's gradients were compared in 1 of seeds 0-7 under
            # --gp_mapping on the H100 (near-tie flips in the G phase)
            run["small_step"] = check_small_steps(seed, 1, kw, tries=16)
        res[label] = run
    return res



def manipulate_phase(man, seed: int) -> dict:
    """The nine manipulation routines on the card at the width of `man`,
    with the CLI's arguments (`manipulate.run_routine`): per routine one
    warm-up call, then one call from launch counts of 0 (host ms ending in
    a synchronize), whose launches must be MANIPULATE's fused forwards
    times PER_REQUEST (style_interpolate: PER_STYLE_STEP a step) and whose
    clouds must be finite, of the right count and shape. Rows whose codes
    no edit touched must equal `forward` of those codes within 1e-5
    max-abs, and style_interpolate at alpha = 0 `Generator.forward` of its
    first code. Then part_exchange, style_interpolate (3 steps) and a
    2 x 3 part_interpolate_detail on the card against the same routines of
    the port on the CPU, at full width in float32 (the weights of `man`),
    both given the same codes drawn on the CPU, by
    `check_small_reference`'s rule at this width: 99% of the points within
    1e-3 and the median within MANIPULATE_MEDIAN. style_interpolate at
    `man`'s own dtype
    (mixed_edge: bf16 edges on its unfused path) is read beside it, not
    gated: on the H100 its median was 2.0e-4."""
    import dataclasses

    import numpy as np
    import torch
    from sp_gan_tpu_torch.data.noise import sample_z
    from sp_gan_tpu_torch.manipulate import (ROUTINES, Manipulator,
                                             region_mask, run_routine)
    from sp_gan_tpu_torch.nn.generator import Generator
    from sp_gan_tpu_torch.ops import kernels
    cfg, N = man.cfg, man.cfg.np
    mask = region_mask(man.ball, 0, N // 3)
    if tuple(MANIPULATE) != ROUTINES:
        raise AssertionError("MANIPULATE must list the CLI's routines")
    res = {}
    for r, (fused, shapes) in MANIPULATE.items():
        run_routine(man, r, mask, seed, MANIPULATE_STEPS)     # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        pcs, _ = run_routine(man, r, mask, seed, MANIPULATE_STEPS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = kernels.launch_counts()
        steps = MANIPULATE_STEPS if r == "style_interpolate" else 0
        for name in KERNEL_NAMES:
            want = fused * PER_REQUEST[name] + steps * PER_STYLE_STEP[name]
            if launches[name] != want:
                raise AssertionError(f"{r}: {name} launched "
                                     f"{launches[name]} times, expected "
                                     f"{want}")
        pcs = np.stack(pcs)
        if pcs.shape != (shapes, N, 3) or not np.isfinite(pcs).all():
            raise AssertionError(f"{r}: bad output: shape {pcs.shape}, "
                                 f"finite {np.isfinite(pcs).all()}")
        res[r] = {"ms": ms, "shapes": shapes,
                  "launches": {k: v for k, v in launches.items() if v}}
        log(f"  {r}: {ms:.2f} ms a call, {shapes} shapes, launches "
            f"{res[r]['launches']}")

    def same(tag, a, b):
        err = float(np.abs(a - b).max())
        log(f"  {tag}: max-abs {err:.3g} from forward of its codes")
        if not err <= 1e-5:
            raise AssertionError(f"{tag} differs from forward by {err}")
        return err

    za, zb = man.sample_codes(1, seed), man.sample_codes(1, seed + 1)
    with torch.inference_mode():
        plain = man.G(man.sphere[None], za, train=False).cpu().numpy()
    ident = {
        "part_edit original": same(
            "part_edit original", man.part_edit(mask, seed)[0],
            man.forward(za)[0]),
        "part_exchange a, b": same(
            "part_exchange a, b", man.part_exchange(mask, seed, seed + 1)[:2],
            man.forward(torch.cat([za, zb]))),
        "part_flip unflipped": same(
            "part_flip unflipped", man.part_flip(seed=seed)[:4],
            man.forward(man.sample_codes(4, seed))),
        "shape_interpolate alpha=0": same(
            "shape_interpolate alpha=0",
            man.shape_interpolate(seed, seed + 1, MANIPULATE_STEPS)[0],
            man.forward(za)[0]),
        "style_interpolate alpha=0": same(
            "style_interpolate alpha=0",
            man.style_interpolate(mask, seed, seed + 1, MANIPULATE_STEPS)[0],
            plain[0])}

    # the card against the CPU on codes drawn on the CPU, in float32 (as
    # check_small_reference): under mixed_edge the unfused path of
    # style_interpolate rounds its edges to bf16, and features that differ
    # in their last f32 bits round to other bf16 values on each device
    def twins(c):
        out = []
        for dev in ("cuda", "cpu"):
            G = Generator(c, seed=None)
            G.load_state_dict(man.G.state_dict())
            m = Manipulator(c, G, sphere=man.ball, device=dev)
            m.sample_codes = (lambda dev: lambda n, seed=0, per_point=None:
                              sample_z(torch.Generator().manual_seed(seed), n,
                                       N, c.nz, c.nv, c.n_rand).to(dev))(
                                           m.device)
            out.append(m)
        return out

    def vs_cpu_errors(fn, pair):
        t = time.perf_counter()
        card = fn(pair[0])
        t1 = time.perf_counter()
        cpu = fn(pair[1])
        cpu_s = time.perf_counter() - t1
        err = np.concatenate([np.abs(a - b).max(axis=-1).ravel()
                              for a, b in zip(card, cpu)])
        return card, {"max": float(err.max()),
                      "p99": float(np.quantile(err, 0.99)),
                      "median": float(np.median(err)),
                      "card_s": t1 - t, "cpu_s": cpu_s}

    pair = twins(dataclasses.replace(cfg, dtype="float32"))
    checks = {
        "part_exchange": lambda m: (m.part_exchange(mask, seed, seed + 1),),
        "style_interpolate (3 steps)": lambda m: (
            m.style_interpolate(mask, seed, seed + 1, 3),),
        "part_interpolate_detail (2 x 3)": lambda m: m.part_interpolate_detail(
            seed, seed + 1, alphas=(0.75, 0.25), mask_sizes=(0, N // 2, N))[:2]}
    vs_cpu = {}
    for tag, fn in checks.items():
        card, vs_cpu[tag] = vs_cpu_errors(fn, pair)
        log(f"  {tag}, float32: cuda vs cpu {vs_cpu[tag]}")
        if not (all(np.isfinite(a).all() for a in card)
                and vs_cpu[tag]["p99"] <= 1e-3
                and vs_cpu[tag]["median"] <= MANIPULATE_MEDIAN):
            raise AssertionError(f"{tag}: cuda disagrees with the cpu")
    # the same routine at Config()'s mixed_edge, read and not gated
    _, bf16 = vs_cpu_errors(checks["style_interpolate (3 steps)"],
                            twins(cfg))
    log(f"  style_interpolate (3 steps), {cfg.dtype} (bf16 edges): cuda vs "
        f"cpu {bf16}")
    return {"routines": res, "identity": ident, "vs_cpu": vs_cpu,
            "style_vs_cpu_mixed_edge": bf16}


def reference_dgcnn_state(seed: int, feat_dims: int = 1024) -> dict:
    """A DGCNN-cls state dict in the reference protocol's key layout
    (`module.encoder.conv{1..4}.0.weight` [out, 2C, 1, 1] and their
    BatchNorms, `conv5` [feat_dims, 512, 1], a classifier the carry
    drops), drawn from `seed`: no weights file is needed."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, loc=0.0):
        return torch.from_numpy((loc + scale * rng.standard_normal(shape))
                                .astype(np.float32))

    sd, fin = {}, 3
    for i, w in enumerate((64, 64, 128, 256)):
        sd[f"module.encoder.conv{i + 1}.0.weight"] = t(
            w, 2 * fin, 1, 1, scale=(2 * fin) ** -0.5)
        fin = w
    sd["module.encoder.conv5.0.weight"] = t(feat_dims, 512, 1,
                                            scale=512 ** -0.5)
    for i, w in enumerate((64, 64, 128, 256, feat_dims)):
        p = f"module.encoder.conv{i + 1}.1"
        sd[f"{p}.weight"] = t(w, scale=0.1, loc=1.0)
        sd[f"{p}.bias"] = t(w, scale=0.1)
        sd[f"{p}.running_mean"] = t(w, scale=0.1)
        sd[f"{p}.running_var"] = t(w, scale=0.1, loc=1.0).abs()
        sd[f"{p}.num_batches_tracked"] = torch.tensor(10)
    sd["module.classifier.linear1.weight"] = t(512, 2 * feat_dims)
    return sd


def checkpoints_phase(man, seed: int) -> dict:
    """Reference-layout checkpoints on the card: the generator of `man`
    and a discriminator drawn from seed + 1 written as `.pth` files in a
    temporary directory and read into fresh modules on the card, their
    state dicts bit-equal; a Trainer warm-started from the two files
    (`--restore --pretrain_model_G/_D`) generates 64 shapes bit-equal
    (`np.array_equal`) to `man`'s from the same codes and takes one step
    with finite losses; `FPD.from_torch` on a DGCNN state dict drawn in
    the reference's key layout and saved with `torch.save`."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    from sp_gan_tpu_torch import compat
    from sp_gan_tpu_torch.data import SyntheticDataset
    from sp_gan_tpu_torch.data.noise import sample_z
    from sp_gan_tpu_torch.eval.fpd import FPD
    from sp_gan_tpu_torch.manipulate import normalize_point_cloud
    from sp_gan_tpu_torch.nn import Discriminator, Generator
    from sp_gan_tpu_torch.train.trainer import Trainer, synthetic_dataset
    cfg, dev = man.cfg, torch.device("cuda")
    D = Discriminator(cfg, seed=seed + 1).to(dev)

    def equal(a, b, what):
        sa, sb = a.state_dict(), b.state_dict()
        if list(sa) != list(sb) or not all(torch.equal(sa[k], sb[k])
                                           for k in sa):
            raise AssertionError(f"{what}: state dicts differ")

    out = {}
    with tempfile.TemporaryDirectory() as d:
        g_path, d_path = os.path.join(d, "G.pth"), os.path.join(d, "D.pth")
        t = time.perf_counter()
        dp, ds = compat.discriminator_trees(D)
        compat.save_reference_checkpoint(
            g_path, *compat.generator_trees(man.G), cfg, epoch=3,
            d_path=d_path, d_params=dp, d_stats=ds)
        (gp, gs), d_trees, epoch = compat.load_reference_checkpoint(
            g_path, cfg, d_path)
        G2 = Generator(cfg, seed=None).to(dev)
        G2.load_state_dict(compat.generator_state_from_jax(gp, gs))
        D2 = Discriminator(cfg, seed=None).to(dev)
        D2.load_state_dict(compat.discriminator_state_from_jax(*d_trees))
        out["round_trip_s"] = time.perf_counter() - t
        equal(man.G, G2, "G after .pth export and import")
        equal(D, D2, "D after .pth export and import")
        if epoch != 3:
            raise AssertionError(f"epoch {epoch} read back, 3 written")
        tcfg = dataclasses.replace(cfg, seed=seed, restore=True,
                                   pretrain_model_G=g_path,
                                   pretrain_model_D=d_path, log_dir=d)
        tr = Trainer(tcfg, dataset=synthetic_dataset(tcfg), device="cuda",
                     logs=False)
        if tr.start_epoch != epoch + 1:
            raise AssertionError(f"start epoch {tr.start_epoch}")
        equal(tr.state.G, man.G, "the warm-started G")
        equal(tr.state.D, D, "the warm-started D")
        z = sample_z(torch.Generator(device=dev).manual_seed(seed + 5), 64,
                     cfg.np, cfg.nz, cfg.nv, cfg.n_rand)
        ours = tr.sample_fn(tr.state, z).cpu().numpy()
        if not np.array_equal(ours, man.forward(z)):
            raise AssertionError("the warm-started trainer generates other "
                                 "shapes than the exporting Manipulator")
        step = tr.time_steps(1)["metrics"][0]
        log(f"  .pth round trip {out['round_trip_s']:.2f} s, bit-equal; "
            f"warm start at epoch {tr.start_epoch}, 64 shapes bit-equal; "
            f"one step {step}")
        if not np.isfinite([step["d_loss"], step["g_loss"]]).all():
            raise AssertionError(f"warm-started step: {step}")
        out.update(start_epoch=tr.start_epoch, step=step)
        del tr
        w_path = os.path.join(d, "dgcnn.pkl")
        torch.save(reference_dgcnn_state(seed), w_path)
        fpd = FPD.from_torch(w_path, device="cuda")
        gen = normalize_point_cloud(torch.from_numpy(ours))
        ref = normalize_point_cloud(torch.from_numpy(
            SyntheticDataset(64, cfg.np, seed=seed).data))
        out["fpd"] = fpd(gen, ref)
        log(f"  FPD.from_torch (reference-layout DGCNN from seed {seed}, "
            f"k=40, 1024 dims): {out['fpd']:.4f}")
        if fpd.random_features or not np.isfinite(out["fpd"]):
            raise AssertionError(f"FPD.from_torch: {out['fpd']}")
    return out


# --------------------------------------------------------- trainer_parts
# the streaming cell: 45,000 clouds of 2048 points (1.1 GB, above the
# trainer's 1 GiB device-data line), a ShapeNet-scale training set
STREAM_CLOUDS = 45000
# the watchdog's stalled step: its limit, and the stall
STALL_LIMIT_S, STALL_S = 2, 60
STALL_CHILD = r"""
import dataclasses, sys, time
sys.path.insert(0, {root!r})
import torch
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.train.trainer import Trainer, synthetic_dataset
cfg = Config(np=256, bs=4, nk=8, max_epoch=1, steps_per_epoch=3,
             seed=1, log_dir={log_dir!r})
# CUDA, the kernel library and the step warmed up without a watchdog
warm = Trainer(cfg, dataset=synthetic_dataset(cfg), device="cuda",
               logs=False)
warm.time_steps(1)
torch.cuda.synchronize()
tr = Trainer(dataclasses.replace(cfg, watchdog_secs={limit}),
             dataset=synthetic_dataset(cfg), device="cuda", logs=False)
step, calls = tr.train_step, []
def stalling(state, real):
    calls.append(1)
    if len(calls) == 2:
        print("step 1 done; step 2 stalls", flush=True)
        time.sleep({stall})
    return step(state, real)
tr.train_step = stalling
tr.train()
print("train returned", flush=True)
"""


def check_prefetch(gen) -> dict:
    """`prefetch_to_device` lands six host batches of the streaming step's
    shape unchanged and in order, the consumer's stream kept busy while
    the copies run."""
    import torch
    from sp_gan_tpu_torch.data.prefetch import prefetch_to_device
    host = [torch.randn(24, 2048, 3, generator=gen).numpy()
            for _ in range(6)]
    got = []
    for b in prefetch_to_device(iter(host), size=2, device="cuda"):
        torch.cuda._sleep(2_000_000)
        got.append(b.cpu())
    bad = [i for i, (a, h) in enumerate(zip(got, host))
           if not torch.equal(a, torch.from_numpy(h))]
    if len(got) != len(host) or bad:
        raise AssertionError(f"prefetch_to_device: {len(got)} batches of "
                             f"{len(host)}, batches {bad} differ")
    return {"batches": len(got), "equal": True}


def check_watchdog_stall(tmp: str) -> dict:
    """A subprocess trains with --watchdog_secs STALL_LIMIT_S and a second
    step that sleeps STALL_S: it must print its first step, then the
    watchdog's message, and exit with 42 long before the stall ends."""
    code = STALL_CHILD.format(root=HERE, log_dir=tmp, limit=STALL_LIMIT_S,
                              stall=STALL_S)
    t = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=STALL_S + 120)
    secs = time.perf_counter() - t
    out = run.stdout
    log(f"  watchdog: a step stalled past {STALL_LIMIT_S} s; the child "
        f"exited {run.returncode} after {secs:.1f} s: "
        f"{out.strip().splitlines()[-1:]}")
    first, dog = out.find("step 1 done"), out.find("[watchdog]")
    if run.returncode != 42 or not 0 <= first < dog \
            or "train returned" in out:
        raise AssertionError(f"watchdog: exit {run.returncode}, stdout "
                             f"{out!r}, stderr {run.stderr[-2000:]!r}")
    return {"exit": run.returncode, "child_s": secs}


def check_save_and_snapshot(tmp: str) -> dict:
    """--save: without matplotlib the Trainer raises at once and names it;
    with it one dump writes the grid PNG and 64 .xyz files. The source
    snapshot is written once and a --restore keeps it."""
    import importlib.util

    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.train.trainer import Trainer, synthetic_dataset
    small = dict(np=256, bs=4, nk=8, seed=2)
    res = {"matplotlib": importlib.util.find_spec("matplotlib") is not None}
    cfg = Config(**small, save=True, log_dir=os.path.join(tmp, "save"))
    if not res["matplotlib"]:
        try:
            Trainer(cfg, dataset=synthetic_dataset(cfg), device="cuda")
        except RuntimeError as e:
            if "matplotlib" not in str(e):
                raise
            res["raised"] = str(e)
        else:
            raise AssertionError("--save without matplotlib did not raise")
        if os.path.exists(cfg.log_dir):
            raise AssertionError("--save without matplotlib wrote files")
    else:
        tr = Trainer(cfg, dataset=synthetic_dataset(cfg), device="cuda")
        tr.dump_samples(1, 20)
        tr.close()
        plot = os.path.join(cfg.log_dir, "plot")
        xyz = [f for _, _, fs in os.walk(os.path.join(plot, "sample"))
               for f in fs if f.endswith("_step_20.xyz")]
        if len(xyz) != 64 or not os.path.getsize(
                os.path.join(plot, "20.png")):
            raise AssertionError(f"--save wrote {len(xyz)} .xyz files")
        res["xyz_files"] = len(xyz)
    log(f"  --save: {res}")
    cfg = Config(**small, log_dir=os.path.join(tmp, "snap"))
    Trainer(cfg, dataset=synthetic_dataset(cfg), device="cuda").close()
    mine = os.path.join(cfg.log_dir, "src_snapshot", "sp_gan_tpu_torch",
                        "train", "trainer.py")
    with open(os.path.join(HERE, "sp_gan_tpu_torch", "train",
                           "trainer.py")) as f, open(mine) as g:
        if f.read() != g.read():
            raise AssertionError("snapshot: trainer.py differs")
    with open(mine, "w") as f:
        f.write("# the code the run started with\n")
    cfg.restore = True
    Trainer(cfg, dataset=synthetic_dataset(cfg), device="cuda").close()
    with open(mine) as f:
        if f.read() != "# the code the run started with\n":
            raise AssertionError("snapshot: --restore overwrote it")
    log("  source snapshot written once, kept on --restore")
    return {**res, "snapshot": "written once"}


def trainer_parts_phase(seed: int) -> dict:
    """The trainer's remaining parts at Config() width (bs=24, N=2048): 3 +
    10 steps on device data with and without --augment (the first with
    --watchdog_secs 120), and streamed from a host dataset of
    STREAM_CLOUDS clouds with and without --augment, each with the default
    step's launches and profiled over 5 more steps; the prefetcher; a
    stalled step under the watchdog; --save; the source snapshot."""
    import tempfile

    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.data import SyntheticDataset
    from sp_gan_tpu_torch.train import trainer as trainer_mod
    res = {"prefetch": check_prefetch(
        torch.Generator().manual_seed(seed + 31))}
    t = time.perf_counter()
    stream = SyntheticDataset(n_items=STREAM_CLOUDS, n_points=2048,
                              seed=seed)
    log(f"  host dataset of {STREAM_CLOUDS} clouds, "
        f"{stream.data.nbytes / 1e9:.3f} GB, made in "
        f"{time.perf_counter() - t:.1f} s")
    if stream.data.nbytes <= trainer_mod.DEVICE_DATA_BYTES:
        raise AssertionError("the streaming cell must be above the line")
    cells = {"device": ({}, None), "device --augment": (
        dict(augment=True, watchdog_secs=120), None),
        "streaming": ({}, stream),
        "streaming --augment": (dict(augment=True), stream)}
    for label, (kw, ds) in cells.items():
        cfg = Config(seed=seed, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tr, run = timed_training(cfg, TIMED_STEPS, WARMUP_STEPS, PER_STEP,
                                 f"{label} step", dataset=ds)
        if (tr.data is None) != (ds is not None):
            raise AssertionError(f"{label}: wrong data path")
        if kw.get("watchdog_secs") and (tr._dog is None or tr._dog.fired):
            raise AssertionError(f"{label}: the watchdog is not armed")
        run["profile"] = profile_call(lambda: tr.time_steps(5),
                                      f"5 {label} steps")
        run["peak_mem_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        # what the trainer keeps on the card between steps: its state, and
        # on device data the dataset
        run["resident_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
        tr.close()
        del tr
        res[label] = run
        log(f"  {label}: {run['ms_per_step']:.3f} ms/step, device idle "
            f"{100 * run['profile']['idle_share']:.1f}% over 5 steps, peak "
            f"memory {run['peak_mem_gb']:.3f} GB, resident "
            f"{run['resident_gb']:.3f} GB")
        if ds is not None and run["resident_gb"] * 1e9 >= ds.data.nbytes / 2:
            raise AssertionError(f"{label}: the dataset reached the card")
    dev = res["device"]["ms_per_step"]
    for label in cells:
        res[label]["vs_device"] = res[label]["ms_per_step"] / dev
    log("  ms/step against the device-data step: " + ", ".join(
        f"{label} {res[label]['vs_device']:.4f}" for label in cells))
    with tempfile.TemporaryDirectory() as tmp:
        res["watchdog"] = check_watchdog_stall(os.path.join(tmp, "stall"))
        res["save"] = check_save_and_snapshot(tmp)
    del stream
    return res


# -------------------------------------------------------------- emd_large
# one pair past kernel E's 1 GiB line, and the line itself
EMD_LARGE_N, EMD_LINE_N = 20480, 16384
# the cap of the runs that must end on their own
EMD_OPEN_CAP = 100000


def emd_certificate(d, asg, price, eps: float) -> dict:
    """In float64, row chunk by row chunk: each row's slack, max_j(-d - p)
    less its own item's -d - p (at most eps in the final phase: eps
    complementary slackness), and the dual value (sum of the rows' maxima
    plus the prices) less the primal value (-cost), at most N * eps for a
    full assignment."""
    import torch
    p = price.double()
    a_own = -d.gather(1, asg.long()[:, None])[:, 0].double()
    worst, dual = 0.0, float(p.sum())
    for lo in range(0, d.shape[0], 1024):
        best = (-d[lo:lo + 1024].double() - p).amax(dim=1)
        own = a_own[lo:lo + 1024] - p[asg[lo:lo + 1024].long()]
        worst = max(worst, float((best - own).max()))
        dual += float(best.sum())
    return {"max_slack": worst, "gap": dual - float(a_own.sum()),
            "cost": -float(a_own.sum()), "n_eps": d.shape[0] * eps}


def emd_large_phase(seed: int) -> dict:
    """The scaled EMD above kernel E's limit (`auction_scaled_jacobi`): one
    pair at N = M = EMD_LARGE_N through emd_auction(scaled=True) in the
    protocol regime (seconds, rounds, forced rows, peak memory; each row
    within eps of its best item, and where the rounds ended before the cap
    a bijection within N * eps of the dual), the same d solved to its end
    under a cap of EMD_OPEN_CAP (a bijection, dual gap at most N * eps);
    at the line (N = EMD_LINE_N) kernel E through the route and
    `auction_scaled_jacobi` on the same d, both ended, their costs within
    N * eps; `auction_scaled_jacobi` on the card and on the CPU at
    [2, 512, 512] bit for bit."""
    import torch
    from sp_gan_tpu_torch.ops import emd, kernels
    eps, iters, phases = PROTOCOL
    res = {}
    pcs = auction_pairs_clouds(EMD_LARGE_N, 2, seed + 41)
    x, y = pcs[:1].contiguous(), pcs[1:].contiguous()
    del pcs
    state = {}
    solve = emd.auction_scaled_jacobi

    def recorded(d, *a, **k):
        asg, price, rounds = solve(d, *a, **k, return_state=True)
        state.update(price=price, rounds=rounds)
        return asg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    with mock.patch.object(emd, "auction_scaled_jacobi", recorded):
        t = time.perf_counter()
        dist, asg = emd.emd_auction(x, y, eps, iters, scaled=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    # the call's own peak, above what earlier phases left allocated
    peak = torch.cuda.max_memory_allocated() - base
    n = EMD_LARGE_N
    if sum(kernels.launch_counts().values()):
        raise AssertionError("emd_large: a kernel launched above the line")
    if dist.shape != (1, n) or not torch.isfinite(dist).all():
        raise AssertionError(f"emd_large: dist {tuple(dist.shape)}")
    d = emd._sqdist_rows(x[0], y[0])
    cert = emd_certificate(d, asg[0], state["price"], eps)
    distinct = int(torch.unique(asg[0]).numel())
    res["protocol"] = dict(seconds=secs, rounds=state["rounds"], cap=iters,
                           distinct_items=distinct,
                           peak_mem_gb=peak / 1e9,
                           matrix_gb=n * n * 4 / 1e9, **cert)
    log(f"  emd_auction(scaled=True) at N = M = {n}: {secs:.2f} s, "
        f"{state['rounds']} rounds (cap {iters}), {distinct} distinct "
        f"items, peak memory {peak / 1e9:.3f} GB (d {n * n * 4 / 1e9:.3f} "
        f"GB); {cert}")
    if cert["max_slack"] > eps * (1 + 1e-3) + 1e-5:
        raise AssertionError(f"emd_large: a row beyond eps of its best "
                             f"item {cert}")
    if state["rounds"] < iters and (distinct != n
                                    or cert["gap"] > cert["n_eps"]):
        raise AssertionError(f"emd_large: ended but not a bijection within "
                             f"N * eps: {distinct} items, {cert}")
    t = time.perf_counter()
    asg2, price2, rounds2 = solve(d, eps, EMD_OPEN_CAP, phases,
                                  return_state=True)
    torch.cuda.synchronize()
    cert2 = emd_certificate(d, asg2, price2, eps)
    res["to_the_end"] = dict(seconds=time.perf_counter() - t,
                             rounds=rounds2, cap=EMD_OPEN_CAP, **cert2)
    log(f"  the same d to its end: {res['to_the_end']}")
    if rounds2 >= EMD_OPEN_CAP or torch.unique(asg2).numel() != n \
            or cert2["gap"] > cert2["n_eps"]:
        raise AssertionError(f"emd_large: no bijection within N * eps "
                             f"{res['to_the_end']}")
    del d, asg2, price2, x, y, dist, asg
    # the line: kernel E's last size, through the route, and item 8
    n = EMD_LINE_N
    pcs = auction_pairs_clouds(n, 2, seed + 43)
    kernels.reset_launch_counts()
    t = time.perf_counter()
    asg_e = emd.emd_auction(pcs[:1], pcs[1:], eps, iters, scaled=True)[1][0]
    torch.cuda.synchronize()
    e_s = time.perf_counter() - t
    if kernels.launch_counts()["auction"] != 1:
        raise AssertionError("emd_large: kernel E did not take the line")
    d = emd._sqdist_rows(pcs[0], pcs[1])
    t = time.perf_counter()
    asg_j, price_j, rounds_j = solve(d, eps, EMD_OPEN_CAP, phases,
                                     return_state=True)
    torch.cuda.synchronize()
    j_s = time.perf_counter() - t
    costs = [float(d.gather(1, a.long()[:, None]).double().sum())
             for a in (asg_e, asg_j)]
    distinct = [int(torch.unique(a).numel()) for a in (asg_e, asg_j)]
    res["line"] = dict(n=n, kernel_e_s=e_s, scaled_jacobi_s=j_s,
                       scaled_jacobi_rounds=rounds_j, costs=costs,
                       distinct_items=distinct, n_eps=n * eps)
    log(f"  at N = M = {n}: {res['line']}")
    if distinct != [n, n] or abs(costs[0] - costs[1]) > n * eps:
        raise AssertionError(f"emd_large: kernel E and "
                             f"auction_scaled_jacobi at the line "
                             f"{res['line']}")
    del d, pcs, asg_e, asg_j
    # the card against the CPU, bit for bit
    d = auction_pairs(512, 2, seed + 47)
    same = []
    for b in range(2):
        gpu = solve(d[b], eps, iters, phases, return_state=True)
        cpu = solve(d[b].cpu(), eps, iters, phases, return_state=True)
        same.append(torch.equal(gpu[0].cpu(), cpu[0])
                    and torch.equal(gpu[1].cpu(), cpu[1])
                    and gpu[2] == cpu[2])
    res["card_vs_cpu_512"] = same
    log(f"  auction_scaled_jacobi at [2, 512, 512], card against CPU "
        f"(assignments, prices, rounds): {same}")
    if not all(same):
        raise AssertionError("emd_large: card and CPU differ")
    return res


def divergence(card, cpu, gap_of) -> dict:
    """Integer outputs of the card against the CPU: the count of entries
    that differ and, at the first, both values and `gap_of(position, card
    value, cpu value)`, the relative f64 gap between the two choices. A gap
    above NEAR_TIE is a fault, not a near-tie."""
    card = card.cpu()
    diff = card != cpu
    res = {"mismatches": int(diff.sum())}
    if res["mismatches"]:
        pos = tuple(int(v) for v in diff.nonzero()[0])
        a, c = int(card[pos]), int(cpu[pos])
        gap = float(gap_of(pos, a, c))
        res.update(first=list(pos), card=a, cpu=c, gap=gap,
                   near_tie=gap <= NEAR_TIE)
        if gap > NEAR_TIE:
            raise AssertionError(f"card and CPU part at {pos} ({a} against "
                                 f"{c}) with a gap of {gap:.3g}: not a "
                                 "near-tie")
    return res


def rel_gap(u, v) -> float:
    return abs(u - v) / max(abs(u), abs(v), 1e-300)


def dist_gap(q, x, a, c=None, r2=None) -> float:
    """The f64 gap between |q - x[a]|^2 and |q - x[c]|^2 (q [C], x [M, C]
    f64), or the threshold r2, on the scale that `pairwise_sqdist`'s f32
    expansion |q|^2 - 2 q.x + |x|^2 rounds at, |q|^2 + |x|^2."""
    def d(j):
        return float(((q - x[j]) ** 2).sum())
    pts = [a] if c is None else [a, c]
    norms = float((q * q).sum()) + max(float((x[j] * x[j]).sum())
                                       for j in pts)
    return abs(d(a) - (r2 if c is None else d(c))) / max(norms, 1e-300)


def legacy_phase(seed: int) -> dict:
    """The point-network layer library (`nn/pointnet.py`, `ops/sampling.py`,
    `ops/grouping.py`, `ops/expansion.py`, `losses/point_aux.py`,
    `losses/shape_preserving.py`; plain PyTorch, no kernel of its own) at
    the published widths of LEGACY: each call's ms on the card (CUDA
    events, median of 3 after one warm-up) and seconds on the CPU; the
    card's float outputs, BatchNorm running statistics and gradients
    within LEGACY_TOL of the CPU's largest entry, its integer outputs (FPS,
    MDS, ball query, kNN, the MST assignment, the Chamfer matches) equal
    to the CPU's or parted only at a near-tie (`divergence`). The modules
    with BatchNorm are compared at the full batch; the rest, whose clouds
    do not meet, on the first LEGACY_ROWS of the batch on both sides (the
    CPU's share of the phase). Inputs are synthetic shapes and normal
    draws from `seed`; each module is drawn on the CPU from `seed` and
    copied to the card."""
    import copy

    import torch
    from sp_gan_tpu_torch.data import SyntheticDataset
    from sp_gan_tpu_torch.losses import (repulsion_loss,
                                         shape_preserving_loss, uniform_loss,
                                         uniform_loss_knn)
    from sp_gan_tpu_torch.losses.shape_preserving import \
        local_mean_covariance
    from sp_gan_tpu_torch.nn import pointnet as pn
    from sp_gan_tpu_torch.ops import expansion, grouping, sampling
    from sp_gan_tpu_torch.ops.pairwise import first_argmin, pairwise_sqdist
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    B, N = LEGACY_B, LEGACY_N
    gen = torch.Generator().manual_seed(seed + 31)
    xyz = torch.from_numpy(SyntheticDataset(B, N, seed + 31).data)
    xyz2 = torch.from_numpy(SyntheticDataset(B, N, seed + 32).data)
    feats = torch.randn(B, N, LEGACY["pt"]["dim"], generator=gen)
    w_pt = torch.randn(B, N, LEGACY["pt"]["dim"], generator=gen)
    ex = LEGACY["expansion"]
    # the synthetic lattice jittered, so that some MST edges pass alpha
    # times their primitive's mean and the backward has points to move
    xe = torch.from_numpy(SyntheticDataset(ex["B"], ex["N"], seed + 33).data)
    xe = xe + 0.02 * torch.randn(xe.shape, generator=gen)
    we = torch.randn(ex["B"], ex["N"], generator=gen)
    rows = {B: LEGACY_ROWS, ex["B"]: max(ex["B"] * LEGACY_ROWS // B, 1)}
    res = {}

    def held(name, setup, batch=None, scale_of=None, grads_elsewhere=()):
        """`setup(device, n)` -> a call returning {key: tensor} on the first
        n clouds of the inputs; the CPU's first call against the card's
        first call on the first rows[batch] clouds (all without `batch`),
        then the card's ms at the full batch. An output whose exact value
        is zero is held on the scale of the output `scale_of` names for
        it; the outputs in `grads_elsewhere` are left to the caller."""
        n = rows[batch] if batch else None
        t = time.perf_counter()
        ref = setup(cpu, n)()
        cpu_s = time.perf_counter() - t
        got = setup(dev, n)()
        torch.cuda.synchronize()
        r = {"cpu_s": cpu_s, "compared_clouds": n or "all", "rel_err": {}}
        for key, want in ref.items():
            if not want.dtype.is_floating_point or key in grads_elsewhere:
                continue
            err = (got[key].detach().cpu().double()
                   - want.detach().double()).abs().max().item()
            scale = ref[(scale_of or {}).get(key, key)].detach().double() \
                .abs().max().item()
            r["rel_err"][key] = err / max(scale, 1e-300)
            if not err <= LEGACY_TOL * scale:
                raise AssertionError(f"legacy {name}[{key}]: card against "
                                     f"CPU {err:.3g}, over {LEGACY_TOL} of "
                                     f"{scale:.3g}")
        r["ms"] = cuda_ms(setup(dev, None), 3)
        log(f"  {name}: {r['ms']:.3f} ms on the card, {cpu_s:.2f} s on the "
            f"CPU ({r['compared_clouds']} clouds); card against CPU (of the "
            "CPU's max-abs) " + ", ".join(f"{k} {v:.2e}"
                                         for k, v in r["rel_err"].items()))
        res[name] = r
        return {"ref": ref, "got": got, **r}

    def on(d, n, *ts):
        return [None if t is None else t[:n].to(d) for t in ts]

    def module_call(module, *args):
        """A module's training-mode call (BatchNorm on batch statistics,
        the running ones updated: both compared) on a fresh copy."""
        def setup(d, n):
            m = copy.deepcopy(module).to(d)
            a = on(d, n, *args)

            def run():
                out = m(*a, train=True)
                o = {f"out{i}": t for i, t in enumerate(
                    out if isinstance(out, tuple) else (out,))}
                o["running"] = torch.cat([b.flatten() for b in m.buffers()])
                return o
            return run
        return setup

    def grads_of(loss_fn, *ts):
        def setup(d, n):
            ins = on(d, n, *ts)

            def run():
                xs = [t.clone().requires_grad_() for t in ins]
                out = loss_fn(*xs)
                out = out if isinstance(out, tuple) else (out,)
                sum(out).backward()
                return {**{f"loss{i}": o for i, o in enumerate(out)},
                        **{f"d_in{i}": x.grad for i, x in enumerate(xs)}}
            return run
        return setup

    # integer outputs: FPS, the ball query and kNN at SA1's, PointConv's
    # and the PointTransformer's calls, on the CPU's centres
    sa1, sa2 = LEGACY["sa"]
    x64 = xyz.double()
    fps = held("farthest_point_sample", lambda d, n: lambda: {
        "idx": sampling.farthest_point_sample(*on(d, n, xyz),
                                              sa1["npoint"])}, B)

    def fps_gap(pos, a, c):
        b, i = pos
        pre = fps["ref"]["idx"][b, :i].long()
        m = ((x64[b][:, None] - x64[b][pre][None]) ** 2).sum(-1).amin(1)
        return rel_gap(float(m[a]), float(m[c]))
    res["farthest_point_sample"]["cpu_vs_card"] = divergence(
        fps["got"]["idx"], fps["ref"]["idx"], fps_gap)
    centres = sampling.gather_points(xyz, sampling.farthest_point_sample(
        xyz, sa1["npoint"]))
    c64 = centres.double()
    r2 = sa1["radius"] ** 2
    bq = held("ball_query", lambda d, n: lambda: {"idx": sampling.ball_query(
        sa1["radius"], sa1["nsample"], *on(d, n, xyz, centres))}, B)
    res["ball_query"]["cpu_vs_card"] = divergence(
        bq["got"]["idx"], bq["ref"]["idx"], lambda p, a, c: min(
            dist_gap(c64[p[0], p[1]], x64[p[0]], a, r2=r2),
            dist_gap(c64[p[0], p[1]], x64[p[0]], c, r2=r2)))
    for name, k, q in (("knn_query[PointConv]", LEGACY["pointconv"]
                        ["nsample"], centres),
                       ("knn_query[PointTransformer]", LEGACY["pt"]["k"],
                        xyz)):
        kq = held(name, lambda d, n, k=k, q=q: lambda: {
            "idx": grouping.knn_query(k, *on(d, n, xyz, q))[0]}, B)
        q64 = q.double()
        res[name]["cpu_vs_card"] = divergence(
            kq["got"]["idx"], kq["ref"]["idx"], lambda p, a, c, q64=q64:
            dist_gap(q64[p[0], p[1]], x64[p[0]], a, c))

    # the modules at the full batch
    m_sa1 = pn.SetAbstraction(sa1["npoint"], sa1["radius"], sa1["nsample"],
                              sa1["mlp"], seed=seed)
    m_sa2 = pn.SetAbstraction(sa2["npoint"], sa2["radius"], sa2["nsample"],
                              sa2["mlp"], in_channels=sa1["mlp"][-1],
                              seed=seed + 1)
    msg = LEGACY["msg"]
    m_msg = pn.SetAbstractionMSG(msg["npoint"], msg["radii"],
                                 msg["nsamples"], msg["mlps"], seed=seed + 2)
    m_fp = pn.FeaturePropagation(LEGACY["fp"]["mlp"],
                                 in_channels=sa2["mlp"][-1], seed=seed + 3)
    pc = LEGACY["pointconv"]
    m_pc = pn.PointConv(pc["npoint"], pc["nsample"], pc["mlp"],
                        pc["bandwidth"], seed=seed + 4)
    pt = LEGACY["pt"]
    m_pt = pn.PointTransformerLayer(pt["dim"], k=pt["k"], seed=seed + 5)
    l1 = held("SetAbstraction[SSG 1]", module_call(m_sa1, xyz))["ref"]
    l2 = held("SetAbstraction[SSG 2]", module_call(
        m_sa2, l1["out0"], l1["out1"]))["ref"]
    held("SetAbstractionMSG", module_call(m_msg, xyz))
    held("FeaturePropagation", module_call(m_fp, xyz, l2["out0"], None,
                                           l2["out1"]))
    held("PointConv", module_call(m_pc, xyz))

    def pt_setup(d, n):
        m = copy.deepcopy(m_pt).to(d)
        x0, p0, w = on(d, n, feats, xyz, w_pt)

        def run():
            m.zero_grad(set_to_none=True)
            x, p = x0.clone().requires_grad_(), p0.clone().requires_grad_()
            out = m(x, p)
            (out * w).sum().backward()
            return {"out": out, "d_x": x.grad, "d_pos": p.grad,
                    **{f"d_{k}": q.grad for k, q in m.named_parameters()}}
        return run
    # the softmax over the group axis does not see attn2's bias (the same
    # shift for every neighbour), so its exact gradient is zero
    held("PointTransformerLayer (+ backward)", pt_setup, B,
         scale_of={"d_attn2.bias": "d_attn2.kernel"})

    # MSN's expansion penalty with its backward, then MDS on its cloud at
    # its mean MST length
    def exp_setup(d, n):
        x0, w = on(d, n, xe, we)

        def run():
            x = x0.clone().requires_grad_()
            dist, assign, mean = expansion.expansion_penalty(
                x, ex["P"], ex["alpha"])
            (dist * w).sum().backward()
            return {"dist": dist, "assign": assign, "mean_mst_length": mean,
                    "d_xyz": x.grad}
        return run
    exp = held("expansion_penalty (+ backward)", exp_setup, ex["B"])
    n_e = rows[ex["B"]]
    _, edge_len = expansion._prim_mst(xe[:n_e].reshape(-1, ex["P"], 3))
    mean_len = edge_len.double().sum(-1) / (ex["P"] - 1)
    lens = edge_len.double().reshape(n_e, ex["N"])
    thr = (ex["alpha"] * mean_len).repeat_interleave(ex["P"]).reshape(
        n_e, ex["N"])
    res["expansion_penalty (+ backward)"]["cpu_vs_card"] = divergence(
        exp["got"]["assign"], exp["ref"]["assign"],
        lambda p, a, c: rel_gap(float(lens[p]), float(thr[p])))
    res["expansion_penalty (+ backward)"]["penalized"] = int(
        (exp["ref"]["assign"] >= 0).sum())
    sigma = expansion.expansion_penalty(xe.to(dev), ex["P"], ex["alpha"])[2]
    def mds_setup(d, n):
        x, s = on(d, n, xe, sigma)
        return lambda: {"idx": sampling.minimum_density_sample(
            x, LEGACY["mds"], s)}
    mds = held("minimum_density_sample", mds_setup, ex["B"])
    xe64, s64 = xe.double(), sigma.cpu().double()

    def mds_gap(pos, a, c):
        b, i = pos
        pre = mds["ref"]["idx"][b, :i].long()
        d2 = ((xe64[b][:, None] - xe64[b][pre][None]) ** 2).sum(-1)
        dens = torch.exp(-d2 / float(s64[b]) ** 2).sum(1)
        return rel_gap(float(dens[a]), float(dens[c]))
    res["minimum_density_sample"]["cpu_vs_card"] = divergence(
        mds["got"]["idx"], mds["ref"]["idx"], mds_gap)

    # the reference losses at their defaults
    held("uniform_loss", lambda d, n: lambda: {
        "loss": uniform_loss(*on(d, n, xyz))}, B)
    held("uniform_loss_knn", lambda d, n: lambda: {
        "loss": uniform_loss_knn(*on(d, n, xyz))}, B)
    held("repulsion_loss (+ backward)", grads_of(repulsion_loss, xyz), B)

    # shape_preserving_loss's Chamfer terms match each neighbourhood's mean
    # and covariance to the nearest of the other cloud's. On smooth
    # surfaces neighbouring means and covariances lie close, so a match's
    # gradient, which the f32 distance |p|^2 - 2 p.q + |q|^2 gives as
    # 2 p - 2 q summed apart, cancels, and the card's and the CPU's
    # roundings of p and q (other summation orders) weigh in it; a near-tie
    # can also part the matches. So the matches are integer outputs (held
    # as `divergence` holds them), and each side's gradients are held to
    # the f64 gradient on its own matches: the card's no farther from it
    # than twice the CPU's (or LEGACY_TOL of its largest entry)
    sp_k, n_sp = LEGACY["sp_k"], rows[B]

    def sp_features(d, dtype=torch.float32):
        """(pt1, pt2 requiring grad, the means and flattened covariances
        [(mu1, mu2), (v1, v2)]) of the loss on the first clouds, on d."""
        a, b = [t[:n_sp].to(d, dtype).clone().requires_grad_()
                for t in (xyz, xyz2)]
        mu1, v1 = local_mean_covariance(grouping.group_points(
            a, grouping.knn_query(sp_k, a, a)[0]))
        mu2, v2 = local_mean_covariance(grouping.group_points(
            b, grouping.knn_query(sp_k, b, a)[0]))
        return a, b, ((mu1, mu2), (v1.flatten(2), v2.flatten(2)))

    def sp_matches(d):
        """The four match sets [4, n, N] of the two Chamfer sums on d
        (pt1's to pt2's and back; means, then covariances) and the
        features in f64."""
        with torch.no_grad():
            feats_ = sp_features(d)[2]
            found = []
            for p, q in feats_:
                dd = pairwise_sqdist(p, q)
                found += [first_argmin(dd), first_argmin(dd.transpose(1, 2))]
        return torch.stack(found).cpu(), [t.cpu().double() for pq in feats_
                                          for t in pq]

    def sp_grads64(pin):
        """(d_pt1, d_pt2) of the two Chamfer sums in f64 on the CPU, each
        match pinned to `pin` and its distance taken directly."""
        a, b, feats_ = sp_features(cpu, torch.float64)
        loss, i = 0.0, 0
        for p, q in feats_:
            for u, v in ((p, q), (q, p)):
                loss = loss + ((u - sampling.gather_points(v, pin[i])) ** 2
                               ).sum() / N
                i += 1
        loss.backward()
        return a.grad, b.grad
    sp = held("shape_preserving_loss (+ backward)", grads_of(
        lambda a, b: shape_preserving_loss(a, b, sp_k), xyz, xyz2), B,
        grads_elsewhere=("d_in0", "d_in1"))
    card_m = sp_matches(dev)[0]
    cpu_m, f64 = sp_matches(cpu)

    def sp_gap(pos, a, c):
        t_, b, i = pos
        p, q = f64[2 * (t_ // 2)], f64[2 * (t_ // 2) + 1]
        if t_ % 2:
            p, q = q, p
        return dist_gap(p[b, i], q[b], a, c)
    out = res["shape_preserving_loss (+ backward)"]
    out["matches"] = divergence(card_m, cpu_m, sp_gap)
    g64_card = sp_grads64(card_m)
    g64_cpu = g64_card if torch.equal(card_m, cpu_m) else sp_grads64(cpu_m)
    out["grad_vs_f64"] = {}
    for i, key in enumerate(("d_in0", "d_in1")):
        scale = g64_card[i].abs().max().item()
        card = (sp["got"][key].detach().cpu().double()
                - g64_card[i]).abs().max().item()
        own = (sp["ref"][key].detach().double() - g64_cpu[i]).abs().max() \
            .item()
        out["grad_vs_f64"][key] = {"card": card / scale,
                                   "cpu": own / scale}
        if not card <= max(2 * own, LEGACY_TOL * scale):
            raise AssertionError(f"legacy shape_preserving_loss[{key}]: the "
                                 f"card {card:.3g} from the f64 gradient, "
                                 f"the CPU {own:.3g} (max {scale:.3g})")
    log(f"  shape_preserving_loss: gradients from f64 on each side's "
        f"matches (of its max-abs) {out['grad_vs_f64']}; matches "
        f"{out['matches']} of {4 * n_sp * N}")
    return res


# the parallel phase: the data-parallel step at Config() width, 3 steps;
# the point-sharded step at the JAX package's large configuration
# (tests/test_points_sharding.py:330-352), one step; the sharded protocol
# on 4 x 4 clouds of 2048 points at eps 0.005 (4 phases) with a cap of
# rounds the Jacobi auction does not reach there: its pairs take 2,700 to
# 12,600 rounds one by one (on the CPU), and 16 in lockstep about 19,600
# (the slowest pair's, each phase; measured on the H100); with a cap of
# 5000 some pairs stopped there, their forced passes 30% below kernel E's
# matchings
PARALLEL_STEPS = 3
PARALLEL_16K = dict(np=16384, bs=2, nk=20)
PARALLEL_PROTOCOL = (4, 2048, 0.005, 20000)
# the points of the pair on which the sharded auction is held to
# `auction_scaled_jacobi` round for round
PARALLEL_PAIR_N = 512
# the point-sharded step's g_loss against the one-device step's on the
# same D: the sharded EdgeConv2 rounds its bf16 diffs as nbr - central
# once (as the JAX package's edge_diff_local), the one-device gather of
# 16384 points rounds nbr and central apart, the instance norms sum in
# another order, and at bs 2 the generator's global BatchNorm turns that
# into flips of a channel's sign (on the CPU at N = 8200: 3.1% on the
# same D, 9.3% free, with 12 of 164,000 G-phase picks apart); the bound
# catches a step that is not the same function, not rounding
PARALLEL_16K_LOSS_TOL = 0.1
# the point-sharded sampler against the one-device one (fused eval path)
# at N 16384 in float32, as the manipulate phase holds the card against
# the CPU: 99% of the coordinates within 1e-3, the median within
# MANIPULATE_MEDIAN (a near-tie neighbour swap moves a shape's pool)
PARALLEL_SAMPLE_P99 = 1e-3
# the sharded protocol's entries against kernel E's (another matching
# within the same eps)
PARALLEL_PROTOCOL_TOL = 1e-2
# the parallel phase's device (a rehearsal on the CPU sets "cpu")
PARALLEL_DEVICE = "cuda"


def _nccl_group(tmp: str, rank: int = 0, world: int = 1) -> None:
    """The default process group over NCCL, meeting in a FileStore."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)


def parallel_steps(cfg, mesh, real, steps: int, pinned=None) -> dict:
    """`steps` training steps of a fresh state of `cfg` on the card (with
    `mesh` the data-parallel step on the rank's rows of each whole batch
    in `real`), from launch counts of 0: each step's losses, both phases'
    gradients and D's weights right after its update ("d_after"), and the
    launches. With `pinned` (another run's "d_after") D takes those
    weights right after each of its updates."""
    import torch
    from sp_gan_tpu_torch.data.sphere import sphere_template
    from sp_gan_tpu_torch.ops import kernels
    from sp_gan_tpu_torch.parallel import shard_batch
    from sp_gan_tpu_torch.train import step as step_mod
    from sp_gan_tpu_torch.train.state import create_train_state
    st = create_train_state(cfg, device=mesh.device if mesh
                            else PARALLEL_DEVICE)
    step = step_mod.make_train_step(cfg, sphere_template(cfg.np), mesh)
    grads, d_after, apply = [], [], step_mod._apply

    def recording(opt, params, g, lr, nan_guard):
        grads.append([t.detach().float().cpu() for t in g])
        apply(opt, params, g, lr, nan_guard)
        if opt is st.d_opt:
            if pinned is not None:
                with torch.no_grad():
                    for p, v in zip(params, pinned[len(d_after)]):
                        p.copy_(v)
            d_after.append([p.detach().cpu().clone() for p in params])

    losses = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    with mock.patch.object(step_mod, "_apply", recording):
        for b in real:
            b = b if mesh is None else shard_batch(mesh, b)
            st, m = step(st, b)
            losses.append({k: float(m[k]) for k in ("d_loss", "g_loss")})
    torch.cuda.synchronize()
    return {"losses": losses, "grads": grads, "d_after": d_after,
            "ms_per_step": (time.perf_counter() - t) * 1e3 / len(real),
            "launches": kernels.launch_counts(),
            "names": ([n for n, _ in st.D.named_parameters()],
                      [n for n, _ in st.G.named_parameters()])}


def compare_steps(ours: dict, ref: dict, label: str,
                  steps: int = PARALLEL_STEPS) -> dict:
    """Losses and gradients of the first `steps` steps of two runs of
    `parallel_steps`, held to the train phase's step-parity bounds
    (`check_small_step`: d_loss 1e-5 and g_loss 5e-5 relative, D's
    gradients 1e-1 of a tensor's max-abs and 2e-2 in relative L2, G's
    5e-1 and 8e-2)."""
    res = {"d_loss": 0.0, "g_loss": 0.0, "d_grads": (0.0, ""),
           "g_grads": (0.0, ""), "d_grads_l2": (0.0, ""),
           "g_grads_l2": (0.0, "")}
    for a, b in zip(ours["losses"][:steps], ref["losses"][:steps]):
        for k in ("d_loss", "g_loss"):
            res[k] = max(res[k], abs(a[k] - b[k]) / abs(b[k]))
    for i, (a, b) in enumerate(zip(ours["grads"][:2 * steps],
                                   ref["grads"][:2 * steps])):
        tag = "dg"[i % 2]
        w = grads_worst(ref["names"][i % 2], a, b)
        res[f"{tag}_grads"] = max(res[f"{tag}_grads"], w["elem"])
        res[f"{tag}_grads_l2"] = max(res[f"{tag}_grads_l2"], w["l2"])
    log(f"  {label}: largest differences {res}")
    if not (res["d_loss"] <= 1e-5 and res["g_loss"] <= 5e-5
            and res["d_grads"][0] <= 1e-1 and res["d_grads_l2"][0] <= 2e-2
            and res["g_grads"][0] <= 5e-1 and res["g_grads_l2"][0] <= 8e-2):
        raise AssertionError(f"{label}: beyond the step-parity bounds: {res}")
    return res


def check_data_parallel(seed: int) -> dict:
    """The data-parallel step on a (1,) data mesh over the one-rank NCCL
    group at Config() width, PARALLEL_STEPS steps, against the one-device
    step from the same state and batches: losses and gradients
    (`compare_steps`), and kernels B and D launched as the default step
    launches them (`PER_STEP`) in both."""
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.parallel import make_mesh
    from sp_gan_tpu_torch.train.trainer import synthetic_dataset
    cfg = Config(seed=seed)
    data = synthetic_dataset(cfg).data
    real = [torch.as_tensor(data[i * cfg.bs:(i + 1) * cfg.bs],
                            device=PARALLEL_DEVICE)
            for i in range(PARALLEL_STEPS)]
    one = parallel_steps(cfg, None, real, PARALLEL_STEPS)
    mesh = make_mesh((1,), ("data",), PARALLEL_DEVICE)
    dp = parallel_steps(cfg, mesh, real, PARALLEL_STEPS)
    res = compare_steps(dp, one, "data-parallel step (1 rank, NCCL) vs "
                        "one-device step")
    per = {k: v / PARALLEL_STEPS for k, v in dp["launches"].items()}
    log(f"  data-parallel step: {dp['ms_per_step']:.2f} ms a step against "
        f"the one-device step's {one['ms_per_step']:.2f} (host clock, the "
        f"first {PARALLEL_STEPS} steps of a fresh state each); launches a "
        f"step {per}")
    for name, n in PER_STEP.items():
        if dp["launches"][name] != n * PARALLEL_STEPS \
                or one["launches"][name] != n * PARALLEL_STEPS:
            raise AssertionError(f"data-parallel step: {name} launched "
                                 f"{dp['launches'][name]} times (one-device "
                                 f"{one['launches'][name]}) in "
                                 f"{PARALLEL_STEPS} steps, expected "
                                 f"{n * PARALLEL_STEPS}")
    return {**res, "ms_per_step": dp["ms_per_step"],
            "one_device_ms_per_step": one["ms_per_step"],
            "launches_per_step": per, "losses": dp["losses"]}


def check_point_sharded(seed: int) -> dict:
    """The point-sharded step on a (1, 1) (data, points) mesh at
    PARALLEL_16K (bs 2, N 16384, nk 20, mixed_edge) beside the one-device
    step, one step each from the same state and batch: finite losses and
    the gaps of the free runs printed, with the EdgeConv2 picks of each
    phase that differ counted (the one-device step selects with kernel G,
    the sharded one among the gathered points in plain PyTorch); then the
    one-device step again with each phase on the sharded run's inputs
    (the D phase on its fakes, the G phase against its updated D), whose
    d_loss must lie within 1e-5 and g_loss within PARALLEL_16K_LOSS_TOL
    of the sharded run's. At bs 2 the generator's global BatchNorm
    normalizes 2 clouds, which turns the two forwards' rounding (the
    sharded instance norms, EdgeConv2's bf16 diffs) into whole flips of
    a channel's sign, so the free losses are only printed."""
    import numpy as np
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.data import SyntheticDataset
    from sp_gan_tpu_torch.data.sphere import sphere_template
    from sp_gan_tpu_torch.ops import edge as edge_mod
    from sp_gan_tpu_torch.parallel import make_mesh
    from sp_gan_tpu_torch.parallel import points as points_mod
    from sp_gan_tpu_torch.train import step as step_mod
    from sp_gan_tpu_torch.train.state import create_train_state
    cfg = Config(seed=seed, **PARALLEL_16K)
    sphere = sphere_template(cfg.np)
    real = torch.as_tensor(SyntheticDataset(cfg.bs, cfg.np, seed=seed).data,
                           device=PARALLEL_DEVICE)
    mesh = make_mesh((1, 1), ("data", "points"), PARALLEL_DEVICE)
    picks = {"one": [], "sharded": []}
    knn, local = edge_mod.knn_dispatch, points_mod._local_knn

    def rec_one(x, k):
        idx = knn(x, k)
        picks["one"].append(idx.long().cpu())
        return idx

    def rec_sharded(xq, xk, k, base):
        idx = local(xq, xk, k, base)
        picks["sharded"].append(idx.cpu())
        return idx

    def run(sharded: bool, pinned=None):
        """One step; returns its losses, ms, peak memory, D-phase fakes
        and D right after its update. `pinned` = (fakes, D) of another
        run: the D phase takes those fakes, D those weights after its
        update."""
        st = create_train_state(cfg, device=PARALLEL_DEVICE)
        step = (step_mod.make_train_step_pointsharded(cfg, sphere, mesh)
                if sharded else step_mod.make_train_step(cfg, sphere))
        keep, apply = {}, step_mod._apply

        def fake_hook(module, args, out):
            if "fake" not in keep:
                keep["fake"] = out.detach().clone()
                if pinned is not None:
                    return pinned[0]

        def after_apply(opt, params, grads, lr, nan_guard):
            apply(opt, params, grads, lr, nan_guard)
            if opt is st.d_opt:
                if pinned is not None:
                    with torch.no_grad():
                        for p, v in zip(st.D.parameters(), pinned[1]):
                            p.copy_(v)
                keep["d"] = [p.detach().clone() for p in st.D.parameters()]

        hook = st.G.register_forward_hook(fake_hook)
        patch = (mock.patch.object(points_mod, "_local_knn", rec_sharded)
                 if sharded else
                 mock.patch.object(edge_mod, "knn_dispatch", rec_one))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t = time.perf_counter()
        with patch, mock.patch.object(step_mod, "_apply", after_apply):
            st, m = step(st, real)
        torch.cuda.synchronize()
        hook.remove()
        return ({"ms": (time.perf_counter() - t) * 1e3,
                 # the step's own peak, above what was held before it
                 "peak_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
                 **{k: float(m[k]) for k in ("d_loss", "g_loss")}},
                (keep["fake"], keep["d"]))

    run(True)                                   # warm-up
    picks["sharded"].clear()
    sharded, inputs = run(True)
    one, _ = run(False)
    selections = (list(picks["one"]), list(picks["sharded"]))
    pinned, _ = run(False, inputs)
    res = {"sharded": sharded, "one": one, "pinned": pinned,
           "picks_differ": [int((a != b).sum()) for a, b in
                            zip(*selections)],
           "picks": int(selections[0][0].numel())}
    for k in ("d_loss", "g_loss"):
        res[f"free_{k}"] = abs(sharded[k] - one[k]) / abs(one[k])
        res[f"pinned_{k}"] = abs(sharded[k] - pinned[k]) / abs(pinned[k])
    log(f"  point-sharded step (1 x 1 mesh, NCCL) at N={cfg.np}, "
        f"bs={cfg.bs}: {res}")
    if len(selections[0]) != 2 or len(selections[1]) != 2:
        raise AssertionError("point-sharded step: EdgeConv2 did not select "
                             "once a phase on both sides")
    if not all(np.isfinite(sharded[k]) for k in ("d_loss", "g_loss")):
        raise AssertionError(f"point-sharded step: non-finite losses {res}")
    if not res["pinned_d_loss"] <= 1e-5:
        raise AssertionError(f"point-sharded step: d_loss on the same fakes "
                             f"beyond 1e-5: {res}")
    if np.isfinite(pinned["g_loss"]):
        if not res["pinned_g_loss"] <= PARALLEL_16K_LOSS_TOL:
            raise AssertionError(f"point-sharded step: g_loss against the "
                                 f"same D beyond {PARALLEL_16K_LOSS_TOL}: "
                                 f"{res}")
    else:
        # BatchNorm over 2 clouds takes var = E[x^2] - mean^2, which
        # cancellation can take below -eps (the JAX package's formula too)
        log("  the one-device step's g_loss is not finite at bs 2; the G "
            "phases are not compared")
    res["sampler"] = check_sharded_sampler(seed, mesh)
    return res


def check_sharded_sampler(seed: int, mesh) -> dict:
    """`make_sample_fn_pointsharded` on the (1, 1) mesh against
    `make_sample_fn` (the fused eval path) at PARALLEL_16K's N in float32,
    2 shapes from the same codes: 99% of the coordinates within
    PARALLEL_SAMPLE_P99, the median within MANIPULATE_MEDIAN."""
    import numpy as np
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.data.noise import sample_z
    from sp_gan_tpu_torch.data.sphere import sphere_template
    from sp_gan_tpu_torch.train.state import create_train_state
    from sp_gan_tpu_torch.train.step import (make_sample_fn,
                                             make_sample_fn_pointsharded)
    cfg = Config(seed=seed, dtype="float32", **PARALLEL_16K)
    sphere = sphere_template(cfg.np)
    st = create_train_state(cfg, device=PARALLEL_DEVICE)
    z = sample_z(torch.Generator(device=PARALLEL_DEVICE).manual_seed(seed),
                 cfg.bs, cfg.np, cfg.nz, cfg.nv)
    out = {}
    for name, fn in (("one", make_sample_fn(cfg, sphere)),
                     ("sharded", make_sample_fn_pointsharded(cfg, sphere,
                                                             mesh))):
        fn(st, z)                                       # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        pcs = fn(st, z)
        torch.cuda.synchronize()
        out[name] = ((time.perf_counter() - t) * 1e3, pcs.cpu().numpy())
    err = np.abs(out["sharded"][1] - out["one"][1])
    res = {"ms_one": out["one"][0], "ms_sharded": out["sharded"][0],
           "median": float(np.median(err)),
           "p99": float(np.quantile(err, 0.99)), "max": float(err.max())}
    log(f"  point-sharded sampler at N={cfg.np} (float32) vs one-device "
        f"sampler: {res}")
    if not np.isfinite(out["sharded"][1]).all() \
            or res["p99"] > PARALLEL_SAMPLE_P99 \
            or res["median"] > MANIPULATE_MEDIAN:
        raise AssertionError(f"point-sharded sampler: {res}")
    return res


def check_sharded_protocol(seed: int) -> dict:
    """`pairwise_emd_matrix(mesh=)` on a (1,) points mesh over NCCL, 4 x 4
    clouds of 2048 points (PARALLEL_PROTOCOL), against the one-device
    protocol (kernel E) within PARALLEL_PROTOCOL_TOL; and the sharded
    auction (`emd_auction_local`) on the first PARALLEL_PAIR_N points of
    the first pair equal, assignment for assignment, to
    `auction_scaled_jacobi` on the same distances, and a bijection (it ran
    to its end)."""
    import numpy as np
    import torch
    from sp_gan_tpu_torch.data import SyntheticDataset
    from sp_gan_tpu_torch.eval.metrics import pairwise_emd_matrix
    from sp_gan_tpu_torch.ops.emd import auction_scaled_jacobi, scaled_phases
    from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist
    from sp_gan_tpu_torch.parallel import emd_auction_local, make_mesh
    S, N, eps, iters = PARALLEL_PROTOCOL
    clouds = torch.as_tensor(SyntheticDataset(2 * S, N, seed=seed + 7).data,
                             device=PARALLEL_DEVICE)
    gen, ref = clouds[:S], clouds[S:]
    mesh = make_mesh((1,), ("points",), PARALLEL_DEVICE)
    torch.cuda.synchronize()
    t = time.perf_counter()
    sharded = pairwise_emd_matrix(gen, ref, eps, iters, mesh=mesh)
    torch.cuda.synchronize()
    s_sharded = time.perf_counter() - t
    t = time.perf_counter()
    one = pairwise_emd_matrix(gen, ref, eps, iters)
    s_one = time.perf_counter() - t
    rel = float(np.abs(sharded - one).max() / np.abs(one).max())
    x, y = gen[:1, :PARALLEL_PAIR_N], ref[:1, :PARALLEL_PAIR_N]
    t = time.perf_counter()
    _, asg = emd_auction_local(x, y, eps, iters, mesh.group("points"))
    torch.cuda.synchronize()
    s_pair = time.perf_counter() - t
    plain = auction_scaled_jacobi(pairwise_sqdist(x[0], y[0]), eps,
                                  iters, scaled_phases(iters))[None]
    differ = int((asg.cpu() != plain.cpu()).sum())
    res = {"max_rel_vs_kernel_e": rel, "s_sharded": s_sharded,
           "s_one_device": s_one, "s_one_pair_sharded": s_pair,
           "assignments_differ": differ,
           "distinct_items": [len(set(a.tolist())) for a in asg.cpu()]}
    log(f"  point-sharded protocol ({S} x {S}, N={N}, eps {eps}, {iters} "
        f"rounds): {res}")
    if differ:
        raise AssertionError("emd_auction_local and auction_scaled_jacobi "
                             f"assign {differ} rows apart")
    if min(res["distinct_items"]) != PARALLEL_PAIR_N:
        raise AssertionError(f"the sharded auction stopped at its cap: "
                             f"{res['distinct_items']} distinct items")
    if rel > PARALLEL_PROTOCOL_TOL:
        raise AssertionError(f"sharded protocol lies {rel} from kernel E's")
    return res


def _multi_card_rank(rank: int, world: int, tmp: str, seed: int) -> None:
    """One rank of `check_multi_card`: the data-parallel step on a
    (world,) mesh, its results saved by rank 0."""
    import pickle
    import torch.distributed as dist
    _nccl_group(tmp, rank, world)
    try:
        from sp_gan_tpu_torch.parallel import make_mesh
        dev = f"cuda:{rank}"
        cfg, real = _multi_card_inputs(seed, world, dev)
        run = parallel_steps(cfg, make_mesh((world,), ("data",), dev), real,
                             PARALLEL_STEPS)
        if rank == 0:
            with open(os.path.join(tmp, "ranks.pkl"), "wb") as f:
                pickle.dump(run, f)
    finally:
        dist.destroy_process_group()


def _multi_card_inputs(seed: int, world: int, device: str):
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.train.trainer import synthetic_dataset
    cfg = Config(seed=seed)
    if cfg.bs % world:
        cfg = Config(seed=seed, bs=8 * world)
    data = synthetic_dataset(cfg).data
    return cfg, [torch.as_tensor(data[i * cfg.bs:(i + 1) * cfg.bs],
                                 device=device)
                 for i in range(PARALLEL_STEPS)]


def check_multi_card(seed: int) -> dict:
    """With two cards or more, that many NCCL ranks run the data-parallel
    step (`_multi_card_rank`), its first step held against the one-card
    step's (`compare_steps`; the one-card G phase against the ranks'
    updated D); else it is not run, and says so."""
    import pickle
    import tempfile
    import torch
    import torch.multiprocessing as mp
    n = torch.cuda.device_count()
    if n < 2:
        log("parallel multi-card: not run (1 card)")
        return {"cards": n, "run": False}
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_multi_card_rank, args=(n, tmp, seed), nprocs=n, join=True)
        with open(os.path.join(tmp, "ranks.pkl"), "rb") as f:
            ranks = pickle.load(f)
    cfg, real = _multi_card_inputs(seed, n, "cuda:0")
    # the first step, its G phase against the ranks' updated D: the
    # synchronized moments sum in another order, and Adam turns a
    # near-zero gradient's rounding into +-lr (as the train phase's small
    # steps pin D for the CPU)
    one = parallel_steps(cfg, None, real[:1], 1, pinned=ranks["d_after"])
    res = compare_steps(ranks, one, f"data-parallel step on {n} cards vs "
                        "one card (first step)", steps=1)
    log(f"parallel multi-card: run on {n} cards")
    return {"cards": n, "run": True, **res}


def parallel_phase(seed: int) -> dict:
    """See the module docstring (9e)."""
    import tempfile
    import torch.distributed as dist
    import torch
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        _nccl_group(tmp)
        try:
            # the communicator's set-up is the first collective's
            t = time.perf_counter()
            dist.all_reduce(torch.zeros(1, device=PARALLEL_DEVICE))
            res["first_collective_s"] = time.perf_counter() - t
            res["data_parallel"] = check_data_parallel(seed)
            res["point_sharded"] = check_point_sharded(seed)
            res["protocol"] = check_sharded_protocol(seed)
        finally:
            dist.destroy_process_group()
    res["multi_card"] = check_multi_card(seed)
    return res


# slice 21: kernels A, G, B and F past k = 32. The lists the checks take:
# just past the old limit, the default step's at --nk 80, the widest
WIDE_K = (33, 40, 64)
NK80 = 80
# the steps of each --nk 80 path: warm-up and timed (Trainer.time_steps),
# and those of the trainer's own loop
WIDE_WARMUP, WIDE_STEPS, WIDE_LOOP_STEPS = 2, 5, 3


def wide_ptxas(text: str) -> list:
    """ptxas's lines for the wide-list instantiations (KM = 64) of the
    selection engine: the filter's, the CUDA-core pass's, the merge's and
    kernel F's CUDA-core kernel, by their whole mangled names."""
    pat = re.compile(r"(knn_filter_kernelILi32ELi64E|knn_exact_kernelILi64E|"
                     r"knn_merge_kernelILi64E|knn_edge_window_kernelILi4E"
                     r"Li64E)")
    return [line for line in ptxas_report(text, 400) if pat.search(line)]


def check_band_to_2w(x, k: int) -> dict:
    """Kernel F at W = ceil(k / 2), the narrowest band its kernel takes
    (k <= 2W; the JAX function's W >= k is the wrapper's), both orders,
    bf16 diffs, against `band_select` and the edge rounding of its plain
    version, bit for bit and twice alike."""
    import torch
    from sp_gan_tpu_torch.ops.approx_knn import band_select
    from sp_gan_tpu_torch.ops.kernels.knn import FILTER_MU, FILTER_NU
    from sp_gan_tpu_torch.ops.kernels.knn_edge import edges_from_idx
    from sp_gan_tpu_torch.ops.kernels.knn_edge_window import _launch_band
    W = -(-k // 2)
    low = (1 << max((2 * W).bit_length(), 1)) - 1
    res = {}
    for mode in ("packed", "exact"):
        args = (x, k, W, low, torch.bfloat16, True, mode, FILTER_MU,
                FILTER_NU)
        ee, idx = _launch_band(*args)
        ee2, idx2 = _launch_band(*args)
        ref = band_select(x, k, W, mode, low)
        ee_p = edges_from_idx(x, ref, torch.bfloat16, True)
        res[mode] = {"vs_plain": int((idx != ref).sum())
                     + int((ee != ee_p).sum()),
                     "vs_again": int((idx != idx2).sum())
                     + int((ee != ee2).sum())}
    log(f"  knn_edge_window[{list(x.shape)}, k={k}, W={W}]: {res}")
    if any(v for r in res.values() for v in r.values()):
        raise AssertionError(f"kernel F at k={k}, W={W}: not bit-equal")
    return res


def check_wide_limits() -> dict:
    """At k = 65 every kNN kernel's wrapper raises on a CUDA tensor, naming
    the limit, and launches nothing."""
    import torch
    from sp_gan_tpu_torch.ops import kernels
    x = torch.zeros(1, 512, 16, device="cuda")
    calls = {"A": lambda: kernels.knn(x, 65),
             "G": lambda: kernels.knn_blocked(x, 65),
             "B": lambda: kernels.knn_edge(x, 65),
             "F": lambda: kernels.knn_edge_window(x, 65, 128)}
    kernels.reset_launch_counts()
    out = {}
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            out[name] = str(e)
            if "k <= 64 (--nk <= 128)" not in str(e):
                raise AssertionError(f"{name} at k = 65: {e}") from e
        else:
            raise AssertionError(f"{name} took k = 65 on CUDA")
    if any(kernels.launch_counts().values()):
        raise AssertionError("a refused call launched a kernel")
    log(f"  k = 65 refused: {out}")
    return out


def trainer_loop_nk80(seed: int) -> dict:
    """The default Config at --nk 80 through the trainer's own loop
    (`Trainer.train`, one epoch of WIDE_LOOP_STEPS steps on its synthetic
    data, a checkpoint at its end), from launch counts of 0: kernel B twice
    and kernel D once a step, every weight finite and moved."""
    import tempfile

    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.ops import kernels
    from sp_gan_tpu_torch.train.trainer import Trainer
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(seed=seed, nk=NK80, max_epoch=1,
                     steps_per_epoch=WIDE_LOOP_STEPS, log_dir=tmp)
        tr = Trainer(cfg, device="cuda", logs=False)
        start = [p.detach().clone() for p in tr.state.G.parameters()]
        kernels.reset_launch_counts()
        t = time.perf_counter()
        state = tr.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = kernels.launch_counts()
    for name, n in PER_STEP.items():
        if launches[name] != n * WIDE_LOOP_STEPS:
            raise AssertionError(f"Trainer.train at --nk {NK80}: {name} "
                                 f"launched {launches[name]} times in "
                                 f"{WIDE_LOOP_STEPS} steps")
    now = list(state.G.parameters())
    if not all(torch.isfinite(p).all() for p in now) or any(
            torch.equal(a, b) for a, b in zip(start, now)):
        raise AssertionError(f"Trainer.train at --nk {NK80}: a weight is "
                             "not finite or did not move")
    log(f"  Trainer.train at --nk {NK80}: {WIDE_LOOP_STEPS} steps in "
        f"{wall:.2f} s (first-use costs included); launches {launches}")
    return {"steps": WIDE_LOOP_STEPS, "wall_s": wall, "launches": launches}


# style_interpolate at --nk 80 (the unfused eval path at B=1, kernel C
# never): at N=2048 PER_STYLE_STEP a step; above 8192 points both EdgeConvs
# select with kernel G
WIDE_STYLE = {2048: PER_STYLE_STEP, SERVE_16K: per(knn_blocked=2)}
WIDE_STYLE_STEPS = 3


def style_nk80(seed: int) -> dict:
    """`Manipulator.style_interpolate` at --nk 80 (k = 40) at N=2048 and
    N=16384, weights from `seed`: WIDE_STYLE_STEPS forwards of batch 1,
    from launch counts of 0, each launching WIDE_STYLE's kernels (A and B,
    or G twice); finite clouds of the right shape. The one user path that
    takes A and G past k = 32 before kernel C does."""
    import numpy as np
    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.manipulate import Manipulator, region_mask
    from sp_gan_tpu_torch.nn.generator import Generator
    from sp_gan_tpu_torch.ops import kernels
    out = {}
    for n, expected in WIDE_STYLE.items():
        cfg = Config(seed=seed, nk=NK80, np=n)
        man = Manipulator(cfg, Generator(cfg, seed=seed), device="cuda")
        mask = region_mask(man.ball, 0, n // 3)
        man.style_interpolate(mask, seed, seed + 1, 1)       # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        pcs = man.style_interpolate(mask, seed, seed + 1, WIDE_STYLE_STEPS)
        wall = time.perf_counter() - t
        launches = kernels.launch_counts()
        tag = f"style_interpolate at --nk {NK80}, N={n}"
        if pcs.shape != (WIDE_STYLE_STEPS, n, 3) or not np.isfinite(pcs).all():
            raise AssertionError(f"{tag}: bad output {pcs.shape}")
        for name, per_step in expected.items():
            if launches[name] != per_step * WIDE_STYLE_STEPS:
                raise AssertionError(f"{tag}: {name} launched "
                                     f"{launches[name]} times")
        log(f"  {tag}: {wall * 1e3 / WIDE_STYLE_STEPS:.2f} ms a step; "
            f"launches {launches}")
        out[n] = {"ms_per_step": wall * 1e3 / WIDE_STYLE_STEPS,
                  "launches": launches}
        del man
    return out


def wide_k_phase(seed: int) -> tuple:
    """Kernels A, G, B and F at k = 33, 40 and 64 bit-equal to their plain
    versions and twice alike, on normal draws at the paths' shapes and on
    the hard inputs of the k <= 32 checks (knn_hard with the quantum cloud,
    the quantum band, knn_blocked_hard), kernel F also at k = 2W; B's, F's
    and G's margins swept at k = 40; k = 65 refused; the default step and
    P1 at --nk 80 (kernel B or F twice and D once a step, D held at its
    k = 40 call), the default one also through the trainer's loop, small
    --nk 80 steps against the CPU; and the k = 40 rows of the kernels line
    (A at serving's shape, B at the training step's, F at P1's, G at a P2
    request's). Returns the phase's figures and those rows."""
    import itertools

    import torch
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.data.sphere import sphere_template
    from sp_gan_tpu_torch.ops import kernels
    from sp_gan_tpu_torch.ops.kernels import _build
    res = {"ptxas_km64": wide_ptxas(_build.last_log), "seconds": {}}
    for line in res["ptxas_km64"]:
        log("  ptxas (KM = 64): " + line)
    t0 = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        res["seconds"][part] = now - t0[0]
        t0[0] = now
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    cfg = Config(seed=seed, nk=NK80)
    camp = Config(seed=seed, **{**CAMPAIGN_N8192, "nk": NK80})
    N = cfg.np
    x_a = torch.as_tensor(sphere_template(N), device="cuda")[None] \
        .expand(64, -1, -1).contiguous()
    x_b = torch.randn(64, N, 64, generator=gen, device="cuda")
    x_t = torch.randn(cfg.bs, N, 64, generator=gen, device="cuda")
    x_f = torch.randn(camp.bs, camp.np, 64, generator=gen, device="cuda")
    x_g = {3: torch.as_tensor(sphere_template(SERVE_16K), device="cuda")[None]
           .expand(REQUEST_16K, -1, -1).contiguous(),
           64: torch.randn(REQUEST_16K, SERVE_16K, 64, generator=gen,
                           device="cuda")}
    eight = list(itertools.product(("packed", "exact"),
                                   (torch.bfloat16, torch.float32),
                                   (True, False)))
    checks, hard_in = {}, {}
    for k in WIDE_K:
        c = {"A": check_knn(x_a, k, "template, "),
             "B_serve": check_knn_edge(x_b, k, [
                 ("packed", torch.float32, False),
                 ("exact", torch.float32, False)], "serve, "),
             "B_train": check_knn_edge(x_t, k, [
                 ("packed", torch.bfloat16, True),
                 ("exact", torch.bfloat16, True)], "train, "),
             "F": check_knn_edge_window(x_f, k, camp.knn_window),
             "G": {str(ch): check_knn_blocked(xg, k)
                   for ch, xg in x_g.items()},
             "F_2W": check_band_to_2w(x_t[:4].contiguous(), k)}
        c["AB_hard"], hard_in = knn_hard(seed + 19, N, k)
        f_hard = {**hard_in, "quantum band": quantum_band_cloud(N, 16)}
        c["F_hard"] = {label: check_knn_edge_window(
            xx, k, camp.knn_window, eight, label + ", ")
            for label, xx in f_hard.items()}
        c["G_hard"], g_hard_in = knn_blocked_hard(seed + 17, k)
        checks[k] = c
        lap(f"checks at k = {k}")
    res["checks"] = {k: {"A": c["A"], "G": c["G"], "F_2W": c["F_2W"]}
                     for k, c in checks.items()}
    k = cfg.k
    res["margin"] = {
        "B": b_margin_sweep({"offset": hard_in["offset"],
                             "grid": hard_in["grid"],
                             "near": hard_in["near"],
                             "quantum": hard_in["quantum"],
                             "randn": x_b[:4].contiguous()}, k),
        "F": f_margin_sweep({"offset": (x_f + 1000).contiguous(),
                             "grid": hard_in["grid"],
                             "near": hard_in["near"],
                             "quantum band": quantum_band_cloud(N, 16),
                             "randn": x_f}, k, camp.knn_window),
        "G": g_margin_sweep({"offset": g_hard_in["offset"],
                             "grid": g_hard_in["grid"],
                             "repeat": g_hard_in["repeat"],
                             "randn": x_g[64]}, k)}
    lap("margin sweeps")
    res["refused"] = check_wide_limits()
    # kernel D at the --nk 80 step's call: d_diff [24, 2048, 40, 64] bf16
    # on kernel B's packed picks, bit for bit and twice alike
    _, idx_t = kernels.knn_edge(x_t, k, torch.bfloat16, True, "packed")
    dd = torch.randn(*x_t.shape[:2], k, 64, generator=gen,
                     device="cuda").to(torch.bfloat16)
    hold_diff_bwd(f"scatter_diff_bwd[--nk {NK80}]", dd, idx_t)
    res["d_at_k40"] = dict(in_degrees(idx_t, N), ms=cuda_ms(
        lambda: kernels.scatter_diff_bwd(dd, idx_t), 20))
    # the paths
    lap("D at k = 40")
    res["loop"] = trainer_loop_nk80(seed)
    lap("Trainer.train")
    tr, step = timed_training(cfg, WIDE_STEPS, WIDE_WARMUP, PER_STEP,
                              f"default step at --nk {NK80}")
    step["profile"] = profile_call(lambda: tr.time_steps(1),
                                   f"default step at --nk {NK80}")
    del tr
    tr, p1 = timed_training(camp, WIDE_STEPS, WIDE_WARMUP, PER_STEP_APPROX,
                            f"P1 at --nk {NK80}")
    p1["profile"] = profile_call(lambda: tr.time_steps(1),
                                 f"P1 at --nk {NK80}")
    del tr
    res["step"], res["p1"] = step, p1
    lap("default step and P1")
    res["style"] = style_nk80(seed)
    lap("style_interpolate")
    res["small_step"] = check_small_steps(seed, 1, {"nk": NK80},
                                          pin_knn=True)
    lap("small steps")
    rows = wide_rows(k, x_a, x_t, x_f, camp.knn_window, x_g, checks[k],
                     step, p1, res["style"])
    lap("k = 40 rows")
    log(f"  wide_k seconds by part: {res['seconds']}")
    return res, rows


def wide_rows(k, x_a, x_t, x_f, window, x_g, checked, step, p1,
              style) -> list:
    """The kernels line's k = 40 rows: ms (CUDA events), plain ms and the
    bound by route (select_bound, from the pairs each call folds exactly)
    of A at serving's [64, 2048, 3], B at the training step's [24, 2048,
    64] (bf16 diffs, packed), F at P1's [4, 8192, 64] and G at a P2
    request (its two calls). A's and G's launches are style_interpolate's
    (`style_nk80`): serving's requests take them past k = 32 with kernel
    C, in the next slice."""
    import torch
    from sp_gan_tpu_torch.ops.kernels.knn import knn, knn_plain
    from sp_gan_tpu_torch.ops.kernels.knn_blocked import (knn_blocked,
                                                          knn_blocked_plain)
    from sp_gan_tpu_torch.ops.kernels.knn_edge import (knn_edge,
                                                       knn_edge_plain)
    from sp_gan_tpu_torch.ops.kernels.knn_edge_window import (
        knn_edge_window, knn_edge_window_plain, window_geometry)
    refined = torch.zeros(1, dtype=torch.int64, device="cuda")

    def pairs(fn):
        refined.zero_()
        fn(refined)
        return int(refined.item())
    tag = f"k = {k} (--nk {2 * k})"
    rows = []
    Ba, Na, _ = x_a.shape
    a_pairs = pairs(lambda r: knn(x_a, k, refined=r))
    rows.append(dict(
        name="knn", route="cuda", source="sp_gan_tpu_torch/csrc/knn.cu",
        replaces="sp_gan_tpu/ops/pallas/knn.py:515 (knn_pallas, "
                 "_knn_kernel :24)",
        launches=style[2048]["launches"]["knn"],
        launches_per_step=style[2048]["launches"]["knn"] / WIDE_STYLE_STEPS,
        k=k, max_abs_err=checked["A"]["max_abs_err"],
        ms=cuda_ms(lambda: knn(x_a, k), 50),
        plain_ms=cuda_ms(lambda: knn_plain(x_a, k), 10),
        **dict(zip(("bound_ms", "bound_by"), select_bound(
            a_pairs, Ba, Na, 3, Ba * Na * 3 * 4 + 2 * Ba * Na * k * 4))),
        library_ms=None, refined_pairs=a_pairs,
        refined_per_query=a_pairs / (Ba * Na), shape=list(x_a.shape),
        path=f"style_interpolate at {tag} (launches); timed at a serving "
             "request's EdgeConv1 shape, which serving takes with kernel C "
             "in the next slice"))
    Bt, Nt, Ct = x_t.shape
    kw = dict(out_dtype=torch.bfloat16, diff_only=True, select_mode="packed")
    b_pairs = pairs(lambda r: knn_edge(x_t, k, **kw, refined=r))
    rows.append(dict(
        name="knn_edge", route="cuda",
        source="sp_gan_tpu_torch/csrc/knn_edge.cu",
        replaces="sp_gan_tpu/ops/pallas/knn.py:313 (knn_edge_pallas, "
                 "_knn_edge_kernel :177)",
        launches=step["launches"]["knn_edge"],
        launches_per_step=step["launches_per_step"]["knn_edge"], k=k,
        max_abs_err=checked["B_train"]["max_abs_err"],
        ms=cuda_ms(lambda: knn_edge(x_t, k, **kw), 20),
        plain_ms=cuda_ms(lambda: knn_edge_plain(x_t, k, **kw), 5),
        **dict(zip(("bound_ms", "bound_by"), select_bound(
            b_pairs, Bt, Nt, Ct, Bt * Nt * Ct * 4 + Bt * Nt * k * Ct * 2
            + Bt * Nt * k * 4))),
        library_ms=None, refined_pairs=b_pairs,
        refined_per_query=b_pairs / (Bt * Nt), shape=list(x_t.shape),
        path=f"train at {tag}"))
    Bf, Nf, Cf = x_f.shape
    W, _ = window_geometry(Nf, k, window)
    f_pairs = pairs(lambda r: knn_edge_window(x_f, k, window, **kw,
                                              refined=r))
    rows.append(dict(
        name="knn_edge_window", route="cuda",
        source="sp_gan_tpu_torch/csrc/knn_edge_window.cu",
        replaces="sp_gan_tpu/ops/pallas/knn.py:463 (knn_edge_window_pallas,"
                 " _knn_edge_window_kernel :339)",
        launches=p1["launches"]["knn_edge_window"],
        launches_per_step=p1["launches_per_step"]["knn_edge_window"], k=k,
        max_abs_err=checked["F"]["max_abs_err"],
        ms=cuda_ms(lambda: knn_edge_window(x_f, k, window, **kw), 20),
        plain_ms=cuda_ms(lambda: knn_edge_window_plain(x_f, k, window,
                                                       **kw), 3),
        **dict(zip(("bound_ms", "bound_by"), select_bound(
            f_pairs, Bf, Nf, Cf, Bf * Nf * Cf * 4 + Bf * Nf * k * Cf * 2
            + Bf * Nf * k * 4, 2 * W + 1))),
        library_ms=None, refined_pairs=f_pairs,
        refined_per_query=f_pairs / (Bf * Nf), shape=list(x_f.shape),
        window=W, path=f"N=8192 approx training (P1) at {tag}"))
    g_calls = {}
    for c, xg in x_g.items():
        Bg, Ng, _ = xg.shape
        g_pairs = pairs(lambda r: knn_blocked(xg, k, refined=r))
        g_bound, g_by = select_bound(g_pairs, Bg, Ng, c, Bg * Ng * c * 4
                                     + 2 * Bg * Ng * k * 4)
        g_calls[f"C={c}"] = dict(
            ms=cuda_ms(lambda: knn_blocked(xg, k), 5),
            plain_ms=cuda_ms(lambda: knn_blocked_plain(xg, k), 1, False),
            bound_ms=g_bound, bound_by=g_by, refined_pairs=g_pairs,
            refined_per_query=g_pairs / (Bg * Ng))
        log(f"  knn_blocked[C={c}, {tag}]: {g_calls[f'C={c}']}")
    rows.append(dict(
        name="knn_blocked", route="cuda",
        source="sp_gan_tpu_torch/csrc/knn.cu",
        replaces="sp_gan_tpu/ops/pallas/knn.py:120 (knn_pallas_blocked, "
                 "_knn_blocked_kernel :58)",
        launches=style[SERVE_16K]["launches"]["knn_blocked"],
        launches_per_step=(style[SERVE_16K]["launches"]["knn_blocked"]
                           / WIDE_STYLE_STEPS), k=k,
        max_abs_err=max(r["max_abs_err"] for r in checked["G"].values()),
        ms=sum(c["ms"] for c in g_calls.values()),
        plain_ms=sum(c["plain_ms"] for c in g_calls.values()),
        bound_ms=sum(c["bound_ms"] for c in g_calls.values()),
        bound_by=g_calls["C=64"]["bound_by"], library_ms=None,
        calls=g_calls, per="one request of 16 at N=16384: the edge1 call "
        "(template) and the edge2 call (normal draws)",
        path=f"style_interpolate at N=16384 at {tag} (launches); timed at "
             "a P2 request's shapes, which serving takes with kernel C in "
             "the next slice"))
    for r in rows:
        log(f"  {r['name']} ({r['path']}): {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']})")
    return rows


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
    for line in ptxas_report(_build.last_log):
        log("  ptxas: " + line)
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
    res_b = check_knn_edge(x_b, k)
    # the training shape: EdgeConv2's input at bs=24
    x_t = torch.randn(cfg.bs, cfg.np, 64, generator=gen, device=dev)
    res_bt = check_knn_edge(x_t, k, [("packed", torch.bfloat16, True),
                                     ("exact", torch.bfloat16, True)])
    # a generator of its own, so that the later phases draw what they drew
    # before this check existed
    res_ab_hard, x_ab_hard = knn_hard(args.seed + 19, cfg.np, k)
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
        res_c_hard = check_edge_tail_hard(tails, k)
    # kernel F at the N=8192 campaign's shape: EdgeConv2's input at bs=4
    camp = Config(**CAMPAIGN_N8192)
    x_f = torch.randn(camp.bs, camp.np, 64, generator=gen, device=dev)
    res_f = check_knn_edge_window(x_f, camp.k, camp.knn_window)
    # kernel F on the hard inputs at N=2048 (W = 512), in all eight forms
    import itertools
    x_f_hard = {**x_ab_hard, "quantum band": quantum_band_cloud(cfg.np, 16)}
    res_f_hard = {label: check_knn_edge_window(
        xx, camp.k, camp.knn_window, list(itertools.product(
            ("packed", "exact"), (torch.bfloat16, torch.float32),
            (True, False))), label + ", ")
        for label, xx in x_f_hard.items()}
    # kernel D on the hard index list, a generator of its own
    res_d_hard = check_scatter_hard(
        torch.Generator(device=dev).manual_seed(args.seed + 23))
    # kernel G at N=16384, a request of 16: EdgeConv1's template, EdgeConv2's
    # features
    x_g = {3: torch.as_tensor(sphere_template(SERVE_16K), device=dev)[None]
           .expand(REQUEST_16K, -1, -1).contiguous(),
           64: torch.randn(REQUEST_16K, SERVE_16K, 64, generator=gen,
                           device=dev)}
    res_g = {c: check_knn_blocked(xg, k) for c, xg in x_g.items()}
    res_g_hard, x_g_hard = knn_blocked_hard(args.seed + 17)
    # kernel H at the N=16384 approx step's shape: the gather's bf16
    # cotangent [2, 16384 * 10, 64] at band picks of W=512
    n_h = TRAIN_16K["np"]
    x_h = torch.randn(TRAIN_16K["bs"], n_h, 64, generator=gen, device=dev)
    idx_h = kernels.knn_edge_window(x_h, k, camp.knn_window, torch.bfloat16,
                                    diff_only=True, select_mode="packed")[1]
    idx_h = idx_h.reshape(TRAIN_16K["bs"], -1)
    g_h = torch.randn(*idx_h.shape, 64, generator=gen,
                      device=dev).to(torch.bfloat16)
    res_h = check_scatter_add(g_h, idx_h, n_h)
    # a generator of its own, so that the later phases draw what they drew
    # before this check existed
    res_h["hard"] = check_scatter_add_hard(
        torch.Generator(device=dev).manual_seed(args.seed + 13))
    del x_h
    ph.end()

    # --------------------------------------------------------------- 3b
    ph.start("last_kernels")
    # a generator of its own, so that the later phases draw what they drew
    # before this phase existed
    last, last_in = last_kernels_phase(
        args.seed, idx_t, torch.Generator(device=dev).manual_seed(
            args.seed + 9))
    log(json.dumps({"last_kernels": last}))
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
    serve_prof = profile_call(lambda: man.generate(64, seed=args.seed),
                              "request of 64 shapes", tf_part)
    log(json.dumps({"serve": {"ms_per_request": serve_s * 1e3 / 2,
                              "launches": launches,
                              "profile": serve_prof}}))
    ph.end()

    # --------------------------------------------------------------- 4b
    ph.start("manipulate")
    manip = manipulate_phase(man, args.seed)
    log(json.dumps({"manipulate": manip}))
    ph.end()

    # --------------------------------------------------------------- 4c
    ph.start("checkpoints")
    ckpts = checkpoints_phase(man, args.seed)
    log(json.dumps({"checkpoints": ckpts}))
    ph.end()

    # ---------------------------------------------------------------- 5
    ph.start("train")
    train = train_phase(args.seed, args.step_seeds)
    log(json.dumps({"train": {k: train[k] for k in (
        "ms_per_step", "steps_per_sec", "points_per_sec", "launches",
        "launches_per_step", "small_step", "profile")}}))
    ph.end()

    # --------------------------------------------------------------- 5b
    ph.start("fused_train")
    fused, fused_in = fused_train_phase(args.seed, args.step_seeds, gen)
    log(json.dumps({"fused_train": {k: fused[k] for k in (
        "concat_bf16", "full", "small", "autograd", "fused_train",
        "fused_dphase", "small_step")}}))
    ph.end()

    # --------------------------------------------------------------- 5c
    ph.start("regularizers")
    regs = regularizers_phase(args.seed)
    log(json.dumps({"regularizers": {label: {k: r[k] for k in (
        "ms_per_step", "steps_per_sec", "launches_per_step", "small_step",
        "profile")} for label, r in regs.items()}}))
    ph.end()

    # ---------------------------------------------------------------- 6
    ph.start("metrics")
    met = metrics_phase(man, args.seed)
    log(json.dumps({"metrics": {k: met[k] for k in (
        "metrics", "wall_s", "solves_per_sec", "launches",
        "expected_launches", "pairs_per_call", "protocol_4096", "checks",
        "optimum", "r3", "hard", "launch", "small", "fpd", "profile")}}))
    ph.end()

    # ---------------------------------------------------------------- 7
    ph.start("largen_train")
    approx = train_phase(args.seed, 1, CAMPAIGN_N8192, PER_STEP_APPROX,
                         SMALL_APPROX, "N=8192 approx training step")
    log(json.dumps({"largen_train": {k: approx[k] for k in (
        "ms_per_step", "steps_per_sec", "points_per_sec", "launches",
        "launches_per_step", "small_step", "profile")}}))
    ph.end()

    # ---------------------------------------------------------------- 8
    ph.start("largen_serve")
    serve16, x_p2, tails_p2 = largen_serve_phase(args.seed)
    log(json.dumps({"largen_serve": serve16}))
    ph.end()

    # ---------------------------------------------------------------- 9
    ph.start("largen_train_16k")
    tr16, train16 = timed_training(Config(seed=args.seed, **TRAIN_16K),
                                   STEPS_16K, 1, PER_STEP_16K,
                                   "N=16384 approx training step")
    train16["profile"] = profile_call(lambda: tr16.time_steps(1),
                                      "N=16384 approx training step")
    del tr16
    log(json.dumps({"largen_train_16k": train16}))
    ph.end()

    # -------------------------------------------------------------- 9b
    ph.start("trainer_parts")
    parts = trainer_parts_phase(args.seed)
    log(json.dumps({"trainer_parts": parts}))
    ph.end()

    # -------------------------------------------------------------- 9c
    ph.start("emd_large")
    big = emd_large_phase(args.seed)
    log(json.dumps({"emd_large": big}))
    ph.end()

    # -------------------------------------------------------------- 9d
    ph.start("legacy")
    legacy = legacy_phase(args.seed)
    log(json.dumps({"legacy": legacy}))
    ph.end()

    # -------------------------------------------------------------- 9e
    ph.start("parallel")
    par = parallel_phase(args.seed)
    log(json.dumps({"parallel": par}))
    ph.end()

    # -------------------------------------------------------------- 9f
    ph.start("wide_k")
    wide, wide_rows_k40 = wide_k_phase(args.seed)
    log(json.dumps({"wide_k": {k: wide[k] for k in (
        "ptxas_km64", "checks", "margin", "refused", "d_at_k40", "loop",
        "step", "p1", "style", "small_step", "seconds")}}))
    ph.end()

    # --------------------------------------------------------------- 10
    ph.start("timings")
    from sp_gan_tpu_torch.ops.kernels.edgeblock import (edge_tail,
                                                        edge_tail_plain)
    from sp_gan_tpu_torch.ops.kernels.knn import knn, knn_plain
    from sp_gan_tpu_torch.ops.kernels.knn_edge import (knn_edge,
                                                       knn_edge_plain)
    N, C = cfg.np, x_b.shape[-1]
    rows = []
    # kernel A at [64, 2048, 3]: the CUDA-core pass folds every pair
    refined = torch.zeros(1, dtype=torch.int64, device=dev)
    knn(x_a, k, refined=refined)
    a_pairs = int(refined.item())
    a_ms = cuda_ms(lambda: knn(x_a, k), 50)
    a_plain = cuda_ms(lambda: knn_plain(x_a, k), 10)
    a_bound, a_by = select_bound(a_pairs, B, N, 3,
                                 B * N * 3 * 4 + 2 * B * N * k * 4)
    a_old_bound, _ = bound(2 * B * N * N * 3,
                           B * N * 3 * 4 + 2 * B * N * k * 4)
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
        library_ms=None, old_bound_ms=a_old_bound, refined_pairs=a_pairs,
        refined_per_query=a_pairs / (B * N),
        hard={n: {kk: r[kk] for kk in ("vs_plain", "vs_g", "vs_again")}
              for n, r in res_ab_hard["A"].items()},
        shape=[B, N, 3], path="serve"))
    # kernel B at [64, 2048, 64] -> f32 [central, nbr - central], packed,
    # and at the training shape [24, 2048, 64] -> bf16 diffs, packed: the
    # filter's three TF32 products of every pair and the exact folds of the
    # pairs it counts, beside the bytes (x read once, ee and idx written
    # once)
    serve_b = dict(out_dtype=torch.float32, diff_only=False,
                   select_mode="packed")
    train_b = dict(out_dtype=torch.bfloat16, diff_only=True,
                   select_mode="packed")
    Bt = x_t.shape[0]
    b_rows = {}
    for label, xx, kw, ec, esize in (("serve", x_b, serve_b, 2 * C, 4),
                                     ("train", x_t, train_b, C, 2)):
        Bx = xx.shape[0]
        refined.zero_()
        knn_edge(xx, k, **kw, refined=refined)
        pairs = int(refined.item())
        nbytes = Bx * N * C * 4 + Bx * N * k * ec * esize + Bx * N * k * 4
        b_bound, b_by = select_bound(pairs, Bx, N, C, nbytes)
        b_rows[label] = dict(
            ms=cuda_ms(lambda: knn_edge(xx, k, **kw), 20),
            plain_ms=cuda_ms(lambda: knn_edge_plain(xx, k, **kw), 5),
            bound_ms=b_bound, bound_by=b_by,
            old_bound_ms=bound(2 * Bx * N * N * C, nbytes)[0],
            refined_pairs=pairs, refined_per_query=pairs / (Bx * N))
        log(f"  knn_edge[{label}, {list(xx.shape)}]: {b_rows[label]}")
    rows.append(dict(
        name="knn_edge", route="cuda",
        source="sp_gan_tpu_torch/csrc/knn_edge.cu",
        replaces="sp_gan_tpu/ops/pallas/knn.py:313 (knn_edge_pallas, "
                 "_knn_edge_kernel :177)",
        launches=launches["knn_edge"], agree=res_b["agree"],
        max_abs_err=res_b["max_abs_err"], max_err=res_b["max_abs_err"],
        **b_rows["serve"], library_ms=None,
        hard={n: {kk: r[kk] for kk in ("vs_plain", "vs_again")}
              for n, r in res_ab_hard["B"].items()},
        margin=b_margin_sweep({"offset": x_ab_hard["offset"],
                               "grid": x_ab_hard["grid"],
                               "near": x_ab_hard["near"],
                               "quantum": x_ab_hard["quantum"],
                               "randn": x_b[:4].contiguous()}, k),
        shape=[B, N, C], path="serve"))
    for mode in ("exact", "packed"):
        for cd in (torch.float32, torch.bfloat16):
            ms = cuda_ms(lambda: knn_edge(x_b, k, cd, True, mode), 20)
            log(f"  knn_edge[{mode}, {str(cd)[6:]}, diff_only]: {ms:.3f} ms")
    rows.append(dict(
        name="knn_edge", route="cuda",
        source="sp_gan_tpu_torch/csrc/knn_edge.cu",
        replaces="sp_gan_tpu/ops/pallas/knn.py:313 (knn_edge_pallas, "
                 "_knn_edge_kernel :177)",
        launches=train["launches"]["knn_edge"],
        launches_per_step=train["launches_per_step"]["knn_edge"],
        agree=res_bt["agree"], max_abs_err=res_bt["max_abs_err"],
        max_err=res_bt["max_abs_err"], **b_rows["train"], library_ms=None,
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
    # kernel D at its three calls: the default step's d_diff (above), F1's
    # neighbour half of d_ee [24, 2048, 10, 128] (row stride 128) on
    # kernel B's concat indices, P1's d_diff [4, 8192, 10, 64] on kernel
    # F's indices; each held bit for bit, timed and taken apart by kernel;
    # bound: d_diff read once (its C of each row), idx read and d_x written
    # once, 2 k + 1 f32 adds an output element
    dgen = torch.Generator(device=dev).manual_seed(args.seed + 29)
    idx_f1 = kernels.knn_edge(x_t, k, torch.bfloat16, False, "packed")[1]
    idx_p1 = kernels.knn_edge_window(x_f, k, camp.knn_window, torch.bfloat16,
                                     diff_only=True, select_mode="packed")[1]
    d_calls = {
        "default step": (dd_t, idx_t),
        "F1 neighbour half": (torch.randn(
            Bt, N, k, 2 * C, generator=dgen,
            device=dev).to(torch.bfloat16)[..., C:], idx_f1),
        "P1": (torch.randn(*x_f.shape[:2], k, x_f.shape[2], generator=dgen,
                           device=dev).to(torch.bfloat16), idx_p1)}
    d_figs = {}
    for label, (dd, ix) in d_calls.items():
        hold_diff_bwd(f"scatter_diff_bwd[{label}]", dd, ix)
        Bd, Nd, kd, Cd = dd.shape
        d_figs[label] = dict(
            diff_pass_figures(dd, ix, label), **dict(zip(
                ("bound_ms", "bound_by"),
                bound(Bd * Nd * Cd * (2 * kd + 1),
                      dd.numel() * dd.element_size() + ix.numel() * 4
                      + Bd * Nd * Cd * 4, F32_OPS))))
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
        calls=d_figs, hard=res_d_hard,
        shape=[Bt, N, k, C], path="train"))
    # kernel C at both call sites of one request, and of one P2 request,
    # all four on the tensor cores (their widths are ebt_tf_fits'). The
    # bound counts the port's own work: three TF32 products of each
    # multiply-add at the TF32 peak; beside it the function's f32
    # multiply-adds at the f32 rate, the FMA design's bound. Bytes: ee and
    # the weights read and out written once.
    def tail_call(targs, reps):
        ee, w1, w2 = targs[0], targs[1], targs[3]
        Bc, Nc, _, c2 = ee.shape
        f2, f = w1.shape[1], w2.shape[1]
        flops = 2 * Bc * Nc * k * (c2 // 2 * f2 + f2 * f + c2 * f + f * f)
        nbytes = 4 * (ee.numel() + sum(t.numel() for t in targs[1:])
                      + Bc * Nc * f)
        c_bound, c_by = bound(3 * flops, nbytes, TF32_FLOPS)
        return dict(ee=list(ee.shape), F2=f2, F=f,
                    ms=cuda_ms(lambda: edge_tail(*targs, k=k), reps),
                    plain_ms=cuda_ms(lambda: edge_tail_plain(*targs, k=k),
                                     max(reps // 2, 3)),
                    bound_ms=c_bound, bound_by=c_by,
                    old_bound_ms=bound(flops, nbytes)[0])
    calls, calls_p2 = {}, {}
    for name, targs in tails.items():
        calls[name] = dict(tail_call(targs, 20),
                           max_abs_err=res_c[name]["max_abs_err"])
        log(f"  edge_tail[{name}]: {calls[name]}")
    for name, targs in tails_p2.items():
        calls_p2[name] = dict(tail_call(targs, 10),
                              max_abs_err=serve16["edge_tail"][name][
                                  "max_abs_err"])
        log(f"  edge_tail[{name} at P2]: {calls_p2[name]}")
    c_split = {g: ms for g, ms in serve_prof["groups"].items()
               if g.startswith("C")}
    rows.append(dict(
        name="edge_tail", route="cuda",
        source="sp_gan_tpu_torch/csrc/edgeblock_tf32.cu",
        replaces="sp_gan_tpu/ops/pallas/edgeblock.py:102 (edge_tail_pallas,"
                 " _edge_tail_kernel :28)",
        launches=launches["edge_tail"],
        max_abs_err=max(c["max_abs_err"] for c in calls.values()),
        max_err=max(c["max_abs_err"] for c in calls.values()),
        hard_max_abs_err=max(r["max_abs_err"] for r in res_c_hard.values()),
        ms=sum(c["ms"] for c in calls.values()),
        plain_ms=sum(c["plain_ms"] for c in calls.values()),
        bound_ms=sum(c["bound_ms"] for c in calls.values()),
        bound_by=calls["edge2"]["bound_by"], library_ms=None,
        old_bound_ms=sum(c["old_bound_ms"] for c in calls.values()),
        ms_at_p2=sum(c["ms"] for c in calls_p2.values()),
        bound_ms_at_p2=sum(c["bound_ms"] for c in calls_p2.values()),
        launches_at_p2=serve16["launches"]["edge_tail"],
        split_ms=c_split,
        per="one request: the edge1 and the edge2 call", calls=calls,
        calls_at_p2=calls_p2, hard=res_c_hard, path="serve"))
    # kernel E at both sizes, protocol regime (measured in phase 6); its
    # launches are those of the protocol's run at that size
    launches_e = {2048: met["launches"]["auction"],
                  4096: met["protocol_4096"]["launches"]["auction"]}
    for n in (2048, 4096):
        rows.append(dict(
            name="auction", route="cuda",
            source="sp_gan_tpu_torch/csrc/auction.cu",
            replaces=("sp_gan_tpu/ops/pallas/auction.py:510 "
                      "(auction_assignment_pallas blockgs, "
                      "_auction_kernel_blockgs :127)" if n == 2048 else
                      "sp_gan_tpu/ops/pallas/auction.py:448 "
                      "(auction_assignment_pallas blockgs_hbm, "
                      "_auction_kernel_blockgs_hbm :240)"),
            launches=launches_e[n], max_err=met[n]["max_abs_err"],
            library_ms=None, path=f"metrics at N={n}",
            protocol_launch=met["launch"] if n == 2048 else None,
            r3=met["r3"] if n == 2048 else None,
            block_rounds=met["checks"][f"{n}/protocol"]["rounds"],
            bidders=met["checks"][f"{n}/protocol"]["bidders"],
            **met[n]))
    # kernel F at the N=8192 campaign's shape: [4, 8192, 64] -> bf16 diffs
    from sp_gan_tpu_torch.ops.kernels.knn_edge_window import (
        knn_edge_window, knn_edge_window_plain, window_geometry)
    Bf, Nf, Cf = x_f.shape
    W, _ = window_geometry(Nf, k, camp.knn_window)
    p1 = dict(out_dtype=torch.bfloat16, diff_only=True, select_mode="packed")
    # by route (select_bound): the filter's TF32 products over each query's
    # band of 2 W + 1 keys and the exact folds the call counts; beside it
    # the f32 FMA bound of the band (old_bound_ms)
    f_bytes = Bf * Nf * Cf * 4 + Bf * Nf * k * Cf * 2 + Bf * Nf * k * 4
    refined.zero_()
    knn_edge_window(x_f, k, camp.knn_window, **p1, refined=refined)
    f_pairs = int(refined.item())
    f_bound, f_by = select_bound(f_pairs, Bf, Nf, Cf, f_bytes, 2 * W + 1)
    f_margin = f_margin_sweep({
        "offset": (x_f + 1000).contiguous(), "grid": x_ab_hard["grid"],
        "near": x_ab_hard["near"],
        "quantum band": x_f_hard["quantum band"], "randn": x_f},
        k, camp.knn_window)
    rows.append(dict(
        name="knn_edge_window", route="cuda",
        source="sp_gan_tpu_torch/csrc/knn_edge_window.cu",
        replaces="sp_gan_tpu/ops/pallas/knn.py:463 (knn_edge_window_pallas,"
                 " _knn_edge_window_kernel :339)",
        launches=approx["launches"]["knn_edge_window"],
        launches_per_step=approx["launches_per_step"]["knn_edge_window"],
        agree=res_f["agree"], max_abs_err=res_f["max_abs_err"],
        max_err=res_f["max_abs_err"],
        ms=cuda_ms(lambda: knn_edge_window(x_f, k, camp.knn_window, **p1),
                   20),
        plain_ms=cuda_ms(lambda: knn_edge_window_plain(
            x_f, k, camp.knn_window, **p1), 3),
        bound_ms=f_bound, bound_by=f_by, library_ms=None,
        old_bound_ms=bound(2 * Bf * Nf * 2 * W * Cf, f_bytes)[0],
        refined_pairs=f_pairs, refined_per_query=f_pairs / (Bf * Nf),
        hard={n: {kk: r[kk] for kk in ("vs_plain", "vs_again")}
              for n, r in res_f_hard.items()},
        margin=f_margin,
        shape=[Bf, Nf, Cf], window=W, path="N=8192 approx training"))
    # kernel G at both call sites of a request of 16 at N=16384, kernel A
    # at the same shapes beside it: EdgeConv1's call on the template,
    # EdgeConv2's on normal draws (the row's time, comparable with earlier
    # readings on draws) and on the features a P2 request hands it (x_p2)
    from sp_gan_tpu_torch.ops.kernels.knn_blocked import (knn_blocked,
                                                          knn_blocked_plain)
    g_calls = {}
    for name, c, xg, checked in (
            ("C=3", 3, x_g[3], res_g[3]), ("C=64", 64, x_g[64], res_g[64]),
            ("C=64, P2 features", 64, x_p2,
             serve16["knn_blocked_features"])):
        Bg, Ng, _ = xg.shape
        refined = torch.zeros(1, dtype=torch.int64, device=dev)
        knn_blocked(xg, k, refined=refined)
        pairs = int(refined.item())
        # the kernel's own work by route (select_bound); its bytes: x read
        # once, idx and dist written once
        g_bound, g_by = select_bound(pairs, Bg, Ng, c,
                                     Bg * Ng * c * 4 + 2 * Bg * Ng * k * 4)
        old_bound, _ = bound(2 * Bg * Ng * Ng * c,
                             Bg * Ng * c * 4 + 2 * Bg * Ng * k * 4)
        g_calls[name] = dict(
            shape=list(xg.shape), ms=cuda_ms(lambda: knn_blocked(xg, k), 5),
            knn_ms=cuda_ms(lambda: knn(xg, k), 3),
            plain_ms=cuda_ms(lambda: knn_blocked_plain(xg, k), 1),
            refined_pairs=pairs, refined_per_query=pairs / (Bg * Ng),
            bound_ms=g_bound, bound_by=g_by,
            old_bound_ms=old_bound, mismatches=checked["vs_knn"])
        log(f"  knn_blocked[{name}]: {g_calls[name]}")
    margin = g_margin_sweep({"offset": x_g_hard["offset"],
                             "grid": x_g_hard["grid"],
                             "repeat": x_g_hard["repeat"],
                             "randn": x_g[64], "P2 features": x_p2}, k)
    req = (g_calls["C=3"], g_calls["C=64"])
    rows.append(dict(
        name="knn_blocked", route="cuda",
        source="sp_gan_tpu_torch/csrc/knn.cu",
        replaces="sp_gan_tpu/ops/pallas/knn.py:120 (knn_pallas_blocked, "
                 "_knn_blocked_kernel :58)",
        launches=serve16["launches"]["knn_blocked"],
        max_abs_err=max(r["max_abs_err"] for r in res_g.values()),
        max_err=max(r["max_abs_err"] for r in res_g.values()),
        ms=sum(c["ms"] for c in req),
        plain_ms=sum(c["plain_ms"] for c in req),
        knn_ms=sum(c["knn_ms"] for c in req),
        bound_ms=sum(c["bound_ms"] for c in req),
        bound_by=g_calls["C=64"]["bound_by"], library_ms=None,
        old_bound_ms=sum(c["old_bound_ms"] for c in req),
        ms_on_p2_features=(g_calls["C=3"]["ms"]
                           + g_calls["C=64, P2 features"]["ms"]),
        hard={**{f"C={c}": {kk: r[kk] for kk in ("vs_knn", "vs_plain",
                                                 "vs_again")}
                 for c, r in res_g.items()},
              **{name: {kk: r[kk] for kk in ("vs_knn", "vs_plain",
                                             "vs_again")}
                 for name, r in res_g_hard.items()},
              "P2 features": {kk: serve16["knn_blocked_features"][kk]
                              for kk in ("vs_knn", "vs_plain", "vs_again")}},
        margin=margin,
        per="one request of 16 at N=16384: the edge1 call (template) and "
            "the edge2 call (normal draws; ms_on_p2_features on the "
            "request's own features)",
        calls=g_calls, path="serve at N=16384"))
    # kernel H at the N=16384 approx step's shape; index_add_ computes the
    # same function in one PyTorch call (on the f32 rows: it takes one type)
    from sp_gan_tpu_torch.ops.kernels.scatter import (scatter_add,
                                                      scatter_add_plain)
    Bh, Sh, Fh = g_h.shape
    h_bound, h_by = bound(Bh * Sh * Fh, g_h.numel() * 2 + idx_h.numel() * 4
                          + Bh * n_h * Fh * 4, F32_OPS)
    tgt_h = (idx_h.long() + n_h * torch.arange(Bh, device=dev)[:, None]
             ).reshape(-1)
    gf_h, zeros_h = g_h.reshape(-1, Fh).float(), torch.zeros(
        Bh * n_h, Fh, device=dev)
    h_passes = scatter_pass_figures(g_h, idx_h, n_h)
    rows.append(dict(
        name="scatter_add", route="cuda",
        source="sp_gan_tpu_torch/csrc/scatter.cu",
        replaces="sp_gan_tpu/ops/pallas/scatter.py:224 (scatter_add_pallas,"
                 " _scatter_kernel :22)",
        launches=train16["launches"]["scatter_add"],
        launches_per_step=train16["launches_per_step"]["scatter_add"],
        max_abs_err=res_h["max_abs_err"], max_err=res_h["max_abs_err"],
        ms=cuda_ms(lambda: scatter_add(g_h, idx_h, n_h), 50),
        plain_ms=cuda_ms(lambda: scatter_add_plain(g_h, idx_h, n_h), 20),
        bound_ms=h_bound, bound_by=h_by,
        library_ms=cuda_ms(lambda: torch.index_add(zeros_h, 0, tgt_h, gf_h),
                           20),
        library="torch.index_add (f32 rows, atomics)", passes=h_passes,
        hard_input_max_abs_err=max(res_h["hard"].values()),
        shape=[Bh, Sh, Fh], n=n_h, path="N=16384 approx training"))
    # kernels I-L and C's bf16 mode at the default --fused_train step's
    # EdgeConv2: ee [24, 2048, 10, 128] bf16, F2 = 64, F = 128; the matmul
    # work each port kernel computes at the bf16 tensor-core peak, each
    # input read and each output written once (the f32 d_u is J's output
    # and K's and L's input)
    ee_f = fused_in["ee"]
    Bt, Nt, kt_, c2 = ee_f.shape
    f2, f = fused_in["w1"].shape[1], fused_in["w2"].shape[1]
    rows_f = Bt * Nt * kt_
    c1 = c2 // 2
    # multiply-adds per edge row: the chain (w1, w2, wx); conv_out (C);
    # d_u = d_out @ wout[j]^T and d_wout (J); d_y1 and d_w2 (K); d_y1,
    # d_diff, d_w1, d_full and d_wx (L)
    chain = c1 * f2 + f2 * f + c2 * f
    macs = {"edge_train_stats2": c1 * f2 + f2 * f,
            "edge_tail": chain + f * f,
            "edge_train_bwd1": chain + 2 * f * f,
            "edge_train_bwd2": chain + 2 * f2 * f,
            "edge_train_bwd3": chain + f2 * f + 2 * c1 * f2 + 2 * c2 * f}
    ee_bytes, dout_bytes = ee_f.numel() * 2, Bt * Nt * f * 4
    du_bytes = rows_f * f * 4
    moved = {"edge_train_stats2": ee_bytes // 2,
             "edge_tail": ee_bytes + dout_bytes,
             "edge_train_bwd1": ee_bytes + dout_bytes + du_bytes,
             "edge_train_bwd2": ee_bytes + du_bytes,
             "edge_train_bwd3": 2 * ee_bytes + du_bytes}
    replaces = {
        "edge_train_stats2": "sp_gan_tpu/ops/pallas/edgeblock_train.py:152 "
                             "(_stats2_pallas, _stats2_kernel :111)",
        "edge_tail": "sp_gan_tpu/ops/pallas/edgeblock.py:102 "
                     "(edge_tail_pallas bf16 mode, _edge_tail_kernel :28)",
        "edge_train_bwd1": "sp_gan_tpu/ops/pallas/edgeblock_train.py:450 "
                           "(edge_block_train_backward pass 1, "
                           "_bwd_pass1_kernel :242)",
        "edge_train_bwd2": "sp_gan_tpu/ops/pallas/edgeblock_train.py:461 "
                           "(edge_block_train_backward pass 2, "
                           "_bwd_pass2_kernel :288)",
        "edge_train_bwd3": "sp_gan_tpu/ops/pallas/edgeblock_train.py:471 "
                           "(edge_block_train_backward pass 3, "
                           "_bwd_pass3_kernel :328)"}
    # bf16 mode, all five on the tensor cores at these widths
    source = {n: "sp_gan_tpu_torch/csrc/edgeblock_train_tc.cu" for n in macs}
    ft_launches = fused["fused_train"]["launches"]
    for name, (fn, plain, fargs) in train_kernel_calls(fused_in).items():
        f_bound, f_by = bound(2 * macs[name] * rows_f, moved[name],
                              BF16_FLOPS)
        # the same products at the f32 rate, the FMA route's own bound
        old_bound, _ = bound(2 * macs[name] * rows_f, moved[name])
        # I, J, K, L and C: the device ms of each part of their calls in
        # the profiled --fused_train step (I and C: two calls), by launch
        split = fused["fused_train"]["profile"]["tc_split_ms"].get(
            {"edge_train_stats2": "I", "edge_train_bwd1": "J",
             "edge_train_bwd2": "K", "edge_train_bwd3": "L",
             "edge_tail": "C"}.get(name))
        rows.append(dict(
            name=name, route="cuda", source=source[name],
            replaces=replaces[name], mode="bf16 edges",
            launches=ft_launches[name],
            launches_per_step=fused["fused_train"]["launches_per_step"][
                name],
            max_abs_err=fused["full"][name]["max_abs_err"],
            max_err=fused["full"][name]["max_abs_err"],
            rel_l2=fused["full"][name]["rel_l2"],
            ms=cuda_ms(lambda: fn(*fargs), 10),
            plain_ms=cuda_ms(lambda: plain(*fargs), 3),
            bound_ms=f_bound, bound_by=f_by, library_ms=None,
            old_bound_ms=old_bound,
            shape=list(ee_f.shape), path="--fused_train step",
            **({"split_ms": split,
                "split_calls": PER_STEP_FUSED[name]} if split else {})))
    # kernel M at the --fused_train step's EdgeConv2: d_ee [24, 2048, 10,
    # 128] bf16; index_add_ of the neighbor half alone is a partial
    # yardstick (it leaves out the central term)
    d_ee = last_in["d_ee"]
    Bm, Nm, km, c2m = d_ee.shape
    cm = c2m // 2
    m_bound, m_by = bound(3 * Bm * Nm * km * cm, d_ee.numel() * 2
                          + idx_t.numel() * 4 + Bm * Nm * cm * 4, F32_OPS)
    tgt_m = (idx_t.long() + Nm * torch.arange(Bm, device=dev)[:, None, None]
             ).reshape(-1)
    nbr_m = d_ee[..., cm:].reshape(-1, cm).float()
    zeros_m = torch.zeros(Bm * Nm, cm, device=dev)
    fm = regs["--fused_train, SPGAN_EDGE_BWD=pallas"]
    rows.append(dict(
        name="edge_scatter_bwd", route="cuda",
        source="sp_gan_tpu_torch/csrc/scatter.cu",
        replaces="sp_gan_tpu/ops/pallas/scatter.py:104 "
                 "(edge_scatter_bwd_pallas, _edge_bwd_kernel :47)",
        launches=fm["launches"]["edge_scatter_bwd"],
        launches_per_step=fm["launches_per_step"]["edge_scatter_bwd"],
        max_abs_err=last["edge_scatter_bwd"]["max_abs_err"],
        max_err=last["edge_scatter_bwd"]["max_abs_err"],
        rel_l2=last["edge_scatter_bwd"]["rel_l2"],
        ms=cuda_ms(lambda: kernels.edge_scatter_bwd(d_ee, idx_t), 50),
        plain_ms=cuda_ms(lambda: kernels.edge_scatter_bwd_plain(d_ee, idx_t),
                         20),
        bound_ms=m_bound, bound_by=m_by,
        library_ms=cuda_ms(lambda: torch.index_add(zeros_m, 0, tgt_m, nbr_m),
                           20),
        library="torch.index_add of the neighbor half only (f32 rows, "
                "atomics): a partial yardstick, no central term",
        shape=list(d_ee.shape),
        path="--fused_train step, SPGAN_EDGE_BWD=pallas"))
    # kernel N at CHAMFER_FUSED: per pair the distance (2C + 2 operations)
    # and a compare in each direction, none an FMA
    xc, yc = last_in["clouds"]
    Bc, Nc, Cc = xc.shape
    Mc = yc.shape[1]
    n_bound, n_by = bound(Bc * Nc * Mc * (2 * Cc + 4),
                          (Bc * Nc + Bc * Mc) * (Cc * 4 + 8), F32_OPS)
    rows.append(dict(
        name="chamfer_nn", route="cuda",
        source="sp_gan_tpu_torch/csrc/chamfer.cu",
        replaces="sp_gan_tpu/ops/pallas/chamfer.py:79 "
                 "(_chamfer_pallas_raw, _chamfer_kernel :26)",
        launches=last["chamfer"]["launches"]["chamfer_nn"],
        max_abs_err=0.0, max_err=0.0,
        ms=cuda_ms(lambda: kernels.chamfer_nn(xc, yc), 20),
        ms_back_to_back=cuda_ms_back_to_back(
            lambda: kernels.chamfer_nn(xc, yc), 20),
        plain_ms=cuda_ms(lambda: kernels.chamfer_nn_plain(xc, yc), 5),
        bound_ms=n_bound, bound_by=n_by, library_ms=None,
        shape=[Bc, Nc, Mc, Cc], path="ops.dispatch.chamfer_directed"))
    # kernel O in both modes at [4, 2048, 2048], the metric regime; its
    # bound counts the rows that bid (as kernel E's)
    d_o = last_in["d"]
    for mode, body in (("jacobi", "_auction_kernel :345"),
                       ("packed", "_auction_kernel_packed :47")):
        o = last["jacobi_auction"][mode]
        o_bound, o_by = auction_bound(d_o, o["bidders"])
        o_ms = cuda_ms(lambda: kernels.auction(d_o, *PROTOCOL, mode=mode), 3)
        o_us = 1e3 * o_ms / max(o["rounds"])
        log(f"  kernel O[{mode}] at {list(d_o.shape)}: {o_us:.3f} us a round "
            f"of the pair with the most rounds ({max(o['rounds'])}); kernel "
            f"E at [4, 2048]: {met[2048]['us_per_round']:.3f} us a "
            "block-round")
        rows.append(dict(
            name=f"jacobi_auction[{mode}]", route="cuda",
            source="sp_gan_tpu_torch/csrc/auction_jacobi.cu",
            replaces=f"sp_gan_tpu/ops/pallas/auction.py:510 "
                     f"(auction_assignment_pallas {mode}, {body})",
            launches=o["launches"], max_abs_err=0.0, max_err=0.0,
            ms=o_ms, us_per_round=o_us,
            e_us_per_block_round=met[2048]["us_per_round"],
            plain_ms=o["plain_ms"], bound_ms=o_bound, bound_by=o_by,
            library_ms=None, rounds=o["rounds"], bidders=o["bidders"],
            regime="eps 0.002, 10000 iterations, 4 phases",
            shape=list(d_o.shape), path=f"auction(mode={mode!r})"))
    rows.extend(wide_rows_k40)
    for r in rows:
        lib = (f"library {r['library_ms']:.4f} ms" if r["library_ms"]
               is not None else "no single PyTorch call computes this "
               "function, so library_ms is null")
        log(f"  {r['name']} ({r['path']}): {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['ms']:.3g}% of bound); {lib}")
    ph.end()

    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
