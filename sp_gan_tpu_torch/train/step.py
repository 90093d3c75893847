"""The G+D training step and the sampler, the port of
`sp_gan_tpu/train/step.py` (`make_train_step` for one device,
`make_sample_fn`).

One step, as in the reference loop and the JAX step:

1. D phase: codes z_d; the generator's training forward without gradient
   (its BatchNorm running averages update); D on the real batch, then on
   the fakes, as separate forwards with separate batch statistics (D's
   running averages update after each); `dis_loss`; an Adam step on D.
2. G phase: codes z_g; the generator's training forward from its updated
   statistics; D on the new fakes with its updated weights, in training
   mode (its running averages update again); `gen_loss`; gradients to G's
   parameters only (`torch.autograd.grad`, so D's gradients and Adam state
   are untouched); an Adam step on G.
3. The EMA of G's parameters (`cfg.ema`).

With `cfg.nan_guard` a phase whose gradients are not all finite skips its
Adam step (parameters and optimizer state unchanged). The sphere
template's kNN graph and f32 edge tensor are run constants, computed once
here; EdgeConv1 runs on them at batch 1 (`edge1_b1`). On the card the
default step runs kernel B twice (EdgeConv2's diff edges in each phase)
and kernel D once (their backward in the G phase); nothing else of it is a
kernel of the port. With `knn_mode="approx"` EdgeConv2 selects in an index
band: kernel F takes kernel B's place up to 8192 points; above that the
band is plain PyTorch (`ops/approx_knn.py`) and its gather's backward is
kernel H, once in the G phase.

`fused_train` (both phases) and `fused_dphase` (the D phase's forward,
which needs no gradient) run the generator's fused train-mode forward
(`nn.fused_train.generator_forward_train`) where `supports_fused` accepts
the configuration, as the JAX step selects it; elsewhere the flags do
nothing. EdgeConv1 then runs at the full batch on the template's edges,
and EdgeConv2 per fused phase takes kernel B once (concat form), kernel I
and kernel C once each, and in the G phase kernels J, K and L and kernel D
(the concat edges' backward) once each. The JAX fused forward ignores
`knn_mode` (EdgeConv2 selects exactly even under approx); the port refuses
that combination.

Under `fused_train` with env SPGAN_EDGE_BWD=pallas, EdgeConv2's concat
edges take their backward from kernel M instead of kernel D
(`ops.edge.EdgeConcat`), as the JAX step does under the same switch.

The D phase's regularizers, as in the JAX step
(`sp_gan_tpu/train/step.py:132-147`):

- WGAN-GP (`gan=wgan` with `lambda_gp > 0`): `losses.wgan_gp` on D in
  training mode with batch statistics whose running averages stay as they
  were (`frozen_running_stats`: the JAX step drops that forward's
  statistics), differentiated twice; with `gp_mapping` the interpolates
  pair each fake point with its real point by the fixed-iteration EMD
  auction (`ops.emd.auction_jacobi`, plain PyTorch as it is XLA in JAX);
- CutMix (`mix`): `losses.cutmix` splices the EMD-aligned fakes into the
  real clouds (kernel E once a step, one phase of eps 0.005 and
  `mix_emd_iters` rounds), D's training forward on the mixed clouds adds
  `mix_loss`, and its statistics become D's.

The step takes z_d and z_g, and the regularizers' draws (`draws`: alpha
[B, 1, 1] of WGAN-GP; lam [B], anchor [B] and flip of CutMix) explicitly
when given (a parity test hands it the JAX step's); otherwise it draws
them from the state's `torch.Generator`. With `n_mix` the drawn codes of
both phases are region-mixed around an anchor on the template
(`data.noise.sample_z` with the template's rows, as the JAX step draws
them); explicit codes are taken as given.

Parallel steps (`parallel.Mesh`, one rank a device; the JAX package's
GSPMD step and `make_train_step_pointsharded`):

- `make_train_step(cfg, sphere, mesh)` is data parallel: each rank runs
  its B / R contiguous rows through the same program, so on the card its
  kernels are the default step's (B twice, D once). `bn_stats="global"`
  averages BatchNorm's moments over the mesh (synchronized BN);
  `per_shard` keeps them per rank, the running averages taken from rank 0
  of the data axis. On one device with `bn_stats="per_shard"` and a mesh
  shape of R ranks (`cfg.bn_groups`), the same statistics come from R
  contiguous groups of the batch instead.
- `make_train_step_pointsharded(cfg, sphere, mesh)` on a ("data",
  "points") mesh also cuts the N points of every cloud over the P ranks of
  a data replica: EdgeConv2 selects among the all-gathered points, the
  norms average their moments over the group, the max pools take the max
  over it (`parallel.points`), and EdgeConv1 takes its rows of the
  template's edges. The fused EdgeBlocks are off, as in the JAX step.

In both, the step draws z, and every other random number, at the global
shape from the state's generator (seeded alike on every rank) and takes
its block, so that it equals the one-process step whatever the mesh;
explicit codes and draws are given at the global shape too, `real` as the
rank's block. D's logits are gathered over the data axis and every loss
is the whole batch's, the same on every rank. Autograd through the
collectives sums every rank's cotangent of a shared value (a gather's
block, an all-reduced moment, a max pool that the P ranks of a replica
share), so the gradients summed over the W ranks are W times the loss's
gradient; the step averages them with one all-reduce before each Adam
step (DDP would all-reduce the D gradients of the G phase that nothing
uses). Parameters, buffers and Adam states stay equal on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data.noise import sample_z
from sp_gan_tpu_torch.losses.cutmix import cutmix, cutmix_draws
from sp_gan_tpu_torch.losses.gan import dis_loss, gen_loss, mix_loss
from sp_gan_tpu_torch.losses.gp import wgan_gp
from sp_gan_tpu_torch.nn.fused_eval import (generator_forward_eval,
                                            supports_fused)
from sp_gan_tpu_torch.nn.fused_train import generator_forward_train
from sp_gan_tpu_torch.nn.layers import Scope, frozen_running_stats, sharded
from sp_gan_tpu_torch.ops.edge import edge_features
from sp_gan_tpu_torch.ops.pairwise import knn_indices
from sp_gan_tpu_torch.parallel.mesh import (Mesh, all_gather_cat, block,
                                            mean_gradients)
from sp_gan_tpu_torch.train.state import (TrainState, ema_update, lr_at,
                                          updates_done)


def template_edges(sphere: torch.Tensor, k: int):
    """(idx [1, N, k] int32, ee [1, N, k, 6] f32) of the template [N, 3]:
    the exact kNN graph (`knn_indices`, the JAX step's XLA selection) and
    its `[central, nbr - central]` edges."""
    x = sphere[None].float()
    idx = knn_indices(x, k)
    return idx, edge_features(x, k, idx=idx)


def _apply(opt: torch.optim.Adam, params, grads, lr: float,
           nan_guard: bool) -> None:
    if nan_guard and not bool(torch.stack(
            [torch.isfinite(g).all() for g in grads]).all()):
        return
    for group in opt.param_groups:
        group["lr"] = lr
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def bn_scope(cfg: Config, mesh: Optional[Mesh], points: bool) -> Scope:
    """The layers' scope of a step: on one device `cfg.bn_groups`
    statistic groups; on a mesh, BatchNorm synchronized over every rank
    (`bn_stats="global"`) or over the points of a data replica, with the
    running averages of its rank 0 (`per_shard`), and with `points` the
    point axis cut over the mesh's `points` group."""
    if mesh is None:
        return Scope(groups=cfg.bn_groups)
    pts = mesh.group("points") if points else None
    if cfg.bn_stats == "per_shard":
        return Scope(bn_sync=pts, bn_replica0=mesh.group("data"), points=pts)
    return Scope(bn_sync=mesh.world, points=pts)


def make_train_step(cfg: Config, sphere, mesh: Optional[Mesh] = None
                    ) -> Callable[..., Tuple[TrainState, dict]]:
    """`step(state, real [B, N, 3], z_d=None, z_g=None, draws=None) ->
    (state, metrics)` on the device of `state.G`. `sphere` [N, 3] (array
    or tensor) is the run's template; metrics are 0-d tensors (d_loss,
    g_loss, real_acc, fake_acc) left on the device. With `mesh` (a
    `data` axis; a `points` axis, if any, of one rank) the step is data
    parallel and `real` is the rank's rows; see the module docstring."""
    if mesh is not None and mesh.axis_size("points") > 1:
        raise ValueError("a mesh that cuts the points takes "
                         "make_train_step_pointsharded")
    if mesh is not None and "data" not in mesh.axes:
        raise ValueError(f"a data-parallel step needs a data axis, the mesh "
                         f"has {mesh.axes}")
    return _make_step(cfg, sphere, mesh, points=False)


def make_train_step_pointsharded(cfg: Config, sphere, mesh: Mesh
                                 ) -> Callable[..., Tuple[TrainState, dict]]:
    """The step on a ("data", "points") mesh with the points of every
    cloud cut over the `points` axis: `step(state, real [B / R, N / P, 3],
    ...)` as `make_train_step`'s; see the module docstring. Supports
    --attn, --n_mix, --mix, WGAN-GP (with --gp_mapping) and per_shard BN;
    the fused EdgeBlocks are off and `knn_mode="approx"` is refused (the
    JAX step has no sharded band)."""
    if tuple(mesh.axes) != ("data", "points"):
        raise ValueError(f"the point-sharded step takes a (data, points) "
                         f"mesh, got {mesh.axes}")
    if cfg.np % mesh.axis_size("points"):
        raise ValueError(f"{cfg.np} points do not divide over "
                         f"{mesh.axis_size('points')} ranks")
    if cfg.knn_mode == "approx":
        raise ValueError("the point-sharded step selects EdgeConv2's "
                         "neighbours exactly; --knn_mode approx has no "
                         "sharded band")
    return _make_step(cfg, sphere, mesh, points=True)


def _make_step(cfg: Config, sphere, mesh: Optional[Mesh], points: bool):
    use_gp = cfg.gan == "wgan" and cfg.lambda_gp > 0
    scope = bn_scope(cfg, mesh, points)
    n_data = mesh.axis_size("data") if mesh is not None else 1
    n_pts = mesh.axis_size("points") if points else 1
    at_data = mesh.index("data") if mesh is not None else 0
    at_pts = mesh.index("points") if points else 0
    data_group = mesh.group("data") if mesh is not None else None
    pts_group = mesh.group("points") if points else None
    fused_ok = supports_fused(cfg) and not points
    use_fused_g = cfg.fused_train and fused_ok
    # the D-phase forward needs no gradient, so the fused forward (whose
    # backward sweeps are the costly part) serves it under either flag
    use_fused_dphase = cfg.fused_dphase and fused_ok
    if (use_fused_g or use_fused_dphase) and cfg.knn_mode == "approx":
        raise ValueError("--fused_train/--fused_dphase select EdgeConv2's "
                         "neighbors exactly; the JAX fused forward ignores "
                         "--knn_mode approx, and the port refuses the pair")
    if (use_fused_g or use_fused_dphase) and mesh is not None \
            and mesh.size > 1:
        raise ValueError("--fused_train/--fused_dphase take EdgeConv2's "
                         "BatchNorm statistics inside their kernels over "
                         "the rank's rows; a mesh of more than one rank "
                         "synchronizes them, which those kernels do not")
    sphere_np = np.asarray(sphere, np.float32)
    edge1_b1 = cfg.edge1_b1 and not cfg.use_head and scope.groups == 1
    cache = {}

    def constants(dev):
        if dev not in cache:
            sph = torch.as_tensor(sphere_np, device=dev)
            cache[dev] = (sph, *template_edges(sph, cfg.k))
        return cache[dev]

    def g_forward(G, x, z, idx, ee, grad_needed=True):
        if use_fused_g or (use_fused_dphase and not grad_needed):
            B = x.shape[0]
            return generator_forward_train(
                G, x, z, edge1_idx=idx.expand(B, -1, -1),
                edge1_ee=ee.expand(B, -1, -1, -1))
        if not edge1_b1:
            B = x.shape[0]
            idx = idx.expand(B, -1, -1)
            ee = ee.expand(B, -1, -1, -1)
        return G(x, z, train=True, edge1_idx=idx, edge1_ee=ee,
                 template_batch_const=edge1_b1)

    def logits(D, pts):
        """D's logits of the rank's clouds, gathered over the data axis."""
        return all_gather_cat(D(pts, train=True), data_group, dim=0)

    def mean_grads(grads):
        if mesh is None:
            return grads
        return mean_gradients(grads, mesh.world, mesh.size)

    def step(state: TrainState, real: torch.Tensor,
             z_d: Optional[torch.Tensor] = None,
             z_g: Optional[torch.Tensor] = None,
             draws: Optional[dict] = None):
        G, D, gen = state.G, state.D, state.gen
        dev = next(G.parameters()).device
        real = real.to(dev, torch.float32)
        B_loc, N_loc, _ = real.shape
        B, N = B_loc * n_data, N_loc * n_pts
        rows = block(B, n_data, at_data)
        cols = block(N, n_pts, at_pts)

        def mine(t):
            """The rank's block of a global [B, N, ...] draw."""
            return t.to(dev)[rows][:, cols]

        sph, idx, ee = constants(dev)
        x = sph[cols][None].expand(B_loc, N_loc, 3)
        idx, ee = idx[:, cols], ee[:, cols]
        spe = state.steps_per_epoch
        draws = dict(draws or {})

        with sharded(scope, G, D):
            # ---------------- D phase ----------------
            if z_d is None:
                z_d = sample_z(gen, B, N, cfg.nz, cfg.nv, cfg.n_rand,
                               cfg.n_mix, sph)
            with torch.no_grad():
                fake = g_forward(G, x, mine(z_d), idx, ee,
                                 grad_needed=False)
            d_params = list(D.parameters())
            logit_real = logits(D, real)
            logit_fake = logits(D, fake)
            d_loss, d_info = dis_loss(logit_real, logit_fake, gan=cfg.gan,
                                      noise_label=cfg.flip_d, gen=gen)
            if use_gp:
                if "alpha" not in draws:
                    draws["alpha"] = torch.rand((B, 1, 1), generator=gen,
                                                device=gen.device)
                with frozen_running_stats(D):
                    d_loss = d_loss + wgan_gp(
                        lambda pts: D(pts, train=True), real, fake,
                        draws["alpha"].to(dev)[rows], cfg.lambda_gp,
                        emd_pairing=cfg.gp_mapping,
                        emd_iters=cfg.gp_emd_iters, points_group=pts_group,
                        data_group=data_group)
            if cfg.mix:
                if "lam" not in draws:
                    draws.update(zip(("lam", "anchor", "flip"),
                                     cutmix_draws(gen, B, N)))
                mixed, _, _ = cutmix(real, fake, draws["lam"].to(dev)[rows],
                                     draws["anchor"].to(dev)[rows],
                                     draws["flip"].to(dev),
                                     emd_iters=cfg.mix_emd_iters,
                                     points_group=pts_group)
                d_loss = d_loss + mix_loss(logits(D, mixed),
                                           gan=cfg.gan)[0]
            d_grads = mean_grads(torch.autograd.grad(d_loss, d_params))
            _apply(state.d_opt, d_params, d_grads,
                   lr_at(cfg, cfg.lr_d, updates_done(state.d_opt), spe),
                   cfg.nan_guard)

            # ------------- G phase (against the updated D) -------------
            if z_g is None:
                z_g = sample_z(gen, B, N, cfg.nz, cfg.nv, cfg.n_rand,
                               cfg.n_mix, sph)
            g_params = list(G.parameters())
            fake2 = g_forward(G, x, mine(z_g), idx, ee)
            logit_fake = logits(D, fake2)
            logit_real = logits(D, real) if cfg.gan == "real" else None
            g_loss, _ = gen_loss(logit_real, logit_fake, gan=cfg.gan,
                                 noise_label=cfg.flip_g, gen=gen)
            g_grads = mean_grads(torch.autograd.grad(g_loss, g_params))
            _apply(state.g_opt, g_params, g_grads,
                   lr_at(cfg, cfg.lr_g, updates_done(state.g_opt), spe),
                   cfg.nan_guard)

        if state.g_ema is not None:
            ema_update(state.g_ema, G, cfg.ema_rate)
        state.step += 1
        metrics = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                   "real_acc": d_info["real_acc"],
                   "fake_acc": d_info["fake_acc"]}
        return state, metrics

    return step


def _sample_net(state: TrainState, use_ema: bool):
    """The generator a sampler runs: the EMA copy (with the live one's
    buffers) when asked for and present, else the live one."""
    if use_ema and state.g_ema is not None:
        with torch.no_grad():
            for e, b in zip(state.g_ema.buffers(), state.G.buffers()):
                e.copy_(b)
        return state.g_ema
    return state.G


def make_sample_fn(cfg: Config, sphere, use_ema: bool = False
                   ) -> Callable[[TrainState, torch.Tensor], torch.Tensor]:
    """`sample(state, z [B, N, nz]) -> clouds [B, N, 3]` in eval mode (the
    BatchNorm running averages), with the EMA parameters when `use_ema`
    and the state has them. Configurations that `supports_fused` accepts
    take the fused eval path (kernel C for both EdgeBlock tails, kernel B
    for EdgeConv2's kNN), with EdgeConv1 on the template's kNN graph; the
    others run `Generator.forward`, and so does `knn_mode="approx"`: the
    JAX sampler runs `G.apply`, whose EdgeConv2 selects in the band, and
    the fused path has no band."""
    sphere_np = np.asarray(sphere, np.float32)
    fused = supports_fused(cfg) and cfg.knn_mode == "exact"
    # eval-mode BatchNorm is per element, so EdgeConv1 at batch 1 is exact
    edge1_b1 = cfg.edge1_b1 and not cfg.use_head
    cache = {}

    def sample(state: TrainState, z: torch.Tensor) -> torch.Tensor:
        net = _sample_net(state, use_ema)
        dev = next(net.parameters()).device
        if dev not in cache:
            sph = torch.as_tensor(sphere_np, device=dev)
            cache[dev] = (sph, knn_indices(sph[None], cfg.k))
        sph, idx = cache[dev]
        z = z.to(dev, torch.float32)
        B = z.shape[0]
        x = sph[None].expand(B, -1, -1)
        with torch.no_grad():
            if fused:
                return generator_forward_eval(
                    net, x, z, edge1_idx=idx.expand(B, -1, -1))
            if not edge1_b1:
                idx = idx.expand(B, -1, -1)
            return net(x, z, train=False, edge1_idx=idx,
                       template_batch_const=edge1_b1)

    return sample


def make_sample_fn_pointsharded(cfg: Config, sphere, mesh: Mesh,
                                use_ema: bool = False
                                ) -> Callable[[TrainState, torch.Tensor],
                                              torch.Tensor]:
    """The eval-mode sampler with the points cut over the mesh's `points`
    axis (the JAX `make_sample_fn_pointsharded`): `sample(state, z_local
    [B, N / P, nz]) -> the rank's points [B, N / P, 3]` of the clouds, with
    `Generator.forward` (EdgeConv1 on the rank's rows of the template's
    edges, EdgeConv2 among the gathered points, the norms and the pool
    over the group); eval-mode BatchNorm needs no collective."""
    sphere_np = np.asarray(sphere, np.float32)
    n_pts, at = mesh.axis_size("points"), mesh.index("points")
    scope = Scope(points=mesh.group("points"))
    edge1_b1 = cfg.edge1_b1 and not cfg.use_head
    cache = {}

    def sample(state: TrainState, z: torch.Tensor) -> torch.Tensor:
        net = _sample_net(state, use_ema)
        dev = next(net.parameters()).device
        if dev not in cache:
            sph = torch.as_tensor(sphere_np, device=dev)
            cache[dev] = (sph, template_edges(sph, cfg.k)[1])
        sph, ee = cache[dev]
        z = z.to(dev, torch.float32)
        B, n, _ = z.shape
        cols = block(n * n_pts, n_pts, at)
        x = sph[cols][None].expand(B, n, 3)
        ee = ee[:, cols]
        if not edge1_b1:
            ee = ee.expand(B, -1, -1, -1)
        with torch.no_grad(), sharded(scope, net):
            return net(x, z, train=False, edge1_ee=ee,
                       template_batch_const=edge1_b1)

    return sample
