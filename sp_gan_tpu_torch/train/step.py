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
from sp_gan_tpu_torch.nn.layers import frozen_running_stats
from sp_gan_tpu_torch.ops.edge import edge_features
from sp_gan_tpu_torch.ops.pairwise import knn_indices
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


def make_train_step(cfg: Config, sphere
                    ) -> Callable[..., Tuple[TrainState, dict]]:
    """`step(state, real [B, N, 3], z_d=None, z_g=None, draws=None) ->
    (state, metrics)` on the device of `state.G`. `sphere` [N, 3] (array
    or tensor) is the run's template; metrics are 0-d tensors (d_loss,
    g_loss, real_acc, fake_acc) left on the device."""
    use_gp = cfg.gan == "wgan" and cfg.lambda_gp > 0
    if cfg.bn_groups != 1:
        raise NotImplementedError("per-shard BatchNorm statistics "
                                  "(bn_stats=per_shard over a mesh) wait "
                                  "for the data-parallel slice")
    use_fused_g = cfg.fused_train and supports_fused(cfg)
    # the D-phase forward needs no gradient, so the fused forward (whose
    # backward sweeps are the costly part) serves it under either flag
    use_fused_dphase = cfg.fused_dphase and supports_fused(cfg)
    if (use_fused_g or use_fused_dphase) and cfg.knn_mode == "approx":
        raise ValueError("--fused_train/--fused_dphase select EdgeConv2's "
                         "neighbors exactly; the JAX fused forward ignores "
                         "--knn_mode approx, and the port refuses the pair")
    sphere_np = np.asarray(sphere, np.float32)
    edge1_b1 = cfg.edge1_b1 and not cfg.use_head
    cache = {}

    def constants(dev):
        if dev not in cache:
            sph = torch.as_tensor(sphere_np, device=dev)
            cache[dev] = (sph, *template_edges(sph, cfg.k))
        return cache[dev]

    def g_forward(G, x, z, grad_needed=True):
        _, idx, ee = constants(x.device)
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

    def step(state: TrainState, real: torch.Tensor,
             z_d: Optional[torch.Tensor] = None,
             z_g: Optional[torch.Tensor] = None,
             draws: Optional[dict] = None):
        G, D, gen = state.G, state.D, state.gen
        dev = next(G.parameters()).device
        real = real.to(dev, torch.float32)
        B, N, _ = real.shape
        sph = constants(dev)[0]
        x = sph[None].expand(B, N, 3)
        spe = state.steps_per_epoch

        # ---------------- D phase ----------------
        if z_d is None:
            z_d = sample_z(gen, B, N, cfg.nz, cfg.nv, cfg.n_rand,
                           cfg.n_mix, sph)
        with torch.no_grad():
            fake = g_forward(G, x, z_d.to(dev), grad_needed=False)
        d_params = list(D.parameters())
        logit_real = D(real, train=True)
        logit_fake = D(fake, train=True)
        d_loss, d_info = dis_loss(logit_real, logit_fake, gan=cfg.gan,
                                  noise_label=cfg.flip_d, gen=gen)
        draws = dict(draws or {})
        if use_gp:
            if "alpha" not in draws:
                draws["alpha"] = torch.rand((B, 1, 1), generator=gen,
                                            device=gen.device)
            with frozen_running_stats(D):
                d_loss = d_loss + wgan_gp(
                    lambda pts: D(pts, train=True), real, fake,
                    draws["alpha"].to(dev), cfg.lambda_gp,
                    emd_pairing=cfg.gp_mapping, emd_iters=cfg.gp_emd_iters)
        if cfg.mix:
            if "lam" not in draws:
                draws.update(zip(("lam", "anchor", "flip"),
                                 cutmix_draws(gen, B, N)))
            mixed, _, _ = cutmix(real, fake, draws["lam"].to(dev),
                                 draws["anchor"].to(dev),
                                 draws["flip"].to(dev),
                                 emd_iters=cfg.mix_emd_iters)
            d_loss = d_loss + mix_loss(D(mixed, train=True), gan=cfg.gan)[0]
        d_grads = torch.autograd.grad(d_loss, d_params)
        _apply(state.d_opt, d_params, d_grads,
               lr_at(cfg, cfg.lr_d, updates_done(state.d_opt), spe),
               cfg.nan_guard)

        # ---------------- G phase (against the updated D) ----------------
        if z_g is None:
            z_g = sample_z(gen, B, N, cfg.nz, cfg.nv, cfg.n_rand,
                           cfg.n_mix, sph)
        g_params = list(G.parameters())
        fake2 = g_forward(G, x, z_g.to(dev))
        logit_fake = D(fake2, train=True)
        logit_real = D(real, train=True) if cfg.gan == "real" else None
        g_loss, _ = gen_loss(logit_real, logit_fake, gan=cfg.gan,
                             noise_label=cfg.flip_g, gen=gen)
        g_grads = torch.autograd.grad(g_loss, g_params)
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
        net = state.G
        if use_ema and state.g_ema is not None:
            net = state.g_ema
            with torch.no_grad():
                for e, b in zip(net.buffers(), state.G.buffers()):
                    e.copy_(b)
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
