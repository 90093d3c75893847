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
here; EdgeConv1 runs on them at batch 1 (`edge1_b1`). On the card the step
runs kernel B twice (EdgeConv2 in each phase) and kernel D once (its
backward in the G phase); nothing else of it is a kernel of the port.

The step takes z_d and z_g explicitly when given (a parity test hands it
the JAX step's codes); otherwise it draws them from the state's
`torch.Generator`. WGAN-GP (`gan=wgan` with `lambda_gp > 0`), CutMix
(`mix`) and region-mixed codes (`n_mix`) need slices not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data.noise import sample_z
from sp_gan_tpu_torch.losses.gan import dis_loss, gen_loss
from sp_gan_tpu_torch.nn.fused_eval import (generator_forward_eval,
                                            supports_fused)
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
    """`step(state, real [B, N, 3], z_d=None, z_g=None) -> (state,
    metrics)` on the device of `state.G`. `sphere` [N, 3] (array or
    tensor) is the run's template; metrics are 0-d tensors (d_loss, g_loss,
    real_acc, fake_acc) left on the device."""
    if cfg.gan == "wgan" and cfg.lambda_gp > 0:
        raise NotImplementedError("WGAN-GP needs the EMD slice (not ported "
                                  "yet); use --lambda_gp 0")
    if cfg.mix:
        raise NotImplementedError("CutMix (--mix) needs the EMD slice, not "
                                  "ported yet")
    if cfg.n_mix:
        raise NotImplementedError("region-mixed codes (--n_mix) are not "
                                  "ported yet")
    if cfg.bn_groups != 1:
        raise NotImplementedError("per-shard BatchNorm statistics "
                                  "(bn_stats=per_shard over a mesh) wait "
                                  "for the data-parallel slice")
    sphere_np = np.asarray(sphere, np.float32)
    edge1_b1 = cfg.edge1_b1 and not cfg.use_head
    cache = {}

    def constants(dev):
        if dev not in cache:
            sph = torch.as_tensor(sphere_np, device=dev)
            cache[dev] = (sph, *template_edges(sph, cfg.k))
        return cache[dev]

    def g_forward(G, x, z):
        _, idx, ee = constants(x.device)
        if not edge1_b1:
            B = x.shape[0]
            idx = idx.expand(B, -1, -1)
            ee = ee.expand(B, -1, -1, -1)
        return G(x, z, train=True, edge1_idx=idx, edge1_ee=ee,
                 template_batch_const=edge1_b1)

    def step(state: TrainState, real: torch.Tensor,
             z_d: Optional[torch.Tensor] = None,
             z_g: Optional[torch.Tensor] = None):
        G, D, gen = state.G, state.D, state.gen
        dev = next(G.parameters()).device
        real = real.to(dev, torch.float32)
        B, N, _ = real.shape
        sph = constants(dev)[0]
        x = sph[None].expand(B, N, 3)
        spe = state.steps_per_epoch

        # ---------------- D phase ----------------
        if z_d is None:
            z_d = sample_z(gen, B, N, cfg.nz, cfg.nv, cfg.n_rand)
        with torch.no_grad():
            fake = g_forward(G, x, z_d.to(dev))
        d_params = list(D.parameters())
        logit_real = D(real, train=True)
        logit_fake = D(fake, train=True)
        d_loss, d_info = dis_loss(logit_real, logit_fake, gan=cfg.gan,
                                  noise_label=cfg.flip_d, gen=gen)
        d_grads = torch.autograd.grad(d_loss, d_params)
        _apply(state.d_opt, d_params, d_grads,
               lr_at(cfg, cfg.lr_d, updates_done(state.d_opt), spe),
               cfg.nan_guard)

        # ---------------- G phase (against the updated D) ----------------
        if z_g is None:
            z_g = sample_z(gen, B, N, cfg.nz, cfg.nv, cfg.n_rand)
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
    others run `Generator.forward`."""
    sphere_np = np.asarray(sphere, np.float32)
    fused = supports_fused(cfg)
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
