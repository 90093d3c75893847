"""Training state and optimizers, the port of `sp_gan_tpu/train/state.py`.

The JAX package threads one immutable pytree through its jitted step; here
the state is the modules themselves, their optimizers and counters, updated
in place by the step:

- Adam with b1 `cfg.beta1`, b2 `cfg.beta2` and eps 1e-8 (optax `adam`'s
  defaults), one per network;
- the StepLR schedule as a function of the update count,
  `base * rate ** ((count // steps_per_epoch) // lr_decay_feq)` with
  `--lr_decay`, else constant (with `--use_sgd` the reference anneals to
  its own initial rate, so the schedule stays constant there too);
- with `cfg.ema`, a copy of the generator whose parameters follow
  `ema_rate * ema + (1 - ema_rate) * param` after every step (its buffers
  are taken from the live generator when it samples);
- the step count and the `torch.Generator` that draws the step's codes and
  label noise.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch

from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.device import resolve_device
from sp_gan_tpu_torch.nn.discriminator import Discriminator
from sp_gan_tpu_torch.nn.generator import Generator

ADAM_EPS = 1e-8


@dataclass
class TrainState:
    G: Generator
    D: Discriminator
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    g_ema: Optional[Generator]     # None unless cfg.ema
    step: int
    gen: torch.Generator           # codes and label noise of the step
    steps_per_epoch: int = 1


def lr_at(cfg: Config, base_lr: float, count: int,
          steps_per_epoch: int) -> float:
    """Learning rate of update number `count` (0-based)."""
    if not cfg.lr_decay:
        return base_lr
    epoch = count // steps_per_epoch
    return base_lr * cfg.lr_decay_rate ** (epoch // cfg.lr_decay_feq)


def make_adam(params, cfg: Config, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(cfg.beta1, cfg.beta2),
                            eps=ADAM_EPS)


def updates_done(opt: torch.optim.Optimizer) -> int:
    """Updates an Adam has applied (its per-parameter step count)."""
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "step" in st:
                return int(st["step"])
    return 0


def ema_update(ema: torch.nn.Module, model: torch.nn.Module,
               decay: float) -> None:
    with torch.no_grad():
        for e, p in zip(ema.parameters(), model.parameters()):
            e.copy_(decay * e + (1.0 - decay) * p)


def create_train_state(cfg: Config, steps_per_epoch: int = 1, device=None,
                       G: Optional[Generator] = None,
                       D: Optional[Discriminator] = None) -> TrainState:
    """A fresh state on `device` (default cuda): G and D drawn with the JAX
    package's initializers from `cfg.seed` and `cfg.seed + 1` unless given,
    new Adams, the EMA copy with `cfg.ema`, step 0 and a generator seeded
    with `cfg.seed`."""
    dev = resolve_device(device)
    G = (G if G is not None else Generator(cfg, seed=cfg.seed)).to(dev)
    D = (D if D is not None else Discriminator(cfg, seed=cfg.seed + 1)).to(dev)
    g_ema = None
    if cfg.ema:
        g_ema = copy.deepcopy(G)
        g_ema.requires_grad_(False)
    return TrainState(
        G=G, D=D, g_opt=make_adam(G.parameters(), cfg, cfg.lr_g),
        d_opt=make_adam(D.parameters(), cfg, cfg.lr_d), g_ema=g_ema, step=0,
        gen=torch.Generator(device=dev).manual_seed(cfg.seed),
        steps_per_epoch=steps_per_epoch)


def param_count(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
