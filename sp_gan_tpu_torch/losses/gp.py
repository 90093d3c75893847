"""Gradient penalties, the port of `sp_gan_tpu/losses/gp.py` on one
device (the JAX `points_axis` and `data_axis` belong to the parallel
slice).

Both differentiate through the discriminator: `torch.autograd.grad` with
`create_graph=True` takes the gradient of D's summed logits with respect
to its input, and the penalty built on it stays differentiable in D's
parameters (the double backward that `jax.grad` under jit gives JAX).
`d_apply` is the discriminator's forward; the caller decides its mode and
whether its BatchNorm running averages may move (the training step keeps
them, as the JAX step drops the mutation).
"""

from __future__ import annotations

from typing import Callable

import torch

from sp_gan_tpu_torch.ops.emd import emd_auction

DApply = Callable[[torch.Tensor], torch.Tensor]


def _input_grad(d_apply: DApply, x: torch.Tensor) -> torch.Tensor:
    """d(sum D(x)) / dx, kept in the graph."""
    x = x.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(d_apply(x).sum(), x, create_graph=True)
    return g


def r1_penalty(d_apply: DApply, real: torch.Tensor) -> torch.Tensor:
    """Zero-centered gradient penalty on real data: E[||grad_x D(x)||^2]."""
    g = _input_grad(d_apply, real)
    return (g.reshape(g.shape[0], -1) ** 2).sum(dim=-1).mean()


def wgan_gp(d_apply: DApply, real: torch.Tensor, fake: torch.Tensor,
            alpha: torch.Tensor, lambda_gp: float = 10.0, gamma: float = 1.0,
            emd_pairing: bool = False, emd_eps: float = 0.005,
            emd_iters: int = 300) -> torch.Tensor:
    """WGAN-GP on interpolates: lambda * E[(||grad D(x_hat)|| / gamma - 1)^2]
    with x_hat = fake + alpha (real - fake), alpha [B, 1, 1] the caller's
    U(0, 1) draw. `emd_pairing` (`--gp_mapping`) first orders real by the
    EMD assignment of each fake point (`emd_auction(fake, real, emd_eps,
    emd_iters)`, the fixed-iteration solver; the assignment carries no
    gradient) and interpolates `real[ass] + alpha (fake - real[ass])`."""
    if emd_pairing:
        with torch.no_grad():
            _, ass = emd_auction(fake, real, emd_eps, emd_iters)
        paired = torch.gather(real, 1, ass.long()[..., None].expand(
            -1, -1, real.shape[-1]))
        interp = paired + alpha * (fake - paired)
    else:
        interp = fake + alpha * (real - fake)
    g = _input_grad(d_apply, interp)
    sumsq = (g.reshape(g.shape[0], -1) ** 2).sum(dim=-1)
    norms = torch.sqrt(sumsq + 1e-12)
    return lambda_gp * ((norms / gamma - 1.0) ** 2).mean()
