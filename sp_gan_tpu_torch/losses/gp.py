"""Gradient penalties, the port of `sp_gan_tpu/losses/gp.py`.

Both differentiate through the discriminator: `torch.autograd.grad` with
`create_graph=True` takes the gradient of D's summed logits with respect
to its input, and the penalty built on it stays differentiable in D's
parameters (the double backward that `jax.grad` under jit gives JAX).
`d_apply` is the discriminator's forward; the caller decides its mode and
whether its BatchNorm running averages may move (the training step keeps
them, as the JAX step drops the mutation).

Under a mesh (the JAX `data_axis` and `points_axis` branches) the clouds
are the rank's block and `wgan_gp` takes the process groups; see there.
"""

from __future__ import annotations

from typing import Callable

import torch

import torch.distributed as dist

from sp_gan_tpu_torch.ops.emd import emd_auction
from sp_gan_tpu_torch.parallel.mesh import (all_gather_cat, all_reduce_sum,
                                            gather_rows_nograd)
from sp_gan_tpu_torch.parallel.points import emd_auction_local

DApply = Callable[[torch.Tensor], torch.Tensor]


def _input_grad(d_apply: DApply, x: torch.Tensor,
                copies: int = 1) -> torch.Tensor:
    """d(sum D(x) / copies) / dx, kept in the graph."""
    x = x.detach().requires_grad_(True)
    total = d_apply(x).sum()
    if copies > 1:
        total = total / copies
    (g,) = torch.autograd.grad(total, x, create_graph=True)
    return g


def r1_penalty(d_apply: DApply, real: torch.Tensor) -> torch.Tensor:
    """Zero-centered gradient penalty on real data: E[||grad_x D(x)||^2]."""
    g = _input_grad(d_apply, real)
    return (g.reshape(g.shape[0], -1) ** 2).sum(dim=-1).mean()


def wgan_gp(d_apply: DApply, real: torch.Tensor, fake: torch.Tensor,
            alpha: torch.Tensor, lambda_gp: float = 10.0, gamma: float = 1.0,
            emd_pairing: bool = False, emd_eps: float = 0.005,
            emd_iters: int = 300, points_group=None,
            data_group=None) -> torch.Tensor:
    """WGAN-GP on interpolates: lambda * E[(||grad D(x_hat)|| / gamma - 1)^2]
    with x_hat = fake + alpha (real - fake), alpha [B, 1, 1] the caller's
    U(0, 1) draw. `emd_pairing` (`--gp_mapping`) first orders real by the
    EMD assignment of each fake point (`emd_auction(fake, real, emd_eps,
    emd_iters)`, the fixed-iteration solver; the assignment carries no
    gradient) and interpolates `real[ass] + alpha (fake - real[ass])`.

    Under a mesh, real, fake and alpha are the rank's block, and the
    penalty is that of the whole batch, the same on every rank:

    * `points_group` (the points cut over its P ranks): the pairing runs
      `parallel.points.emd_auction_local` in one phase, the scaled Jacobi
      auction that equals the fixed-iteration solver until every row is
      assigned, and pairs with the all-gathered real cloud; D's logits are
      the same on the P ranks of a data replica, so the input gradient is
      taken of their sum over P: over the mesh these sum to the whole
      batch's logits, and the gathers' backward hands each rank its own
      points' gradient; each cloud's squares are summed over the group;
    * `data_group`: the clouds' norms are gathered over the data replicas
      before the mean."""
    if emd_pairing:
        with torch.no_grad():
            if points_group is not None:
                _, ass = emd_auction_local(fake, real, emd_eps, emd_iters,
                                           points_group, phases=1)
                source = gather_rows_nograd(real, points_group, dim=1)
            else:
                _, ass = emd_auction(fake, real, emd_eps, emd_iters)
                source = real
        paired = torch.gather(source, 1, ass.long()[..., None].expand(
            -1, -1, real.shape[-1]))
        interp = paired + alpha * (fake - paired)
    else:
        interp = fake + alpha * (real - fake)
    copies = (1 if points_group is None
              else dist.get_world_size(points_group))
    g = _input_grad(d_apply, interp, copies)
    sumsq = all_reduce_sum((g.reshape(g.shape[0], -1) ** 2).sum(dim=-1),
                           points_group)
    norms = all_gather_cat(torch.sqrt(sumsq + 1e-12), data_group, dim=0)
    return lambda_gp * ((norms / gamma - 1.0) ** 2).mean()
