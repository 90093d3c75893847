"""The fused train-mode EdgeBlock, the port of the non-kernel half of
`sp_gan_tpu/ops/pallas/edgeblock_train.py`.

Train-mode BatchNorm needs the batch statistics of three chained convs of
the edge tensor ee [B, N, k, 2C]. BN1 (conv_w1 on the diff half) and BNx
(conv_x on all of ee) follow from the first and second moments of ee
(`_moment_stats`: one [2C, 2C] product, which the JAX package also leaves
outside Pallas); BN2 (conv_w2 of a nonlinear function of BN1's output)
from kernel I's sums (`edge_train_stats2`). With the three (mean, var)
folded into affines, the forward is kernel C (`edge_tail`) and the
backward kernels J, K and L in sequence (`ops/kernels/edgeblock_train.py`).
Variances are `E[h^2] - E[h]^2` clamped at 0, as in the JAX package.

A block's parameters are a dict of f32 tensors keyed by the names of
`PARAM_NAMES` (`block_params` takes them from an `nn.layers.EdgeBlock`).
`fused_edge_block` is differentiable in ee and in every parameter
(`FusedEdgeBlock`); its batch statistics carry no gradient.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from sp_gan_tpu_torch.ops.kernels.edgeblock import edge_tail
from sp_gan_tpu_torch.ops.kernels.edgeblock_train import (edge_train_bwd1,
                                                          edge_train_bwd2,
                                                          edge_train_bwd3,
                                                          edge_train_stats2)

PARAM_NAMES = ("conv_w1.kernel", "conv_w1.bias", "bn_w1.scale", "bn_w1.bias",
               "conv_w2.kernel", "conv_w2.bias", "bn_w2.scale", "bn_w2.bias",
               "conv_x.kernel", "conv_x.bias", "bn_x.scale", "bn_x.bias",
               "out_kernel", "out_bias")
BNS = ("bn_w1", "bn_w2", "bn_x")


def block_params(block: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters of an `nn.layers.EdgeBlock` by `PARAM_NAMES`."""
    return {n: block.get_parameter(n) for n in PARAM_NAMES}


def _affine(mean, var, gamma, beta, conv_bias, eps: float = 1e-5):
    """Conv bias and train-mode BN(mean, var) folded into [scale; shift]
    [2, F]: (xW + b - mean) * inv * gamma + beta = xW * a[0] + a[1]."""
    inv = gamma * torch.rsqrt(var + eps)
    return torch.stack([inv, (conv_bias - mean) * inv + beta]).float()


def _moment_stats(ee: torch.Tensor, kernel, bias,
                  cols: slice) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch mean and variance of (ee[..., cols] @ kernel + bias) per
    channel from the first and second moments of the edge tensor slice,
    accumulated in f32."""
    e = ee[..., cols]
    flat = e.reshape(-1, e.shape[-1]).float()
    M = flat.shape[0]
    mu_e = flat.mean(dim=0)                                   # [C]
    second = (flat.t() @ flat) / M                            # [C, C]
    mean_h = mu_e @ kernel + bias
    e_xw2 = torch.einsum("cf,cd,df->f", kernel, second, kernel)
    mean_xw = mu_e @ kernel
    var_h = e_xw2 + 2 * bias * mean_xw + bias ** 2 - mean_h ** 2
    return mean_h, var_h.clamp(min=0.0)


def edge_block_train_stats(p: Dict[str, torch.Tensor], ee: torch.Tensor,
                           k: int, neg: float = 0.01, eps: float = 1e-5
                           ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Train-mode batch statistics of the three BNs: {bn: (mean, var)}."""
    C = ee.shape[-1] // 2
    M = ee.numel() // ee.shape[-1]
    f = {n: t.detach().float() for n, t in p.items()}
    m1, v1 = _moment_stats(ee, f["conv_w1.kernel"], f["conv_w1.bias"],
                           slice(C, 2 * C))
    mx, vx = _moment_stats(ee, f["conv_x.kernel"], f["conv_x.bias"],
                           slice(0, 2 * C))
    a1 = _affine(m1, v1, f["bn_w1.scale"], f["bn_w1.bias"], f["conv_w1.bias"],
                 eps)
    sums = edge_train_stats2(ee, f["conv_w1.kernel"].contiguous(),
                             a1.contiguous(),
                             f["conv_w2.kernel"].contiguous(), k, neg)
    mean2 = sums[0] / M + f["conv_w2.bias"]           # h2 = y1 @ W2 + b2
    var2 = sums[1] / M - (sums[0] / M) ** 2
    return {"bn_w1": (m1, v1), "bn_w2": (mean2, var2.clamp(min=0.0)),
            "bn_x": (mx, vx)}


def _fold_all(f: Dict[str, torch.Tensor], stats, eps: float):
    """Every sweep's constants: a1, a2, ax and [g2; b2; gx; bx] [4, F],
    [g1; b1] [2, F2]."""
    a = {bn: _affine(*stats[bn], f[f"{bn}.scale"], f[f"{bn}.bias"],
                     f[conv + ".bias"], eps).contiguous()
         for bn, conv in zip(BNS, ("conv_w1", "conv_w2", "conv_x"))}
    gb2x = torch.stack([f["bn_w2.scale"], f["bn_w2.bias"], f["bn_x.scale"],
                        f["bn_x.bias"]]).float().contiguous()
    gb1 = torch.stack([f["bn_w1.scale"], f["bn_w1.bias"]]).float() \
        .contiguous()
    return a["bn_w1"], a["bn_w2"], a["bn_x"], gb2x, gb1


def _weights(f: Dict[str, torch.Tensor]):
    return tuple(f[n].contiguous() for n in (
        "conv_w1.kernel", "conv_w2.kernel", "conv_x.kernel", "out_kernel"))


def edge_block_train_forward(p: Dict[str, torch.Tensor], ee: torch.Tensor,
                             k: int, neg: float = 0.01, eps: float = 1e-5):
    """Fused train-mode forward: (out [B, N, F] f32, stats). Kernel I,
    then kernel C with the batch statistics folded."""
    f = {n: t.detach().float() for n, t in p.items()}
    stats = edge_block_train_stats(f, ee, k, neg, eps)
    a1, a2, ax, _, _ = _fold_all(f, stats, eps)
    w1, w2, wx, wout = _weights(f)
    out = edge_tail(ee, w1, a1, w2, a2, wx, ax, wout,
                    f["out_bias"][None].contiguous(), k=k, neg=neg)
    return out, stats


def edge_block_train_backward(p: Dict[str, torch.Tensor], ee: torch.Tensor,
                              stats, d_out: torch.Tensor, k: int,
                              neg: float = 0.01, eps: float = 1e-5):
    """The three-sweep backward, kernels J, K and L in sequence: (d_params
    by `PARAM_NAMES`, d_ee in ee's type). The conv biases that feed a
    train-mode BN get exactly zero; the BN gammas and betas come from the
    sweeps' sums (d_gamma = sum(d_p * xhat), d_beta = sum(d_p))."""
    f = {n: t.detach().float() for n, t in p.items()}
    a1, a2, ax, gb2x, gb1 = _fold_all(f, stats, eps)
    w1, w2, wx, wout = _weights(f)
    d_out = d_out.float().contiguous()
    sums, d_wout, d_bout, d_u = edge_train_bwd1(
        ee, d_out, w1, a1, w2, a2, wx, ax, gb2x, wout, k, neg)
    s1, d_w2 = edge_train_bwd2(ee, d_u, w1, a1, w2, a2, wx, ax, gb2x, sums,
                               gb1, k, neg)
    d_ee, d_w1, d_wx = edge_train_bwd3(ee, d_u, w1, a1, w2, a2, wx, ax, gb2x,
                                       sums, gb1, s1, k, neg)
    zeros = torch.zeros_like
    d_params = {
        "conv_w1.kernel": d_w1, "conv_w1.bias": zeros(f["conv_w1.bias"]),
        "conv_w2.kernel": d_w2, "conv_w2.bias": zeros(f["conv_w2.bias"]),
        "conv_x.kernel": d_wx, "conv_x.bias": zeros(f["conv_x.bias"]),
        "out_kernel": d_wout, "out_bias": d_bout,
        "bn_w1.scale": s1[1], "bn_w1.bias": s1[0],
        "bn_w2.scale": sums[1], "bn_w2.bias": sums[0],
        "bn_x.scale": sums[3], "bn_x.bias": sums[2]}
    return d_params, d_ee


class FusedEdgeBlock(torch.autograd.Function):
    """The fused train-mode EdgeBlock under autograd: forward
    `edge_block_train_forward`, backward `edge_block_train_backward`.
    Returns out and the six batch statistics (m1, v1, m2, v2, mx, vx),
    which are non-differentiable. Under `no_grad` autograd keeps no node
    and saves nothing."""

    @staticmethod
    def forward(ctx, ee, k, neg, eps, *params):
        p = dict(zip(PARAM_NAMES, params))
        out, stats = edge_block_train_forward(p, ee, k, neg, eps)
        flat = [t for bn in BNS for t in stats[bn]]
        ctx.save_for_backward(ee, *flat, *params)
        ctx.k, ctx.neg, ctx.eps = k, neg, eps
        ctx.mark_non_differentiable(*flat)
        return (out, *flat)

    @staticmethod
    def backward(ctx, d_out, *d_stats):
        ee, *rest = ctx.saved_tensors
        flat, params = rest[:6], rest[6:]
        stats = {bn: (flat[2 * i], flat[2 * i + 1])
                 for i, bn in enumerate(BNS)}
        p = dict(zip(PARAM_NAMES, params))
        d_params, d_ee = edge_block_train_backward(
            p, ee, stats, d_out, ctx.k, ctx.neg, ctx.eps)
        return (d_ee.to(ee.dtype), None, None, None,
                *[d_params[n].to(p[n].dtype) for n in PARAM_NAMES])


def fused_edge_block(p: Dict[str, torch.Tensor], ee: torch.Tensor, k: int,
                     neg: float = 0.01, eps: float = 1e-5):
    """Differentiable fused train-mode EdgeBlock: (out [B, N, F] f32,
    {bn: (batch mean, batch var)}) with `p` by `PARAM_NAMES`."""
    out, *flat = FusedEdgeBlock.apply(ee.contiguous(), k, neg, eps,
                                      *[p[n] for n in PARAM_NAMES])
    return out, {bn: (flat[2 * i], flat[2 * i + 1])
                 for i, bn in enumerate(BNS)}
