"""Fused train-mode generator forward, the port of
`sp_gan_tpu/nn/fused_train.py`: what `Generator.forward(train=True)`
computes, with EdgeConv2 running through the fused train-mode EdgeBlock
(`ops/edgeblock_train.py`: kernels I and C forward, J, K and L backward).

It computes with the Generator's own parameters and updates its BatchNorm
running averages in place as `_ra` does (momentum 0.9, the batch
statistics detached). The helpers are those of the JAX module, on the
Generator's submodules (its `_instance_norm` is
`nn.layers.instance_norm_points`). As there:

- EdgeConv1 runs at the full batch (no batch-1 broadcast) on the edges it
  is given, through `_edge_block_xla` (plain PyTorch), because its
  2 * 3 input channels are fewer than 64; EdgeConv2 runs the fused
  EdgeBlock on the concat-form fused edges (`ops.edge.edge_features`,
  differentiable through `EdgeConcat`);
- under `mixed_edge` (and `bfloat16`) both EdgeBlocks take bf16 edges,
  selection staying f32; everything else is f32.

`_edge_block_xla` keeps the f32 sums of its BatchNorm-feeding dense
layers unrounded under bf16 edges, as the compiled JAX function does on
the CPU: XLA drops the bf16 rounding between the dot (and its bias) and
the f32 BatchNorm that reads it (tests/test_torch_fused_train.py measures
both). Supports what `nn.fused_eval.supports_fused` accepts.
"""

from __future__ import annotations

from typing import Optional

import torch

from sp_gan_tpu_torch.nn.fused_eval import supports_fused
from sp_gan_tpu_torch.nn.generator import Generator
from sp_gan_tpu_torch.nn.layers import (EdgeBlock, SPBatchNorm,
                                        instance_norm_points, lrelu)
from sp_gan_tpu_torch.ops.edge import edge_features
from sp_gan_tpu_torch.ops.edgeblock_train import block_params, fused_edge_block

MOMENTUM = 0.9
NEG = 0.01
NEG2 = 0.2


def _dense(p, x: torch.Tensor, act_neg: Optional[float] = None,
           f32_sums: bool = False) -> torch.Tensor:
    """x @ kernel + bias in x's dtype (`f32_sums`: operands rounded to x's
    dtype, the sum and the bias in f32)."""
    k, b = p.kernel.to(x.dtype), p.bias.to(x.dtype)
    if f32_sums:
        x, k, b = x.float(), k.float(), p.bias.float()
    y = x @ k + b
    return y if act_neg is None else lrelu(y, act_neg)


def _bn_train(p: SPBatchNorm, x: torch.Tensor, eps: float = 1e-5):
    """Train-mode BN of a small [B, C] tensor: (y, (mean, var))."""
    xf = x.float()
    mean = xf.mean(dim=0)
    var = (xf * xf).mean(dim=0) - mean * mean
    inv = torch.rsqrt(var + eps)
    y = ((xf - mean) * inv * p.scale + p.bias).to(x.dtype)
    return y, (mean, var)


def _adain(p, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    gb = style @ p.style_kernel.to(style.dtype) \
        + p.style_bias.to(style.dtype)
    C = x.shape[-1]
    return gb[..., :C] * instance_norm_points(x) + gb[..., C:]


def _ra(bn: SPBatchNorm, batch) -> None:
    """Running-average update of `bn` in place, as SPBatchNorm's."""
    mean, var = batch
    with torch.no_grad():
        bn.mean.copy_(MOMENTUM * bn.mean + (1 - MOMENTUM) * mean.detach())
        bn.var.copy_(MOMENTUM * bn.var + (1 - MOMENTUM) * var.detach())


def _edge_block_xla(blk: EdgeBlock, ee: torch.Tensor, k: int,
                    neg: float = 0.01, eps: float = 1e-5):
    """Plain train-mode EdgeBlock on the edge tensor (the math of
    `nn.layers.EdgeBlock` on the concat form): (out, {bn: (mean, var)})."""
    C = ee.shape[-1] // 2
    f32 = ee.dtype != torch.float32

    def bn_train(p, h):
        hf = h.float()
        mean = hf.mean(dim=(0, 1, 2))
        var = (hf * hf).mean(dim=(0, 1, 2)) - mean * mean
        y = (hf - mean) * torch.rsqrt(var + eps) * p.scale + p.bias
        return y.to(ee.dtype), (mean, var)

    stats = {}
    w1 = _dense(blk.conv_w1, ee[..., C:], f32_sums=f32)
    w1, stats["bn_w1"] = bn_train(blk.bn_w1, w1)
    w1 = lrelu(w1, neg)
    w2 = _dense(blk.conv_w2, w1, f32_sums=f32)
    w2, stats["bn_w2"] = bn_train(blk.bn_w2, w2)
    w = torch.softmax(lrelu(w2, neg), dim=2)
    v = _dense(blk.conv_x, ee, f32_sums=f32)
    v, stats["bn_x"] = bn_train(blk.bn_x, v)
    v = lrelu(v, neg) * w
    out = torch.einsum("bnkc,kco->bno", v, blk.out_kernel.to(v.dtype))
    out = out + blk.out_bias.to(out.dtype)
    return out, stats


def generator_forward_train(G: Generator, x: torch.Tensor, z: torch.Tensor,
                            edge1_idx: Optional[torch.Tensor] = None,
                            edge1_ee: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """x [B, N, 3], z [B, N, nz] -> [B, N, 3] f32 with G's weights, G's
    BatchNorm running averages updated. edge1_idx [B, N, k] and edge1_ee
    [B, N, k, 6]: EdgeConv1's template graph and edges, at the full
    batch."""
    cfg = G.cfg
    if not supports_fused(cfg):
        raise ValueError("this configuration has no fused train path")
    k = cfg.k
    x, z = x.float(), z.float()
    B, N, _ = x.shape
    mixed = cfg.dtype in ("mixed_edge", "bfloat16")
    bf16 = torch.bfloat16

    if cfg.z_norm:
        z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)
    style = _dense(G.head2, _dense(G.head1, torch.cat([x, z], -1), NEG), NEG)

    def edge(blk: EdgeBlock, inp, idx, ee=None):
        if ee is not None:
            if mixed:
                ee = ee.to(bf16)
        elif mixed:
            # kNN selection in f32, the [B, N, k, *] edges and the
            # EdgeBlock's matmuls in bf16
            if idx is None:
                ee = edge_features(inp, k, out_dtype=bf16)
            else:
                ee = edge_features(inp.to(bf16), k, idx=idx)
        else:
            ee = edge_features(inp, k, idx=idx)
        if inp.shape[-1] * 2 >= 64:
            out, stats = fused_edge_block(block_params(blk), ee, k, NEG)
        else:
            out, stats = _edge_block_xla(blk, ee, k, NEG)
        for bn in stats:
            _ra(getattr(blk, bn), stats[bn])
        return out.float()

    x1 = lrelu(edge(G.edge1, x, edge1_idx, edge1_ee), NEG2)
    x1 = _adain(G.adain1, x1, style)

    x2 = lrelu(edge(G.edge2, x1, None), NEG2)
    x2 = _adain(G.adain2, x2, style)

    g = x2.amax(dim=1)
    g = _dense(G.global1, g)
    g, st1 = _bn_train(G.global_bn1, g)
    _ra(G.global_bn1, st1)
    g = lrelu(g, NEG)
    g = _dense(G.global2, g)
    g, st2 = _bn_train(G.global_bn2, g)
    _ra(G.global_bn2, st2)
    g = lrelu(g, NEG)
    g = g[:, None, :].expand(B, N, g.shape[-1])

    feat = torch.cat([g, x2], dim=-1)
    out = _dense(G.tail2, _dense(G.tail1, feat, NEG), NEG)
    out = torch.tanh(_dense(G.tail3, out))
    if cfg.off:
        out = out + x
    return out.float()
