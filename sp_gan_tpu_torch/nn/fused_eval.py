"""Eval forward through the fused EdgeBlock tail, the port of
`sp_gan_tpu/nn/fused_eval.py`: the serving path.

Computes what `Generator.forward(train=False)` computes, but each EdgeBlock
folds its BatchNorms into per-channel affines and runs everything after the
neighbor gather as kernel C (`ops/kernels/edgeblock.py`). The edges are the
concat form `[central, nbr - central]` in f32 whatever `cfg.dtype` says, as
in the JAX package, and the first EdgeBlock runs at the full batch. The
dense, AdaIN and global layers are the Generator's own modules.

The default architecture is supported (eql, attn and use_head off, no bf16
sub-mode); `Manipulator` serves other configurations through
`Generator.forward`.
"""

from __future__ import annotations

from typing import Optional

import torch

from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.nn.generator import NEG, NEG2, Generator
from sp_gan_tpu_torch.nn.layers import EdgeBlock, SPBatchNorm, TorchDense, lrelu
from sp_gan_tpu_torch.ops.edge import edge_features
from sp_gan_tpu_torch.ops.kernels.edgeblock import edge_tail


def supports_fused(cfg: Config) -> bool:
    """The JAX package's rule: not with eql, attn, use_head, per-shard
    BatchNorm groups (`cfg.bn_groups > 1`: the fused kernels take the
    whole batch's statistics) or a bf16 sub-mode."""
    return not (cfg.eql or cfg.attn or cfg.use_head or cfg.bn_groups > 1
                or cfg.dtype in ("bfloat16_g", "bfloat16_d",
                                 "bfloat16_tail32"))


def fold_bn(dense: TorchDense, bn: SPBatchNorm):
    """(dense kernel [in, out], [scale; shift] [2, out]) of a dense layer
    followed by eval BatchNorm, in f32, detached from autograd."""
    with torch.no_grad():
        inv = bn.scale / torch.sqrt(bn.var + bn.epsilon)
        shift = (dense.bias - bn.mean) * inv + bn.bias
        return (dense.kernel.detach().float().contiguous(),
                torch.stack([inv, shift]).float().contiguous())


def edge_block_eval(block: EdgeBlock, x: torch.Tensor,
                    idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One EdgeBlock's eval forward, [B, N, C] -> [B, N, F] f32."""
    ee = edge_features(x.float(), block.k, idx=idx)
    w1, a1 = fold_bn(block.conv_w1, block.bn_w1)
    w2, a2 = fold_bn(block.conv_w2, block.bn_w2)
    wx, ax = fold_bn(block.conv_x, block.bn_x)
    return edge_tail(ee.contiguous(), w1, a1, w2, a2, wx, ax,
                     block.out_kernel.float().contiguous(),
                     block.out_bias[None].float().contiguous(),
                     k=block.k, neg=block.negative_slope)


def generator_forward_eval(G: Generator, x: torch.Tensor, z: torch.Tensor,
                           edge1_idx: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """x [B, N, 3], z [B, N, nz] -> [B, N, 3] f32 with G's weights."""
    cfg = G.cfg
    if not supports_fused(cfg):
        raise ValueError("this configuration has no fused eval path")
    x, z = x.float(), z.float()
    B, N, _ = x.shape
    if cfg.z_norm:
        z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)
    style = lrelu(G.head2(lrelu(G.head1(torch.cat([x, z], -1)), NEG)), NEG)

    x1 = G.adain1(lrelu(edge_block_eval(G.edge1, x, edge1_idx), NEG2), style)
    x2 = G.adain2(lrelu(edge_block_eval(G.edge2, x1), NEG2), style)

    g = x2.amax(dim=1)
    g = lrelu(G.global_bn1(G.global1(g)), NEG)
    g = lrelu(G.global_bn2(G.global2(g)), NEG)
    feat = torch.cat([g[:, None, :].expand(B, N, g.shape[-1]), x2], -1)
    out = lrelu(G.tail2(lrelu(G.tail1(feat), NEG)), NEG)
    out = torch.tanh(G.tail3(out))
    return out + x if cfg.off else out
