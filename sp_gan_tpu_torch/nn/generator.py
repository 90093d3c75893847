"""Sphere-guided generator, the port of `sp_gan_tpu/nn/generator.py`
(training and eval forward, style blending).

Per-point style from (sphere xyz ++ z) -> two attention EdgeConvs with
AdaIN -> global max-pool branch -> MLP tail with tanh, channel-last. With
`knn_mode="approx"` the second EdgeConv selects its neighbors in a circular
index band of half-width `knn_window` (`ops/edge.py`). `z2`, `blend_mask`
and `blend_alpha` blend two codes' styles, and `interpolate` blends codes
or styles on a part of the template (the manipulation routines). Module
names are the JAX tree's (`head1`, `edge1`, `adain1`, `edge2`, `global_bn1`,
`tail3`, ...), so a JAX checkpoint loads through
`compat.generator_state_from_jax` with `strict=True`. Under a `scope`
whose points are cut over ranks (`nn.layers.sharded`) the global pool is
the max over every rank and EdgeConv2 selects exactly (the JAX generator
has no sharded band).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.nn.layers import (UNSHARDED, AdaptivePointNorm,
                                        Attention, EdgeBlock, SPBatchNorm,
                                        TorchDense, lrelu, make_dense,
                                        max_points)

NEG = 0.01     # reference `neg`
NEG2 = 0.2     # reference `neg_2`


class Generator(nn.Module):
    """`Generator(cfg, seed)` draws its weights with the JAX package's
    initializers from `np.random.default_rng(seed)`; `seed=None` leaves the
    placeholders for a `load_state_dict` to fill."""

    scope = UNSHARDED

    def __init__(self, cfg: Config, seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        Dense = make_dense(cfg.eql)
        dim = 128
        k = cfg.nk // 2
        mixed = cfg.dtype == "mixed_edge"
        self.head1 = Dense(3 + cfg.nz, dim)
        self.head2 = Dense(dim, dim)
        if cfg.use_head:
            self.pc_head1 = Dense(3, dim // 2)
            self.pc_head2 = Dense(dim // 2, dim)
            c1_in, c1_out = dim, dim
        else:
            c1_in, c1_out = 3, 64
        self.c1_out = c1_out
        self.edge1 = EdgeBlock(c1_in, c1_out, k, mixed=mixed)
        self.adain1 = AdaptivePointNorm(c1_out, dim)
        self.edge2 = EdgeBlock(c1_out, dim, k, mixed=mixed)
        self.adain2 = AdaptivePointNorm(dim, dim)
        self.global1 = Dense(dim, dim)
        self.global_bn1 = SPBatchNorm(dim)
        self.global2 = Dense(dim, 512)
        self.global_bn2 = SPBatchNorm(512)
        if cfg.attn:
            self.attn = Attention(512 + dim)
        self.tail1 = TorchDense(512 + dim, 256)
        self.tail2 = TorchDense(256, 64)
        self.tail3 = TorchDense(64, 3)
        if seed is not None:
            self.init_weights(np.random.default_rng(seed))

    def init_weights(self, rng: np.random.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(rng)

    def _style(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """The per-point style of the head, from x in the compute dtype."""
        if self.cfg.z_norm:
            z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)
        s = torch.cat([x, z.to(x.dtype)], dim=-1)
        return lrelu(self.head2(lrelu(self.head1(s), NEG)), NEG)

    def forward(self, x: torch.Tensor, z: torch.Tensor, train: bool = False,
                edge1_idx: Optional[torch.Tensor] = None,
                template_batch_const: bool = False,
                edge1_ee: Optional[torch.Tensor] = None,
                z2: Optional[torch.Tensor] = None, blend_mask=None,
                blend_alpha: float = 0.0) -> torch.Tensor:
        """x: sphere points [B, N, 3]; z: codes [B, N, nz] -> [B, N, 3] f32.
        `train` normalizes with batch statistics and updates every
        BatchNorm's running averages in place.

        edge1_idx: precomputed kNN indices [B, N, k] of the template for
        the first EdgeConv; edge1_ee: its precomputed edge tensor
        [B, N, k, 6] (the training step's run constant). Both are ignored
        with use_head. template_batch_const: every x[b] is the same
        template, so the first EdgeConv (which z does not reach) runs at
        batch 1, its BatchNorm statistics taken at batch 1, and is
        broadcast; the broadcast's backward sums over the batch.

        z2, blend_mask, blend_alpha: style-space part interpolation. The
        shared head runs on z and on z2, and where blend_mask [N] is set the
        style is `style * (1 - a) + style2 * a` (in the style's dtype); the
        codes themselves are not blended (that is `interpolate`'s other
        mode)."""
        cfg = self.cfg
        B, N, _ = x.shape
        dtype = torch.bfloat16 if cfg.g_bf16 else torch.float32
        x = x.to(dtype)

        style = self._style(x, z)
        if z2 is not None:
            style2 = self._style(x, z2)
            sel = torch.as_tensor(blend_mask, device=style.device)
            sel = sel.reshape(1, -1, 1).to(style.dtype)
            a = torch.as_tensor(blend_alpha, dtype=style.dtype,
                                device=style.device)
            style = torch.where(sel > 0, style * (1 - a) + style2 * a, style)

        pc = x
        if cfg.use_head:
            pc = lrelu(self.pc_head1(pc), NEG)
            pc = lrelu(self.pc_head2(pc), NEG)
            edge1_idx = edge1_ee = None   # pc is a learned lift
        if template_batch_const and not cfg.use_head:
            i1 = None if edge1_idx is None else edge1_idx[:1]
            e1 = None if edge1_ee is None else edge1_ee[:1]
            x1 = lrelu(self.edge1(pc[:1], train, i1, e1), NEG2)
            x1 = x1.expand(B, N, self.c1_out)
        else:
            x1 = lrelu(self.edge1(pc, train, edge1_idx, edge1_ee), NEG2)
        x1 = self.adain1(x1, style)

        # --knn_mode approx: EdgeConv2 selects in the template's spiral index
        # band |i - j| <= knn_window, in training and in eval alike
        win2 = (cfg.knn_window if cfg.knn_mode == "approx"
                and self.scope.points is None else None)
        x2 = lrelu(self.edge2(x1, train, window=win2), NEG2)
        x2 = self.adain2(x2, style)

        g = max_points(x2, self.scope.points)                     # [B, dim]
        g = lrelu(self.global_bn1(self.global1(g), train), NEG)
        g = lrelu(self.global_bn2(self.global2(g), train), NEG)
        feat = torch.cat([g[:, None, :].expand(B, N, g.shape[-1]), x2], -1)
        if cfg.attn:
            feat = self.attn(feat)

        if cfg.g_tail_f32:
            feat = feat.float()
        out = lrelu(self.tail1(feat), NEG)
        out = lrelu(self.tail2(out), NEG)
        out = torch.tanh(self.tail3(out))
        if cfg.off:
            out = out + x
        return out.float()

    def interpolate(self, x: torch.Tensor, z1: torch.Tensor,
                    z2: torch.Tensor, selection, alpha: float,
                    use_latent: bool = False,
                    train: bool = False) -> torch.Tensor:
        """Part interpolation: blend the codes (or, with `use_latent`, the
        styles the head makes of them) of z1 and z2 where `selection` [N]
        is 1, by `alpha`, then run the generator."""
        if not use_latent:
            sel = torch.as_tensor(selection, device=z1.device)
            sel = sel.reshape(1, -1, 1).to(z1.dtype)
            z = torch.where(sel > 0, z1 * (1 - alpha) + z2 * alpha, z1)
            return self(x, z, train=train)
        return self(x, z1, train=train, z2=z2, blend_mask=selection,
                    blend_alpha=alpha)
