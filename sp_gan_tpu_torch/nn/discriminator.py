"""PointNet-style discriminator, the port of
`sp_gan_tpu/nn/discriminator.py`.

Shared pointwise MLP 3 -> 64 -> 128 -> 256 (BatchNorm, leaky ReLU 0.01),
lift to 1024 (512 with small_d), max-pool over the points, head
1024 -> 512 -> 256 -> 64 -> 1. Channel-last. With `pool_commute` (the
default) fc2's BatchNorm, leaky ReLU and max-pool run as `MaxPoolBNLReLU`,
which only reduces the [B, N, 1024] activation. Module names are the JAX
tree's (`mlp1`, `bn1`, ..., `fc2`, `bn_fc2`, `head1`, ..., `head4`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.nn.layers import (MaxPoolBNLReLU, SPBatchNorm,
                                        TorchDense, lrelu)

NEG = 0.01     # reference `neg`


class Discriminator(nn.Module):
    """`Discriminator(cfg, seed)` draws its weights with the JAX package's
    initializers from `np.random.default_rng(seed)`; `seed=None` leaves the
    placeholders for a `load_state_dict` to fill."""

    def __init__(self, cfg: Config, seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        widths = (3, 64, 128, 256)
        for i in range(3):
            setattr(self, f"mlp{i + 1}", TorchDense(widths[i], widths[i + 1]))
            setattr(self, f"bn{i + 1}", SPBatchNorm(widths[i + 1]))
        dim = 512 if cfg.small_d else 1024
        self.fc2 = TorchDense(256, dim)
        self.commute = cfg.pool_commute
        self.bn_fc2 = (MaxPoolBNLReLU(dim, negative_slope=NEG) if self.commute
                       else SPBatchNorm(dim))
        head = (dim, 512, 256, 64, 1)
        for i in range(4):
            setattr(self, f"head{i + 1}", TorchDense(head[i], head[i + 1]))
        if seed is not None:
            self.init_weights(np.random.default_rng(seed))

    def init_weights(self, rng: np.random.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(rng)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x [B, N, 3] -> logits [B, 1] f32. `train` normalizes with batch
        statistics and updates the running averages in place."""
        h = x.to(torch.bfloat16 if self.cfg.d_bf16 else torch.float32)
        for i in range(1, 4):
            h = getattr(self, f"mlp{i}")(h)
            h = lrelu(getattr(self, f"bn{i}")(h, train), NEG)
        h = self.fc2(h)
        if self.commute:
            h = self.bn_fc2(h, train)
        else:
            h = lrelu(self.bn_fc2(h, train), NEG).amax(dim=1)
        h = h.float()
        for i in range(1, 4):
            h = lrelu(getattr(self, f"head{i}")(h), NEG)
        return self.head4(h)
