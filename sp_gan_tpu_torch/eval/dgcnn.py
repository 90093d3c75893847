"""DGCNN classification feature extractor for FPD, the port of
`sp_gan_tpu/eval/dgcnn.py`.

Four EdgeConv stages (64, 64, 128, 256) on kNN graphs that include the
point itself (k = 40 by default), edge features `[central, nbr -
central]`, a dense layer, eval-mode BatchNorm and leaky ReLU 0.2, a max
over the neighbors; then the stages' features concatenated, `conv5` to
`feat_dims`, BatchNorm, leaky ReLU and a global max (with `max_avg` also
the mean). Parameters are named after the flax tree paths
(`conv1.kernel` [in, out], `bn1.scale`, `bn1.mean`, ...), so
`compat.state_from_jax` loads the JAX package's extractor variables with
`strict=True`.

The kNN is the plain `ops.pairwise.knn_indices` (the JAX extractor's is
XLA, not a Pallas kernel) and the edges are gathered by index.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from sp_gan_tpu_torch.nn.layers import SPBatchNorm, TorchDense, lrelu
from sp_gan_tpu_torch.ops.edge import edge_features
from sp_gan_tpu_torch.ops.pairwise import knn_indices

WIDTHS = (64, 64, 128, 256)


def lecun_normal_(t: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default Dense kernel init: a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in."""
    z = torch.randn(t.shape, generator=gen)
    while bool((out := z.abs() > 2.0).any()):
        z[out] = torch.randn(int(out.sum()), generator=gen)
    std = math.sqrt(1.0 / t.shape[0]) / 0.87962566103423978
    with torch.no_grad():
        t.copy_(z * std)


class DGCNNFeat(nn.Module):
    """[B, N, 3] -> [B, feat_dims] global feature ([B, 2 feat_dims] with
    `multi="max_avg"`). `seed` draws flax's default initializers from a
    `torch.Generator`; None leaves the weights for a state dict."""

    def __init__(self, k: int = 40, feat_dims: int = 1024,
                 multi: Optional[str] = None, include_self: bool = True,
                 seed: Optional[int] = 0):
        super().__init__()
        self.k, self.multi, self.include_self = k, multi, include_self
        fin = 3
        for i, w in enumerate(WIDTHS):
            setattr(self, f"conv{i + 1}", TorchDense(2 * fin, w))
            setattr(self, f"bn{i + 1}", SPBatchNorm(w))
            fin = w
        self.conv5 = TorchDense(sum(WIDTHS), feat_dims)
        self.bn5 = SPBatchNorm(feat_dims)
        if seed is not None:
            gen = torch.Generator().manual_seed(seed)
            for i in range(1, 6):
                conv = getattr(self, f"conv{i}")
                lecun_normal_(conv.kernel, gen)
                with torch.no_grad():
                    conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        k = min(self.k, x.shape[1] - 1)      # clamp for tiny clouds
        feats = []
        for i in range(1, 5):
            idx = knn_indices(h, k, exclude_self=not self.include_self)
            ee = edge_features(h, k, idx=idx)             # [B, N, k, 2C]
            v = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(ee))
            h = lrelu(v, 0.2).amax(dim=2)                 # max over nbrs
            feats.append(h)
        g = lrelu(self.bn5(self.conv5(torch.cat(feats, dim=-1))), 0.2)
        gmax = g.amax(dim=1)
        if self.multi == "max_avg":
            return torch.cat([gmax, g.mean(dim=1)], dim=-1)
        return gmax
