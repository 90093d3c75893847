"""PointNet++ set abstraction and feature propagation, PointConv and the
PointTransformer layer, the port of `sp_gan_tpu/nn/pointnet.py` (the
reference's `Common/pointnet_util.py:63-321`, `Common/pointconv_util.py:
199-384` and `Generation/modules.py:1602-1646`).

Channel-last like the JAX modules; the per-group MLPs are dense layers on
[B, S, k, C] blocks. Parameter and buffer names are the flax module paths
(`mlp1.kernel` [in, out], `bn1.scale`, `bn1.mean`, `scale0_mlp1.bias`,
`to_q.kernel`, ...), so `compat.pointnet_state_from_jax` carries a flax
module's `params` and `batch_stats` over with `strict=True`. Dense layers
take flax's default init (`FlaxDense`) and BatchNorm flax's semantics
(`SPBatchNorm`: every axis but the last, biased variance, momentum 0.9),
each forward taking `train` as the flax `__call__` does.

flax reads a dense layer's input width from the first call; a torch module
allocates its weights when it is built, so each module here takes the
width of its input features as the keyword `in_channels` (0: no features),
and `seed` (None leaves the weights for a state dict).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from sp_gan_tpu_torch.nn.layers import FlaxDense, SPBatchNorm
from sp_gan_tpu_torch.ops.grouping import group_points, knn_query
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist
from sp_gan_tpu_torch.ops.sampling import (ball_query, farthest_point_sample,
                                           gather_points,
                                           interpolation_weights,
                                           three_interpolate, three_nn)


def _init(module: nn.Module, seed: Optional[int]) -> None:
    # flax's default init of every dense layer, in registration order
    if seed is None:
        return
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, FlaxDense):
            m.init_weights(gen)


def _add_mlp(owner: nn.Module, fin: int, widths: Sequence[int],
             dense: str = "mlp", bn: str = "bn") -> list:
    """Registers dense + BatchNorm pairs `{dense}{i}` / `{bn}{i}` (i from
    1) on `owner`; returns their names."""
    names = []
    for i, w in enumerate(widths):
        d, b = f"{dense}{i + 1}", f"{bn}{i + 1}"
        setattr(owner, d, FlaxDense(fin, w))
        setattr(owner, b, SPBatchNorm(w))
        names.append((d, b))
        fin = w
    return names


def _run_mlp(owner: nn.Module, names: list, h: torch.Tensor, train: bool
             ) -> torch.Tensor:
    for d, b in names:
        h = torch.relu(getattr(owner, b)(getattr(owner, d)(h), train))
    return h


class SetAbstraction(nn.Module):
    """Sample (FPS) -> group (ball query) -> per-group MLP -> max pool.
    [B, N, 3] xyz (+ [B, N, C] features) -> ([B, S, 3], [B, S, mlp[-1]]).
    `group_all` makes one group of every point, at the origin (the
    reference's GroupAll)."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 mlp: Sequence[int], group_all: bool = False,
                 use_xyz: bool = True, *, in_channels: int = 0,
                 seed: Optional[int] = 0):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp, self.group_all, self.use_xyz = tuple(mlp), group_all, use_xyz
        xyz_in = group_all or use_xyz or not in_channels
        self._layers = _add_mlp(self, 3 * xyz_in + in_channels, mlp)
        _init(self, seed)

    def forward(self, xyz: torch.Tensor,
                features: Optional[torch.Tensor] = None, train: bool = True):
        if self.group_all:
            new_xyz = torch.zeros((xyz.shape[0], 1, 3), dtype=xyz.dtype,
                                  device=xyz.device)
            grouped = xyz[:, None]                           # [B, 1, N, 3]
            if features is not None:
                grouped = torch.cat([grouped, features[:, None]], dim=-1)
        else:
            new_xyz = gather_points(
                xyz, farthest_point_sample(xyz, self.npoint))  # [B, S, 3]
            idx = ball_query(self.radius, self.nsample, xyz, new_xyz)
            grouped = group_points(xyz, idx) - new_xyz[:, :, None]
            if features is not None:
                feat = group_points(features, idx)
                grouped = (torch.cat([grouped, feat], dim=-1)
                           if self.use_xyz else feat)
        return new_xyz, _run_mlp(self, self._layers, grouped,
                                 train).amax(dim=2)


class SetAbstractionMSG(nn.Module):
    """Multi-scale grouping (`PointNetSetAbstractionMsg`): one ball query
    and MLP per radius, the pooled features concatenated."""

    def __init__(self, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]], *,
                 in_channels: int = 0, seed: Optional[int] = 0):
        super().__init__()
        self.npoint, self.radii, self.nsamples = npoint, radii, nsamples
        self.mlps = tuple(tuple(m) for m in mlps)
        self._layers = [_add_mlp(self, 3 + in_channels, mlp, f"scale{s}_mlp",
                                 f"scale{s}_bn")
                        for s, mlp in enumerate(mlps)]
        _init(self, seed)

    def forward(self, xyz: torch.Tensor,
                features: Optional[torch.Tensor] = None, train: bool = True):
        new_xyz = gather_points(xyz, farthest_point_sample(xyz, self.npoint))
        outs = []
        for r, ns, layers in zip(self.radii, self.nsamples, self._layers):
            idx = ball_query(r, ns, xyz, new_xyz)
            grouped = group_points(xyz, idx) - new_xyz[:, :, None]
            if features is not None:
                grouped = torch.cat([grouped, group_points(features, idx)],
                                    dim=-1)
            outs.append(_run_mlp(self, layers, grouped, train).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(nn.Module):
    """Inverse-distance 3-NN interpolation and a pointwise MLP
    (`PointNetFeaturePropagation`). `in_channels` is feat1's channels plus
    feat2's."""

    def __init__(self, mlp: Sequence[int], *, in_channels: int,
                 seed: Optional[int] = 0):
        super().__init__()
        self.mlp = tuple(mlp)
        self._layers = _add_mlp(self, in_channels, mlp)
        _init(self, seed)

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                feat1: Optional[torch.Tensor], feat2: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        """xyz1 [B, N, 3] dense points, xyz2 [B, S, 3] sparse points with
        feat2; feat1 the features skipped to xyz1 (or None)."""
        if xyz2.shape[1] == 1:
            interp = feat2.expand(feat2.shape[0], xyz1.shape[1],
                                  feat2.shape[-1])
        else:
            dist, idx = three_nn(xyz1, xyz2)
            interp = three_interpolate(feat2, idx,
                                       interpolation_weights(dist))
        h = interp if feat1 is None else torch.cat([feat1, interp], dim=-1)
        return _run_mlp(self, self._layers, h, train)


class PointConv(nn.Module):
    """Density-weighted PointConv set abstraction: kNN groups at FPS
    centres, their MLP features scaled by a learned function of the
    inverse Gaussian density, contracted against a weight net of the
    local coordinates."""

    def __init__(self, npoint: int, nsample: int, mlp: Sequence[int],
                 bandwidth: float = 0.1, *, in_channels: int = 0,
                 seed: Optional[int] = 0):
        super().__init__()
        self.npoint, self.nsample, self.bandwidth = npoint, nsample, bandwidth
        self.mlp = tuple(mlp)
        self.density_net = FlaxDense(1, 1)
        self._layers = _add_mlp(self, 3 + in_channels, mlp)
        self.weight_net1 = FlaxDense(3, 16)
        self.weight_net2 = FlaxDense(16, 16)
        self.linear = FlaxDense(mlp[-1] * 16, mlp[-1])
        self.bn_out = SPBatchNorm(mlp[-1])
        _init(self, seed)

    def forward(self, xyz: torch.Tensor,
                features: Optional[torch.Tensor] = None, train: bool = True):
        B = xyz.shape[0]
        # Gaussian kernel density of each point (compute_density)
        bw = self.bandwidth
        gauss = torch.exp(-pairwise_sqdist(xyz, xyz) / (2.0 * bw ** 2)) \
            / (2.5 * bw)
        inv_density = 1.0 / (gauss.mean(dim=-1) + 1e-8)          # [B, N]

        new_xyz = gather_points(xyz, farthest_point_sample(xyz, self.npoint))
        idx, _ = knn_query(self.nsample, xyz, new_xyz)
        grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None]
        grouped = grouped_xyz if features is None else torch.cat(
            [grouped_xyz, group_points(features, idx)], dim=-1)

        grouped_density = group_points(inv_density[..., None], idx)
        scale = grouped_density / grouped_density.amax(dim=2, keepdim=True)
        density_scale = torch.sigmoid(self.density_net(scale))

        h = _run_mlp(self, self._layers, grouped, train) * density_scale
        # the weight net over local coordinates, contracted with h
        w = torch.relu(self.weight_net2(torch.relu(
            self.weight_net1(grouped_xyz))))
        out = torch.einsum("bskc,bskw->bscw", h, w).reshape(
            B, self.npoint, -1)
        out = self.bn_out(self.linear(out), train)
        return new_xyz, torch.relu(out)


class PointTransformerLayer(nn.Module):
    """Vector self-attention over kNN groups with a relative-position
    encoding. x [B, N, in_channels] (in_channels defaults to dim), pos
    [B, N, 3] -> [B, N, dim]."""

    def __init__(self, dim: int, pos_hidden: int = 64,
                 attn_hidden_mult: int = 4, k: int = 16, *,
                 in_channels: Optional[int] = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.dim, self.pos_hidden = dim, pos_hidden
        self.attn_hidden_mult, self.k = attn_hidden_mult, k
        cin = dim if in_channels is None else in_channels
        self.to_q = FlaxDense(cin, dim, use_bias=False)
        self.to_k = FlaxDense(cin, dim, use_bias=False)
        self.to_v = FlaxDense(cin, dim, use_bias=False)
        self.pos1 = FlaxDense(3, pos_hidden)
        self.pos2 = FlaxDense(pos_hidden, dim)
        self.attn1 = FlaxDense(dim, dim * attn_hidden_mult)
        self.attn2 = FlaxDense(dim * attn_hidden_mult, dim)
        _init(self, seed)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        q, kk, v = self.to_q(x), self.to_k(x), self.to_v(x)
        idx, _ = knn_query(self.k, pos, pos)
        rel_pos = pos[:, :, None] - group_points(pos, idx)      # [B, N, k, 3]
        pos_emb = self.pos2(torch.relu(self.pos1(rel_pos)))     # [B, N, k, C]
        v_n = group_points(v, idx) + pos_emb
        a = q[:, :, None] - group_points(kk, idx) + pos_emb
        a = self.attn2(torch.relu(self.attn1(a)))
        return (torch.softmax(a, dim=2) * v_n).sum(dim=2)
