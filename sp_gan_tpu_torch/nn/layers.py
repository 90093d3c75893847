"""Generator and discriminator layers, the port of `sp_gan_tpu/nn/layers.py`.

Channel-last like the JAX package ([B, N, C]; a pointwise Conv1d is a
Dense on the last axis). Parameter and buffer names are the JAX tree's
leaf names (`kernel` [in, out], `bias`, `scale`, `mean`, `var`, ...), so
`compat.generator_state_from_jax` carries a JAX checkpoint over by renaming
alone. Each layer's `init_weights(rng)` draws the JAX package's
initializers from a numpy generator:

* `TorchDense`: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for kernel and bias;
* `FlaxDense`: flax's default Dense init, a LeCun normal kernel (truncated
  at two standard deviations) and a zero bias, drawn from a
  `torch.Generator` (the DGCNN extractor and `nn/pointnet.py`);
* `EqualDense`: kernel N(0, 1), bias 0, kernel scaled by sqrt(2/fan_in) in
  the forward;
* `AdaptivePointNorm`: style kernel N(0, 1), bias [gamma=1, beta=0];
* `SPBatchNorm`, `MaxPoolBNLReLU`: scale 1, bias 0, running mean 0,
  running var 1.

BatchNorm follows the JAX package, not `torch.nn.BatchNorm`: statistics in
f32 over every axis but the last, `var = E[x^2] - mean^2` (biased), running
averages `0.9 * old + 0.1 * batch` updated in place in training mode, eps
1e-5. The JAX package's per-shard statistic groups wait for the
data-parallel slice (`train.step.make_train_step` refuses them).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sp_gan_tpu_torch.ops.edge import edge_diff_features


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


def _uniform(rng: np.random.Generator, shape, fan_in: int) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    return torch.from_numpy(
        rng.uniform(-bound, bound, shape).astype(np.float32))


def _normal(rng: np.random.Generator, shape) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def lrelu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return F.leaky_relu(x, slope)


class TorchDense(nn.Module):
    """Dense layer with torch's default init (a 1x1 Conv1d on [B, N, C])."""

    def __init__(self, fin: int, fout: int, use_bias: bool = True):
        super().__init__()
        self.kernel = _param(fin, fout)
        self.bias = _param(fout) if use_bias else None

    def init_weights(self, rng: np.random.Generator) -> None:
        fin = self.kernel.shape[0]
        with torch.no_grad():
            self.kernel.copy_(_uniform(rng, self.kernel.shape, fin))
            if self.bias is not None:
                self.bias.copy_(_uniform(rng, self.bias.shape, fin))

    def forward(self, x: torch.Tensor, f32_sums: bool = False
                ) -> torch.Tensor:
        """`f32_sums`: x's dtype for the operands, the f32 sums kept
        unrounded (see `EdgeBlock`)."""
        k = self.kernel.to(x.dtype)
        if f32_sums:
            x, k = x.float(), k.float()
        y = torch.matmul(x, k)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def lecun_normal_(t: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default Dense kernel init: a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in."""
    z = torch.randn(t.shape, generator=gen)
    while bool((out := z.abs() > 2.0).any()):
        z[out] = torch.randn(int(out.sum()), generator=gen)
    std = math.sqrt(1.0 / t.shape[0]) / 0.87962566103423978
    with torch.no_grad():
        t.copy_(z * std)


class FlaxDense(TorchDense):
    """Dense layer with flax's default init: `init_weights(gen)` draws a
    LeCun normal kernel from the `torch.Generator` and zeroes the bias."""

    def init_weights(self, gen: torch.Generator) -> None:
        lecun_normal_(self.kernel, gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


class EqualDense(nn.Module):
    """Equalized-learning-rate dense: weight stored N(0, 1), scaled by
    sqrt(2/fan_in) in the forward."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.kernel = _param(fin, fout)
        self.bias = _param(fout)
        self.scale = math.sqrt(2.0 / fin)

    def init_weights(self, rng: np.random.Generator) -> None:
        with torch.no_grad():
            self.kernel.copy_(_normal(rng, self.kernel.shape))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (torch.matmul(x, (self.kernel * self.scale).to(x.dtype))
                + self.bias.to(x.dtype))


def make_dense(eql: bool):
    return EqualDense if eql else TorchDense


class SplitEdgeDense(nn.Module):
    """EdgeBlock's value conv on `[central, diff]` without building the
    concat: with kernel K [2C, F], `central @ K[:C]` per point, broadcast
    over k, plus `diff @ K[C:]` per edge. Init as `TorchDense(2C, F)`."""

    def __init__(self, c: int, fout: int):
        super().__init__()
        self.kernel = _param(2 * c, fout)
        self.bias = _param(fout)

    init_weights = TorchDense.init_weights

    def forward(self, central: torch.Tensor, diff: torch.Tensor,
                f32_sums: bool = False) -> torch.Tensor:
        C = central.shape[-1]
        kc = self.kernel.to(diff.dtype)
        if f32_sums:
            central, diff, kc = central.float(), diff.float(), kc.float()
        v = (torch.matmul(diff, kc[C:])
             + torch.matmul(central, kc[:C])[:, :, None, :])
        return v + self.bias.to(v.dtype)


def instance_norm_points(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm1d without affine on [B, N, C]: each channel normalized
    over the points, biased variance, statistics in f32."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = xf.var(dim=1, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class SPBatchNorm(nn.Module):
    """BatchNorm over every axis but the last:
    `(x - mean) * (rsqrt(var + eps) * scale) + bias` in f32, cast back to
    x's dtype. Training mode normalizes with the batch statistics and
    updates the running ones in place (unless `update_running` is False,
    see `frozen_running_stats`); eval mode uses the running ones."""

    def __init__(self, c: int, epsilon: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.epsilon = epsilon
        self.momentum = momentum
        self.update_running = True

    def init_weights(self, rng: np.random.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def statistics(self, xf: torch.Tensor, train: bool):
        """(mean, biased var) of f32 `xf` over every axis but the last in
        training mode, updating the running averages; the running ones in
        eval mode."""
        if not train:
            return self.mean, self.var
        axes = tuple(range(xf.dim() - 1))
        mean = xf.mean(dim=axes)
        var = (xf * xf).mean(dim=axes) - mean * mean
        if not self.update_running:
            return mean, var
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return mean, var

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        mean, var = self.statistics(xf, train)
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mean) * inv + self.bias).to(x.dtype)


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Inside the block the training-mode BatchNorms of `module` normalize
    with batch statistics but leave their running averages as they are
    (the JAX step runs a forward and drops its `batch_stats` mutation)."""
    norms = [m for m in module.modules() if isinstance(m, SPBatchNorm)]
    before = [m.update_running for m in norms]
    for m in norms:
        m.update_running = False
    try:
        yield
    finally:
        for m, b in zip(norms, before):
            m.update_running = b


class MaxPoolBNLReLU(SPBatchNorm):
    """`max_n lrelu(bn(h))` over the points of h [B, N, C], computed as
    `lrelu(bn(max_n h))` where scale >= 0 and `lrelu(bn(min_n h))` where
    scale < 0 (BN is a per-channel affine and leaky ReLU is increasing), so
    the [B, N, C] tensor is only reduced (max, min, mean, mean of squares)
    and never normalized elementwise. Returns [B, C] f32. Parameter and
    buffer names are `SPBatchNorm`'s. `amax`/`amin` split the gradient
    evenly among tied extremes, as JAX's max does."""

    def __init__(self, c: int, epsilon: float = 1e-5, momentum: float = 0.9,
                 negative_slope: float = 0.01):
        super().__init__(c, epsilon, momentum)
        self.negative_slope = negative_slope

    def forward(self, h: torch.Tensor, train: bool = False) -> torch.Tensor:
        hf = h.float()
        mean, var = self.statistics(hf, train)
        pooled = torch.where(self.scale >= 0, hf.amax(dim=1),
                             hf.amin(dim=1))                  # [B, C]
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        return lrelu((pooled - mean) * inv + self.bias, self.negative_slope)


class AdaptivePointNorm(nn.Module):
    """Per-point AdaIN: instance-norm the features, then scale and shift
    with (gamma, beta) predicted per point from the style."""

    def __init__(self, channels: int, style_dim: int, use_eql: bool = False):
        super().__init__()
        self.channels = channels
        self.style_kernel = _param(style_dim, 2 * channels)
        self.style_bias = _param(2 * channels)
        self.use_eql = use_eql

    def init_weights(self, rng: np.random.Generator) -> None:
        C = self.channels
        with torch.no_grad():
            self.style_kernel.copy_(_normal(rng, self.style_kernel.shape))
            self.style_bias.copy_(torch.cat([torch.ones(C), torch.zeros(C)]))

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        C = self.channels
        k = self.style_kernel
        if self.use_eql:
            k = k * math.sqrt(2.0 / k.shape[0])
        gb = torch.matmul(style, k.to(style.dtype)) \
            + self.style_bias.to(style.dtype)
        gamma, beta = gb[..., :C], gb[..., C:]
        return gamma * instance_norm_points(x) + beta


class EdgeBlock(nn.Module):
    """Attention-weighted EdgeConv, [B, N, fin] -> [B, N, fout].

    Only the diff half `nbr - central` of the edge features is built
    ([B, N, k, fin]); the central half enters through `SplitEdgeDense`.
    conv_w turns the diffs into softmax weights over the k neighbors,
    conv_x into values; their product is contracted over (k, fout).
    `mixed` runs the [B, N, k, *] tensors in bf16 (selection stays f32)
    and returns f32. Its three dense layers that feed a BatchNorm take bf16
    operands and hand the BatchNorm their f32 sums unrounded, as the JAX
    package's compiled step does (XLA drops the bf16 rounding between a
    dot and the f32 BatchNorm that reads it). Rounding there would cost up
    to 8% of a channel's std where its |mean| is 40 std, and left the
    block's output two to three times farther from float32 than JAX's.

    The neighbors come from x (kNN on its f32 values), from `idx` [B, N, k]
    or, with `ee` [B, N, k, 2C] (a precomputed `[central, nbr - central]`
    tensor: the training step's run-constant template edges), from
    `ee[..., C:]`, cast to bf16 under `mixed` as in the JAX package. The
    two given forms round differently under `mixed`: `idx` gives
    `bf16(nbr) - bf16(central)`, `ee` gives `bf16(nbr - central)`.
    `window` (with neither given) restricts the kNN to the circular index
    band |i - j| <= window, the `--knn_mode approx` selection
    (`ops/edge.py`)."""

    def __init__(self, fin: int, fout: int, k: int, mixed: bool = False,
                 negative_slope: float = 0.01):
        super().__init__()
        self.fin, self.fout, self.k = fin, fout, k
        self.mixed = mixed
        self.negative_slope = negative_slope
        self.conv_w1 = TorchDense(fin, fout // 2)
        self.bn_w1 = SPBatchNorm(fout // 2)
        self.conv_w2 = TorchDense(fout // 2, fout)
        self.bn_w2 = SPBatchNorm(fout)
        self.conv_x = SplitEdgeDense(fin, fout)
        self.bn_x = SPBatchNorm(fout)
        self.out_kernel = _param(k, fout, fout)
        self.out_bias = _param(fout)

    def init_weights(self, rng: np.random.Generator) -> None:
        fan_in = self.k * self.fout
        with torch.no_grad():
            self.out_kernel.copy_(_uniform(rng, self.out_kernel.shape, fan_in))
            self.out_bias.copy_(_uniform(rng, self.out_bias.shape, fan_in))

    def forward(self, x: torch.Tensor, train: bool = False,
                idx: Optional[torch.Tensor] = None,
                ee: Optional[torch.Tensor] = None,
                window: Optional[int] = None) -> torch.Tensor:
        B, N, C = x.shape
        if C != self.fin:
            raise ValueError(f"EdgeBlock expects {self.fin} channels, got {C}")
        out_dtype = x.dtype
        if ee is not None:
            diff = ee[..., C:]
            if self.mixed:
                diff = diff.to(torch.bfloat16)
        elif self.mixed:
            if idx is None:
                diff = edge_diff_features(x, self.k, out_dtype=torch.bfloat16,
                                          window=window)
            else:
                diff = edge_diff_features(x.to(torch.bfloat16), self.k,
                                          idx=idx)
        else:
            diff = edge_diff_features(x, self.k, idx=idx,
                                      window=window)          # [B, N, k, C]
        central = x.to(diff.dtype)
        slope = self.negative_slope

        f32, dt = self.mixed, diff.dtype

        def bn(norm, h):
            return norm(h, train).to(dt)

        w = lrelu(bn(self.bn_w1, self.conv_w1(diff, f32)), slope)
        w = lrelu(bn(self.bn_w2, self.conv_w2(w, f32)), slope)
        w = torch.softmax(w, dim=2)                           # over k

        v = lrelu(bn(self.bn_x, self.conv_x(central, diff, f32)), slope)
        v = v * w

        # conv_out: the reference's Conv2d with a [1, k] kernel
        kern = self.out_kernel.to(v.dtype).reshape(self.k * self.fout,
                                                   self.fout)
        out = torch.matmul(v.reshape(B, N, self.k * self.fout), kern)
        out = out + self.out_bias.to(out.dtype)
        return out.to(out_dtype) if self.mixed else out


class Attention(nn.Module):
    """Global self-attention: 1/8-width query and key, 1/2-width value,
    zero-initialized gain, residual."""

    def __init__(self, channels: int):
        super().__init__()
        ch = channels
        self.theta = TorchDense(ch, ch // 8, use_bias=False)
        self.phi = TorchDense(ch, ch // 8, use_bias=False)
        self.g = TorchDense(ch, ch // 2, use_bias=False)
        self.o = TorchDense(ch // 2, ch, use_bias=False)
        self.gamma = nn.Parameter(torch.zeros(()))

    def init_weights(self, rng: np.random.Generator) -> None:
        with torch.no_grad():
            self.gamma.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        theta, phi, g = self.theta(x), self.phi(x), self.g(x)
        energy = torch.einsum("bnc,bmc->bnm", theta, phi)
        beta = torch.softmax(energy, dim=-1)
        o = self.o(torch.einsum("bnm,bmc->bnc", beta, g))
        return self.gamma * o + x
