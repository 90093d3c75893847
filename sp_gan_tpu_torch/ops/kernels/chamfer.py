"""Kernel N: both nearest-neighbour reductions of the Chamfer distance,
`csrc/chamfer.cu`.

Replaces `sp_gan_tpu/ops/pallas/chamfer.py::_chamfer_pallas_raw`
(`_chamfer_kernel`): x [B, N, C] and y [B, M, C] give (d1 [B, N] f32,
i1 [B, N] int32, d2 [B, M] f32, i2 [B, M] int32), the squared distance of
each point to its nearest point of the other cloud and that point's index,
ties to the lowest index. The distances are `ops/pairwise.pairwise_sqdist`'s
f32 fold, which the kernel computes in the same order, so kernel and plain
version agree bit for bit.

The kernel computes each distance once: a block takes a tile of x rows,
keeps their row minima in registers over all of y, and merges its column
minima into the cloud's by a 64-bit `atomicMin` on a key (the distance's
orderable bits above the x index) in a [B, M] scratch the wrapper
allocates; a short pass unpacks d2 and i2. A minimum of keys leaves the
lowest index among equal distances, as the plain version's argmin does.

`chamfer_nn` launches the kernel for CUDA tensors (C <= 8) and runs
`chamfer_nn_plain` for CPU tensors; `chamfer_nn.launches` counts kernel
launches (one per call: both directions and the unpacking are one launch
of the function).
"""

from __future__ import annotations

from typing import Tuple

import torch

from sp_gan_tpu_torch.ops.kernels import _build
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist

MAX_C = 8

Nearest = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0] \
            or x.shape[2] != y.shape[2]:
        raise ValueError(f"x and y must be [B, N, C] and [B, M, C], got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if min(x.shape) < 1 or y.shape[1] < 1:
        raise ValueError(f"empty clouds {tuple(x.shape)}, {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"x is on {x.device}, y on {y.device}")


def chamfer_nn_plain(x: torch.Tensor, y: torch.Tensor) -> Nearest:
    """The kernel's function in plain PyTorch: `pairwise_sqdist` and its
    minima over each axis, argmin taking the first of tied entries."""
    d = pairwise_sqdist(x, y)
    return (d.amin(dim=2), d.argmin(dim=2).to(torch.int32),
            d.amin(dim=1), d.argmin(dim=1).to(torch.int32))


def chamfer_nn(x: torch.Tensor, y: torch.Tensor) -> Nearest:
    """(d1 [B, N], i1 [B, N], d2 [B, M], i2 [B, M]) of x [B, N, C] and
    y [B, M, C], see the module docstring. Kernel N on CUDA,
    `chamfer_nn_plain` on the CPU. Carries no gradient."""
    _check(x, y)
    if x.device.type == "cpu":
        return chamfer_nn_plain(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"chamfer_nn runs on cuda or cpu, not {x.device}")
    B, N, C = x.shape
    M = y.shape[1]
    if C > MAX_C or B > 65535:
        raise ValueError(f"kernel N takes C <= {MAX_C} and B <= 65535 on "
                         f"CUDA, got {tuple(x.shape)}")
    x = x.detach().float().contiguous()
    y = y.detach().float().contiguous()
    # one allocation (each costs the host several microseconds, as much as
    # a tenth of the call): the column keys [B, M] int64, then d1, i1, d2,
    # i2
    colkey, d1, i1, d2, i2 = torch.empty(
        2 * B * M + 2 * B * N + 2 * B * M, dtype=torch.int32,
        device=x.device).split([2 * B * M, B * N, B * N, B * M, B * M])
    d1, i1 = d1.view(torch.float32).view(B, N), i1.view(B, N)
    d2, i2 = d2.view(torch.float32).view(B, M), i2.view(B, M)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spgan_chamfer(x.data_ptr(), y.data_ptr(), d1.data_ptr(),
                                i1.data_ptr(), d2.data_ptr(), i2.data_ptr(),
                                colkey.data_ptr(), B, N, M, C, stream)
    _build.check(err, "spgan_chamfer")
    chamfer_nn.launches += 1
    return d1, i1, d2, i2


chamfer_nn.launches = 0
