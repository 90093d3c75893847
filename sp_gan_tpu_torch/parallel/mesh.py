"""The device mesh over `torch.distributed`, the port of
`sp_gan_tpu/parallel/mesh.py`.

One process a device. A run of R ranks starts with `torchrun
--nproc_per_node R ...`; rank r then holds `cuda:LOCAL_RANK` over NCCL, or
the CPU over gloo (`--device cpu`). The backend follows the device and
nothing else: NCCL on CUDA, gloo on the CPU, and any other pairing raises.

A mesh of shape S and axes A lays the W = prod(S) ranks out as
`np.arange(W).reshape(S)`, as the JAX package lays out its devices: rank r
sits at `np.unravel_index(r, S)`. Each axis has one process group per line
of the mesh along it. Under `("data", "points")` the `points` group of a
rank is the P ranks of its data replica, and its `data` group the R ranks
that hold the same points. `shard_batch` cuts a rank's block of a global
batch as the JAX `P("data", "points", None)` places it.

The collectives that the parallel layers differentiate through are here:
`all_reduce_sum` (`torch.distributed.nn.functional.all_reduce`) and
`all_gather_cat`, whose backwards sum the cotangents of every rank of the
group.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

from sp_gan_tpu_torch.device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device: Union[str, torch.device]) -> str:
    """The one backend the port runs on `device`'s type."""
    dev = torch.device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {dev}")
    return BACKENDS[dev.type]


def _check_backend(device: torch.device) -> None:
    have, want = dist.get_backend(), backend_for(device)
    if have != want:
        raise ValueError(f"the process group runs {have}, but a {device.type}"
                         f" device takes {want}")


def env_world_size() -> Optional[int]:
    """The launcher's WORLD_SIZE, or None outside a torchrun launch."""
    w = os.environ.get("WORLD_SIZE")
    return int(w) if w else None


def init_distributed(device=None, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Joins the default process group and returns this rank's device:
    `cuda:LOCAL_RANK` (NCCL) when `device` is cuda without an index (the
    default), the device itself when it names one, or the CPU (gloo).
    `rank`, `world_size` and `init_method` default to torchrun's
    environment (`RANK`, `WORLD_SIZE`, `env://`). If the group exists
    already, only checks that its backend is the device's."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        _check_backend(dev)
        return dev
    if rank is None or world_size is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError("a mesh of more than one rank needs RANK and "
                               "WORLD_SIZE: launch the run with torchrun")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method=init_method
                            or "env://", rank=rank, world_size=world_size)
    return dev


class Mesh:
    """The ranks of the default process group as a grid of `shape` named
    by `axes`; see the module docstring. `device` is this rank's."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device: torch.device):
        self.shape = tuple(int(s) for s in shape)
        self.axes = tuple(axes)
        if len(self.shape) != len(self.axes):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axes} "
                             "differ in length")
        self.size = dist.get_world_size()
        if self.size != int(np.prod(self.shape)):
            raise ValueError(f"a mesh of shape {self.shape} needs "
                             f"{int(np.prod(self.shape))} ranks, the process "
                             f"group has {self.size}")
        self.rank = dist.get_rank()
        self.device = device
        self.coords = dict(zip(self.axes, (int(c) for c in np.unravel_index(
            self.rank, self.shape))))
        grid = np.arange(self.size).reshape(self.shape)
        self.groups = {}
        for i, axis in enumerate(self.axes):
            lines = np.moveaxis(grid, i, -1).reshape(-1, self.shape[i])
            # every rank creates every group of the axis, in one order
            for line in lines.tolist():
                group = (dist.group.WORLD if len(line) == self.size
                         else dist.new_group(line))
                if self.rank in line:
                    self.groups[axis] = group

    @property
    def world(self):
        return dist.group.WORLD

    def axis_size(self, axis: str) -> int:
        """Ranks along `axis`, 1 where the mesh has no such axis."""
        return self.shape[self.axes.index(axis)] if axis in self.axes else 1

    def index(self, axis: str) -> int:
        """This rank's place along `axis`, 0 where the mesh has none."""
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """This rank's process group along `axis`, None where the mesh has
        no such axis."""
        return self.groups.get(axis)


def make_mesh(shape: Sequence[int] = (1,), axes: Sequence[str] = ("data",),
              device=None) -> Mesh:
    """The mesh over the default process group (`init_distributed` first).
    The group's size must be prod(shape) and its backend the device's."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: call "
                           "init_distributed first (torchrun sets its "
                           "environment)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _check_backend(dev)
    return Mesh(shape, axes, dev)


def block(n: int, parts: int, index: int) -> slice:
    """The contiguous block `index` of `n` items cut in `parts`."""
    if n % parts:
        raise ValueError(f"{n} does not divide into {parts} equal blocks")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def shard_batch(mesh: Mesh, batch):
    """This rank's block of a global batch [B, N, ...] (array or tensor):
    the B / R rows of its data replica and, with a `points` axis, its
    N / P points."""
    out = batch[block(batch.shape[0], mesh.axis_size("data"),
                      mesh.index("data"))]
    if "points" in mesh.axes:
        out = out[:, block(batch.shape[1], mesh.axis_size("points"),
                           mesh.index("points"))]
    return out


class _GatherCat(torch.autograd.Function):
    """all_gather along `dim`; the backward all-reduces the cotangent and
    takes this rank's block, so each block's gradient is the sum of every
    rank's cotangent of it (`torch.distributed.nn.functional.all_gather`
    emulates that on gloo with a scatter that takes the group's ranks for
    global ones, which fails on a group that is not the world). Built of
    differentiable collectives, so it differentiates twice."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return gather_rows_nograd(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce_sum(grad.contiguous(), ctx.group)
        at = dist.get_rank(ctx.group) * ctx.n
        return grad.narrow(ctx.dim, at, ctx.n), None, None


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along `dim` in rank order,
    differentiable (the backward sums every rank's cotangent of a block
    into its owner's gradient). `group=None` returns x."""
    if group is None:
        return x
    return _GatherCat.apply(x, group, dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, differentiable (the backward sums the
    cotangents of every rank). `group=None` returns x."""
    if group is None:
        return x
    with warnings.catch_warnings():
        # its suggested successor has no backward
        warnings.simplefilter("ignore", FutureWarning)
        return dist_fn.all_reduce(x, group=group)


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the group (equal shards), differentiable."""
    if group is None:
        return x
    return all_reduce_sum(x, group) / dist.get_world_size(group)


def gather_rows_nograd(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """`all_gather_cat` outside autograd."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def mean_gradients(grads, group, size: int) -> list:
    """Gradients summed over `group` in one all-reduce and divided by
    `size`; a list of new tensors shaped like `grads`."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat = flat / size
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out
