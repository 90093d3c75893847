"""Kernel D: the backward of the diff-only edge op, `csrc/scatter.cu`.

Replaces `sp_gan_tpu/ops/pallas/scatter.py::scatter_diff_bwd_pallas`
(`_diff_bwd_kernel`). For `diff = nbr - central` edge features, d_diff
[B, N, k, C] (f32 or bf16) and the neighbor indices idx [B, N, k] int32
give

    d_x[b, p] = sum_{(q, j): idx[b, q, j] = p} d_diff[b, q, j]
                - sum_j d_diff[b, p, j]

as [B, N, C] f32, accumulated in f32. The kernel inverts the neighbor
lists into a CSR by target and sums each target's in-edges in ascending
source order, the central sum last: deterministic, with no float atomics
(the CUDA source has the passes and the bound).

`scatter_diff_bwd` launches the kernel for CUDA tensors and runs
`scatter_diff_bwd_plain`, the same sums in the same order in plain
PyTorch, for CPU tensors. `scatter_diff_bwd.launches` counts kernel
launches (one per call: the four passes are one launch of the function).
"""

from __future__ import annotations

import torch

from sp_gan_tpu_torch.ops.kernels import _build

MAX_C = 128
GRAD_DTYPES = (torch.float32, torch.bfloat16)


def _check(d_diff: torch.Tensor, idx: torch.Tensor) -> None:
    if d_diff.dim() != 4:
        raise ValueError(f"d_diff must be [B, N, k, C], got "
                         f"{tuple(d_diff.shape)}")
    B, N, k, C = d_diff.shape
    if tuple(idx.shape) != (B, N, k):
        raise ValueError(f"idx must be {(B, N, k)}, got {tuple(idx.shape)}")
    if d_diff.dtype not in GRAD_DTYPES:
        raise TypeError(f"d_diff must be one of {GRAD_DTYPES}, "
                        f"got {d_diff.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if not (d_diff.is_contiguous() and idx.is_contiguous()):
        raise ValueError("d_diff and idx must be contiguous")
    if idx.device != d_diff.device:
        raise ValueError(f"idx is on {idx.device}, d_diff on "
                         f"{d_diff.device}")
    if not 1 <= C <= MAX_C or min(B, N, k) < 1:
        raise ValueError(f"need C in 1..{MAX_C} and B, N, k >= 1, got "
                         f"{tuple(d_diff.shape)}")


def scatter_rows(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The neighbor gather's transpose: g [B, N, k, C], idx [B, N, k] ->
    out [B, n, C] f32, out[b, p] the sum of the g[b, q, j] with
    idx[b, q, j] == p. On the CPU `index_add_` adds them in ascending
    (q, j) order; on CUDA in no fixed order."""
    B, _, _, C = g.shape
    target = idx.long() + n * torch.arange(B, device=idx.device)[:, None, None]
    out = torch.zeros(B * n, C, dtype=torch.float32, device=g.device)
    out.index_add_(0, target.reshape(-1), g.reshape(-1, C).float())
    return out.reshape(B, n, C)


def scatter_diff_bwd_plain(d_diff: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the neighbor rows added by
    target (`scatter_rows`), then the central sum over j in ascending
    order, subtracted last. On the CPU the sums run in the kernel's
    order."""
    g = d_diff.float()
    central = g[:, :, 0]
    for j in range(1, g.shape[2]):
        central = central + g[:, :, j]
    return scatter_rows(g, idx, g.shape[1]) - central


def scatter_diff_bwd(d_diff: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(d_diff [B, N, k, C] f32/bf16, idx [B, N, k] int32) -> d_x [B, N, C]
    f32, see the module docstring. Kernel D on CUDA,
    `scatter_diff_bwd_plain` on the CPU."""
    _check(d_diff, idx)
    if d_diff.device.type == "cpu":
        return scatter_diff_bwd_plain(d_diff, idx)
    if d_diff.device.type != "cuda":
        raise ValueError(f"scatter_diff_bwd runs on cuda or cpu, not "
                         f"{d_diff.device}")
    B, N, k, C = d_diff.shape
    d_x = torch.empty((B, N, C), dtype=torch.float32, device=d_diff.device)
    # in-degrees, segment starts, fill cursors, sources as filled and
    # sorted; freeing it on return is safe, since the caching allocator
    # hands it only to work queued later on this stream
    scratch = torch.empty(B * (3 * N + 1 + 2 * N * k), dtype=torch.int32,
                          device=d_diff.device)
    lib = _build.library()
    with torch.cuda.device(d_diff.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spgan_scatter_diff_bwd(
            d_diff.data_ptr(), idx.data_ptr(), d_x.data_ptr(),
            scratch.data_ptr(), B, N, k, C,
            int(d_diff.dtype == torch.bfloat16), stream)
    _build.check(err, "spgan_scatter_diff_bwd")
    scatter_diff_bwd.launches += 1
    return d_x


scatter_diff_bwd.launches = 0
