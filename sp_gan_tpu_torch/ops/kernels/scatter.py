"""Kernels D, H and M: deterministic scatter-adds, `csrc/scatter.cu`.

Kernel H replaces `sp_gan_tpu/ops/pallas/scatter.py::scatter_add_pallas`
(`_scatter_kernel`): g [B, S, F] (f32 or bf16) and idx [B, S] int32 give
out[b, p] = sum_{s: idx[b, s] = p} g[b, s], [B, n, F] f32. It is the
backward of the neighbor gather (`scatter_rows`) where the JAX package
calls the Pallas kernel: on CUDA once the gather's one-hot would pass
1 GiB (`one_hot_bytes`, the rule of `sp_gan_tpu/ops/edge.py:66`); below
that JAX contracts an XLA one-hot and the port keeps `index_add_`. Kernel
H runs kernel D's CSR passes without the central term: a stable counting
sort of the sources by target, then the sums in ascending source order, no
float atomics, bit-identical across launches.
`scatter_add` launches it for CUDA tensors and runs `scatter_add_plain`
(`index_add_`, ascending source order on the CPU) for CPU tensors;
`scatter_add.launches` counts kernel launches.

Kernel D, the backward of the diff-only edge op, replaces
`sp_gan_tpu/ops/pallas/scatter.py::scatter_diff_bwd_pallas`
(`_diff_bwd_kernel`). For `diff = nbr - central` edge features, d_diff
[B, N, k, C] (f32 or bf16) and the neighbor indices idx [B, N, k] int32
give

    d_x[b, p] = sum_{(q, j): idx[b, q, j] = p} d_diff[b, q, j]
                - sum_j d_diff[b, p, j]

as [B, N, C] f32, accumulated in f32. The kernel inverts the neighbor
lists into a CSR by target and sums each target's in-edges in ascending
source order, the central sum last: deterministic, with no float atomics
(the CUDA source has the passes and the bound).
d_diff's rows may lie at any stride (`row_stride`), so the neighbor half
`d_ee[..., C:]` of the concat edges goes in without a copy.

`scatter_diff_bwd` launches the kernel for CUDA tensors and runs
`scatter_diff_bwd_plain`, the same sums in the same order in plain
PyTorch, for CPU tensors. `scatter_diff_bwd.launches` counts kernel
launches (one per call: the four passes are one launch of the function).

Kernel M, the backward of the concat-form edge op under
`SPGAN_EDGE_BWD=pallas`, replaces
`sp_gan_tpu/ops/pallas/scatter.py::edge_scatter_bwd_pallas`
(`_edge_bwd_kernel`). d_ee [B, N, k, 2C] (f32 or bf16) and idx [B, N, k]
int32 give

    d_x[b, p] = sum_{(q, j): idx[b, q, j] = p} d_ee[b, q, j, C:]
                + sum_j (d_ee[b, p, j, :C] - d_ee[b, p, j, C:])

as [B, N, C] f32, accumulated in f32 whatever d_ee's type, as the Pallas
kernel's exact one-hot matmuls accumulate. It is kernel D's CSR passes on
the neighbor half, the central sum added last. `edge_scatter_bwd`
launches it for CUDA tensors and runs `edge_scatter_bwd_plain` (the same
sums in the same order) for CPU tensors; `edge_scatter_bwd.launches`
counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from sp_gan_tpu_torch.ops.kernels import _build

MAX_C = 128
MAX_TARGETS = 1 << 19       # targets a cloud the CSR passes take
GRAD_DTYPES = (torch.float32, torch.bfloat16)


def _check(d_diff: torch.Tensor, idx: torch.Tensor, halves: int = 1,
           strided: bool = False) -> Optional[int]:
    """d_diff [B, N, k, halves * C] and idx [B, N, k] as the kernels take
    them: both contiguous, or with `strided` d_diff's rows at one stride,
    which it returns (`row_stride`)."""
    if d_diff.dim() != 4 or d_diff.shape[-1] % halves:
        raise ValueError(f"d_diff must be [B, N, k, {halves}C], got "
                         f"{tuple(d_diff.shape)}")
    B, N, k, C = d_diff.shape
    C //= halves
    if tuple(idx.shape) != (B, N, k):
        raise ValueError(f"idx must be {(B, N, k)}, got {tuple(idx.shape)}")
    if d_diff.dtype not in GRAD_DTYPES:
        raise TypeError(f"d_diff must be one of {GRAD_DTYPES}, "
                        f"got {d_diff.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    rs = row_stride(d_diff) if strided else None
    if not idx.is_contiguous() or not (
            rs is not None if strided else d_diff.is_contiguous()):
        raise ValueError("idx must be contiguous, and d_diff contiguous"
                         + (" or its rows at one stride" if strided else ""))
    if idx.device != d_diff.device:
        raise ValueError(f"idx is on {idx.device}, d_diff on "
                         f"{d_diff.device}")
    if not 1 <= C <= MAX_C or min(B, N, k) < 1:
        raise ValueError(f"need C in 1..{MAX_C} and B, N, k >= 1, got "
                         f"{tuple(d_diff.shape)}")
    return rs


def row_stride(d: torch.Tensor) -> Optional[int]:
    """The stride of the rows of d [B, N, k, C] when every row's C values
    are contiguous and row s = (b N + q) k + j starts at s * stride, as in
    a contiguous tensor (C) or the half d_ee[..., C:] of one (2C); else
    None."""
    B, N, k, C = d.shape
    rs = d.stride(2)
    if (C > 1 and d.stride(3) != 1) or rs < C:
        return None
    for dim, size in ((1, k), (0, N)):
        if d.shape[dim] > 1 and d.stride(dim) != size * rs:
            return None
        rs *= size
    return d.stride(2)


# one-hot bytes above which the JAX package's gather backward leaves the
# XLA one-hot contraction for the Pallas scatter (sp_gan_tpu/ops/edge.py:66)
ONE_HOT_LIMIT = 1 << 30


def one_hot_bytes(B: int, S: int, n: int, dtype: torch.dtype) -> int:
    """Bytes of the [B, S, n] one-hot that the JAX package would contract
    for a scatter-add of B * S rows of `dtype` into n targets."""
    return B * S * n * torch.empty((), dtype=dtype).element_size()


def _check_add(g: torch.Tensor, idx: torch.Tensor, n: int) -> None:
    if g.dim() != 3:
        raise ValueError(f"g must be [B, S, F], got {tuple(g.shape)}")
    B, S, F = g.shape
    if tuple(idx.shape) != (B, S):
        raise ValueError(f"idx must be {(B, S)}, got {tuple(idx.shape)}")
    if g.dtype not in GRAD_DTYPES:
        raise TypeError(f"g must be one of {GRAD_DTYPES}, got {g.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if not (g.is_contiguous() and idx.is_contiguous()):
        raise ValueError("g and idx must be contiguous")
    if idx.device != g.device:
        raise ValueError(f"idx is on {idx.device}, g on {g.device}")
    if min(B, S, F, n) < 1:
        raise ValueError(f"need B, S, F, n >= 1, got {tuple(g.shape)}, "
                         f"n={n}")


def scatter_add_plain(g: torch.Tensor, idx: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Kernel H's function in plain PyTorch: one `index_add_` into
    [B * n, F] f32. On the CPU it adds in ascending source order, the
    kernel's; on CUDA in no fixed order."""
    B, _, F = g.shape
    target = idx.long() + n * torch.arange(B, device=idx.device)[:, None]
    out = torch.zeros(B * n, F, dtype=torch.float32, device=g.device)
    out.index_add_(0, target.reshape(-1), g.reshape(-1, F).float())
    return out.reshape(B, n, F)


def _launch(name: str, g: torch.Tensor, idx: torch.Tensor, n: int,
            sources: int, C: int, dims) -> torch.Tensor:
    """Runs the CSR scatter `name` of `csrc/scatter.cu` on CUDA tensors g
    (f32 or bf16) and idx: n targets and `sources` sources a cloud, out
    [B, n, C] f32; `dims` are the function's int arguments before the
    type flag."""
    if g.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {g.device}")
    B = g.shape[0]
    lib = _build.library()
    ints = lib.spgan_csr_scratch(B, n, sources)
    if ints < 0:
        raise ValueError(f"{name} takes n <= {MAX_TARGETS} targets, got {n}")
    out = torch.empty((B, n, C), dtype=torch.float32, device=g.device)
    # histograms, bucket starts, sources placed by bucket and sorted by
    # target; freeing it on return is safe, since the caching allocator
    # hands it only to work queued later on this stream
    scratch = torch.empty(ints, dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(
            g.data_ptr(), idx.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            *dims, int(g.dtype == torch.bfloat16), stream)
    _build.check(err, name)
    return out


def scatter_add(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(g [B, S, F] f32/bf16, idx [B, S] int32) -> out [B, n, F] f32, see
    the module docstring. Kernel H on CUDA (F <= 128), `scatter_add_plain`
    on the CPU."""
    _check_add(g, idx, n)
    if g.device.type == "cpu":
        return scatter_add_plain(g, idx, n)
    B, S, F = g.shape
    if F > MAX_C:
        raise ValueError(f"kernel H (scatter_add) takes F <= {MAX_C} "
                         f"channels on CUDA, got {F}")
    out = _launch("spgan_scatter_add", g, idx, n, S, F, (B, S, n, F))
    scatter_add.launches += 1
    return out


scatter_add.launches = 0


def scatter_rows(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The neighbor gather's transpose: g [B, N, k, C], idx [B, N, k] ->
    out [B, n, C] f32, out[b, p] the sum of the g[b, q, j] with
    idx[b, q, j] == p. Kernel H on CUDA where the JAX package calls its
    Pallas scatter (a one-hot of more than 1 GiB), else `index_add_`
    (`scatter_add_plain`): on the CPU in ascending (q, j) order, on CUDA in
    no fixed order."""
    B, N, k, C = g.shape
    g2, idx2 = g.reshape(B, N * k, C), idx.reshape(B, N * k)
    if (g.device.type == "cuda"
            and one_hot_bytes(B, N * k, n, g.dtype) > ONE_HOT_LIMIT):
        return scatter_add(g2.contiguous(), idx2.to(torch.int32).contiguous(),
                           n)
    return scatter_add_plain(g2, idx2, n)


def scatter_diff_bwd_plain(d_diff: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the neighbor rows added by
    target (`scatter_add_plain`), then the central sum over j in ascending
    order, subtracted last. On the CPU the sums run in the kernel's
    order."""
    g = d_diff.float()
    B, N, k, C = g.shape
    central = g[:, :, 0]
    for j in range(1, k):
        central = central + g[:, :, j]
    return (scatter_add_plain(g.reshape(B, N * k, C), idx.reshape(B, N * k),
                              N) - central)


def scatter_diff_bwd(d_diff: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(d_diff [B, N, k, C] f32/bf16, its rows contiguous or at one stride
    (`row_stride`), idx [B, N, k] int32) -> d_x [B, N, C] f32, see the
    module docstring. Kernel D on CUDA, `scatter_diff_bwd_plain` on the
    CPU."""
    stride = _check(d_diff, idx, strided=True)
    if d_diff.device.type == "cpu":
        return scatter_diff_bwd_plain(d_diff, idx)
    B, N, k, C = d_diff.shape
    d_x = _launch("spgan_scatter_diff_bwd", d_diff, idx, N, N * k, C,
                  (B, N, k, C, stride))
    scatter_diff_bwd.launches += 1
    return d_x


scatter_diff_bwd.launches = 0


def edge_scatter_bwd_plain(d_ee: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """Kernel M's function in plain PyTorch: the neighbor half added by
    target (`scatter_add_plain`), then the central sum over j in ascending
    order of `d_ee[..., j, :C] - d_ee[..., j, C:]`, added last, all in f32.
    On the CPU the sums run in the kernel's order."""
    g = d_ee.float()
    B, N, k, C2 = g.shape
    C = C2 // 2
    central = torch.zeros(B, N, C, dtype=torch.float32, device=g.device)
    for j in range(k):
        central = central + (g[:, :, j, :C] - g[:, :, j, C:])
    return (scatter_add_plain(g[..., C:].reshape(B, N * k, C),
                              idx.reshape(B, N * k), N) + central)


def edge_scatter_bwd(d_ee: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(d_ee [B, N, k, 2C] f32/bf16, idx [B, N, k] int32) -> d_x [B, N, C]
    f32, see the module docstring. Kernel M on CUDA,
    `edge_scatter_bwd_plain` on the CPU."""
    _check(d_ee, idx, halves=2)
    if d_ee.device.type == "cpu":
        return edge_scatter_bwd_plain(d_ee, idx)
    B, N, k, C2 = d_ee.shape
    d_x = _launch("spgan_edge_scatter_bwd", d_ee, idx, N, N * k, C2 // 2,
                  (B, N, k, C2 // 2))
    edge_scatter_bwd.launches += 1
    return d_x


edge_scatter_bwd.launches = 0
