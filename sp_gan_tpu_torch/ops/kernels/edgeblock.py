"""Kernel C: the EdgeBlock tail with BatchNorm folded into affines,
`csrc/edgeblock.cu`.

Replaces `sp_gan_tpu/ops/pallas/edgeblock.py::edge_tail_pallas`
(`_edge_tail_kernel`). ee [B, N, k, 2C] -> out [B, N, F], with
diff = ee[..., C:] and leaky ReLU of slope `neg`:

    h   = lrelu(lrelu(diff @ w1 * a1[0] + a1[1]) @ w2 * a2[0] + a2[1])
    v   = lrelu(ee @ wx * ax[0] + ax[1]) * softmax_k(h)
    out = bout + v.reshape(k * F) @ wout.reshape(k * F, F)

w1 [C, F2], w2 [F2, F], wx [2C, F], wout [k, F, F]; a1 [2, F2], a2 and
ax [2, F] hold a scale row and a shift row (conv bias and eval BatchNorm
folded, `nn.fused_eval.fold_bn`, or batch statistics folded,
`ops.edgeblock_train`); bout [1, F]. The weights, affines and output are
f32. ee is f32 on the serving path (`edge_block_eval`, which hands the JAX
kernel f32 edges too) or bf16, the JAX kernel's bf16 mode, which the fused
training forward runs under mixed_edge: the matmul operands (the edge rows,
w1, w2, wx, the activations before @ w2 and v before @ wout) are rounded
to bf16 and the products summed in f32; wout stays f32, as the JAX
kernel's bf16 x f32 dot promotes it.

On an H100 at EdgeConv2's serving shape (ee [64, 2048, 10, 128], F = 128)
the function is bound by f32 operations: 118 GFLOP against 0.67 GB of
input. f32 mode runs on f32 FMAs (`csrc/edgeblock.cu`); bf16 mode runs on
the tensor cores (`csrc/edgeblock_train_tc.cu`, with wout kept as a bf16
pair hi + lo, about 16 of its bits) wherever C is a multiple of 4, F2
divides 256 and the weights fit in shared memory (C <= 224 at F = 128,
F2 = 64, k = 10), else on the FMA kernels too. The CUDA sources say how
their passes are laid out; the scratch each call takes is sized for the
path that runs.

`edge_tail` launches the kernel for CUDA tensors and runs `edge_tail_plain`,
the same function in plain PyTorch, for CPU tensors. `edge_tail.launches`
counts kernel launches.
"""

from __future__ import annotations

import torch

from sp_gan_tpu_torch.ops.kernels import _build

WIDTHS = (64, 128)      # output widths F the CUDA kernel is built for
MAX_K = 32
EE_DTYPES = (torch.float32, torch.bfloat16)


def _check(ee: torch.Tensor, w1, a1, w2, a2, wx, ax, wout, bout,
           k: int) -> None:
    if ee.dim() != 4 or ee.shape[-1] % 2:
        raise ValueError(f"ee must be [B, N, k, 2C], got {tuple(ee.shape)}")
    B, N, kk, C2 = ee.shape
    C, F2, F = C2 // 2, w1.shape[-1], w2.shape[-1]
    if kk != k or k < 1:
        raise ValueError(f"k={k} must equal ee's k={kk}, at least 1")
    if F not in WIDTHS or F2 % 4:
        raise ValueError(f"F={F} must be one of {WIDTHS} and F2={F2} a "
                         "multiple of 4")
    want = {"ee": (ee, (B, N, k, C2)), "w1": (w1, (C, F2)),
            "a1": (a1, (2, F2)), "w2": (w2, (F2, F)), "a2": (a2, (2, F)),
            "wx": (wx, (C2, F)), "ax": (ax, (2, F)),
            "wout": (wout, (k, F, F)), "bout": (bout, (1, F))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        want_dt = EE_DTYPES if name == "ee" else (torch.float32,)
        if t.dtype not in want_dt:
            raise TypeError(f"{name} must be one of {want_dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != ee.device:
            raise ValueError(f"{name} is on {t.device}, ee on {ee.device}")


def edge_tail_plain(ee: torch.Tensor, w1, a1, w2, a2, wx, ax, wout, bout,
                    k: int, neg: float = 0.01) -> torch.Tensor:
    """The kernel's function in plain PyTorch (f32 matmuls; on a GPU the
    caller turns TF32 off for a true f32 reference). A bf16 ee rounds the
    matmul operands to bf16 (`x.to(bf16).float()`); a product of two bf16
    values is exact in f32, so only the order of the sums differs from the
    kernel."""
    B, N, _, C2 = ee.shape
    F = w2.shape[-1]
    cd = ee.dtype

    def r(t):
        return t.to(cd).float()

    ee = ee.float()
    diff = ee[..., C2 // 2:]
    h = torch.nn.functional.leaky_relu(diff @ r(w1) * a1[0] + a1[1], neg)
    h = torch.nn.functional.leaky_relu(r(h) @ r(w2) * a2[0] + a2[1], neg)
    att = torch.softmax(h, dim=2)
    v = torch.nn.functional.leaky_relu(ee @ r(wx) * ax[0] + ax[1], neg) * att
    return r(v).reshape(B, N, k * F) @ wout.reshape(k * F, F) + bout[0]


def edge_tail(ee: torch.Tensor, w1, a1, w2, a2, wx, ax, wout, bout, k: int,
              neg: float = 0.01) -> torch.Tensor:
    """[B, N, k, 2C] f32 or bf16 -> [B, N, F] f32, see the module
    docstring.
    Kernel C on CUDA, `edge_tail_plain` on the CPU."""
    _check(ee, w1, a1, w2, a2, wx, ax, wout, bout, k)
    if ee.device.type == "cpu":
        return edge_tail_plain(ee, w1, a1, w2, a2, wx, ax, wout, bout, k, neg)
    if ee.device.type != "cuda":
        raise ValueError(f"edge_tail runs on cuda or cpu, not {ee.device}")
    B, N, _, C2 = ee.shape
    if k > MAX_K:
        raise ValueError(f"kernel C (edge_tail) takes k <= {MAX_K} (--nk <= "
                         f"{2 * MAX_K}) on CUDA; got k={k} (from --nk "
                         f"{2 * k})")
    F2, F = w1.shape[-1], w2.shape[-1]
    bf16 = int(ee.dtype == torch.bfloat16)
    out = torch.empty((B, N, F), dtype=torch.float32, device=ee.device)
    lib = _build.library()
    with torch.cuda.device(ee.device):
        n = lib.spgan_edge_tail_scratch(B, N, C2 // 2, F2, F, k, bf16)
        if n < 0:
            _build.check(-n, "spgan_edge_tail_scratch")
        # scratch for v (and, on the tensor cores, wout's bf16 pair);
        # freeing it on return is safe, since the caching allocator hands
        # it only to work queued later on this stream
        scratch = torch.empty(n, dtype=torch.float32, device=ee.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spgan_edge_tail(
            ee.data_ptr(), w1.data_ptr(), a1.data_ptr(), w2.data_ptr(),
            a2.data_ptr(), wx.data_ptr(), ax.data_ptr(), wout.data_ptr(),
            bout.data_ptr(), scratch.data_ptr(), out.data_ptr(), B, N,
            C2 // 2, F2, F, k, float(neg), bf16, stream)
    _build.check(err, "spgan_edge_tail")
    edge_tail.launches += 1
    return out


edge_tail.launches = 0
