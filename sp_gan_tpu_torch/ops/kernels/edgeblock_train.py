"""Kernels I-L: the fused train-mode EdgeBlock's batch-statistics sweep and
its three backward sweeps, `csrc/edgeblock_train.cu`.

Replace the four `pallas_call`s of `sp_gan_tpu/ops/pallas/edgeblock_train.py`:

- I, `edge_train_stats2` (`_stats2_pallas`, `_stats2_kernel`): the sum and
  sum of squares over all B*N*k edge rows of
  h2 = lrelu(diff @ w1 * a1[0] + a1[1]) @ w2, as [2, F];
- J, `edge_train_bwd1` (backward pass 1, `_bwd_pass1_kernel`): the BN2
  and BNx backward sums [S2a, S2b, Sxa, Sxb] [4, F], d_wout [k, F, F],
  d_bout [F], and d_u = d_out @ wout[j]^T [B, N, k, F], which J computes
  once for K and L;
- K, `edge_train_bwd2` (`_bwd_pass2_kernel`): the BN1 sums [S1a, S1b]
  [2, F2] and d_w2 [F2, F];
- L, `edge_train_bwd3` (`_bwd_pass3_kernel`): d_ee [B, N, k, 2C] in ee's
  type, d_w1 [C, F2] and d_wx [2C, F].

Each sweep recomputes the JAX `_chunk_common` chain from the edge rows
(`chain` below). ee is f32 or bf16; a bf16 ee runs the JAX kernels' bf16
mode: both operands of every matmul are rounded to bf16 and the products
summed in f32 (`mm`); the affines, leaky ReLU, softmax and BatchNorm
arithmetic stay f32. The other inputs are f32: w1 [C, F2], w2 [F2, F],
wx [2C, F], wout [k, F, F], the affines a1 [2, F2], a2 and ax [2, F] (scale
row, shift row), gb2x [4, F] (BN2 and BNx gamma, beta) and gb1 [2, F2].

On an H100 the four are bound by bytes in bf16 mode (the CUDA sources
have the counts and the design). In bf16 mode I, J, K and L run their
products on the tensor cores (`csrc/edgeblock_train_tc.cu`; I reads only
the diff half of ee) wherever the block's weights fit in shared memory
(at F = 128, F2 = 64, k = 10: C <= 192 for J and L, C <= 208 for K, and
wider for I); the f32 mode and wider blocks run them as f32 FMAs
(`csrc/edgeblock_train.cu`). The scratch each call
takes is sized for the path that runs. Each wrapper launches its kernel
for CUDA tensors and runs its plain PyTorch version (`*_plain`, the same
arithmetic) for CPU tensors; `fn.launches` counts kernel launches. The
CUDA kernels take C a multiple of 4, F2 a multiple of 4 dividing 256, F
in {64, 128} and k <= 32; the plain versions any widths.
"""

from __future__ import annotations

import torch

from sp_gan_tpu_torch.ops.kernels import _build

WIDTHS = (64, 128)      # output widths F the CUDA kernels are built for
MAX_K = 32
EE_DTYPES = (torch.float32, torch.bfloat16)


def mm(x: torch.Tensor, w: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """The JAX `_mm`: both operands in `cd`, products summed in f32. A
    product of two bf16 values is exact in f32, so the f32 matmul of the
    rounded operands computes what the bf16 dot does, up to sum order."""
    return x.to(cd).float() @ w.to(cd).float()


def compute_dtype(ee: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if ee.dtype == torch.bfloat16 else torch.float32


def lrelu(v: torch.Tensor, neg: float) -> torch.Tensor:
    return torch.where(v >= 0, v, neg * v)


def dlrelu(v: torch.Tensor, neg: float) -> torch.Tensor:
    return torch.where(v >= 0, 1.0, neg)


def chain(ee, w1, a1, w2, a2, wx, ax, k: int, neg: float) -> dict:
    """The forward recompute of `_chunk_common` over every edge row: flat
    [R, 2C] (R = B*N*k), diff, p1, y1 [R, F2], p2, px [R, F], w (softmax
    over k) and v [P, k, F] (P = B*N)."""
    cd = compute_dtype(ee)
    C2, F = ee.shape[-1], w2.shape[-1]
    flat = ee.reshape(-1, C2).float()
    diff = flat[:, C2 // 2:]
    p1 = mm(diff, w1, cd) * a1[0] + a1[1]
    y1 = lrelu(p1, neg)
    p2 = mm(y1, w2, cd) * a2[0] + a2[1]
    y2 = lrelu(p2, neg).reshape(-1, k, F)
    e2 = torch.exp(y2 - y2.amax(dim=1, keepdim=True))
    w = e2 / e2.sum(dim=1, keepdim=True)
    px = mm(flat, wx, cd) * ax[0] + ax[1]
    v = lrelu(px, neg).reshape(-1, k, F)
    return dict(flat=flat, diff=diff, p1=p1, y1=y1, p2=p2, px=px, w=w, v=v)


def _top(ch: dict, d_u: torch.Tensor, gb2x, neg: float) -> dict:
    """The top of the backward: d_p2, d_px [R, F] and the x-hats of BN2
    and BNx from d_u [P, k, F]."""
    F = d_u.shape[-1]
    w, v = ch["w"], ch["v"]
    d_wgt = d_u * v
    d_y2 = w * (d_wgt - (w * d_wgt).sum(dim=1, keepdim=True))
    d_p2 = d_y2.reshape(-1, F) * dlrelu(ch["p2"], neg)
    d_px = (d_u * w).reshape(-1, F) * dlrelu(ch["px"], neg)
    return dict(d_p2=d_p2, d_px=d_px,
                xhat2=(ch["p2"] - gb2x[1]) / gb2x[0],
                xhatx=(ch["px"] - gb2x[3]) / gb2x[2])


def _bn_bwd(scale, d_p, sa, sb, xhat, m: float) -> torch.Tensor:
    """BatchNorm's input gradient from its output gradient and the sums
    S_a = sum(d_p), S_b = sum(d_p xhat), in the JAX kernels' form."""
    return scale * (d_p - sa / m - xhat * (sb / m))


def _rows(ee: torch.Tensor) -> float:
    B, N, k, _ = ee.shape
    return float(B * N * k)


def _d_p1(ee, ch, top, w2, a2, gb1, s2, neg):
    """(d_h2 [R, F], d_p1 [R, F2], xhat1 [R, F2]) from the BN2 sums s2."""
    cd = compute_dtype(ee)
    d_h2 = _bn_bwd(a2[0], top["d_p2"], s2[0], s2[1], top["xhat2"],
                   _rows(ee))
    d_p1 = mm(d_h2, w2.t(), cd) * dlrelu(ch["p1"], neg)
    return d_h2, d_p1, (ch["p1"] - gb1[1]) / gb1[0]


def edge_train_stats2_plain(ee, w1, a1, w2, k: int,
                            neg: float = 0.01) -> torch.Tensor:
    """Kernel I's function in plain PyTorch: [sum h2; sum h2^2] [2, F]."""
    cd = compute_dtype(ee)
    diff = ee.reshape(-1, ee.shape[-1]).float()[:, ee.shape[-1] // 2:]
    y1 = lrelu(mm(diff, w1, cd) * a1[0] + a1[1], neg)
    h2 = mm(y1, w2, cd)
    return torch.stack([h2.sum(0), (h2 * h2).sum(0)])


def edge_train_bwd1_plain(ee, d_out, w1, a1, w2, a2, wx, ax, gb2x, wout,
                          k: int, neg: float = 0.01):
    """Kernel J's function in plain PyTorch: (sums [4, F], d_wout [k, F, F],
    d_bout [F], d_u [B, N, k, F])."""
    cd = compute_dtype(ee)
    B, N = ee.shape[:2]
    F = w2.shape[-1]
    dout = d_out.reshape(-1, F).float()
    d_u = mm(dout, wout.reshape(k * F, F).t(), cd).reshape(-1, k, F)
    ch = chain(ee, w1, a1, w2, a2, wx, ax, k, neg)
    top = _top(ch, d_u, gb2x, neg)
    sums = torch.stack([top["d_p2"].sum(0),
                        (top["d_p2"] * top["xhat2"]).sum(0),
                        top["d_px"].sum(0),
                        (top["d_px"] * top["xhatx"]).sum(0)])
    u = (ch["v"] * ch["w"]).reshape(-1, k * F)
    d_wout = mm(u.t(), dout, cd).reshape(k, F, F)
    return sums, d_wout, dout.sum(0), d_u.reshape(B, N, k, F)


def edge_train_bwd2_plain(ee, d_u, w1, a1, w2, a2, wx, ax, gb2x, s2, gb1,
                          k: int, neg: float = 0.01):
    """Kernel K's function in plain PyTorch: (s1 [2, F2], d_w2 [F2, F])."""
    cd = compute_dtype(ee)
    F = w2.shape[-1]
    ch = chain(ee, w1, a1, w2, a2, wx, ax, k, neg)
    top = _top(ch, d_u.reshape(-1, k, F), gb2x, neg)
    d_h2, d_p1, xhat1 = _d_p1(ee, ch, top, w2, a2, gb1, s2, neg)
    s1 = torch.stack([d_p1.sum(0), (d_p1 * xhat1).sum(0)])
    return s1, mm(ch["y1"].t(), d_h2, cd)


def edge_train_bwd3_plain(ee, d_u, w1, a1, w2, a2, wx, ax, gb2x, s2, gb1,
                          s1, k: int, neg: float = 0.01):
    """Kernel L's function in plain PyTorch: (d_ee [B, N, k, 2C] in ee's
    type, d_w1 [C, F2], d_wx [2C, F])."""
    cd = compute_dtype(ee)
    C = ee.shape[-1] // 2
    F = w2.shape[-1]
    m = _rows(ee)
    ch = chain(ee, w1, a1, w2, a2, wx, ax, k, neg)
    top = _top(ch, d_u.reshape(-1, k, F), gb2x, neg)
    _, d_p1, xhat1 = _d_p1(ee, ch, top, w2, a2, gb1, s2, neg)
    d_h1 = _bn_bwd(a1[0], d_p1, s1[0], s1[1], xhat1, m)
    d_hx = _bn_bwd(ax[0], top["d_px"], s2[2], s2[3], top["xhatx"], m)
    d_diff = mm(d_h1, w1.t(), cd)
    d_full = mm(d_hx, wx.t(), cd)
    d_ee = torch.cat([d_full[:, :C], d_full[:, C:] + d_diff], dim=1)
    return (d_ee.reshape(ee.shape).to(ee.dtype), mm(ch["diff"].t(), d_h1, cd),
            mm(ch["flat"].t(), d_hx, cd))


def _check(ee: torch.Tensor, k: int, **named) -> tuple:
    """Checks ee [B, N, k, 2C] and the named f32 operands against the
    shapes their names imply; returns (B, N, C, F2, F)."""
    if ee.dim() != 4 or ee.shape[-1] % 2:
        raise ValueError(f"ee must be [B, N, k, 2C], got {tuple(ee.shape)}")
    B, N, kk, C2 = ee.shape
    if kk != k or k < 1:
        raise ValueError(f"k={k} must equal ee's k={kk}, at least 1")
    if ee.dtype not in EE_DTYPES:
        raise TypeError(f"ee must be one of {EE_DTYPES}, got {ee.dtype}")
    C, F2, F = C2 // 2, named["w1"].shape[-1], named["w2"].shape[-1]
    shapes = {"w1": (C, F2), "a1": (2, F2), "w2": (F2, F), "a2": (2, F),
              "wx": (C2, F), "ax": (2, F), "gb2x": (4, F), "gb1": (2, F2),
              "wout": (k, F, F), "s2": (4, F), "s1": (2, F2),
              "d_out": (B, N, F), "d_u": (B, N, k, F)}
    for name, t in named.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != ee.device:
            raise ValueError(f"{name} is on {t.device}, ee on {ee.device}")
    if ee.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the EdgeBlock train kernels run on cuda or cpu, "
                         f"not {ee.device}")
    return B, N, C, F2, F


def _launch(pass_: int, name: str, ee, k, neg, widths, fn_args,
            outs: list):
    """Launches `spgan_ebt_<name>` with its scratch; checks the kernels'
    limits first."""
    B, N, C, F2, F = widths
    if F not in WIDTHS or F2 % 4 or 256 % F2 or C % 4 or k > MAX_K:
        raise ValueError(
            f"kernel {name} takes F in {WIDTHS}, F2 a multiple of 4 "
            f"dividing 256, C a multiple of 4 and k <= {MAX_K} on CUDA; got "
            f"F={F}, F2={F2}, C={C}, k={k}")
    lib = _build.library()
    with torch.cuda.device(ee.device):
        bf16 = int(ee.dtype == torch.bfloat16)
        n = lib.spgan_ebt_scratch(pass_, B, N, C, F2, F, k, bf16)
        if n < 0:
            _build.check(-n, "spgan_ebt_scratch")
        # freeing the scratch on return is safe: the caching allocator
        # hands it only to work queued later on this stream
        scratch = torch.empty(n, dtype=torch.float32, device=ee.device)
        stream = torch.cuda.current_stream().cuda_stream
        # the kernels read 16 bytes at a time: a view that starts off that
        # boundary is copied
        args = [t.contiguous() for t in fn_args]
        args = [t.clone() if t.data_ptr() % 16 else t for t in args]
        err = getattr(lib, f"spgan_ebt_{name}")(
            *[t.data_ptr() for t in args + outs], scratch.data_ptr(), B, N,
            C, F2, F, k, float(neg), bf16, stream)
    _build.check(err, f"spgan_ebt_{name}")


def _empty(ee, *shape):
    return torch.empty(shape, dtype=torch.float32, device=ee.device)


def edge_train_stats2(ee, w1, a1, w2, k: int,
                      neg: float = 0.01) -> torch.Tensor:
    """Kernel I: [sum h2; sum h2^2] [2, F] f32 over every edge row."""
    widths = _check(ee, k, w1=w1, a1=a1, w2=w2)
    if ee.device.type == "cpu":
        return edge_train_stats2_plain(ee, w1, a1, w2, k, neg)
    out = _empty(ee, 2, widths[4])
    _launch(0, "stats2", ee, k, neg, widths, [ee, w1, a1, w2], [out])
    edge_train_stats2.launches += 1
    return out


def edge_train_bwd1(ee, d_out, w1, a1, w2, a2, wx, ax, gb2x, wout, k: int,
                    neg: float = 0.01):
    """Kernel J: (sums [4, F], d_wout [k, F, F], d_bout [F], d_u
    [B, N, k, F]), all f32."""
    widths = _check(ee, k, d_out=d_out, w1=w1, a1=a1, w2=w2, a2=a2, wx=wx,
                    ax=ax, gb2x=gb2x, wout=wout)
    if ee.device.type == "cpu":
        return edge_train_bwd1_plain(ee, d_out, w1, a1, w2, a2, wx, ax, gb2x,
                                     wout, k, neg)
    B, N, C, F2, F = widths
    outs = [_empty(ee, 4, F), _empty(ee, k, F, F), _empty(ee, F),
            _empty(ee, B, N, k, F)]
    _launch(1, "bwd1", ee, k, neg, widths,
            [ee, d_out, w1, a1, w2, a2, wx, ax, gb2x, wout], outs)
    edge_train_bwd1.launches += 1
    return tuple(outs)


def edge_train_bwd2(ee, d_u, w1, a1, w2, a2, wx, ax, gb2x, s2, gb1, k: int,
                    neg: float = 0.01):
    """Kernel K: (s1 [2, F2], d_w2 [F2, F]), f32."""
    widths = _check(ee, k, d_u=d_u, w1=w1, a1=a1, w2=w2, a2=a2, wx=wx, ax=ax,
                    gb2x=gb2x, s2=s2, gb1=gb1)
    if ee.device.type == "cpu":
        return edge_train_bwd2_plain(ee, d_u, w1, a1, w2, a2, wx, ax, gb2x,
                                     s2, gb1, k, neg)
    F2, F = widths[3:]
    outs = [_empty(ee, 2, F2), _empty(ee, F2, F)]
    _launch(2, "bwd2", ee, k, neg, widths,
            [ee, d_u, w1, a1, w2, a2, wx, ax, gb2x, s2, gb1], outs)
    edge_train_bwd2.launches += 1
    return tuple(outs)


def edge_train_bwd3(ee, d_u, w1, a1, w2, a2, wx, ax, gb2x, s2, gb1, s1,
                    k: int, neg: float = 0.01):
    """Kernel L: (d_ee [B, N, k, 2C] in ee's type, d_w1 [C, F2], d_wx
    [2C, F] f32)."""
    widths = _check(ee, k, d_u=d_u, w1=w1, a1=a1, w2=w2, a2=a2, wx=wx, ax=ax,
                    gb2x=gb2x, s2=s2, gb1=gb1, s1=s1)
    if ee.device.type == "cpu":
        return edge_train_bwd3_plain(ee, d_u, w1, a1, w2, a2, wx, ax, gb2x,
                                     s2, gb1, s1, k, neg)
    B, N, C, F2, F = widths
    outs = [torch.empty_like(ee, memory_format=torch.contiguous_format),
            _empty(ee, C, F2), _empty(ee, 2 * C, F)]
    _launch(3, "bwd3", ee, k, neg, widths,
            [ee, d_u, w1, a1, w2, a2, wx, ax, gb2x, s2, gb1, s1], outs)
    edge_train_bwd3.launches += 1
    return tuple(outs)


for _fn in (edge_train_stats2, edge_train_bwd1, edge_train_bwd2,
            edge_train_bwd3):
    _fn.launches = 0
