"""Kernel D (`ops/kernels/scatter.py::scatter_diff_bwd`, `csrc/scatter.cu`),
the backward of the diff-only edge op and of the concat edges' neighbour
half, with no JAX import, so that its card tests run wherever the port
does (tests/test_torch_train_ops.py holds the plain version against the
Pallas kernel).

On the CPU: the rows of d_diff may lie at one stride (`row_stride`), so the
neighbour half `d_ee[..., C:]` of the concat edges goes in without a copy
and gives what its contiguous copy gives; `EdgeConcat`'s backward hands it
over so; the reference that drops out-of-range entries, as the kernel
does, is the plain version wherever the entries are in range.

On the card (`cuda` marker; `python -m pytest tests/test_torch_diff_bwd.py
-m cuda -q` on the H100) kernel D is held bit for bit (`torch.equal`) to
the plain version run on CPU copies, which sums in the kernel's order
(ascending source, central sum last), and to itself over two launches: at
its three calls (the default step's and P1's diffs, F1's strided
neighbour half) in f32 and bf16, and on an index list with a hub of 9000
in-edges, targets with no source and entries out of range.
"""

import numpy as np
import pytest
import torch

from sp_gan_tpu_torch.ops import edge
from sp_gan_tpu_torch.ops.kernels.scatter import (row_stride,
                                                  scatter_add_plain,
                                                  scatter_diff_bwd,
                                                  scatter_diff_bwd_plain)

torch.set_num_threads(2)   # six test workers share the host's cores


def _randn(shape, seed) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed)
                            .standard_normal(shape).astype(np.float32))


def _idx(B, N, k, seed, high=None) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, high or N, (B, N, k)).astype(np.int32))


def hard_idx(B: int, N: int, k: int, seed: int = 0) -> torch.Tensor:
    """Targets drawn from the first N / 2 (the rest get no source), cloud
    0's first 9000 sources on target 5 (a hub: its warp in the sum pass
    takes 282 rounds of 32 rows), every 97th entry out of range (-1, N,
    2^31 - 1, -2^31)."""
    idx = _idx(B, N, k, seed, N // 2).reshape(B, -1)
    idx[0, :9000] = 5
    bad = torch.tensor([-1, N, 2 ** 31 - 1, -2 ** 31], dtype=torch.int32)
    n_bad = idx[:, ::97].numel()
    idx[:, ::97] = bad[torch.arange(n_bad) % 4].reshape(B, -1)
    return idx.reshape(B, N, k)


def reference(d_diff: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel D's function on CPU tensors, entries of idx outside [0, N)
    dropped: their rows zeroed and sent to target 0 (+0.0 changes no sum
    that starts at +0.0), the central sums of every row kept."""
    g = d_diff.float()
    B, N, k, C = g.shape
    oob = (idx < 0) | (idx >= N)
    central = g[:, :, 0]
    for j in range(1, k):
        central = central + g[:, :, j]
    nbr = scatter_add_plain(g.masked_fill(oob[..., None], 0.0)
                            .reshape(B, N * k, C),
                            idx.masked_fill(oob, 0).reshape(B, N * k), N)
    return nbr - central


class TestRowStride:
    def test_strides(self):
        d = torch.zeros(2, 5, 3, 8)
        assert row_stride(d) == 8
        assert row_stride(d[..., 4:]) == 8     # not a half: rows of 4
        assert row_stride(d[..., :4]) == 8
        assert row_stride(d[:, :, :2]) is None  # rows not evenly spaced
        assert row_stride(d.transpose(1, 2)) is None
        assert row_stride(d[..., ::2]) is None
        assert row_stride(torch.zeros(1, 5, 1, 8)[..., 3:]) == 8

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_neighbour_half_equals_its_copy(self, dtype):
        """The concat edges' neighbour half at its row stride of 2C gives
        what its contiguous copy gives, with no launch on the CPU."""
        d_ee = _randn((2, 96, 5, 32), seed=1).to(dtype)
        idx = _idx(2, 96, 5, seed=2)
        half = d_ee[..., 16:]
        assert row_stride(half) == 32 and not half.is_contiguous()
        before = scatter_diff_bwd.launches
        assert torch.equal(scatter_diff_bwd(half, idx),
                           scatter_diff_bwd(half.contiguous(), idx))
        assert scatter_diff_bwd.launches == before

    def test_rejects_rows_without_one_stride(self):
        idx = torch.zeros(1, 8, 2, dtype=torch.int32)
        with pytest.raises(ValueError):
            scatter_diff_bwd(torch.zeros(1, 8, 2, 32)[..., ::2], idx)
        with pytest.raises(ValueError):
            scatter_diff_bwd(torch.zeros(1, 8, 4, 16)[:, :, :2], idx)
        with pytest.raises(ValueError):
            scatter_diff_bwd(torch.zeros(1, 8, 2, 16),
                             torch.zeros(1, 2, 8, dtype=torch.int32)
                             .transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_concat_backward_reads_the_half_in_place(dtype, monkeypatch):
    """`EdgeConcat`'s backward hands kernel D the neighbour half without a
    copy, and gives what it gave on a contiguous copy."""
    seen = []
    real = edge.scatter_diff_bwd

    def recording(d, idx):
        seen.append(d)
        return real(d, idx)
    monkeypatch.setattr(edge, "scatter_diff_bwd", recording)
    x = _randn((2, 64, 16), seed=3).requires_grad_()
    ee, idx = edge.edge_concat_fused(x, 4, dtype)
    g = _randn(tuple(ee.shape), seed=4).to(dtype)
    ee.backward(g)
    assert len(seen) == 1 and not seen[0].is_contiguous()
    assert row_stride(seen[0]) == 32
    d_nbr = g[..., 16:]
    expect = ((g[..., :16] - d_nbr).sum(dim=2)
              + (scatter_diff_bwd_plain(d_nbr.contiguous(), idx)
                 + d_nbr.float().sum(dim=2)).to(dtype)).float()
    assert torch.equal(x.grad, expect)


class TestReference:
    def test_is_the_plain_version_in_range(self):
        """On in-range entries, a hub (target 5) and targets with no
        source included, the reference is the plain version bit for
        bit."""
        dd = _randn((2, 1024, 10, 8), seed=5)
        idx = _idx(2, 1024, 10, seed=6, high=512).reshape(2, -1)
        idx[0, :9000] = 5
        idx = idx.reshape(2, 1024, 10)
        assert torch.equal(reference(dd, idx), scatter_diff_bwd_plain(dd, idx))

    def test_drops_out_of_range_entries(self):
        """Against a loop in float32 that skips them, ascending source,
        central sum last."""
        B, N, k, C = 1, 48, 3, 4
        dd = _randn((B, N, k, C), seed=7)
        idx = _idx(B, N, k, seed=8)
        idx[0, ::5, 1] = torch.tensor([-1, N, 2 ** 31 - 1, -2 ** 31] * 3,
                                      dtype=torch.int32)[:idx[0, ::5].shape[0]]
        g, ix = dd.numpy(), idx.numpy()
        out = np.zeros((B, N, C), np.float32)
        for q in range(N):
            for j in range(k):
                p = ix[0, q, j]
                if 0 <= p < N:
                    out[0, p] = out[0, p] + g[0, q, j]
        for p in range(N):
            cs = g[0, p, 0]
            for j in range(1, k):
                cs = cs + g[0, p, j]
            out[0, p] = out[0, p] - cs
        assert np.array_equal(reference(dd, idx).numpy(), out)


# ---------------------------------------------------------------- on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")


def _hold_d(dd: torch.Tensor, idx: torch.Tensor) -> None:
    """Kernel D bit for bit against the reference on CPU copies, and
    against itself over two launches."""
    a, b = scatter_diff_bwd(dd, idx), scatter_diff_bwd(dd, idx)
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), reference(dd.cpu(), idx.cpu()))


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_default_step_call(self, dtype):
        """The default step's call: d_diff [24, 2048, 10, 64] on kernel
        B's packed indices."""
        _card()
        from sp_gan_tpu_torch.ops.kernels import knn_edge
        x = _randn((24, 2048, 64), seed=10).cuda()
        idx = knn_edge(x, 10, torch.bfloat16, True, "packed")[1]
        _hold_d(_randn((24, 2048, 10, 64), seed=11).cuda().to(dtype), idx)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_f1_neighbour_half(self, dtype):
        """F1's call: the neighbour half of d_ee [24, 2048, 10, 128] at its
        row stride, equal to the contiguous copy's launch."""
        _card()
        from sp_gan_tpu_torch.ops.kernels import knn_edge
        x = _randn((24, 2048, 64), seed=12).cuda()
        idx = knn_edge(x, 10, torch.bfloat16, False, "packed")[1]
        half = _randn((24, 2048, 10, 128), seed=13).cuda().to(dtype)[..., 64:]
        _hold_d(half, idx)
        assert torch.equal(scatter_diff_bwd(half, idx),
                           scatter_diff_bwd(half.contiguous(), idx))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_p1_call(self, dtype):
        """P1's call: d_diff [4, 8192, 10, 64] on kernel F's indices at
        W = 512."""
        _card()
        from sp_gan_tpu_torch.ops.kernels import knn_edge_window
        x = _randn((4, 8192, 64), seed=14).cuda()
        idx = knn_edge_window(x, 10, 512, torch.bfloat16, diff_only=True,
                              select_mode="packed")[1]
        _hold_d(_randn((4, 8192, 10, 64), seed=15).cuda().to(dtype), idx)

    @pytest.mark.parametrize("C", [3, 64, 128])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_hard_idx(self, C, dtype):
        """A hub of 9000 in-edges, targets with no source, entries out of
        range; odd C and the widest."""
        _card()
        idx = hard_idx(2, 2048, 10).cuda()
        _hold_d(_randn((2, 2048, 10, C), seed=16).cuda().to(dtype), idx)

    def test_ragged(self):
        """N not a multiple of a bucket's 128 targets, an odd k, a
        strided f32 half."""
        _card()
        idx = _idx(3, 1999, 7, seed=17).cuda()
        d_ee = _randn((3, 1999, 7, 2 * 48), seed=18).cuda()
        _hold_d(d_ee[..., 48:], idx)
