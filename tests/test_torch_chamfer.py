"""The port's Chamfer distance (`ops/chamfer.py`), kernel N's plain version
(`ops/kernels/chamfer.py::chamfer_nn_plain`) and `ops/dispatch.py::
chamfer_directed` against the JAX package on the CPU: `nn_distance`,
`chamfer`, `chamfer_sums` and `chamfer_tiled` against their JAX
counterparts; kernel N's plain version against `_chamfer_pallas_raw` and
the fused op's gradients against `jax.grad` of `chamfer_pallas`, the
Pallas functions in interpret mode, jitted (as tests/test_pallas.py runs
them); and the size at which `chamfer_directed` takes the fused op.

Kernel N's one pass (`csrc/chamfer.cu`) emulated in numpy
(`emulate_one_pass`): row minima kept over tiles of y by each thread's
columns, then merged over threads; column minima over each thread's rows,
packed into 64-bit keys and merged by min over the block and then over the
blocks in a shuffled order; held to `chamfer_nn_plain` on duplicated
points, a grid, x = y and a repeated point.

Kernel N itself runs only on a GPU (`cuda` marker); chip_smoke.py holds it
against its plain version there, and the `cuda` tests below on the hard
inputs.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sp_gan_tpu.ops import dispatch as jdispatch
from sp_gan_tpu.ops.pallas import chamfer as jpallas
from sp_gan_tpu_torch.ops import dispatch, kernels
from sp_gan_tpu_torch.ops.kernels import chamfer_nn, chamfer_nn_plain
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist

# the modules (both packages' `ops` export a function of the same name)
jchamfer = importlib.import_module("sp_gan_tpu.ops.chamfer")
chamfer = importlib.import_module("sp_gan_tpu_torch.ops.chamfer")

torch.set_num_threads(2)   # six test workers share the host's cores


def clouds(seed, B=2, N=64, M=48, C=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N, C)).astype(np.float32) * 0.5,
            rng.standard_normal((B, M, C)).astype(np.float32) * 0.5)


def t(*a):
    return [torch.from_numpy(v) for v in a]


def exact_sqdist(x, y):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return ((x[:, :, None] - y[:, None]) ** 2).sum(-1)


def picks_agree(ours, theirs, d, axis, rel=1e-5):
    """Equal picks, or picks whose exact distances lie within `rel` of
    each other (the kNN tests' near-tie rule)."""
    d = np.moveaxis(d, axis, -1)
    a = np.take_along_axis(d, ours[..., None], -1)[..., 0]
    b = np.take_along_axis(d, theirs[..., None], -1)[..., 0]
    return bool(np.all((ours == theirs)
                       | (np.abs(a - b) <= rel * np.maximum(a, b))))


class TestPlainFunctions:
    """Against the JAX functions: values within 2e-4, indices exact."""

    def test_nn_distance(self):
        x, y = clouds(0)
        ours = chamfer.nn_distance(*t(x, y))
        theirs = jax.jit(jchamfer.nn_distance)(jnp.asarray(x), jnp.asarray(y))
        for a, b in zip(ours, theirs):
            b = np.asarray(b)
            if b.dtype == np.int32:
                assert a.dtype == torch.int32
                np.testing.assert_array_equal(a.numpy(), b)
            else:
                np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-4)

    @pytest.mark.parametrize("fn", ["chamfer", "chamfer_sums"])
    def test_means_and_sums(self, fn):
        x, y = clouds(1)
        ours = getattr(chamfer, fn)(*t(x, y))
        theirs = jax.jit(getattr(jchamfer, fn))(jnp.asarray(x),
                                                jnp.asarray(y))
        for a, b in zip(np.atleast_1d(ours) if fn == "chamfer_sums"
                        else ours, np.atleast_1d(theirs)
                        if fn == "chamfer_sums" else theirs):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-4, atol=2e-4)

    def test_tiled_equals_dense(self):
        x, y = clouds(2)
        ours = chamfer.chamfer_tiled(*t(x, y), chunk=16)
        theirs = jchamfer.chamfer_tiled(jnp.asarray(x), jnp.asarray(y),
                                        chunk=16)
        dense = chamfer.chamfer(*t(x, y))
        for a, b, c in zip(ours, theirs, dense):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=2e-4)
            assert torch.equal(a, c)
        with pytest.raises(ValueError):
            chamfer.chamfer_tiled(*t(x, y), chunk=48)


class TestKernelNPlain:
    @pytest.mark.parametrize("B, N, M, tq", [(2, 64, 48, 16), (1, 40, 96, 8),
                                             (3, 32, 32, 16)])
    def test_matches_pallas(self, B, N, M, tq):
        """Indices equal but at near-ties (exact distances within 1e-5 of
        each other); distances within 1e-6 + 1e-5 relative."""
        x, y = clouds(3, B, N, M)
        ours = chamfer_nn_plain(*t(x, y))
        fn = jax.jit(lambda a, b: jpallas._chamfer_pallas_raw(a, b, tq=tq))
        with pltpu.force_tpu_interpret_mode():
            theirs = [np.asarray(v) for v in fn(jnp.asarray(x),
                                                jnp.asarray(y))]
        d = exact_sqdist(x, y)
        for i, axis in ((1, 2), (3, 1)):
            assert ours[i].dtype == torch.int32
            assert picks_agree(ours[i].numpy(), theirs[i], d, axis)
        for i in (0, 2):
            np.testing.assert_allclose(ours[i].numpy(), theirs[i],
                                       rtol=1e-5, atol=1e-6)

    def test_ties_go_to_the_lowest_index(self):
        """Duplicated points: both directions pick the first copy."""
        x, y = clouds(4, 1, 16, 16)
        y[:, 8:] = y[:, :8]
        x[:, 8:] = x[:, :8]
        _, i1, _, i2 = chamfer_nn_plain(*t(x, y))
        assert (i1 < 8).all() and (i2 < 8).all()

    def test_wrapper_takes_the_plain_version_on_cpu(self):
        x, y = t(*clouds(5))
        kernels.reset_launch_counts()
        for a, b in zip(chamfer_nn(x, y), chamfer_nn_plain(x, y)):
            assert torch.equal(a, b)
        assert chamfer_nn.launches == 0
        with pytest.raises(ValueError):
            chamfer_nn(x, y[:1])


class TestFusedGradients:
    def test_matches_jax_grad_of_chamfer_pallas(self, monkeypatch):
        """`chamfer_directed` on its fused route (the switch shrunk to 0,
        so that the CPU holds the inputs): gradients of w1 . d1 + w2 . d2
        in both clouds within 2e-4 of `jax.grad` of the JAX
        `chamfer_pallas` (kernel in interpret mode, XLA scatter
        backward)."""
        calls = []
        fused = chamfer.chamfer_fused
        monkeypatch.setattr(dispatch, "CHAMFER_FUSED_ABOVE", 0)
        monkeypatch.setattr(dispatch, "chamfer_fused",
                            lambda a, b: calls.append(1) or fused(a, b))
        x, y = clouds(6)
        rng = np.random.default_rng(7)
        w1 = rng.standard_normal(x.shape[:2]).astype(np.float32)
        w2 = rng.standard_normal(y.shape[:2]).astype(np.float32)

        def loss(a, b):
            d1, d2 = jpallas.chamfer_pallas(a, b)
            return (d1 * w1).sum() + (d2 * w2).sum()

        with pltpu.force_tpu_interpret_mode():
            gx, gy = jax.jit(jax.grad(loss, argnums=(0, 1)))(
                jnp.asarray(x), jnp.asarray(y))
        xt, yt = (v.requires_grad_() for v in t(x, y))
        d1, d2 = dispatch.chamfer_directed(xt, yt)
        assert calls == [1]
        ((d1 * torch.from_numpy(w1)).sum()
         + (d2 * torch.from_numpy(w2)).sum()).backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0,
                                   atol=2e-4)
        np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gy), rtol=0,
                                   atol=2e-4)

    def test_fused_equals_the_dense_route(self):
        """The fused op and `chamfer_directed`'s dense route give the same
        distances and gradients (the same f32 values; the backward
        scatter adds in source order)."""
        x, y = clouds(8)
        w = torch.from_numpy(np.random.default_rng(9).standard_normal(
            x.shape[:2]).astype(np.float32))
        grads = []
        for fn in (chamfer.chamfer_fused, dispatch.chamfer_directed):
            xt, yt = (v.requires_grad_() for v in t(x, y))
            d1, d2 = fn(xt, yt)
            ((d1 * w).sum() + d2.sum()).backward()
            grads.append((d1.detach(), d2.detach(), xt.grad, yt.grad))
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("B, N, M", [(1, 16384, 8192), (1, 16384, 8193),
                                     (64, 2048, 2048), (24, 2048, 2048),
                                     (32, 2048, 2048), (33, 2048, 2048)])
def test_switch_at_the_jax_size(B, N, M, monkeypatch):
    """`chamfer_directed` takes the fused op exactly where the JAX one
    (with Pallas on) traces `chamfer_pallas`: above B * N * M = 128 Mi.
    The JAX side is traced only (`make_jaxpr` on shapes), nothing runs."""
    monkeypatch.setattr(jdispatch, "pallas_enabled", lambda: True)
    spec = (jax.ShapeDtypeStruct((B, N, 3), jnp.float32),
            jax.ShapeDtypeStruct((B, M, 3), jnp.float32))
    jaxpr = str(jax.make_jaxpr(jdispatch.chamfer_directed)(*spec))
    assert dispatch.uses_fused_chamfer(B, N, M) == ("pallas_call" in jaxpr)


def test_directed_routes(monkeypatch):
    """Above the size `chamfer_directed` calls the fused op, at or below
    it the dense minima (thresholds shrunk so that the CPU holds both)."""
    calls = []
    fused = chamfer.chamfer_fused
    monkeypatch.setattr(dispatch, "chamfer_fused",
                        lambda x, y: calls.append(1) or fused(x, y))
    x, y = t(*clouds(10, 2, 16, 8))
    monkeypatch.setattr(dispatch, "CHAMFER_FUSED_ABOVE", 256)
    dense = dispatch.chamfer_directed(x, y)
    assert not calls
    monkeypatch.setattr(dispatch, "CHAMFER_FUSED_ABOVE", 255)
    fused_out = dispatch.chamfer_directed(x, y)
    assert calls == [1]
    for a, b in zip(dense, fused_out):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_n_matches_plain_on_cuda():
    """Kernel N against its plain version on the card: all four outputs
    bit-equal (chip_smoke.py does the same at [64, 2048, 3])."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    x, y = (v.cuda() for v in t(*clouds(11, 3, 500, 300)))
    for a, b in zip(chamfer_nn(x, y), chamfer_nn_plain(x, y)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Kernel N's one pass, emulated

def orderable_u(d):
    """uint64 images of float32 d that order like the floats."""
    u = d.astype(np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xffffffff, u | 0x80000000)


def from_orderable_u(k):
    k = k.astype(np.uint64)
    u = np.where(k & 0x80000000, k & 0x7fffffff, ~k & 0xffffffff)
    return u.astype(np.uint32).view(np.float32)


def emulate_one_pass(x, y, rows=16, tile=256, seed=0):
    """Kernel N's four outputs for x [B, N, C], y [B, M, C] as its pass
    reduces d: thread (tx, ty) of a block of 16 rows-of-`rows` holds `rows`
    rows of x and the columns ty, ty + 16, ... of each y tile."""
    rng = np.random.default_rng(seed)
    d = pairwise_sqdist(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    B, n, m = d.shape
    out = [np.empty((B, n), np.float32), np.empty((B, n), np.int32),
           np.empty((B, m), np.float32), np.empty((B, m), np.int32)]
    for b in range(B):
        # rows: a thread's running minimum over its columns in ascending
        # order (strict <: the first of equal values), then the 16 threads
        # of a row merge in a shuffled order, the lower index on a tie
        best = np.full(n, np.inf, np.float32)
        idx = np.zeros(n, np.int64)
        for ty in rng.permutation(16):
            cols = np.array([c for c in range(m) if c % 16 == ty])
            if cols.size == 0:
                continue
            j = d[b][:, cols].argmin(axis=1)
            tb, ti = d[b][np.arange(n), cols[j]], cols[j]
            take = (tb < best) | ((tb == best) & (ti < idx))
            best, idx = np.where(take, tb, best), np.where(take, ti, idx)
        out[0][b], out[1][b] = best, idx
        # columns: a thread's rows (strict <, ascending), a key of the
        # orderable distance (-0 as +0) above the row, min over the block,
        # then over the blocks in a shuffled order
        key = np.full(m, np.uint64(2 ** 64 - 1))
        blocks = list(range(0, n, 16 * rows))
        rng.shuffle(blocks)
        for n0 in blocks:
            bkey = np.full(m, np.uint64(2 ** 64 - 1))
            for r0 in range(n0, min(n, n0 + 16 * rows), rows):
                blk = d[b][r0:r0 + rows]
                i = blk.argmin(axis=0)
                dv = blk[i, np.arange(m)]
                dv = np.where(dv == 0, np.float32(0), dv).astype(np.float32)
                k = (orderable_u(dv) << np.uint64(32)) | (
                    (r0 + i).astype(np.uint64))
                bkey = np.minimum(bkey, k)
            key = np.minimum(key, bkey)
        out[2][b] = from_orderable_u(key >> np.uint64(32))
        out[3][b] = (key & np.uint64(0xffffffff)).astype(np.int32)
    return out


def hard_clouds(kind, seed=12):
    """Inputs with many equal distances: duplicated points, a grid, x = y,
    one point repeated; N and M not multiples of the kernel's tiles."""
    rng = np.random.default_rng(seed)
    if kind == "duplicated":
        x, y = clouds(seed, 2, 300, 200)
        x[:, 150:] = x[:, :150]
        y[:, 100:] = y[:, 50:150]
        return x, y
    if kind == "grid":
        g = np.stack(np.meshgrid(*[np.arange(7)] * 3), -1).reshape(-1, 3)
        g = (g * 0.25).astype(np.float32)
        return (g[rng.permutation(len(g))[None, :300]].copy(),
                g[rng.permutation(len(g))[None, :290]].copy())
    if kind == "x=y":
        x, _ = clouds(seed, 2, 270, 1)
        return x, x.copy()
    x, y = clouds(seed, 1, 513, 257)
    x[:, 100:400] = x[:, 7:8]
    y[:, 30:200] = y[:, 3:4]
    return x, y


@pytest.mark.parametrize("kind", ["duplicated", "grid", "x=y", "repeated"])
@pytest.mark.parametrize("rows, tile", [(16, 256), (8, 256), (3, 40)])
def test_one_pass_equals_plain(kind, rows, tile):
    """The emulated pass's four outputs equal `chamfer_nn_plain`'s bit for
    bit, ties to the lowest index in both directions, whatever the rows a
    thread holds."""
    x, y = hard_clouds(kind)
    got = emulate_one_pass(x, y, rows, tile)
    want = [v.numpy() for v in chamfer_nn_plain(*t(x, y))]
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()
    if kind == "x=y":              # each point finds itself
        assert (got[1] == np.arange(x.shape[1])).all()
        return
    d = pairwise_sqdist(*t(x, y)).numpy()
    tied = (d == d.min(axis=2, keepdims=True)).sum(axis=2)
    assert (tied > 1).any()        # the input reached the tie rule


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["duplicated", "grid", "x=y", "repeated"])
def test_kernel_n_on_hard_inputs_on_cuda(kind):
    """Kernel N on the tie-heavy inputs: all four outputs bit-equal to the
    plain version and twice alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    x, y = (v.cuda() for v in t(*hard_clouds(kind)))
    got, again = chamfer_nn(x, y), chamfer_nn(x, y)
    for a, b, c in zip(got, chamfer_nn_plain(x, y), again):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 4, 5, 8])
def test_kernel_n_widths_on_cuda(C):
    """Kernel N at each width up to 8, N != M: bit-equal to the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    x, y = (v.cuda() for v in t(*clouds(13, 3, 700, 333, C)))
    for a, b in zip(chamfer_nn(x, y), chamfer_nn_plain(x, y)):
        assert torch.equal(a, b)
