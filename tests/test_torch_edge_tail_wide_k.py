"""Kernel C's f32 mode past k = 32 (33 <= k <= 64, the generator's --nk up
to 128) on the CPU, where the port runs its plain version:

- `edge_tail_plain` against the JAX package's `edge_tail_pallas` in
  interpret mode (as tests/test_torch_edgeblock_train.py runs it) at k =
  33, 40 and 64, on f32 and bf16 edges, at EdgeConv2's and EdgeConv1's
  widths, on an EdgeBlock's weights with random BatchNorm statistics
  folded (`fold_bn`) and carried to JAX as numpy arrays;
- the premise of the tensor-core design at those depths (k F = 5120 and
  8192): with TF32 rounding emulated as tests/test_torch_edge_tail.py
  emulates it, three TF32 products a product hold the f32 gate |err| <=
  1e-5 + 1e-4 |plain| and one does not;
- the wrapper's limits, checked before any launch: k <= 64 on f32 edges
  and on bf16 edges (the fused training forward's, with kernels I-L);
- the fused eval forward (the serving path, both EdgeBlock tails in kernel
  C) at --nk 80 against the JAX package's `generator_forward_eval` in
  interpret mode on the same weights and codes (JAX jitted: run op by op,
  an interpret-mode kernel's host callbacks can wait forever on work
  queued behind them).

Tolerances: 2e-4 in f32, as the port's parity tests hold the JAX package
(measured: at most 2.5e-8 on tail outputs up to 0.056, 2.8e-7 on the
forward's clouds). In bf16 both round the matmul operands at the same
places after f32 sums taken in other orders, so a rounding may land one
bf16 ulp (2^-8 of the value) apart and move the output through wout:
within 4e-4 of the output's max-abs (measured up to 1.7e-4, EdgeConv1 at
k = 64), and no farther from the JAX float32 result than 1.1 times the JAX
bf16 result is, plus 1e-6 (measured: the two distances within 0.05% of
each other).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import test_torch_edge_tail as base
import sp_gan_tpu.ops.edge as jedge
from sp_gan_tpu.config import Config as JaxConfig
from sp_gan_tpu.nn.fused_eval import generator_forward_eval as jfused_forward
from sp_gan_tpu.ops.pairwise import knn_indices as jknn
from sp_gan_tpu.ops.pallas.edgeblock import edge_tail_pallas
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.nn import fused_eval, layers
from sp_gan_tpu_torch.nn.fused_eval import fold_bn, generator_forward_eval
from sp_gan_tpu_torch.nn.generator import Generator
from sp_gan_tpu_torch.ops.kernels.edgeblock import (MAX_K, check_kernel_limits,
                                                    edge_tail, edge_tail_plain)
from test_torch_generator import (jax_vars, randomize_bn, template_batch,
                                  tiled_codes)

torch.set_num_threads(2)   # six test workers share the host's cores

WIDE_K = (33, 40, 64)
# (C, F) of the generator's two EdgeBlocks; F2 = F / 2
WIDTHS = {"EdgeConv2": (64, 128), "EdgeConv1": (3, 64)}
F32_TOL = 2e-4
BF16_TOL, BF16_FACTOR = 4e-4, 1.1


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def block_tail(C: int, F: int, k: int, seed: int, B: int = 1, N: int = 64):
    """Kernel C's arguments as numpy f32 arrays: an EdgeBlock(C, F, k)'s
    weights drawn from `seed`, its BatchNorms' statistics randomized and
    folded as the serving path folds them, and edges [B, N, k, 2C] drawn
    from `seed` with their centre half shared by a point's k rows."""
    rng = np.random.default_rng(seed)
    blk = layers.EdgeBlock(C, F, k)
    for m in blk.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(rng)
    randomize_bn(blk, seed + 1)
    w1, a1 = fold_bn(blk.conv_w1, blk.bn_w1)
    w2, a2 = fold_bn(blk.conv_w2, blk.bn_w2)
    wx, ax = fold_bn(blk.conv_x, blk.bn_x)
    x = rng.standard_normal((B, N, 1, C)).astype(np.float32)
    nbr = rng.standard_normal((B, N, k, C)).astype(np.float32)
    ee = np.concatenate([np.broadcast_to(x, nbr.shape), nbr - x], -1)
    weights = [t.detach().numpy() for t in (w1, a1, w2, a2, wx, ax)]
    return [np.ascontiguousarray(ee, np.float32), *weights,
            blk.out_kernel.detach().numpy(),
            blk.out_bias.detach().numpy()[None]]


def pallas_tail(args, k: int, bf16: bool) -> np.ndarray:
    ee = jnp.asarray(args[0])
    if bf16:
        ee = ee.astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(edge_tail_pallas(ee, *map(jnp.asarray, args[1:]),
                                           k=k, tq=64))


def plain_tail(args, k: int, bf16: bool) -> np.ndarray:
    ee = torch.from_numpy(args[0])
    if bf16:
        ee = ee.to(torch.bfloat16)
    return edge_tail_plain(ee, *map(torch.from_numpy, args[1:]),
                           k=k).numpy()


@pytest.mark.parametrize("k", WIDE_K)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_plain_matches_pallas_f32(width, k):
    """f32 edges: the plain version within 2e-4 of the Pallas kernel."""
    C, F = WIDTHS[width]
    args = block_tail(C, F, k, seed=k)
    ours, theirs = plain_tail(args, k, False), pallas_tail(args, k, False)
    assert ours.shape == (1, 64, F) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("k", WIDE_K)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_plain_matches_pallas_bf16(width, k):
    """bf16 edges (the JAX kernel's bf16 mode): within 4e-4 of the
    output's max-abs, and no farther from the JAX float32 tail than JAX's
    own bf16 tail is (times 1.1, plus 1e-6)."""
    C, F = WIDTHS[width]
    args = block_tail(C, F, k, seed=k)
    ours, theirs = plain_tail(args, k, True), pallas_tail(args, k, True)
    exact = pallas_tail(args, k, False)
    assert ours.shape == (1, 64, F) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=BF16_TOL * np.abs(theirs).max())
    assert rel(ours, exact) <= BF16_FACTOR * rel(theirs, exact) + 1e-6
    assert rel(theirs, exact) > 1e-5   # bf16 rounding is there to see


@pytest.mark.parametrize("inputs", list(base.INPUTS))
@pytest.mark.parametrize("k", (40, 64))
def test_three_tf32_products_hold_the_f32_gate(k, inputs):
    """At EdgeConv2's widths and k = 40 and 64 (a contraction over
    k F = 5120 and 8192) the tail with three TF32 products a matmul lies
    within the f32 gate of the plain version, at least 2.5e-6 inside it;
    with one TF32 product it does not (measured on these inputs: the
    three-product tail 4.3e-6 to 1.0e-5 inside the gate, the one-product
    tail 3.7e-5 to 9.5e-3 beyond it)."""
    offset, scale = base.INPUTS[inputs]
    args = base.tail_args(64, 64, 128, k, 2, 32, offset, scale)
    ref = edge_tail_plain(*args, k=k)
    three = base.tail_emulated(*args, k, 3)
    one = base.tail_emulated(*args, k, 1)
    assert base.gate_excess(three, ref) <= -base.GATE_ABS / 4, inputs
    assert base.gate_excess(one, ref) > 0, inputs


class TestLimits:
    def test_f32_takes_k_up_to_64(self):
        """The check passes f32 edges and bf16 edges at k = 64 (--nk 128),
        the largest either mode launches (bf16 past k = 32 since the
        tensor-core engine of kernels I-L and C's bf16 mode took it)."""
        assert MAX_K == {torch.float32: 64, torch.bfloat16: 64}
        check_kernel_limits(64, torch.float32)
        check_kernel_limits(64, torch.bfloat16)

    @pytest.mark.parametrize("k, dtype, limit", [
        (65, torch.float32, "k <= 64 (--nk <= 128) in f32 mode"),
        (65, torch.bfloat16, "k <= 64 (--nk <= 128) in bf16 mode")])
    def test_refused_past_the_limit(self, k, dtype, limit):
        """f32 and bf16 at k = 65 are refused before a launch, naming the
        limit and the --nk they came from."""
        with pytest.raises(ValueError) as e:
            check_kernel_limits(k, dtype)
        assert limit in str(e.value) and f"(from --nk {2 * k})" in str(e.value)

    def test_cpu_tensors_take_the_plain_version_at_any_k(self):
        """The limit is the kernel's: on the CPU the wrapper runs the plain
        version at k = 65 and launches nothing."""
        args = [torch.from_numpy(a) for a in block_tail(3, 64, 65, 5, N=8)]
        before = edge_tail.launches
        assert torch.equal(edge_tail(*args, k=65),
                           edge_tail_plain(*args, k=65))
        assert edge_tail.launches == before


@pytest.mark.parametrize("dtype", ["float32", "mixed_edge"])
def test_fused_eval_at_nk_80_matches_jax(dtype, monkeypatch):
    """The serving forward at --nk 80 (k = 40 in both EdgeBlocks; bs 2,
    N 128, full widths, BatchNorm statistics randomized) against the JAX
    package's `generator_forward_eval`, jitted, with `edge_tail_pallas` in
    interpret mode: within 2e-4. Both compute in f32 whatever `dtype`
    says. The port selects in the exact order (SPGAN_KNN_SELECT=exact), as
    the JAX package selects on the CPU, and its picks equal JAX's kNN on
    the port's EdgeConv inputs. Under jit XLA fuses the JAX forward's dense
    and AdaIN layers into other sums, which moves EdgeConv2's input by
    about 1e-6, and at 40 of 128 points one point's picks then part at a
    near-tie (its three coordinates 3.2e-3 apart, every other one within
    3e-7): so JAX's EdgeConv2 takes the port's picks."""
    monkeypatch.setenv("SPGAN_KNN_SELECT", "exact")
    cfg = Config(np=128, nk=80, dtype=dtype)
    G = Generator(cfg, seed=1)
    randomize_bn(G, seed=2)
    x, z = template_batch(128, 2), tiled_codes(2, 128, cfg.nz, seed=3)
    seen = []
    real = fused_eval.edge_features

    def recording(xx, k, idx=None):
        ee, picks = real(xx, k, idx=idx, return_idx=True)
        seen.append((xx.numpy().copy(), picks.numpy().copy()))
        return ee
    monkeypatch.setattr(fused_eval, "edge_features", recording)
    with torch.inference_mode():
        ours = generator_forward_eval(G, torch.from_numpy(x),
                                      torch.from_numpy(z)).numpy()
    for xx, picks in seen:
        theirs = np.asarray(jax.jit(lambda v: jknn(v, 40, exclude_self=True))(
            jnp.asarray(xx)))
        np.testing.assert_array_equal(np.sort(picks, -1),
                                      np.sort(theirs, -1))
    j_real = jedge.edge_features

    def pinned(xx, k, idx=None, **kw):
        if idx is None and xx.shape[-1] == seen[1][0].shape[-1]:
            idx = jnp.asarray(seen[1][1])
        return j_real(xx, k, idx=idx, **kw)
    monkeypatch.setattr(jedge, "edge_features", pinned)
    jcfg = JaxConfig(np=128, nk=80, dtype=dtype)
    fwd = jax.jit(lambda v, x, z: jfused_forward(jcfg, v, x, z))
    with pltpu.force_tpu_interpret_mode():
        theirs = np.asarray(fwd(jax_vars(G), jnp.asarray(x),
                                jnp.asarray(z)))
    assert ours.shape == (2, 128, 3) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, rtol=F32_TOL, atol=F32_TOL)
