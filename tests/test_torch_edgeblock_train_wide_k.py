"""Kernels I-L past k = 32 (33 <= k <= 64, the generator's --nk up to 128)
on the CPU, where the port runs their plain versions, against the JAX
package: `edge_train_stats2_plain` and `edge_train_bwd{1,2,3}_plain`
against `_stats2_pallas` and `edge_block_train_backward` in Pallas
interpret mode at k = 33, 40 and 64, on f32 and bf16 edges of a small
block (C 8, F 64), at the tolerances of tests/test_torch_edgeblock_train.py
(the fused path's generator and step at --nk 80 are
tests/test_torch_fused_train_wide_k.py's). The JAX functions run jitted,
one compile a (k, dtype): an eager interpret-mode kernel followed by eager
JAX ops can wait forever on its host callback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import test_torch_edgeblock_train as ebt_base
from sp_gan_tpu.ops import edge_features as j_edge_features
from sp_gan_tpu.ops.pairwise import knn_indices as j_knn
from sp_gan_tpu.ops.pallas import edgeblock_train as jebt
from sp_gan_tpu_torch.compat import trees
from sp_gan_tpu_torch.ops.kernels import edgeblock_train as kebt

torch.set_num_threads(2)   # six test workers share the host's cores

WIDE_K = (33, 40, 64)
# a small block: B, N (at least the widest k), C, F (F2 = F / 2)
SB, SN, SC, SF = 1, 96, 8, 64
F32_STATS_TOL, F32_GRAD_TOL = 2e-4, 1e-3


def jax_i_to_l(params, ee: np.ndarray, cot: np.ndarray, a1: np.ndarray,
               k: int, bf16: bool) -> dict:
    """Kernel I's Pallas function on the port's a1, and the JAX backward
    (its three Pallas passes) on JAX's own statistics, jitted in interpret
    mode, as numpy: I's sums and the outputs of passes 1-3 by the names of
    `ebt_base.PASS_OUTPUTS`."""
    e = jnp.asarray(ee)
    if bf16:
        e = e.astype(jnp.bfloat16)

    def run(p, e, a1, c):
        sums2 = jebt._stats2_pallas(e, p["conv_w1"]["kernel"], a1,
                                    p["conv_w2"]["kernel"], k)
        stats = jebt.edge_block_train_stats(p, e, k)
        d, d_ee = jebt.edge_block_train_backward(p, e, stats, c, k)
        return sums2, d, d_ee.astype(jnp.float32)

    with pltpu.force_tpu_interpret_mode():
        sums2, d, d_ee = jax.device_get(jax.jit(run)(
            params, e, jnp.asarray(a1), jnp.asarray(cot)))
    return {"stats2": np.asarray(sums2),
            "sums": np.stack([d["bn_w2"]["bias"], d["bn_w2"]["scale"],
                              d["bn_x"]["bias"], d["bn_x"]["scale"]]),
            "d_wout": d["out_kernel"], "d_bout": d["out_bias"],
            "s1": np.stack([d["bn_w1"]["bias"], d["bn_w1"]["scale"]]),
            "d_w2": d["conv_w2"]["kernel"], "d_ee": np.asarray(d_ee),
            "d_w1": d["conv_w1"]["kernel"], "d_wx": d["conv_x"]["kernel"]}


@pytest.fixture(scope="module")
def i_to_l():
    """{k: ({bf16: the plain versions' outputs}, {bf16: JAX's})} on one
    small block and edge tensor a k, bf16 False for f32 edges."""
    out = {}
    for k in WIDE_K:
        rng = np.random.default_rng(k)
        x = jnp.asarray(rng.standard_normal((SB, SN, SC)).astype(np.float32))
        ee = np.array(j_edge_features(x, k, idx=j_knn(x, k)))
        cot = rng.standard_normal((SB, SN, SF)).astype(np.float32)
        blk = ebt_base.block(k, SC, SF, k)
        params, _ = trees(blk)
        ours = {}
        for bf16 in (False, True):
            e = torch.from_numpy(ee)
            if bf16:
                e = e.to(torch.bfloat16)
            inp = ebt_base.train_inputs(blk, e, torch.from_numpy(cot), k)
            res = ebt_base.plain_j_k_l(inp)
            res["stats2"] = kebt.edge_train_stats2_plain(
                e, inp["w1"], inp["a1"], inp["w2"], k)
            res["a1"] = inp["a1"].numpy()
            ours[bf16] = {n: np.asarray(v) for n, v in res.items()}
        theirs = {bf16: jax_i_to_l(params, ee, cot, ours[bf16]["a1"], k,
                                   bf16) for bf16 in (False, True)}
        out[k] = (ours, theirs)
    return out


# the outputs of each kernel's plain version, by kernel
KERNEL_OUTPUTS = {"I": ("stats2",), **ebt_base.PASS_OUTPUTS}


@pytest.mark.parametrize("kernel", list(KERNEL_OUTPUTS))
@pytest.mark.parametrize("k", WIDE_K)
def test_plain_matches_pallas_f32(i_to_l, k, kernel):
    """f32 edges: kernel I's sums within 2e-4 of their max-abs (the file's
    statistics tolerance) and each output of J (the BN2 and BNx sums,
    d_wout, d_bout), K (the BN1 sums, d_w2) and L (d_ee, d_w1, d_wx)
    within 1e-3 of its max-abs (its gradient tolerance). Measured: I
    within 1.8e-7 of the max-abs, J-L within 1.1e-6."""
    ours, theirs = i_to_l[k]
    tol = F32_STATS_TOL if kernel == "I" else F32_GRAD_TOL
    for name in KERNEL_OUTPUTS[kernel]:
        ebt_base._close(ours[False][name], theirs[False][name], tol,
                        f"{name} at k={k}")


@pytest.mark.parametrize("kernel", list(KERNEL_OUTPUTS))
@pytest.mark.parametrize("k", WIDE_K)
def test_plain_matches_pallas_bf16(i_to_l, k, kernel):
    """bf16 edges: each output no farther (relative L2) from the JAX
    float32 result than 1.1 times JAX's bf16 result is, plus 1e-6 (d_bout
    is a sum of d_out alone, which no bf16 rounding reaches); and bf16
    rounding is there to see in JAX's own d_ee. Measured: every other
    distance 0.9994 to 1.0002 times JAX's."""
    ours, theirs = i_to_l[k]
    for name in KERNEL_OUTPUTS[kernel]:
        exact = np.asarray(theirs[False][name], np.float32)
        assert ebt_base.rel(ours[True][name], exact) <= \
            ebt_base.BF16_FACTOR * ebt_base.rel(
                np.asarray(theirs[True][name], np.float32), exact) + 1e-6, \
            f"{name} at k={k}"
    assert ebt_base.rel(theirs[True]["d_ee"], theirs[False]["d_ee"]) > 1e-4
