"""The port's expansion penalty (`sp_gan_tpu_torch/ops/expansion.py`)
against the JAX package's on the CPU: Prim's parents and the assignment
exactly, distances, mean MST lengths and gradients within 2e-4. The
gradient is the JAX custom VJP's: `2 g (x - x[assign])` on penalized
points; `mean_mst_length` gets none in either package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_gan_tpu.ops import expansion as je
from sp_gan_tpu_torch.ops import expansion as pe

torch.set_num_threads(2)   # six test workers share the host's cores

TOL = 2e-4


def clustered(seed, b, n):
    """Tight clusters far apart: some MST edges are many times the mean,
    so every primitive has penalized points."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-1, 1, (b, 4, 3))
    pick = rng.integers(0, 4, (b, n))
    x = np.take_along_axis(centres, pick[..., None], 1) \
        + 0.05 * rng.standard_normal((b, n, 3))
    return x.astype(np.float32)


def chain(n, repeats=2):
    """Points on a line at integer spacing, each repeated: Prim meets
    equal distances every round."""
    x = np.zeros((1, n, 3), np.float32)
    x[0, :, 0] = np.arange(n) // repeats
    x[0, -1, 0] = 3 * n                       # one outlier
    return x


CASES = {"clustered 2x128/32": (clustered(0, 2, 128), 32, 1.5),
         "clustered 1x256/64": (clustered(1, 1, 256), 64, 1.5),
         "clustered alpha 1.2": (clustered(2, 3, 64), 16, 1.2),
         "tied chain": (chain(32), 16, 1.5)}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_equal(case):
    x, P, alpha = CASES[case]
    jd, ja, jm = je.expansion_penalty(jnp.asarray(x), P, alpha)
    td, ta, tm = pe.expansion_penalty(torch.from_numpy(x), P, alpha)
    assert ta.dtype == torch.int32 and tm.shape == (x.shape[0],)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert (ta >= 0).any()
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=TOL)


@pytest.mark.parametrize("case", ["clustered 2x128/32", "tied chain"])
def test_prim_tree_equal(case):
    x, P, _ = CASES[case]
    prims = x.reshape(-1, P, 3)
    jp, jl = jax.vmap(je._prim_mst)(jnp.asarray(prims))
    tp, tl = pe._prim_mst(torch.from_numpy(prims))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    assert (tp[:, 0] == -1).all() and (tl[:, 0] == 0).all()


@pytest.mark.parametrize("case", ["clustered 2x128/32",
                                  "clustered alpha 1.2", "tied chain"])
def test_gradient_equal(case):
    x, P, alpha = CASES[case]
    w = np.random.default_rng(3).standard_normal(x.shape[:2]) \
        .astype(np.float32)

    def loss(xx):
        d, _, m = je.expansion_penalty(xx, P, alpha)
        return (d * w).sum() + m.sum()
    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    d, _, m = pe.expansion_penalty(tx, P, alpha)
    ((d * torch.from_numpy(w)).sum() + m.sum()).backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=TOL,
                               atol=TOL * np.abs(want).max())
    assert np.abs(want).max() > 0


def test_mean_mst_length_carries_no_gradient():
    x, P, alpha = CASES["clustered 2x128/32"]
    want = np.asarray(jax.grad(lambda xx: je.expansion_penalty(
        xx, P, alpha)[2].sum())(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    m = pe.expansion_penalty(tx, P, alpha)[2]
    assert m.requires_grad                    # differentiable in shape
    m.sum().backward()
    assert not want.any() and not tx.grad.any()


def test_loss_and_refusal():
    x, P, alpha = CASES["clustered 1x256/64"]
    want = float(je.expansion_loss(jnp.asarray(x), P, alpha))
    got = float(pe.expansion_loss(torch.from_numpy(x), P, alpha))
    assert got == pytest.approx(want, rel=TOL)
    with pytest.raises(ValueError, match="multiple"):
        pe.expansion_penalty(torch.zeros(1, 30, 3), 16)
