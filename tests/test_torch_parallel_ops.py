"""The port's point-sharded ops (`sp_gan_tpu_torch/parallel/points.py`),
with the points of [2, 64, 3] clouds cut over 2 and over 4 gloo ranks,
against the JAX functions on the 8-device CPU mesh of tests/conftest.py
(`tests/test_points_sharding.py`'s shapes, k 4) and against the port's own
unsharded functions; WGAN-GP and CutMix on a 2 x 2 (data, points) mesh
against their dense calls.

All ranks run in one spawn for the module (`torch_parallel_workers.py`).
The EMD auction runs on clouds on a grid of quarters, whose squared
distances are exact in f32 in any order of operations, so that both
packages bid on the same numbers and the assignments can be held equal.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as PS

import torch_parallel_workers as workers
from sp_gan_tpu.parallel import make_mesh
from sp_gan_tpu.parallel import points as jpoints
from sp_gan_tpu_torch.losses.cutmix import cutmix
from sp_gan_tpu_torch.losses.gp import wgan_gp
from sp_gan_tpu_torch.ops.edge import edge_features
from sp_gan_tpu_torch.ops.emd import auction_scaled_jacobi
from sp_gan_tpu_torch.ops.pairwise import knn_indices, pairwise_sqdist

torch.set_num_threads(2)   # six test workers share the host's cores

K = 4
SPLITS = (2, 4)


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {
        "x": rng.standard_normal((2, 64, 3)).astype(f32),
        "y": rng.standard_normal((2, 64, 3)).astype(f32),
        # the auction's clouds: quarters in [-2, 2]
        "gx": (rng.integers(-8, 9, (2, 64, 3)) / 4).astype(f32),
        "gy": (rng.integers(-8, 9, (2, 64, 3)) / 4).astype(f32),
        "k": K,
        "w_edge": rng.standard_normal((2, 64, K, 6)).astype(f32),
        "h": rng.standard_normal((2, 64, 5)).astype(f32),
        # the max held by several points, on one rank and across ranks
        "h_tie": np.floor(rng.uniform(0, 3, (2, 64, 5))).astype(f32),
        "w_max": rng.standard_normal((2, 5)).astype(f32),
        "real": rng.standard_normal((4, 64, 3)).astype(f32),
        "fake": (0.5 * rng.standard_normal((4, 64, 3))).astype(f32),
        "alpha": rng.uniform(size=(4, 1, 1)).astype(f32),
        "lam": rng.uniform(size=4).astype(f32),
        "anchor": rng.integers(0, 64, 4),
        "flip": np.array(False),
    }


@pytest.fixture(scope="module")
def run():
    inp = _inputs()
    ranks = workers.spawn(4, "ops", inp)
    return inp, ranks


def whole(ranks, key, P, axis=1):
    """The points of ranks 0..P-1 (one group) joined along `axis`; ranks
    2-3 of the 2-way split ran the same and must agree."""
    if P == 2:
        for a, b in zip(ranks[:2], ranks[2:]):
            np.testing.assert_array_equal(a[f"2/{key}"], b[f"2/{key}"])
    return np.concatenate([r[f"{P}/{key}"] for r in ranks[:P]], axis=axis)


def jax_mesh(P):
    return make_mesh((P,), ("points",))


def jax_local(fn, P, n_in=1, out=PS(None, "points")):
    """`fn` of the JAX rank's blocks under shard_map over P devices."""
    return shard_map(fn, mesh=jax_mesh(P),
                     in_specs=(PS(None, "points", None),) * n_in,
                     out_specs=out, check_vma=False)


@pytest.mark.parametrize("P", SPLITS)
def test_knn_indices_equal_jax(run, P):
    inp, ranks = run
    got = whole(ranks, "knn", P)
    ref = np.asarray(jpoints.knn_pointsharded(jnp.asarray(inp["x"]), K,
                                              jax_mesh(P)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, knn_indices(
        torch.from_numpy(inp["x"]), K).numpy())


@pytest.mark.parametrize("P", SPLITS)
def test_edge_features_and_gradient(run, P):
    """The edges equal JAX's and the port's unsharded ones; the gradient of
    a weighted sum through the gather equals JAX's through shard_map."""
    inp, ranks = run
    x = jnp.asarray(inp["x"])
    got = whole(ranks, "edge", P)
    np.testing.assert_allclose(got, np.asarray(
        jpoints.edge_features_pointsharded(x, K, jax_mesh(P))),
        rtol=0, atol=1e-6)
    xt = torch.from_numpy(inp["x"]).requires_grad_(True)
    ee = edge_features(xt, K)
    np.testing.assert_allclose(got, ee.detach().numpy(), rtol=0, atol=1e-6)
    w = jnp.asarray(inp["w_edge"])
    gj = jax.grad(lambda v: jnp.sum(jpoints.edge_features_pointsharded(
        v, K, jax_mesh(P)) * w))(x)
    np.testing.assert_allclose(whole(ranks, "edge_grad", P), np.asarray(gj),
                               rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("P", SPLITS)
def test_chamfer_minima_equal_jax(run, P):
    inp, ranks = run
    d1, d2 = jpoints.chamfer_pointsharded(jnp.asarray(inp["x"]),
                                          jnp.asarray(inp["y"]), jax_mesh(P))
    np.testing.assert_allclose(whole(ranks, "d1", P), np.asarray(d1),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(whole(ranks, "d2", P), np.asarray(d2),
                               rtol=0, atol=1e-5)
    d = pairwise_sqdist(torch.from_numpy(inp["x"]),
                        torch.from_numpy(inp["y"]))
    np.testing.assert_array_equal(whole(ranks, "d1", P),
                                  d.amin(-1).numpy())
    np.testing.assert_array_equal(whole(ranks, "d2", P),
                                  d.amin(-2).numpy())


@pytest.mark.parametrize("P", SPLITS)
def test_emd_auction_round_for_round(run, P):
    """Assignments equal to the port's unsharded scaled Jacobi auction on
    the same distances (pair by pair) and to JAX's point-sharded auction;
    distances and the gradient (to xyz1 only, 2 (x - y[sigma])) equal."""
    inp, ranks = run
    gx, gy = inp["gx"], inp["gy"]
    asg = whole(ranks, "emd_asg", P)
    d = pairwise_sqdist(torch.from_numpy(gx), torch.from_numpy(gy))
    ref = np.stack([auction_scaled_jacobi(d[b], 0.005, 5000, 4).numpy()
                    for b in range(2)])
    np.testing.assert_array_equal(asg, ref)
    assert all(len(set(a)) == 64 for a in asg)          # a bijection
    jd, ja = jax_local(
        lambda a, b: jpoints.emd_auction_local(a, b, eps=0.005, iters=5000),
        P, 2, (PS(None, "points"),) * 2)(jnp.asarray(gx), jnp.asarray(gy))
    np.testing.assert_array_equal(asg, np.asarray(ja))
    matched = np.take_along_axis(gy, asg[..., None].astype(np.int64), 1)
    np.testing.assert_array_equal(whole(ranks, "emd_dist", P),
                                  ((gx - matched) ** 2).sum(-1))
    np.testing.assert_allclose(whole(ranks, "emd_gx", P),
                               2 * (gx - matched), rtol=0, atol=1e-6)
    assert all(r[f"{P}/emd_gy_none"] for r in ranks)


@pytest.mark.parametrize("P", SPLITS)
@pytest.mark.parametrize("name", ["h", "h_tie"])
def test_global_max_routes_as_unsharded_max(run, P, name):
    """The value equals the max over all points; the gradient of a
    weighted sum of it is the unsharded `amax`'s, split evenly over every
    point that holds the max, wherever it lies (h_tie has maxima on several
    ranks); without ties it is also JAX's."""
    inp, ranks = run
    h = torch.from_numpy(inp[name]).requires_grad_(True)
    g = h.amax(dim=1)
    (g * torch.from_numpy(inp["w_max"])).sum().backward()
    for r in ranks[:P]:
        np.testing.assert_array_equal(r[f"{P}/{name}_max"],
                                      g.detach().numpy())
    np.testing.assert_allclose(whole(ranks, f"{name}_grad", P),
                               h.grad.numpy(), rtol=0, atol=1e-7)
    if name == "h":
        w = jnp.asarray(inp["w_max"])
        gj = jax.grad(lambda v: jnp.sum(jax_local(
            lambda a: jpoints.global_max_points(a), P,
            out=PS())(v) * w))(jnp.asarray(inp["h"]))
        np.testing.assert_allclose(whole(ranks, "h_grad", P),
                                   np.asarray(gj), rtol=0, atol=1e-7)


@pytest.mark.parametrize("mapping", [False, True])
def test_sharded_gp_matches_dense(run, mapping):
    """WGAN-GP on the 2 x 2 mesh (a critic with whole-batch statistics,
    its per-cloud sum over the points) against the dense call: the
    penalty and its gradient in the critic's weight, averaged over the
    ranks as the training step averages them."""
    inp, ranks = run
    w = torch.tensor(1.3, requires_grad=True)
    gp = wgan_gp(workers.toy_critic(w), torch.from_numpy(inp["real"]),
                 torch.from_numpy(inp["fake"]),
                 torch.from_numpy(inp["alpha"]), 10.0, emd_pairing=mapping,
                 emd_iters=100)
    (gw,) = torch.autograd.grad(gp, [w])
    for r in ranks:
        np.testing.assert_allclose(r[f"gp{int(mapping)}"], float(gp.detach()),
                                   rtol=2e-5)
        np.testing.assert_allclose(r[f"gp{int(mapping)}_dw"], float(gw),
                                   rtol=2e-4)


def test_sharded_cutmix_matches_dense(run, monkeypatch):
    """CutMix on the 2 x 2 mesh against the dense call: the mask and
    map_s equal; the mixed clouds equal where the dense call aligns by
    the scaled Jacobi auction (the sharded solver's unsharded twin, which
    kernel E's block Gauss-Seidel auction is not)."""
    inp, ranks = run
    monkeypatch.setattr(importlib.import_module(
        "sp_gan_tpu_torch.losses.cutmix"), "emd_auction", workers.jacobi_emd)
    mixed, map_s, mask = cutmix(
        torch.from_numpy(inp["real"]), torch.from_numpy(inp["fake"]),
        torch.from_numpy(inp["lam"]), torch.from_numpy(inp["anchor"]),
        torch.tensor(False), emd_iters=50)
    for key, ref in (("mask", mask), ("mix", mixed)):
        got = np.concatenate([np.concatenate(
            [ranks[2 * d + p][key] for p in range(2)], axis=1)
            for d in range(2)], axis=0)
        np.testing.assert_array_equal(got, ref.numpy())
    got = np.concatenate([ranks[0]["map_s"], ranks[2]["map_s"]])
    np.testing.assert_allclose(got, map_s.numpy(), rtol=1e-6)
