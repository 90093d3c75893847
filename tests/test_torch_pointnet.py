"""The port's point-network layers (`sp_gan_tpu_torch/nn/pointnet.py`)
against the JAX package's flax modules on the CPU.

Each flax module is initialised from a key, run once in training mode
(which moves its `batch_stats`), and its `params` and `batch_stats` are
carried into the port module by `compat.pointnet_state_from_jax` with
`strict=True`. Then on the same numpy inputs: the training-mode outputs
and the updated running statistics, and the eval-mode outputs on the
carried statistics, within 2e-4 (f32, the ROADMAP's tolerance); the
PointTransformer layer's gradients against `jax.grad` of the same scalar
within 2e-4 of each tensor's largest entry.

Ball queries keep their inputs clear of the radius: every squared distance
from a group centre to a point lies at least CLEAR from r^2 (f64), well
above the f32 rounding of either package's distance (|x| <= sqrt(3)).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_gan_tpu.nn import pointnet as jpn
from sp_gan_tpu_torch.compat import pointnet_state_from_jax, pointnet_trees
from sp_gan_tpu_torch.nn import pointnet as ppn
from sp_gan_tpu_torch.ops.sampling import farthest_point_sample

torch.set_num_threads(2)   # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
CLEAR = 1e-5
B, N, C = 2, 128, 5


def cloud(seed, n=N, b=B):
    return np.random.default_rng(seed).uniform(
        -1, 1, (b, n, 3)).astype(np.float32)


def feats(seed, n=N, c=C, b=B):
    return np.random.default_rng(seed).standard_normal(
        (b, n, c)).astype(np.float32)


def assert_clear(xyz, npoint, radii):
    """Every centre-to-point squared distance of the FPS centres at least
    CLEAR from each r^2."""
    idx = farthest_point_sample(torch.from_numpy(xyz), npoint).numpy()
    centres = np.take_along_axis(xyz, idx[..., None].astype(np.int64), 1)
    d = ((centres.astype(np.float64)[:, :, None]
          - xyz.astype(np.float64)[:, None]) ** 2).sum(-1)
    for r in radii:
        assert np.abs(d - r * r).min() > CLEAR, r


def carried(jmod, variables, pmod):
    pmod.load_state_dict(pointnet_state_from_jax(
        variables["params"], variables.get("batch_stats", {})), strict=True)
    return pmod


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=tol, atol=tol)


def run_both(jmod, pmod, args):
    """flax init, one training call (mutating batch_stats), the carry;
    the port's training call against flax's, the running statistics
    against the mutated ones, then both in eval mode on them."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    v0 = jmod.init(jax.random.PRNGKey(3), *jargs, train=True)
    carried(jmod, v0, pmod)
    want, mut = jax.jit(lambda v, *a: jmod.apply(
        v, *a, train=True, mutable=["batch_stats"]))(v0, *jargs)
    got = pmod(*targs, train=True)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        close(g, w)
    stats = pointnet_trees(pmod)[1]
    flat_p = jax.tree_util.tree_leaves_with_path(stats)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(
        jax.device_get(mut["batch_stats"])))
    assert len(flat_p) == len(flat_j) > 0
    for path, leaf in flat_p:
        close(torch.from_numpy(leaf), flat_j[path])
    v1 = {"params": v0["params"], "batch_stats": mut["batch_stats"]}
    want = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(v1, *jargs)
    with torch.no_grad():
        got = pmod(*targs, train=False)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        close(g, w)


class TestSetAbstraction:
    @pytest.mark.parametrize("with_feats,use_xyz", [
        (True, True), (True, False), (False, True)])
    def test_ball_groups(self, with_feats, use_xyz):
        xyz = cloud(0)
        assert_clear(xyz, 16, [0.5])
        f = feats(1) if with_feats else None
        jm = jpn.SetAbstraction(npoint=16, radius=0.5, nsample=8,
                                mlp=(16, 24), use_xyz=use_xyz)
        pm = ppn.SetAbstraction(16, 0.5, 8, (16, 24), use_xyz=use_xyz,
                                in_channels=C if with_feats else 0,
                                seed=None)
        run_both(jm, pm, [xyz, f])

    def test_group_all(self):
        jm = jpn.SetAbstraction(npoint=1, radius=0, nsample=0, mlp=(16,),
                                group_all=True)
        pm = ppn.SetAbstraction(1, 0, 0, (16,), group_all=True,
                                in_channels=C, seed=None)
        run_both(jm, pm, [cloud(2), feats(3)])

    def test_msg(self):
        xyz = cloud(4)
        radii = (0.3, 0.6)
        assert_clear(xyz, 16, radii)
        jm = jpn.SetAbstractionMSG(npoint=16, radii=radii, nsamples=(4, 8),
                                   mlps=((8, 16), (8, 12)))
        pm = ppn.SetAbstractionMSG(16, radii, (4, 8), ((8, 16), (8, 12)),
                                   in_channels=C, seed=None)
        run_both(jm, pm, [xyz, feats(5)])


class TestFeaturePropagation:
    @pytest.mark.parametrize("sparse,skip", [(16, True), (16, False),
                                             (1, True)])
    def test_interpolation(self, sparse, skip):
        xyz1, xyz2 = cloud(6), cloud(7, n=sparse)
        f1 = feats(8) if skip else None
        f2 = feats(9, n=sparse, c=7)
        jm = jpn.FeaturePropagation(mlp=(16, 8))
        pm = ppn.FeaturePropagation((16, 8), in_channels=7 + C * skip,
                                    seed=None)
        run_both(jm, pm, [xyz1, xyz2, f1, f2])


class TestPointConv:
    @pytest.mark.parametrize("with_feats", [True, False])
    def test_density_weighted(self, with_feats):
        f = feats(11) if with_feats else None
        jm = jpn.PointConv(npoint=16, nsample=8, mlp=(8, 12), bandwidth=0.2)
        pm = ppn.PointConv(16, 8, (8, 12), 0.2,
                           in_channels=C if with_feats else 0, seed=None)
        run_both(jm, pm, [cloud(10), f])


class TestPointTransformer:
    def _pair(self, in_channels=16, dim=16):
        x = feats(12, c=in_channels)
        pos = cloud(13)
        jm = jpn.PointTransformerLayer(dim=dim, pos_hidden=8,
                                       attn_hidden_mult=2, k=6)
        v = jm.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(pos))
        pm = carried(jm, v, ppn.PointTransformerLayer(
            dim, 8, 2, 6, in_channels=in_channels, seed=None))
        return jm, v, pm, x, pos

    @pytest.mark.parametrize("in_channels", [16, 10])
    def test_forward(self, in_channels):
        jm, v, pm, x, pos = self._pair(in_channels)
        want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(pos))
        close(pm(torch.from_numpy(x), torch.from_numpy(pos)), want)
        assert not pointnet_trees(pm)[1]          # no BatchNorm

    def test_gradients(self):
        jm, v, pm, x, pos = self._pair()
        w = feats(14, c=16)

        def loss(params, xx, pp):
            return (jm.apply({"params": params}, xx, pp) * w).sum()
        gp, gx, gpos = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            v["params"], jnp.asarray(x), jnp.asarray(pos))
        tx = torch.from_numpy(x).requires_grad_(True)
        tpos = torch.from_numpy(pos).requires_grad_(True)
        (pm(tx, tpos) * torch.from_numpy(w)).sum().backward()
        want = {"x": gx, "pos": gpos, **{
            ".".join(k.key for k in path): g for path, g in
            jax.tree_util.tree_leaves_with_path(gp)}}
        got = {"x": tx.grad, "pos": tpos.grad,
               **dict(pm.named_parameters())}
        assert set(got) == set(want)
        for name, g in got.items():
            g = g if name in ("x", "pos") else g.grad
            ref = np.asarray(want[name])
            close(g, ref, TOL * max(1.0, np.abs(ref).max()))


class TestCarry:
    def test_names_are_the_flax_paths(self):
        """Every module's state dict is the flax tree's flattened paths,
        and `pointnet_trees` gives the tree back."""
        jm = jpn.PointConv(npoint=8, nsample=4, mlp=(8, 8))
        xyz, f = jnp.asarray(cloud(15)), jnp.asarray(feats(16))
        v = jm.init(jax.random.PRNGKey(0), xyz, f, train=True)
        pm = carried(jm, v, ppn.PointConv(8, 4, (8, 8), in_channels=C))
        params, stats = pointnet_trees(pm)
        for ours, theirs in ((params, v["params"]),
                             (stats, v["batch_stats"])):
            a = jax.tree_util.tree_leaves_with_path(ours)
            b = jax.tree_util.tree_leaves_with_path(jax.device_get(theirs))
            assert [p for p, _ in a] == [p for p, _ in b]
            for (_, x), (_, y) in zip(a, b):
                np.testing.assert_array_equal(x, y)

    def test_seeded_init_is_flax_default(self):
        """`seed` draws LeCun normal kernels (truncated at 2 std) and zero
        biases; BatchNorm starts at scale 1, bias 0, mean 0, var 1."""
        pm = ppn.SetAbstraction(4, 0.2, 4, (256, 256), in_channels=61,
                                seed=5)
        k = pm.mlp2.kernel.detach().numpy()
        std = np.sqrt(1 / 256) / 0.87962566103423978
        assert np.abs(k).max() <= 2 * std
        assert abs(k.std() / (std * 0.87962566103423978) - 1) < 0.02
        assert pm.mlp1.kernel.shape == (64, 256)
        assert not pm.mlp1.bias.detach().any()
        assert torch.equal(pm.bn1.var, torch.ones(256))
        again = ppn.SetAbstraction(4, 0.2, 4, (256, 256), in_channels=61,
                                   seed=5)
        assert torch.equal(again.mlp1.kernel, pm.mlp1.kernel)


PORTED = ("sp_gan_tpu_torch.ops.sampling", "sp_gan_tpu_torch.ops.grouping",
          "sp_gan_tpu_torch.ops.expansion",
          "sp_gan_tpu_torch.losses.point_aux",
          "sp_gan_tpu_torch.losses.shape_preserving",
          "sp_gan_tpu_torch.nn.pointnet")


@pytest.fixture(scope="module")
def imported():
    """The modules one fresh interpreter holds after importing PORTED."""
    code = (f"import sys, importlib\n"
            f"for m in {PORTED!r}: importlib.import_module(m)\n"
            "print('\\n'.join(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return set(r.stdout.split())


@pytest.mark.parametrize("module", PORTED)
def test_imports_neither_jax_nor_the_jax_package(module, imported):
    assert module in imported
    bad = [m for m in imported
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "sp_gan_tpu")]
    assert not bad, bad
