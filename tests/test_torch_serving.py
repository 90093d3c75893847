"""The PyTorch port's serving path against the JAX package's: Manipulator,
checkpoint reading, the generate CLI, device choice, and the port's import
boundary (no JAX, nothing of sp_gan_tpu).

The JAX Manipulator serves every configuration that `supports_fused`
accepts through `generator_forward_eval` wherever Pallas runs, i.e. on a
TPU: kNN by `knn_pallas` and `knn_edge_pallas`, each EdgeBlock's tail by
`edge_tail_pallas`. The reference here is that path, jitted, with
`pallas_enabled` switched on and the three kernels in interpret mode.

Checkpoints are written by the JAX package's own `save_checkpoint` into
tmp_path, holding weights drawn by the port from a seed.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from sp_gan_tpu.config import Config as JaxConfig
from sp_gan_tpu.data.augment import normalize_point_cloud as jnormalize
from sp_gan_tpu.data.sphere import sphere_template as jsphere_template
from sp_gan_tpu.manipulate import Manipulator as JaxManipulator
from sp_gan_tpu.nn import fused_eval as jfused
from sp_gan_tpu.ops import dispatch as jdispatch
from sp_gan_tpu.ops.pairwise import knn_indices as jknn_indices
from sp_gan_tpu.train.checkpoint import save_checkpoint
from sp_gan_tpu.train.state import TrainState
from sp_gan_tpu_torch import generate as generate_cli
from sp_gan_tpu_torch.compat import generator_state_from_jax, generator_trees
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.manipulate import (Manipulator, from_checkpoint,
                                         normalize_point_cloud)
from sp_gan_tpu_torch.nn.generator import Generator
from sp_gan_tpu_torch.ops.kernels import knn_edge_plain
from sp_gan_tpu_torch.train.checkpoint import latest_checkpoint, load_generator

torch.set_num_threads(2)   # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 256
CFG_KW = dict(np=N)


@pytest.fixture(autouse=True)
def exact_selection(monkeypatch):
    # the JAX generator on the CPU selects neighbors with the exact XLA top-k
    monkeypatch.setenv("SPGAN_KNN_SELECT", "exact")


@pytest.fixture(scope="module")
def weights():
    """(g_params, g_stats, g_ema) numpy trees drawn by the port."""
    params, stats = generator_trees(Generator(Config(**CFG_KW), seed=11))
    ema, _ = generator_trees(Generator(Config(**CFG_KW), seed=12))
    return params, stats, ema


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, weights):
    """A run directory with config.json and ckpt_epoch_{2,10}.pkl written
    by the JAX package."""
    params, stats, ema = weights
    d = tmp_path_factory.mktemp("run")
    for epoch in (2, 10):
        state = TrainState(g_params=params, g_stats=stats, d_params={},
                           d_stats={}, g_opt=(), d_opt=(), g_ema=ema,
                           step=jnp.int32(epoch), rng=jax.random.PRNGKey(0))
        save_checkpoint(str(d), state, epoch, cfg=JaxConfig(**CFG_KW))
    return d


@pytest.fixture
def jax_served(monkeypatch):
    """fn(params, stats, z) -> (clouds, EdgeConv2's input) of the JAX
    Manipulator's TPU path, see the module docstring."""
    seen = []
    block_eval = jfused.edge_block_eval

    def recording(p, s, x, k, idx=None):
        seen.append(x)
        return block_eval(p, s, x, k, idx=idx)

    monkeypatch.setattr(jfused, "edge_block_eval", recording)
    monkeypatch.setattr(jdispatch, "pallas_enabled", lambda: True)
    jcfg = JaxConfig(**CFG_KW)
    fwd = jax.jit(lambda v, x, z: (jfused.generator_forward_eval(
        jcfg, v, x, z), seen[-1]))
    sphere = jnp.asarray(jsphere_template(N))

    def run(params, stats, z):
        x = jnp.broadcast_to(sphere[None], (z.shape[0], N, 3))
        with pltpu.force_tpu_interpret_mode():
            out, x1 = fwd({"params": params, "batch_stats": stats}, x,
                          jnp.asarray(np.asarray(z)))
        return np.asarray(out), np.asarray(x1)

    return run


def assert_parity_up_to_knn_flips(man, z, ours, theirs, their_x1):
    """Per shape: the port's clouds `ours` equal the JAX clouds `theirs`
    within the f32 parity of 2e-4, unless the two packages pick different
    EdgeConv2 neighbors for that shape. EdgeConv2 selects on features that
    the two packages round differently (1e-6 relative), so a near-tie can
    swap, and the global max-pool then moves the whole shape. Every such
    swap must be a near-tie: exact distances within 1e-4 relative.
    `their_x1` is the JAX EdgeConv2's input."""
    got = {}
    hook = man.G.adain1.register_forward_hook(
        lambda m, a, o: got.__setitem__("x1", o.detach().clone()))
    man.forward(z)
    hook.remove()
    k = man.cfg.k
    ours_idx = knn_edge_plain(got["x1"], k, diff_only=True,
                              select_mode="exact")[1].numpy()
    x1 = np.asarray(their_x1, np.float64)
    their_idx = np.asarray(jknn_indices(jnp.asarray(their_x1), k))
    swapped = (ours_idx != their_idx).any(axis=(1, 2))
    for b, q, j in np.argwhere(ours_idx != their_idx):
        da = ((x1[b, q] - x1[b, ours_idx[b, q, j]]) ** 2).sum()
        dr = ((x1[b, q] - x1[b, their_idx[b, q, j]]) ** 2).sum()
        assert abs(da - dr) <= 1e-4 * max(da, dr), "not a near-tie"
    assert swapped.mean() <= 0.5, "near-tie swaps in most shapes"
    for b in np.flatnonzero(~swapped):
        np.testing.assert_allclose(ours[b], theirs[b], rtol=2e-4, atol=2e-4)


def _man(weights, device="cpu"):
    params, stats, _ = weights
    cfg = Config(**CFG_KW)
    G = Generator(cfg, seed=None)
    G.load_state_dict(generator_state_from_jax(params, stats), strict=True)
    return Manipulator(cfg, G, device=device)


class TestServingParity:
    def test_forward_matches_jax_manipulator(self, weights, jax_served):
        """Config() defaults at N=256 (`mixed_edge`, served in f32 by the
        fused path on both sides); measured 4.0e-7, no neighbor swaps."""
        params, stats, _ = weights
        z = np.broadcast_to(np.random.default_rng(0).standard_normal(
            (3, 1, 128)).astype(np.float32) * 0.2, (3, N, 128))
        man = _man(weights)
        assert man.fused
        ours = man.forward(z)
        theirs, their_x1 = jax_served(params, stats, z)
        assert ours.shape == (3, N, 3)
        assert_parity_up_to_knn_flips(man, z, ours, theirs, their_x1)

    def test_generate_is_normalized_jax_forward_of_its_codes(
            self, weights, jax_served):
        """generate(n=3, batch=2) draws batch b with seed `seed + 2b`; the
        same codes through the JAX Manipulator's TPU path, then the JAX
        package's normalization, give the same clouds."""
        params, stats, _ = weights
        man = _man(weights)
        pcs = man.generate(3, seed=5, batch=2)
        assert pcs.shape == (3, N, 3) and pcs.dtype == np.float32
        z = torch.cat([man.sample_codes(2, 5), man.sample_codes(1, 7)])
        theirs, their_x1 = jax_served(params, stats, z.numpy())
        ref = np.asarray(jnormalize(jnp.asarray(theirs)))
        assert_parity_up_to_knn_flips(man, z.numpy(), pcs, ref, their_x1)
        np.testing.assert_allclose(np.sqrt((pcs ** 2).sum(-1)).max(-1), 1.0,
                                   rtol=1e-6)

    def test_unfused_config_matches_jax_manipulator(self):
        """A configuration the fused path does not take (attn) is served by
        `Generator.forward`, as the JAX Manipulator serves it by
        `Generator.apply` on every backend; f32, measured 4.2e-6 in the
        generator tests, limit 2e-4."""
        cfg_kw = dict(np=N, dtype="float32", attn=True)
        G = Generator(Config(**cfg_kw), seed=13)
        with torch.no_grad():
            G.attn.gamma.fill_(0.5)
        params, stats = generator_trees(G)
        man = Manipulator(Config(**cfg_kw), G, device="cpu")
        assert not man.fused
        z = np.broadcast_to(np.random.default_rng(1).standard_normal(
            (2, 1, 128)).astype(np.float32) * 0.2, (2, N, 128))
        jman = JaxManipulator(JaxConfig(**cfg_kw), params, stats)
        np.testing.assert_allclose(man.forward(z),
                                   jman.forward(jnp.asarray(z)),
                                   rtol=2e-4, atol=2e-4)

    def test_normalize_matches_jax(self):
        pc = np.random.default_rng(1).standard_normal((2, 64, 3)) \
            .astype(np.float32) * 3 + 1
        np.testing.assert_allclose(
            normalize_point_cloud(torch.from_numpy(pc)).numpy(),
            np.asarray(jnormalize(jnp.asarray(pc))), rtol=1e-6, atol=1e-6)

    def test_codes(self, weights):
        man = _man(weights)
        z = man.sample_codes(4, seed=3)
        assert z.shape == (4, N, 128)
        assert torch.equal(z, z[:, :1].expand_as(z))
        assert torch.equal(z, man.sample_codes(4, seed=3))
        assert not torch.equal(z, man.sample_codes(4, seed=4))
        assert not torch.equal(man.sample_codes(1, 0, per_point=True)[0, 0],
                               man.sample_codes(1, 0, per_point=True)[0, 1])
        assert man.generate(0).shape == (0, N, 3)


class TestCheckpoints:
    def test_state_loads_strict_from_jax_checkpoint(self, run_dir, weights):
        path = latest_checkpoint(str(run_dir))
        assert path.endswith("ckpt_epoch_10.pkl")
        G = Generator(Config(**CFG_KW), seed=None)
        for use_ema, ref_seed in ((False, 11), (True, 12)):
            G.load_state_dict(generator_state_from_jax(
                *load_generator(path, use_ema=use_ema)), strict=True)
            ref = Generator(Config(**CFG_KW), seed=ref_seed).state_dict()
            for name, t in G.named_parameters():
                assert torch.equal(t, ref[name]), name

    def test_missing_ema_raises(self, tmp_path, weights):
        params, stats, _ = weights
        state = TrainState(g_params=params, g_stats=stats, d_params={},
                           d_stats={}, g_opt=(), d_opt=(), g_ema=None,
                           step=jnp.int32(0), rng=jax.random.PRNGKey(0))
        path = save_checkpoint(str(tmp_path), state, 1)
        with pytest.raises(ValueError, match="EMA"):
            load_generator(path, use_ema=True)
        assert latest_checkpoint(str(tmp_path / "none")) is None

    def test_cli_generates_from_run_dir(self, run_dir, tmp_path, weights):
        out = tmp_path / "pcs.npy"
        generate_cli.main(["--log_dir", str(run_dir), "--n", "3", "--seed",
                           "1", "--out", str(out), "--device", "cpu"])
        pcs = np.load(out)
        man = from_checkpoint(latest_checkpoint(str(run_dir)),
                              Config(**CFG_KW), device="cpu")
        np.testing.assert_array_equal(pcs, man.generate(3, seed=1))


    def test_cli_xyz_dir_matches_the_jax_writer(self, run_dir, tmp_path,
                                                weights):
        """`--xyz_dir D` writes `D/<i>.xyz` a shape, byte-equal to the JAX
        package's `save_xyz` of the same array."""
        from sp_gan_tpu.viz import save_xyz as jax_save_xyz
        out, d = tmp_path / "pcs.npy", tmp_path / "xyz"
        generate_cli.main(["--log_dir", str(run_dir), "--n", "3", "--out",
                           str(out), "--xyz_dir", str(d), "--device", "cpu"])
        pcs = np.load(out)
        assert sorted(os.listdir(d)) == ["0.xyz", "1.xyz", "2.xyz"]
        for i, pc in enumerate(pcs):
            jax_save_xyz(str(tmp_path / "want.xyz"), pc)
            with open(d / f"{i}.xyz", "rb") as f, \
                    open(tmp_path / "want.xyz", "rb") as g:
                assert f.read() == g.read()


class TestDevice:
    def test_entry_points_need_cuda_unless_told_cpu(self, run_dir, weights,
                                                    monkeypatch, tmp_path):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        params, stats, _ = weights
        G = Generator(Config(**CFG_KW), seed=None)
        ckpt = latest_checkpoint(str(run_dir))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Manipulator(Config(**CFG_KW), G)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            from_checkpoint(ckpt, Config(**CFG_KW))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            generate_cli.main(["--log_dir", str(run_dir), "--out",
                               str(tmp_path / "x.npy")])
        assert Manipulator(Config(**CFG_KW), G, device="cpu").device.type \
            == "cpu"


def _python(code_or_args, cwd, env=None):
    args = code_or_args if isinstance(code_or_args, list) else \
        ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


class TestBoundary:
    def test_port_imports_no_jax(self):
        code = (
            "import importlib, pkgutil, sys\n"
            "import sp_gan_tpu_torch as p\n"
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "'sp_gan_tpu_torch.')]\n"
            "for n in names: importlib.import_module(n)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'flax')) or m == 'sp_gan_tpu' "
            "or m.startswith('sp_gan_tpu.')]\n"
            "assert len(names) >= 15, names\n"
            "assert not bad, bad\n"
            "print('ok', len(names))\n")
        r = _python(code, REPO)
        assert r.returncode == 0, r.stderr
        assert r.stdout.startswith("ok")

    def test_chip_smoke_fails_without_a_gpu(self, tmp_path):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        r = _python(["chip_smoke.py"], REPO, env)
        assert r.returncode != 0 and '"ok": true' not in r.stdout
        # alone in a directory, without the package, it fails as well
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        r = _python(["chip_smoke.py"], str(tmp_path), env)
        assert r.returncode != 0 and '"ok": true' not in r.stdout
