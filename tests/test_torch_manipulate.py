"""The PyTorch port's manipulation routines against the JAX package's
(`sp_gan_tpu/manipulate.py`), on the CPU: masks, code edits, the nine
routines, style blending in the generator, the CLI, and device choice.

The packages draw different codes from one seed, so both Manipulators take
their codes from one table of numpy codes keyed by (count, seed) in place
of `sample_codes`; every routine is then compared end to end, its code
edits included. The JAX Manipulator on the CPU serves through
`Generator.apply` (its fused path needs Pallas on a TPU); the port's takes
its fused eval path. Both run in float32, within 2e-4.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_gan_tpu import manipulate as jman
from sp_gan_tpu.config import Config as JaxConfig
from sp_gan_tpu.data import sphere_template as jsphere_template
from sp_gan_tpu.data.sphere import sphere_sqdist as jsphere_sqdist
from sp_gan_tpu.nn import Generator as JaxGenerator
from sp_gan_tpu.train.checkpoint import save_checkpoint
from sp_gan_tpu.train.state import TrainState
from sp_gan_tpu_torch import manipulate as tman
from sp_gan_tpu_torch.compat import generator_trees
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data.sphere import sphere_sqdist, sphere_template
from sp_gan_tpu_torch.nn.generator import Generator

torch.set_num_threads(2)   # six test workers share the host's cores

N = 128
CFG_KW = dict(np=N, nz=16, nk=8, dtype="float32")
TOL = 2e-4
# region sizes of part_interpolate_detail at this N (the default sizes
# are the reference's, for N=2048)
SIZES = (0, N // 4, N // 2, 3 * N // 4, N)


def code_table(n: int, seed: int, nz: int = 16) -> np.ndarray:
    """[n, N, nz] codes for (n, seed): 0.2 N(0, 1), one per shape."""
    z = np.random.default_rng(1000 + seed).standard_normal((n, 1, nz))
    return np.broadcast_to(0.2 * z, (n, N, nz)).astype(np.float32)


@pytest.fixture(autouse=True)
def exact_selection(monkeypatch):
    # the JAX generator on the CPU selects neighbors with the exact XLA top-k
    monkeypatch.setenv("SPGAN_KNN_SELECT", "exact")


@pytest.fixture(scope="module")
def weights():
    """(params, stats) numpy trees drawn by the port, with running
    statistics moved off their initial values."""
    G = Generator(Config(**CFG_KW), seed=7)
    rng = np.random.default_rng(8)
    with torch.no_grad():
        for name, b in G.named_buffers():
            if name.endswith("var"):
                b.mul_(torch.from_numpy(rng.uniform(0.5, 1.5, b.shape)
                                        .astype(np.float32)))
            else:
                b.add_(torch.from_numpy(rng.normal(0, 0.1, b.shape)
                                        .astype(np.float32)))
    return generator_trees(G)


@pytest.fixture(scope="module")
def pair(weights):
    """(port Manipulator, JAX Manipulator) on the same weights, both
    drawing their codes from `code_table`."""
    params, stats = weights
    ours = tman.Manipulator(Config(**CFG_KW),
                            tman.load_jax_generator(params, stats,
                                                    Config(**CFG_KW)),
                            device="cpu")
    assert ours.fused
    theirs = jman.Manipulator(JaxConfig(**CFG_KW), params, stats)
    ours.sample_codes = lambda n, seed=0, per_point=None: torch.from_numpy(
        code_table(n, seed))
    theirs.sample_codes = lambda n, seed=0, per_point=None: jnp.asarray(
        code_table(n, seed))
    return ours, theirs


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


class TestMasksAndEdits:
    def test_sphere_sqdist(self):
        ball = sphere_template(200)
        np.testing.assert_array_equal(sphere_sqdist(ball),
                                      jsphere_sqdist(jsphere_template(200)))

    @pytest.mark.parametrize("axis", [0, 1, 2])
    @pytest.mark.parametrize("positive", [True, False])
    def test_half_space_mask(self, axis, positive):
        ball = sphere_template(N)
        ours = tman.half_space_mask(ball, axis, 0.1, positive)
        np.testing.assert_array_equal(
            ours, jman.half_space_mask(ball, axis, 0.1, positive))
        assert ours.dtype == np.int32

    @pytest.mark.parametrize("anchor,num", [(0, N // 3), (17, 5), (5, N)])
    def test_region_mask(self, anchor, num):
        ball = sphere_template(N)
        ours = tman.region_mask(ball, anchor, num)
        np.testing.assert_array_equal(ours,
                                      jman.region_mask(ball, anchor, num))
        assert ours.sum() == num and ours[anchor] == 1

    def test_region_mask_ties(self):
        """Repeated points tie: numpy's argsort settles them alike."""
        ball = np.repeat(sphere_template(N // 4), 4, axis=0)
        for num in (3, 6, 9):
            np.testing.assert_array_equal(tman.region_mask(ball, 2, num),
                                          jman.region_mask(ball, 2, num))

    @pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
    def test_z_edits(self, alpha):
        z1, z2 = code_table(2, 1), code_table(2, 2)
        z1 = z1 + np.random.default_rng(0).normal(
            0, 0.01, z1.shape).astype(np.float32)
        mask = tman.region_mask(sphere_template(N), 3, N // 3)
        t1, t2 = torch.from_numpy(z1), torch.from_numpy(z2)
        j1, j2 = jnp.asarray(z1), jnp.asarray(z2)
        np.testing.assert_array_equal(
            tman.blend_z(t1, t2, mask, alpha).numpy(),
            np.asarray(jman.blend_z(j1, j2, mask, alpha)))
        np.testing.assert_array_equal(tman.replace_z(t1, t2, mask).numpy(),
                                      np.asarray(jman.replace_z(j1, j2, mask)))
        np.testing.assert_array_equal(tman.flip_z(t1, mask).numpy(),
                                      np.asarray(jman.flip_z(j1, mask)))
        for a, b in zip(tman.exchange_z(t1, t2, mask),
                        jman.exchange_z(j1, j2, mask)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _mask():
    return tman.region_mask(sphere_template(N), 0, N // 3)


# routine -> fn(manipulator) -> the arrays it returns, as the CLI calls it
ROUTINES = {
    "correspondence": lambda m: m.correspondence(4, 0),
    "shape_interpolate": lambda m: m.shape_interpolate(0, 1, 6),
    "part_interpolate": lambda m: m.part_interpolate(_mask(), 0, 1, 6),
    "style_interpolate": lambda m: m.style_interpolate(_mask(), 0, 1, 4),
    "part_interpolate_detail": lambda m: m.part_interpolate_detail(
        0, 1, mask_sizes=SIZES),
    "part_edit": lambda m: m.part_edit(_mask(), 0),
    "part_flip": lambda m: m.part_flip(seed=0),
    "part_exchange": lambda m: m.part_exchange(_mask(), 0, 1),
    "edit_interpolate": lambda m: m.edit_interpolate(_mask(), 0, steps=6),
}


class TestRoutines:
    @pytest.mark.parametrize("name", sorted(ROUTINES))
    def test_matches_jax(self, pair, name):
        ours, theirs = (ROUTINES[name](m) for m in pair)
        if not isinstance(ours, tuple):
            ours, theirs = (ours,), (theirs,)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a.shape == np.shape(b)
            assert np.isfinite(a).all()
            close(a, b)

    def test_unedited_rows_equal_forward(self, pair):
        """Rows whose codes no edit touched equal `forward` of those codes
        within 1e-5 (a batch of another size rounds the dense layers
        otherwise): the original of part_edit, a and b of part_exchange,
        the unflipped half of part_flip, alpha = 0 of shape_interpolate.
        Style blending at alpha = 0 is the plain generator's forward, bit
        for bit."""
        man = pair[0]
        za, zb = code_table(1, 0), code_table(1, 1)

        def same(a, b):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)

        same(man.part_edit(_mask(), 0)[0], man.forward(za)[0])
        same(man.part_exchange(_mask(), 0, 1)[:2],
             man.forward(np.concatenate([za, zb])))
        same(man.part_flip(seed=0)[:4], man.forward(code_table(4, 0)))
        same(man.shape_interpolate(0, 1, 3)[0], man.forward(za)[0])
        with torch.no_grad():
            plain = man.G(man.sphere[None], torch.from_numpy(za),
                          train=False).numpy()
        np.testing.assert_array_equal(
            man.style_interpolate(_mask(), 0, 1, 2)[0], plain[0])


class TestGeneratorBlend:
    @pytest.fixture(scope="class")
    def nets(self, weights):
        params, stats = weights
        G = tman.load_jax_generator(params, stats, Config(**CFG_KW))
        jG = JaxGenerator(JaxConfig(**CFG_KW))
        v = {"params": params, "batch_stats": stats}
        return G.eval(), jG, v

    def _inputs(self):
        x = sphere_template(N)[None].repeat(2, 0)
        z1 = code_table(2, 3)
        z2 = code_table(2, 4)
        return x, z1, z2, _mask()

    @pytest.mark.parametrize("alpha", [0.0, 0.4, 1.0])
    def test_forward_z2(self, nets, alpha):
        G, jG, v = nets
        x, z1, z2, mask = self._inputs()
        with torch.no_grad():
            ours = G(torch.from_numpy(x), torch.from_numpy(z1), train=False,
                     z2=torch.from_numpy(z2), blend_mask=mask,
                     blend_alpha=alpha).numpy()
        theirs = jax.jit(lambda v, a: jG.apply(
            v, jnp.asarray(x), jnp.asarray(z1), train=False,
            z2=jnp.asarray(z2), blend_mask=jnp.asarray(mask),
            blend_alpha=a))(v, alpha)
        close(ours, theirs)

    @pytest.mark.parametrize("use_latent", [False, True])
    def test_interpolate(self, nets, use_latent):
        G, jG, v = nets
        x, z1, z2, mask = self._inputs()
        with torch.no_grad():
            ours = G.interpolate(torch.from_numpy(x), torch.from_numpy(z1),
                                 torch.from_numpy(z2), mask, 0.6,
                                 use_latent=use_latent).numpy()
        theirs = jax.jit(lambda v: jG.apply(
            v, jnp.asarray(x), jnp.asarray(z1), jnp.asarray(z2),
            jnp.asarray(mask), 0.6, use_latent=use_latent,
            method=JaxGenerator.interpolate))(v)
        close(ours, theirs)
        with torch.no_grad():
            other = G.interpolate(torch.from_numpy(x), torch.from_numpy(z1),
                                  torch.from_numpy(z2), mask, 0.6,
                                  use_latent=not use_latent).numpy()
        assert np.abs(other - ours).max() > 1e-4   # the modes differ


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, weights):
    """config.json and ckpt_epoch_3.pkl written by the JAX package."""
    params, stats = weights
    d = tmp_path_factory.mktemp("run")
    state = TrainState(g_params=params, g_stats=stats, d_params={},
                       d_stats={}, g_opt=(), d_opt=(), g_ema=None,
                       step=jnp.int32(3), rng=jax.random.PRNGKey(0))
    save_checkpoint(str(d), state, 3, cfg=JaxConfig(**CFG_KW))
    return d


class TestCli:
    def test_all_routines(self, run_dir, tmp_path, capsys):
        out = tmp_path / "figs"
        tman.main(["--log_dir", str(run_dir), "--routine", "all",
                   "--out_dir", str(out), "--steps", "3", "--device", "cpu"])
        for r in tman.ROUTINES:
            png = out / f"{r}.png"
            assert png.stat().st_size > 1000, r
            assert open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
        assert capsys.readouterr().out.count("wrote") == 9

    def test_without_matplotlib_exits_before_any_forward(
            self, run_dir, tmp_path, monkeypatch):
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        monkeypatch.setattr(tman.Manipulator, "_forward", None)
        with pytest.raises(SystemExit, match="matplotlib"):
            tman.main(["--log_dir", str(run_dir), "--device", "cpu",
                       "--out_dir", str(tmp_path)])
        assert not os.listdir(tmp_path)

    def test_unknown_routine(self, run_dir):
        with pytest.raises(SystemExit, match="unknown routine"):
            tman.main(["--log_dir", str(run_dir), "--routine", "twist",
                       "--device", "cpu"])


class TestDevice:
    def test_needs_cuda_unless_told_cpu(self, weights, run_dir, tmp_path,
                                        monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        G = Generator(Config(**CFG_KW), seed=None)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tman.Manipulator(Config(**CFG_KW), G)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tman.main(["--log_dir", str(run_dir), "--out_dir",
                       str(tmp_path)])
        assert tman.Manipulator(Config(**CFG_KW), G,
                                device="cpu").device.type == "cpu"
