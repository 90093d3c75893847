"""Checkpoints between the port and the JAX package, both ways, and the
kNN kernels' limits taken off the CPU path.

The port writes the JAX `TrainState` layout (optax Adam trees, an rng
key), so the JAX package's `from_checkpoint` serves a checkpoint the port
wrote and the port's `load_checkpoint` resumes from one the JAX package
wrote. The serving comparison runs in float32: under `mixed_edge` the
packages' bf16 roundings swap near-tie neighbors (tests/test_torch_serving
.py), which no tolerance of 2e-4 covers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sp_gan_tpu.config import Config as JaxConfig
from sp_gan_tpu.data.augment import normalize_point_cloud as jnormalize
from sp_gan_tpu.manipulate import from_checkpoint as jax_from_checkpoint
from sp_gan_tpu.nn import Generator as JaxGenerator
from sp_gan_tpu.train.checkpoint import load_checkpoint as jax_load
from sp_gan_tpu.train.checkpoint import save_checkpoint as jax_save
from sp_gan_tpu.train.state import TrainState as JaxTrainState
from sp_gan_tpu.train.state import create_train_state as jax_create
from sp_gan_tpu_torch.compat import trees
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data.sphere import sphere_template
from sp_gan_tpu_torch.manipulate import Manipulator
from sp_gan_tpu_torch.nn.generator import Generator
from sp_gan_tpu_torch.ops.kernels.knn import check_kernel_limits, knn
from sp_gan_tpu_torch.ops.kernels.knn_edge import knn_edge
from sp_gan_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from sp_gan_tpu_torch.train.state import create_train_state
from sp_gan_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)   # six test workers share the host's cores

TINY = dict(np=64, bs=4, nk=8, nz=16)


def jax_config(cfg: Config) -> JaxConfig:
    fields = {f.name for f in dataclasses.fields(JaxConfig)}
    return JaxConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                        if k in fields})


@pytest.fixture(scope="module", params=[False, True], ids=["const", "decay"])
def port_ckpt(request, tmp_path_factory):
    """A port checkpoint after two float32 training steps, with EMA, with
    and without `--lr_decay`."""
    d = str(tmp_path_factory.mktemp("port"))
    cfg = Config(**TINY, dtype="float32", ema=True, lr_decay=request.param,
                 log_dir=d, data_root=d, steps_per_epoch=2)
    tr = Trainer(cfg, device="cpu", logs=False)
    shuffle = torch.Generator().manual_seed(0)
    for lo in (0, 4):
        tr.state, _ = tr.train_step(tr.state,
                                    tr.batch(np.arange(lo, lo + 4), shuffle))
    return tr, cfg, save_checkpoint(d, tr.state, 1, cfg)


class TestPortToJax:
    def test_state_keys_are_the_train_state_fields(self, port_ckpt):
        import pickle
        _, cfg, path = port_ckpt
        with open(path, "rb") as f:
            blob = pickle.load(f)
        st = blob["state"]
        assert set(st) == {f.name for f in dataclasses.fields(JaxTrainState)}
        assert set(blob) == {"state", "epoch", "torch"}
        assert st["rng"].dtype == np.uint32 and st["rng"].shape == (2,)
        for opt in ("g_opt", "d_opt"):
            assert int(st[opt]["0"]["count"]) == 2
            assert st[opt]["0"]["count"].dtype == np.int32
            assert st[opt]["1"] == ({"count": np.int32(2)} if cfg.lr_decay
                                    else {})

    def test_jax_restores_the_optax_state(self, port_ckpt):
        tr, cfg, path = port_ckpt
        jcfg = jax_config(cfg)
        template, *_ = jax_create(jcfg, jax.random.PRNGKey(0))
        st, epoch = jax_load(path, template)
        assert epoch == 1 and int(st.step) == 2
        adam = st.g_opt[0]
        assert isinstance(adam, optax.ScaleByAdamState)
        assert int(adam.count) == 2
        exp_avg = tr.state.g_opt.state[
            dict(tr.state.G.named_parameters())["tail3.kernel"]]["exp_avg"]
        np.testing.assert_array_equal(np.asarray(adam.mu["tail3"]["kernel"]),
                                      exp_avg.numpy())

    def test_jax_serves_it(self, port_ckpt):
        """JAX `from_checkpoint` on the port's file: clouds within 2e-4 of
        the port's `sample_fn` (EMA weights) on the same codes."""
        tr, cfg, path = port_ckpt
        man = jax_from_checkpoint(path, jax_config(cfg), use_ema=True)
        z = np.broadcast_to(np.random.default_rng(1).standard_normal(
            (3, 1, cfg.nz)).astype(np.float32) * cfg.nv,
            (3, cfg.np, cfg.nz)).copy()
        want = tr.sample_fn(tr.state, torch.from_numpy(z)).numpy()
        np.testing.assert_allclose(man.forward(jnp.asarray(z)), want,
                                   rtol=0, atol=2e-4)


class TestJaxToPort:
    @pytest.mark.parametrize("decay", [False, True])
    def test_port_resumes_from_a_jax_checkpoint(self, tmp_path, decay):
        """Adam moments, counts and the step equal the JAX state's; the
        step generator is seeded from the rng key."""
        cfg = Config(**TINY, lr_decay=decay)
        jcfg = jax_config(cfg)
        st, *_ = jax_create(jcfg, jax.random.PRNGKey(3))
        rng = np.random.default_rng(0)

        def noisy(tree):
            return jax.tree.map(lambda v: jnp.asarray(
                rng.standard_normal(v.shape).astype(np.float32)), tree)

        adam = st.g_opt[0]._replace(count=jnp.int32(7), mu=noisy(st.g_params),
                                    nu=noisy(st.g_params))
        dadam = st.d_opt[0]._replace(count=jnp.int32(7),
                                     mu=noisy(st.d_params),
                                     nu=noisy(st.d_params))
        st = st.replace(step=jnp.int32(7), g_opt=(adam, *st.g_opt[1:]),
                        d_opt=(dadam, *st.d_opt[1:]))
        path = jax_save(str(tmp_path), st, 3)
        state = create_train_state(cfg, device="cpu")
        assert load_checkpoint(path, state) == 3 and state.step == 7
        for net, opt, jadam in ((state.G, state.g_opt, adam),
                                (state.D, state.d_opt, dadam)):
            for name, p in net.named_parameters():
                s = opt.state[p]
                assert float(s["step"]) == 7
                path_ = name.split(".")
                mu, nu = jadam.mu, jadam.nu
                for key in path_:
                    mu, nu = mu[key], nu[key]
                np.testing.assert_array_equal(s["exp_avg"].numpy(),
                                              np.asarray(mu))
                np.testing.assert_array_equal(s["exp_avg_sq"].numpy(),
                                              np.asarray(nu))
        key = np.asarray(st.rng, np.uint32)
        want = torch.Generator().manual_seed((int(key[0]) << 32)
                                             | int(key[1]))
        assert torch.equal(state.gen.get_state(), want.get_state())
        g_params, _ = trees(state.G)
        np.testing.assert_array_equal(g_params["tail3"]["kernel"],
                                      np.asarray(st.g_params["tail3"]
                                                 ["kernel"]))

    def test_round_trip_keeps_the_port_state(self, tmp_path):
        """A port checkpoint read back by the port: Adam states and the
        generator state equal."""
        cfg = Config(**TINY, log_dir=str(tmp_path), data_root=str(tmp_path),
                     steps_per_epoch=1)
        tr = Trainer(cfg, device="cpu", logs=False)
        tr.state, _ = tr.train_step(tr.state, tr.batch(
            np.arange(4), torch.Generator().manual_seed(0)))
        path = save_checkpoint(str(tmp_path), tr.state, 1, cfg)
        other = create_train_state(dataclasses.replace(cfg, seed=9),
                                   device="cpu")
        load_checkpoint(path, other)
        for opt, mine in ((other.g_opt, tr.state.g_opt),
                          (other.d_opt, tr.state.d_opt)):
            a, b = opt.state_dict(), mine.state_dict()
            assert a["state"].keys() == b["state"].keys()
            for k in a["state"]:
                for f in ("step", "exp_avg", "exp_avg_sq"):
                    assert torch.equal(a["state"][k][f], b["state"][k][f])
        assert torch.equal(other.gen.get_state(), tr.state.gen.get_state())


class TestKnnLimits:
    @pytest.mark.parametrize("dtype", ["float32", "mixed_edge"])
    def test_manipulator_at_nk_80(self, dtype):
        """k = 40 > 32 runs on the CPU. In float32 the clouds equal the
        JAX Generator's on the same weights and codes within 2e-4; under
        mixed_edge they are finite and of the right shape."""
        cfg = Config(np=128, nk=80, nz=16, dtype=dtype)
        G = Generator(cfg, seed=0)
        man = Manipulator(cfg, G, device="cpu")
        z = man.sample_codes(2, seed=3)
        out = man.generate(2, seed=3)
        assert out.shape == (2, 128, 3) and np.isfinite(out).all()
        if dtype != "float32":
            return
        params, stats = trees(G)
        jg = JaxGenerator(jax_config(cfg))
        x = jnp.broadcast_to(jnp.asarray(sphere_template(128))[None],
                             (2, 128, 3))
        want = jax.jit(lambda v, x, z: jg.apply(v, x, z, train=False))(
            {"params": params, "batch_stats": stats}, x,
            jnp.asarray(z.numpy()))
        np.testing.assert_allclose(out, np.asarray(jnormalize(want)),
                                   rtol=0, atol=2e-4)

    def test_plain_versions_take_any_k_and_c(self):
        x = torch.randn(2, 48, 160)
        idx, dist = knn(x, 40)
        assert idx.shape == (2, 48, 40) and bool((dist[..., 1:]
                                                  >= dist[..., :-1]).all())
        ee, idx2 = knn_edge(x, 40)
        assert ee.shape == (2, 48, 40, 320) and torch.equal(idx, idx2)
        with pytest.raises(ValueError, match="N-1"):
            knn(x, 48)

    @pytest.mark.parametrize("k, C, match", [
        (40, 3, r"k <= 32 \(--nk <= 64\).*k=40 \(from --nk 80\)"),
        (10, 160, "C <= 128.*C=160")])
    def test_cuda_limits_name_the_flag(self, k, C, match):
        with pytest.raises(ValueError, match=match):
            check_kernel_limits("kernel A (knn)", k, C)
        check_kernel_limits("kernel A (knn)", 32, 128)
