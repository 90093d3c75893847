"""Reference-layout checkpoints (`.pth`) of the PyTorch port against the
JAX package's `sp_gan_tpu/compat`, on the CPU: export bit for bit, import
of JAX-written files, the round trip, the trainer's warm start from a
`.pth` and from a `.pkl`, the DGCNN carry and `FPD.from_torch`, and the
export CLI.

Weights are drawn by the port from a seed (or by the JAX package's
`create_train_state`); files are written into tmp_path. Nothing is
downloaded: the DGCNN state dict is drawn from a seed in the reference's
key layout.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_gan_tpu import compat as jcompat
from sp_gan_tpu.config import Config as JaxConfig
from sp_gan_tpu.eval.dgcnn import DGCNNFeat as JaxDGCNNFeat
from sp_gan_tpu.train.checkpoint import save_checkpoint as jax_save
from sp_gan_tpu.train.state import create_train_state as jax_create
from sp_gan_tpu_torch import compat
from sp_gan_tpu_torch import export_torch as export_cli
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data import SyntheticDataset
from sp_gan_tpu_torch.eval.fpd import FPD, fpd_from_weights
from sp_gan_tpu_torch.nn import Discriminator, Generator
from sp_gan_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)   # six test workers share the host's cores

TINY = dict(np=64, bs=4, nk=8, nz=16)
VARIANTS = {"default": {}, "eql": dict(eql=True),
            "attn_head_small_d": dict(attn=True, use_head=True,
                                      small_d=True)}


def jax_config(cfg: Config) -> JaxConfig:
    fields = {f.name for f in dataclasses.fields(JaxConfig)}
    return JaxConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                        if k in fields})


def nets(cfg: Config, seed: int = 3):
    """Port G and D drawn from `seed`, attention's gamma off zero."""
    G, D = Generator(cfg, seed=seed), Discriminator(cfg, seed=seed + 1)
    if cfg.attn:
        with torch.no_grad():
            G.attn.gamma.fill_(0.25)
    return G, D


def assert_same_dict(ours: dict, theirs: dict):
    assert list(ours) == list(theirs)
    for k in ours:
        a, b = np.asarray(ours[k]), np.asarray(theirs[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def assert_module_state(module, params, stats):
    want = compat.state_from_jax(params, stats)
    got = module.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k


class TestExport:
    @pytest.mark.parametrize("variant", sorted(VARIANTS))
    def test_equal_to_jax_export(self, variant):
        cfg = Config(**TINY, **VARIANTS[variant])
        G, D = nets(cfg)
        gp, gs = compat.generator_trees(G)
        dp, ds = compat.discriminator_trees(D)
        assert_same_dict(compat.export_generator(gp, gs, cfg),
                         jcompat.export_generator(gp, gs, jax_config(cfg)))
        assert_same_dict(compat.export_discriminator(dp, ds, cfg),
                         jcompat.export_discriminator(dp, ds,
                                                      jax_config(cfg)))

    @pytest.mark.parametrize("variant", sorted(VARIANTS))
    def test_reads_jax_written_pth(self, variant, tmp_path):
        cfg = Config(**TINY, **VARIANTS[variant])
        G, D = nets(cfg, seed=5)
        gp, gs = compat.generator_trees(G)
        dp, ds = compat.discriminator_trees(D)
        g_path, d_path = str(tmp_path / "G.pth"), str(tmp_path / "D.pth")
        jcompat.save_reference_checkpoint(g_path, gp, gs, jax_config(cfg),
                                          epoch=9, d_path=d_path,
                                          d_params=dp, d_stats=ds)
        (g2, s2), d, epoch = compat.load_reference_checkpoint(g_path, cfg,
                                                              d_path)
        assert epoch == 9
        G2, D2 = Generator(cfg, seed=None), Discriminator(cfg, seed=None)
        G2.load_state_dict(compat.generator_state_from_jax(g2, s2),
                           strict=True)
        D2.load_state_dict(compat.discriminator_state_from_jax(*d),
                           strict=True)
        assert_module_state(G2, gp, gs)
        assert_module_state(D2, dp, ds)

    @pytest.mark.parametrize("variant", sorted(VARIANTS))
    def test_round_trip(self, variant, tmp_path):
        cfg = Config(**TINY, **VARIANTS[variant])
        G, D = nets(cfg, seed=7)
        g_path, d_path = str(tmp_path / "G.pth"), str(tmp_path / "D.pth")
        compat.save_reference_checkpoint(
            g_path, *compat.generator_trees(G), cfg, epoch=2, d_path=d_path,
            d_params=compat.discriminator_trees(D)[0],
            d_stats=compat.discriminator_trees(D)[1])
        blob = torch.load(g_path, weights_only=True)
        assert set(blob) == {"G_model", "G_epoch"} and blob["G_epoch"] == 2
        assert all(v.device.type == "cpu" for v in blob["G_model"].values())
        bn = [k for k in blob["G_model"] if k.endswith("num_batches_tracked")]
        assert bn and all(int(blob["G_model"][k]) == 0 for k in bn)
        (gp, gs), (dp, ds), _ = compat.load_reference_checkpoint(
            g_path, cfg, d_path)
        assert_module_state(G, gp, gs)
        assert_module_state(D, dp, ds)

    def test_shape_map(self):
        """The reference's shapes: Conv1d [out, in, 1], 1x1 Conv2d
        [out, in, 1, 1], conv_out [out, in, 1, k], Linear [out, in],
        EqualLR `weight_orig`."""
        cfg = Config(**TINY, eql=True)
        sd = compat.export_generator(*compat.generator_trees(nets(cfg)[0]),
                                     cfg)
        k = cfg.nk // 2
        assert sd["head.0.conv.weight_orig"].shape == (128, 3 + 16, 1)
        assert sd["EdgeConv1.conv_w.0.weight"].shape == (32, 3, 1, 1)
        assert sd["EdgeConv2.conv_out.weight"].shape == (128, 128, 1, k)
        assert sd["global_conv.0.linear.weight_orig"].shape == (128, 128)
        assert sd["tail.4.weight"].shape == (3, 64, 1)
        assert sd["global_conv.1.running_var"].shape == (128,)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX `TrainState` with EMA at TINY, its config and G, D."""
    jcfg = JaxConfig(**TINY, ema=True)
    state, *_ = jax_create(jcfg, jax.random.PRNGKey(4))
    # an EMA unlike the weights, so the tests tell the two apart
    state = state.replace(g_ema=jax.tree.map(lambda p: p * 0.5,
                                             state.g_params),
                          step=jnp.int32(6))
    return jax.device_get(state), jcfg


def warm_trainer(log_dir, g, d=None) -> Trainer:
    cfg = Config(**TINY, ema=True, restore=True, pretrain_model_G=g,
                 pretrain_model_D=d, log_dir=str(log_dir),
                 data_root=str(log_dir))
    return Trainer(cfg, dataset=SyntheticDataset(8, TINY["np"]),
                   device="cpu", logs=False)


class TestWarmStart:
    def test_from_pth_under_log_dir(self, jax_state, tmp_path):
        """A reference `.pth` pair named relative to log_dir: G and D are
        the file's, the EMA copy is G, the Adams start fresh, and the
        epoch after the file's comes next."""
        state, jcfg = jax_state
        jcompat.save_reference_checkpoint(
            str(tmp_path / "G.pth"), state.g_params, state.g_stats, jcfg,
            epoch=7, d_path=str(tmp_path / "D.pth"),
            d_params=state.d_params, d_stats=state.d_stats)
        assert not os.path.exists("G.pth")
        tr = warm_trainer(tmp_path, "G.pth", "D.pth")
        assert tr.start_epoch == 8
        assert_module_state(tr.state.G, state.g_params, state.g_stats)
        assert_module_state(tr.state.D, state.d_params, state.d_stats)
        assert_module_state(tr.state.g_ema, state.g_params, state.g_stats)
        assert not tr.state.g_opt.state and not tr.state.d_opt.state
        assert tr.state.step == 0
        # and it trains from there
        real = tr.batch(np.arange(4), torch.Generator().manual_seed(0))
        tr.state, m = tr.train_step(tr.state, real)
        assert np.isfinite([float(m["d_loss"]), float(m["g_loss"])]).all()

    def test_from_pth_g_only(self, jax_state, tmp_path):
        state, jcfg = jax_state
        path = str(tmp_path / "only_G.pth")
        jcompat.save_reference_checkpoint(path, state.g_params,
                                          state.g_stats, jcfg, epoch=0)
        tr = warm_trainer(tmp_path, path)
        assert tr.start_epoch == 1
        assert_module_state(tr.state.G, state.g_params, state.g_stats)
        fresh = Discriminator(Config(**TINY), seed=Config().seed + 1)
        for a, b in zip(tr.state.D.state_dict().values(),
                        fresh.state_dict().values()):
            assert torch.equal(a, b)

    def test_from_pkl(self, jax_state, tmp_path):
        """A checkpoint of the JAX package by absolute path: the whole
        state (weights, statistics, EMA, step)."""
        state, jcfg = jax_state
        path = jax_save(str(tmp_path), state, 5, cfg=jcfg)
        tr = warm_trainer(tmp_path / "elsewhere", path)
        assert tr.start_epoch == 6
        assert_module_state(tr.state.G, state.g_params, state.g_stats)
        assert_module_state(tr.state.D, state.d_params, state.d_stats)
        assert_module_state(tr.state.g_ema, state.g_ema, state.g_stats)
        assert tr.state.step == 6


def reference_dgcnn_state(seed: int, k_feat: int = 64) -> dict:
    """A DGCNN-cls state dict in the reference's key layout (the
    `module.` prefix of a DataParallel save, `encoder.` stages, a
    classifier that the carry drops), drawn from `seed`."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, loc=0.0):
        return torch.from_numpy((loc + scale * rng.standard_normal(shape))
                                .astype(np.float32))

    sd = {}
    fin = 3
    for i, w in enumerate((64, 64, 128, 256)):
        p = f"module.encoder.conv{i + 1}"
        sd[f"{p}.0.weight"] = t(w, 2 * fin, 1, 1, scale=(2 * fin) ** -0.5)
        fin = w
    sd["module.encoder.conv5.0.weight"] = t(k_feat, 512, 1, scale=512 ** -0.5)
    for i, w in enumerate((64, 64, 128, 256, k_feat)):
        p = f"module.encoder.conv{i + 1}.1"
        sd[f"{p}.weight"] = t(w, scale=0.1, loc=1.0)
        sd[f"{p}.bias"] = t(w, scale=0.1)
        sd[f"{p}.running_mean"] = t(w, scale=0.1)
        sd[f"{p}.running_var"] = t(w, scale=0.1, loc=1.0).abs()
        sd[f"{p}.num_batches_tracked"] = torch.tensor(10)
    sd["module.classifier.linear1.weight"] = t(512, 2 * k_feat)
    return sd


class TestDGCNN:
    def test_convert_equal_to_jax(self):
        sd = reference_dgcnn_state(0)
        ours, theirs = compat.convert_dgcnn(sd), jcompat.convert_dgcnn(sd)
        flat = lambda tree: compat.state_from_jax(tree["params"],  # noqa
                                                  tree["batch_stats"])
        a, b = flat(ours), flat(theirs)
        assert list(a) == list(b)
        for key in a:
            assert torch.equal(a[key], b[key]), key

    def test_from_torch_matches_jax_features(self, tmp_path):
        """FPD.from_torch on a `torch.save`d state dict: its activations
        equal the JAX `DGCNNFeat` on the same weights within 2e-4; and
        `fpd_from_weights` takes the same file."""
        path = str(tmp_path / "dgcnn.pkl")
        sd = reference_dgcnn_state(1)
        torch.save(sd, path)
        fpd = FPD.from_torch(path, k=8, feat_dims=64, batch_size=4,
                             device="cpu")
        assert not fpd.random_features
        pts = np.random.default_rng(2).standard_normal((6, 64, 3)) \
            .astype(np.float32)
        ours = fpd.activations(pts)
        theirs = np.asarray(jax.jit(lambda v, x: JaxDGCNNFeat(
            k=8, feat_dims=64).apply(v, x, train=False))(
                jcompat.convert_dgcnn(sd), jnp.asarray(pts)))
        assert ours.shape == (6, 64)
        np.testing.assert_allclose(ours, theirs, rtol=2e-4,
                                   atol=2e-4 * np.abs(theirs).max())
        # the trainer's and the evaluate CLI's entry takes torch weights
        # too (the reference's extractor: k = 40, 1024 features)
        torch.save(reference_dgcnn_state(1, 1024), path)
        acts = fpd_from_weights(path, device="cpu").activations(pts[:2])
        assert acts.shape == (2, 1024) and np.isfinite(acts).all()


class TestExportCli:
    def test_exports_jax_checkpoint(self, jax_state, tmp_path):
        """The CLI on a JAX `.pkl` writes what the JAX package's
        `save_reference_checkpoint` writes, EMA weights and D included."""
        state, jcfg = jax_state
        jax_save(str(tmp_path), state, 5, cfg=jcfg)
        out_g, out_d = str(tmp_path / "G.pth"), str(tmp_path / "D.pth")
        export_cli.main(["--log_dir", str(tmp_path), "--ema", "--out", out_g,
                         "--out_d", out_d])
        jcompat.save_reference_checkpoint(
            str(tmp_path / "jG.pth"), state.g_ema, state.g_stats, jcfg,
            epoch=5, d_path=str(tmp_path / "jD.pth"),
            d_params=state.d_params, d_stats=state.d_stats)
        for ours, theirs in ((out_g, "jG.pth"), (out_d, "jD.pth")):
            a = torch.load(ours, weights_only=True)
            b = torch.load(str(tmp_path / theirs), weights_only=True)
            assert list(a) == list(b)
            model = [k for k in a if k.endswith("_model")][0]
            assert a[model.replace("model", "epoch")] == 5
            assert list(a[model]) == list(b[model])
            for k, v in a[model].items():
                assert torch.equal(v, b[model][k]), k

    def test_missing_ema_and_checkpoint(self, tmp_path):
        jcfg = JaxConfig(**TINY)
        state, *_ = jax_create(jcfg, jax.random.PRNGKey(0))
        (tmp_path / "config.json").write_text(Config(**TINY).to_json())
        with pytest.raises(SystemExit, match="no checkpoint"):
            export_cli.main(["--log_dir", str(tmp_path)])
        jax_save(str(tmp_path), jax.device_get(state), 1, cfg=jcfg)
        with pytest.raises(SystemExit, match="EMA"):
            export_cli.main(["--log_dir", str(tmp_path), "--ema", "--out",
                             str(tmp_path / "G.pth")])
