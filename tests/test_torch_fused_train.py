"""The port's fused training path (`--fused_train`, `--fused_dphase`) against
the JAX package, on the CPU: the differentiable concat-form fused edge op
(`ops.edge.EdgeConcat`) against JAX's `edge_features` VJP, the fused
train-mode generator forward (`nn.fused_train.generator_forward_train`)
against JAX's run in Pallas interpret mode, a `fused_train=True` step
against the JAX step, and the selection rules of `make_train_step`.

The generator comparisons replay the port's discrete choices (EdgeConv2's
neighbors, the global max pool) into the JAX function (`Replay` of
tests/test_torch_train_step.py), as the step parity tests do: a near-tie
broken the other way moves a whole row or gradient column.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import test_torch_train_step as base
from sp_gan_tpu.config import Config as JaxConfig
from sp_gan_tpu.data import sphere_template
from sp_gan_tpu.nn import fused_train as jfused
from sp_gan_tpu.ops import dispatch as jdispatch
from sp_gan_tpu.ops import edge as jedge
from sp_gan_tpu_torch.compat import trees
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.nn import Generator
from sp_gan_tpu_torch.nn import fused_train as tfused
from sp_gan_tpu_torch.nn.layers import EdgeBlock
from sp_gan_tpu_torch.ops import edge as tedge
from sp_gan_tpu_torch.ops import kernels
from sp_gan_tpu_torch.train import step as tstep
from sp_gan_tpu_torch.train.step import template_edges

torch.set_num_threads(2)   # six test workers share the host's cores

KW = dict(np=256, nk=8, nz=16)
B = 2
GB = 4    # the generator's batch: see TestFusedGenerator


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ------------------------------------------------------------ EdgeConcat
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_concat_vjp_matches_jax(dtype, monkeypatch):
    """`edge_features(idx=None)` (kernel B's concat form, backward kernel D
    plus the central sum) against the JAX `edge_features` VJP at the same
    neighbors (the port's, replayed): edges equal; d_x within 1e-6 of its
    max-abs in float32 (sum order). With bf16 edges both packages round the
    central sum, the scatter and their sum to bf16, over sums taken in
    other orders: within 1e-2 of the max-abs elementwise (two bf16 ulps
    of the largest entry) and 4e-3 in relative L2."""
    monkeypatch.setenv("SPGAN_KNN_SELECT", "exact")
    rng = np.random.default_rng(0)
    k = 4
    xn = rng.standard_normal((B, 64, 16)).astype(np.float32)
    cd = getattr(torch, dtype)
    x = torch.from_numpy(xn).requires_grad_()
    ee, idx = tedge.edge_features(x, k, return_idx=True, out_dtype=cd)
    assert ee.dtype == cd and ee.requires_grad
    g = torch.from_numpy(rng.standard_normal(ee.shape).astype(np.float32))
    g = g.to(cd)
    (ee.float() * g.float()).sum().backward()

    picks = jnp.asarray(idx.numpy())
    monkeypatch.setattr(jdispatch, "knn", lambda x, k: picks)
    jdt = jnp.dtype(dtype)
    ee_j, vjp = jax.vjp(lambda x: jedge.edge_features(x, k, out_dtype=jdt),
                        jnp.asarray(xn))
    (d_x,) = vjp(jnp.asarray(g.float().numpy()).astype(jdt))
    np.testing.assert_array_equal(ee.float().detach().numpy(),
                                  np.asarray(ee_j.astype(jnp.float32)))
    ours, theirs = x.grad.numpy(), np.asarray(d_x)
    scale = np.abs(theirs).max()
    if dtype == "float32":
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6 * scale)
    else:
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-2 * scale)
        assert rel(ours, theirs) <= 4e-3


# ------------------------------------------- _edge_block_xla's bf16 sums
def test_edge_block_xla_keeps_f32_sums():
    """EdgeConv1 of the fused forward on bf16 template edges: the jitted
    JAX `_edge_block_xla` lies closer to the port that keeps the f32 sums
    of its BatchNorm-feeding dense layers unrounded than to one that
    rounds them to bf16, and the port lies no farther from JAX's float32
    result than JAX's bf16 result does. So XLA drops the rounding between
    a bf16 dot and the f32 BatchNorm here too (as for `EdgeBlock`,
    tests/test_torch_train_mixed_vjp.py). Measured at seeds 0-2: port
    against JAX bf16 6.2e-3 to 6.4e-3 (rounding the sums: 9.1e-3 to
    1.2e-2); to JAX float32 the port 5.0e-3, JAX bf16 6.0e-3."""
    k = 4
    sph = torch.from_numpy(sphere_template(256))
    ee = template_edges(sph, k)[1].expand(4, -1, -1, -1).contiguous()
    for seed in (0, 1):
        blk = EdgeBlock(3, 64, k)
        blk.init_weights(np.random.default_rng(seed))
        for sub in (blk.conv_w1, blk.conv_w2, blk.conv_x):
            sub.init_weights(np.random.default_rng(seed + 1))
        params, _ = trees(blk)
        run = jax.jit(lambda p, e: jfused._edge_block_xla(p, e, k)[0])
        e = jnp.asarray(ee.numpy())
        theirs = np.asarray(run(params, e.astype(jnp.bfloat16))
                            .astype(jnp.float32))
        exact = np.asarray(run(params, e))
        eb = ee.to(torch.bfloat16)
        dense = tfused._dense
        with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
            ours = tfused._edge_block_xla(blk, eb, k)[0].float().numpy()
            mp.setattr(tfused, "_dense",
                       lambda p, x, act_neg=None, f32_sums=False:
                       dense(p, x, act_neg))
            rounded = tfused._edge_block_xla(blk, eb, k)[0].float().numpy()
        assert rel(ours, theirs) < rel(rounded, theirs)
        assert rel(ours, exact) <= rel(theirs, exact)


# ------------------------------------------------ the fused generator
def port_generator(dtype: str, x, z, ct, idx, ee, kw=KW):
    """The port's fused forward and VJP from Generator(seed=0) weights of
    Config(**kw): (results, EdgeConv2's picks, the global pool's
    choices)."""
    cfg = Config(**kw, dtype=dtype)
    gb = x.shape[0]
    G = Generator(cfg, seed=0)
    params0, stats0 = trees(G)
    picks, pools = [], []
    concat, adain = tedge.edge_concat_fused, tfused._adain

    def rec_concat(x, *a):
        out = concat(x, *a)
        picks.append(out[1].numpy().copy())
        return out

    def rec_adain(p, x, style):
        out = adain(p, x, style)
        if p is G.adain2:
            pools.append(("g", out.detach().argmax(1).numpy()
                          .astype(np.int32)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPGAN_KNN_SELECT", "exact")
        mp.setattr(tedge, "edge_concat_fused", rec_concat)
        mp.setattr(tfused, "_adain", rec_adain)
        out = tfused.generator_forward_train(
            G, torch.from_numpy(x), torch.from_numpy(z),
            edge1_idx=idx.expand(gb, -1, -1),
            edge1_ee=ee.expand(gb, -1, -1, -1))
    names = [n for n, _ in G.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                list(G.parameters()))
    res = {"out": out.detach().numpy(),
           "grads": {n: g.numpy() for n, g in zip(names, grads)},
           "stats": base.flat(trees(G)[1])}
    return res, picks, pools, (params0, stats0)


def jax_generator(dtype: str, weights, x, z, ct, idx, ee, replay, kw=KW):
    """JAX's `generator_forward_train` in interpret mode and its VJP, the
    port's choices replayed."""
    params, stats = weights
    cfg = JaxConfig(**kw, dtype=dtype)
    gb = x.shape[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdispatch, "knn", replay.knn)
        mp.setattr(jfused, "jnp", replay)
        replay.n_knn = replay.n_pool = 0

        def fwd(p):
            return jfused.generator_forward_train(
                cfg, p, stats, jnp.asarray(x), jnp.asarray(z),
                edge1_idx=jnp.broadcast_to(idx, (gb,) + idx.shape[1:]),
                edge1_ee=jnp.broadcast_to(ee, (gb,) + ee.shape[1:]))

        with pltpu.force_tpu_interpret_mode():
            out, vjp, new_stats = jax.vjp(jax.jit(fwd), params, has_aux=True)
            (grads,) = vjp(jnp.asarray(ct))
            out = np.asarray(out)
    return {"out": out, "grads": base.flat(jax.device_get(grads)),
            "stats": base.flat(jax.device_get(new_stats))}


def run_generators(kw=KW, gb=GB):
    """The port in float32 and mixed_edge, JAX in the same, and JAX in
    float32 on the port's mixed_edge choices (the witness), at Config(**kw)
    and a batch of gb."""
    cfg = Config(**kw)
    sph = torch.from_numpy(sphere_template(cfg.np))
    idx, ee = template_edges(sph, cfg.k)
    rng = np.random.default_rng(2)
    x = np.broadcast_to(sph.numpy()[None], (gb, cfg.np, 3)).copy()
    z = (0.2 * rng.standard_normal((gb, cfg.np, cfg.nz))).astype(
        np.float32)
    ct = rng.standard_normal((gb, cfg.np, 3)).astype(np.float32)
    args = (x, z, ct, idx, ee)
    out = {}
    for dtype in ("float32", "mixed_edge"):
        ours, picks, pools, weights = port_generator(dtype, *args, kw=kw)
        if dtype == "float32":
            # the port's own response to one ulp of z, same choices
            out["one_ulp"] = []
            for eps in (2.0 ** -23, -2.0 ** -23):
                ulp, p2, pl2, _ = port_generator(
                    dtype, x, (z * (1 + eps)).astype(np.float32), ct, idx, ee,
                    kw=kw)
                assert all(np.array_equal(a, b) for a, b in zip(picks, p2))
                assert all(np.array_equal(a[1], b[1])
                           for a, b in zip(pools, pl2))
                out["one_ulp"].append(ulp)
        replay = base.Replay()
        replay.load(picks, pools)
        out["port", dtype] = ours
        out["jax", dtype] = jax_generator(dtype, weights, *args[:3],
                                          idx.numpy(), ee.numpy(), replay,
                                          kw=kw)
        if dtype == "float32":
            # under mixed_edge the packages' EdgeConv1 outputs differ by
            # bf16 rounding, more than a near-tie
            replay.assert_near_ties([("knn", 0), ("pool", 0, 1)])
        if dtype == "mixed_edge":
            out["witness"] = jax_generator("float32", weights, *args[:3],
                                           idx.numpy(), ee.numpy(), replay,
                                           kw=kw)
    return out


@pytest.fixture(scope="module")
def generator_runs():
    return run_generators()


class TestFusedGenerator:
    """At N=256 and a batch of 4 (over a batch of 2 the global BatchNorms
    normalize each channel to +-1 and the function is degenerate)."""

    def test_float32(self, generator_runs):
        """Output within 2e-4 of its max-abs and the updated running
        statistics within 2e-4. The gradients: within the larger of the G
        phase's tolerances of tests/test_torch_train_step.py (2e-2 of each
        tensor's max-abs, a bias that feeds a training BatchNorm on its
        kernel's scale as its exact gradient is zero; 1e-2 in relative
        L2) and twice the port's own response to one ulp of z. The G
        forward is that ill-conditioned here: one ulp of z moves its
        gradients by 8.3e-2 of a tensor's max-abs (tail1's kernel) and
        1.1e-2 in relative L2, through the instance norms (AdaIN over 256
        points) and the global BatchNorms over 4 shapes; the JAX package's
        own fused-against-flax test allows 0.15 relative L2 for this
        (tests/test_fused_train_generator.py). The fused EdgeBlocks alone
        agree within 6e-7 of max-abs on one cotangent
        (tests/test_torch_edgeblock_train.py). Measured: output 1.7e-5,
        statistics 5.0e-6, gradients 8.3e-2 and 1.5e-2."""
        ours, theirs = generator_runs["port", "float32"], \
            generator_runs["jax", "float32"]
        scale = np.abs(theirs["out"]).max()
        np.testing.assert_allclose(ours["out"], theirs["out"], rtol=0,
                                   atol=2e-4 * scale)
        assert set(ours["stats"]) == set(theirs["stats"])
        for name, v in ours["stats"].items():
            np.testing.assert_allclose(v, theirs["stats"][name], rtol=0,
                                       atol=2e-4, err_msg=name)
        assert set(ours["grads"]) == set(theirs["grads"])
        own = [base.grad_errors(u["grads"], ours["grads"])
               for u in generator_runs["one_ulp"]]
        elem = max(2e-2, 2 * max(o[0] for o in own))
        l2 = max(1e-2, 2 * max(o[1] for o in own))
        got = base.grad_errors(ours["grads"], theirs["grads"])
        assert got[0] <= elem and got[1] <= l2, (got, elem, l2)

    def test_mixed_edge(self, generator_runs):
        """Under mixed_edge the port's output, statistics and whole
        gradient lie no farther (relative L2) from JAX's float32 run on
        the same choices than 1.1 times JAX's mixed_edge run does (plus
        1e-6 for f32 sums in another order), and each gradient tensor no
        farther than 1.5 times JAX's distance or 1e-2, the per-tensor rule
        of tests/test_torch_train_mixed_vjp.py. Biases that feed a
        training BatchNorm are left out. bf16 edges move this forward's
        gradient far: JAX's own mixed_edge gradient lies 0.61 from its
        float32 one (relative L2). Measured: output 0.018 against JAX's
        0.023, whole gradient 0.62 against 0.61, per tensor 0.76 to 1.30
        times JAX's distance (tail3's bias 4.3 times, at 1.2e-3), the
        statistics 0.99 to 1.02 times."""
        ours, theirs = generator_runs["port", "mixed_edge"], \
            generator_runs["jax", "mixed_edge"]
        wit = generator_runs["witness"]

        def check(a, b, c, what):
            assert rel(a, c) <= 1.1 * rel(b, c) + 1e-6, what

        check(ours["out"], theirs["out"], wit["out"], "out")
        names = sorted(n for n in wit["grads"]
                       if not base.PRE_BN_BIAS.search(n))
        whole = [np.concatenate([r["grads"][n].ravel() for n in names])
                 for r in (ours, theirs, wit)]
        check(*whole, "G's gradient")
        for n in names:
            a, b, c = ours["grads"][n], theirs["grads"][n], wit["grads"][n]
            assert rel(a, c) <= max(1.5 * rel(b, c), 1e-2), n
        for n in wit["stats"]:
            check(ours["stats"][n], theirs["stats"][n], wit["stats"][n], n)


# ------------------------------------------------------ the fused step
@pytest.fixture(scope="module")
def f32_step():
    """One fused_train=True float32 step of each package (the JAX step
    takes its unfused path on the CPU, the same function)."""
    return base.run_both(dtype="float32", fused_train=True)


# the conv biases that feed EdgeConv2's train-mode BatchNorms: the fused
# backward gives them exactly zero gradient, so Adam leaves them in place
ZERO_GRAD = ("edge2.conv_w1.bias", "edge2.conv_w2.bias", "edge2.conv_x.bias")


class TestFusedStepParity(base.TestOneStepParity):
    """`tests/test_torch_train_step.py`'s one-step parity at its
    tolerances, with the port's G running the fused train-mode forward in
    both phases."""

    @pytest.mark.parametrize("net", ["d", "g"])
    def test_parameters_after_step(self, f32_step, net):
        """Within 2 lr + 2e-6 of the JAX step's. Every parameter moved
        but EdgeConv2's conv biases, whose gradient the fused backward
        makes exactly zero (the JAX step's XLA autodiff gives them
        rounding noise, which Adam turns into +-lr)."""
        theirs = f32_step["jax"]
        ours = f32_step["free" if net == "d" else "pinned"][f"{net}_params"]
        assert set(ours) == set(theirs[f"{net}_params"])
        for name, v in ours.items():
            np.testing.assert_allclose(
                v, theirs[f"{net}_params"][name], rtol=0,
                atol=2 * base.LR + 2e-6, err_msg=name)
        if net == "g":
            grads = f32_step["pinned"]["g_grads"]
            for name, v in ours.items():
                moved = not np.array_equal(v, theirs["start_g"][name])
                assert moved == (name not in ZERO_GRAD), name
                assert grads[name].any() == (name not in ZERO_GRAD), name


# ------------------------------------------------------ selection rules
def _step_counts(monkeypatch, **kw):
    """Calls of the fused forward and of Generator.forward in one step."""
    calls = {"fused": 0, "module": 0}
    fused, module = tstep.generator_forward_train, Generator.forward

    def count(key, fn):
        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(tstep, "generator_forward_train",
                        count("fused", fused))
    monkeypatch.setattr(Generator, "forward", count("module", module))
    cfg = Config(np=64, bs=2, nk=8, nz=16, **kw)
    from sp_gan_tpu_torch.nn import Discriminator
    from sp_gan_tpu_torch.train.state import create_train_state
    state = create_train_state(cfg, device="cpu", G=Generator(cfg, seed=0),
                               D=Discriminator(cfg, seed=1))
    step = tstep.make_train_step(cfg, sphere_template(cfg.np))
    state, m = step(state, torch.randn(2, 64, 3) * 0.3)
    assert all(np.isfinite(float(v)) for v in m.values())
    return calls


@pytest.mark.parametrize("kw, fused, module", [
    (dict(fused_train=True), 2, 0),
    (dict(fused_dphase=True), 1, 1),
    (dict(), 0, 2),
    (dict(fused_train=True, attn=True), 0, 2),     # supports_fused fails
    (dict(fused_dphase=True, eql=True), 0, 2),
])
def test_flags_select_the_fused_forward(kw, fused, module, monkeypatch):
    """`fused_train` serves both phases, `fused_dphase` the D phase's
    forward; where `supports_fused` fails the flags do nothing, as in the
    JAX step. On the CPU the kernels' plain versions run."""
    calls = _step_counts(monkeypatch, **kw)
    assert calls == {"fused": fused, "module": module}


@pytest.mark.parametrize("flag", ["fused_train", "fused_dphase"])
def test_approx_knn_with_fused_raises(flag):
    """The JAX fused forward selects EdgeConv2's neighbors exactly even
    under --knn_mode approx; the port refuses the pair."""
    cfg = Config(np=64, bs=2, nk=8, nz=16, knn_mode="approx",
                 knn_window=16, **{flag: True})
    with pytest.raises(ValueError, match="approx"):
        tstep.make_train_step(cfg, sphere_template(cfg.np))


def test_fused_step_launches_nothing_on_cpu():
    """On the CPU every wrapper runs its plain version: no launch counts."""
    kernels.reset_launch_counts()
    cfg = Config(np=64, bs=2, nk=8, nz=16, fused_train=True)
    from sp_gan_tpu_torch.nn import Discriminator
    from sp_gan_tpu_torch.train.state import create_train_state
    state = create_train_state(cfg, device="cpu", G=Generator(cfg, seed=0),
                               D=Discriminator(cfg, seed=1))
    tstep.make_train_step(cfg, sphere_template(cfg.np))(
        state, torch.randn(2, 64, 3) * 0.3)
    assert not any(kernels.launch_counts().values())


def test_train_cli_fused(tmp_path, capsys):
    """`python -m sp_gan_tpu_torch.train --fused_train` trains through the
    fused path on the CPU, and the bench takes both flags."""
    from sp_gan_tpu_torch import bench
    from sp_gan_tpu_torch.train import __main__ as train_cli
    d = str(tmp_path / "run")
    train_cli.main(["--device", "cpu", "--np", "64", "--bs", "4", "--nk",
                    "8", "--nz", "16", "--max_epoch", "1",
                    "--steps_per_epoch", "2", "--log_dir", d, "--data_root",
                    str(tmp_path), "--fused_train"])
    assert "Epoch: [ 1]" in capsys.readouterr().out
    bench.main(["--device", "cpu", "--np", "64", "--bs", "4", "--nk", "8",
                "--steps", "1", "--warmup", "1", "--fused_train",
                "--fused_dphase"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "fused_train, fused_dphase" in line
