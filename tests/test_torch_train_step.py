"""One default training step of the PyTorch port against the JAX package's
`make_train_step`, on the CPU, in float32.

Both start from the same JAX-initialised weights (carried through
`sp_gan_tpu_torch.compat`), the same real batch and the same codes: z_d and
z_g are rebuilt from the JAX step's own key splits (`train/step.py:116-120`)
and handed to the port's explicit-z arguments. The JAX step runs jitted on
the CPU through its XLA twins, as tests/test_train_step.py runs it.

Two kinds of choice in the step turn on near-ties that the packages' f32
rounding can break either way: EdgeConv2's neighbor selection and the max
pools over the points (the generator's global pool, D's fc2 pool). A flip
there moves a whole shape or a whole gradient column. So the port's
choices are recorded and replayed into the JAX step (`Replay`), and the
JAX step's own choices are checked to agree with them up to near-ties.
Selection itself is held against the Pallas kernel in
tests/test_torch_train_ops.py.

Adam's first step is about lr * sign(g), so a parameter whose gradient is
near zero moves by +-lr on rounding noise, differently in the two
packages. The G phase runs against the updated D, which carries that
noise; so the G phase is compared on a second port run whose D is set to
the JAX step's updated D right after D's Adam step ("pinned"): g_loss, G's
gradients and parameters, and the statistics. The D phase (d_loss, D's
gradients and parameters) is compared on the free run.
"""

import functools
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as flax_nn

from sp_gan_tpu import losses as jlosses
from sp_gan_tpu.config import Config as JaxConfig
from sp_gan_tpu.data import sphere_template as jsphere_template
from sp_gan_tpu.data.h5 import SyntheticDataset as JaxSynthetic
from sp_gan_tpu.data.noise import sample_z as jsample_z
from sp_gan_tpu.nn import discriminator as jdisc
from sp_gan_tpu.nn import generator as jgenerator
from sp_gan_tpu.nn import layers as jlayers
from sp_gan_tpu.ops import approx_knn as japprox
from sp_gan_tpu.ops import dispatch as jdispatch
from sp_gan_tpu.ops import emd as jemd
from sp_gan_tpu.ops.pairwise import knn_indices as jknn_indices
from sp_gan_tpu.train.state import create_train_state as jcreate
from sp_gan_tpu.train.step import make_train_step as jmake_step
from sp_gan_tpu_torch.compat import state_from_jax, trees
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.nn import Discriminator, Generator
from sp_gan_tpu_torch.nn import discriminator as tdisc
from sp_gan_tpu_torch.nn import fused_train as tfused
from sp_gan_tpu_torch.nn.layers import MaxPoolBNLReLU, lrelu
from sp_gan_tpu_torch.ops import edge as tedge
from sp_gan_tpu_torch.train import step as tstep
from sp_gan_tpu_torch.train.state import create_train_state

# the CutMix and GP modules (each package's `losses` exports a function
# named like the first)
jcutmix = importlib.import_module("sp_gan_tpu.losses.cutmix")
tcutmix = importlib.import_module("sp_gan_tpu_torch.losses.cutmix")
tgp = importlib.import_module("sp_gan_tpu_torch.losses.gp")

torch.set_num_threads(2)   # six test workers share the host's cores

CFG_KW = dict(np=256, bs=4, nk=8)
LR = 1e-4
# dense biases that feed a training-mode BatchNorm: BN subtracts the batch
# mean, so their exact gradient is zero and both packages return rounding
# noise; they are compared on the scale of their layer's kernel gradient
PRE_BN_BIAS = re.compile(r"(^|\.)(conv_w1|conv_w2|conv_x|global1|global2|"
                         r"mlp\d|fc2)\.bias$")


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.array(v, np.float32)
    return out


def recording_tx(store, lr):
    """optax Adam (b1 0.5, b2 0.99) that first hands its gradients to
    `store`."""
    def update(g, s, params=None):
        jax.debug.callback(lambda t: store.append(t), g)
        return g, s
    record = optax.GradientTransformation(lambda p: optax.EmptyState(),
                                          update)
    return optax.chain(record, optax.adam(lr, b1=0.5, b2=0.99))


def knn_near_tie(idx, ref, x, rel):
    """True when kNN picks are equal or differ only where the two picks'
    exact distances lie within `rel` of each other."""
    b, q, j = np.nonzero(idx != ref)
    x64 = np.asarray(x, np.float64)
    da = ((x64[b, q] - x64[b, idx[b, q, j]]) ** 2).sum(-1)
    dr = ((x64[b, q] - x64[b, ref[b, q, j]]) ** 2).sum(-1)
    return bool(np.all(np.abs(da - dr) <= rel * np.maximum(da, dr))
                and len(b) <= 0.01 * idx.size)


def pool_near_tie(x, idx, which, rel):
    """True when the values of x [B, N, C] at idx [B, C] are within `rel`
    of each channel's own max (which == 1) or min (2), relative to the
    channel's max-abs over the points."""
    got = np.take_along_axis(x, idx[:, None, :], axis=1)[:, 0, :]
    best = x.max(axis=1) if which == 1 else x.min(axis=1)
    return bool(np.all(np.abs(got - best) <= rel * np.abs(x).max(axis=1)))


class Replay:
    """The port's discrete choices, replayed into the JAX step at run time.

    The JAX step is traced once; every kNN dispatch and every max or min
    over the points in its nn modules becomes a `pure_callback` that reads
    the entry of its call number from `table` when the step runs, so the
    same compiled step replays another table on its next call. Each call
    also hands its input to `inputs`, for the near-tie checks. Installed as
    `sp_gan_tpu.ops.dispatch.knn` (`knn`) and as the `jnp` of the JAX
    layers and generator modules (`max`/`min`, everything else passes
    through to `jax.numpy`)."""

    def __init__(self, own_knn=None):
        self.table, self.inputs = {}, {}
        self.n_knn = self.n_pool = self.n_emd = self.n_lrelu = 0
        # the JAX step's own selection, for the near-tie checks
        self.own_knn = own_knn or jknn_indices

    def load(self, knn_picks, pools, emds=(), slopes=()):
        """Entries from a port run: kNN picks in call order, pools as
        ("g", argmax) or ("d", argmax, argmin) in call order, EMD
        assignments (WGAN-GP's pairing, CutMix's alignment) and the signs
        of D's leaky ReLU inputs (1 where the input is >= 0) in call
        order."""
        self.table = {("knn", i): a for i, a in enumerate(knn_picks)}
        self.table.update({("emd", i): a for i, a in enumerate(emds)})
        self.table.update({("lrelu", i): a for i, a in enumerate(slopes)})
        for i, entry in enumerate(pools):
            for which in range(1, len(entry)):
                self.table[("pool", i, which)] = entry[which]
        self.inputs = {}

    def _read(self, key, like, x):
        jax.debug.callback(
            lambda a: self.inputs.__setitem__(key, np.asarray(a)), x)
        return jax.pure_callback(lambda: self.table[key],
                                 jax.ShapeDtypeStruct(like, jnp.int32))

    def knn(self, x, k):
        key = ("knn", self.n_knn)
        self.n_knn += 1
        x = jax.lax.stop_gradient(x)
        return self._read(key, x.shape[:2] + (k,), x)

    def __getattr__(self, name):
        return getattr(jnp, name)

    def leaky_relu(self, x, negative_slope=0.01):
        """D's leaky ReLU with the port's slope choices (installed through
        `FlaxNN` as the `nn` of the JAX discriminator module)."""
        key = ("lrelu", self.n_lrelu)
        self.n_lrelu += 1
        up = self._read(key, x.shape, jax.lax.stop_gradient(x)) != 0
        return jnp.where(up, x, negative_slope * x)

    def emd(self, xyz1, xyz2, eps=0.005, iters=50, scaled=False):
        """`emd_auction` with the port's assignment: (dist, assignment)."""
        key = ("emd", self.n_emd)
        self.n_emd += 1
        both = jax.lax.stop_gradient(jnp.concatenate([xyz1, xyz2], axis=1))
        ass = self._read(key, xyz1.shape[:2], both)
        matched = jnp.take_along_axis(xyz2, ass[..., None], axis=1)
        return jnp.sum((xyz1 - matched) ** 2, axis=-1), ass

    def _pool(self, x, which):
        # D's pool asks for max, then min, of one tensor; G's for max only
        if which == 1:
            self.n_pool += 1
        key = ("pool", self.n_pool - 1, which)
        idx = self._read(key, (x.shape[0], x.shape[2]),
                         jax.lax.stop_gradient(x))
        return jnp.take_along_axis(x, idx[:, None, :], axis=1)[:, 0, :]

    def max(self, x, axis=None, **kw):
        return self._pool(x, 1) if axis == 1 else jnp.max(x, axis, **kw)

    def min(self, x, axis=None, **kw):
        return self._pool(x, 2) if axis == 1 else jnp.min(x, axis, **kw)

    def assert_near_ties(self, keys, rel=1e-4):
        """The JAX step's own choices agree with the replayed ones up to
        near-ties within `rel`, at the given entries."""
        for key in keys:
            if key[0] == "emd":
                continue      # the assignment's cost: see emd_cost_gaps
            x, mine = self.inputs[key], self.table[key]
            if key[0] == "knn":
                own = np.asarray(self.own_knn(jnp.asarray(x),
                                              mine.shape[-1]))
                assert knn_near_tie(mine, own, x, rel), key
            elif key[0] == "lrelu":
                # a slope differs only where the input is within rounding
                # of 0, on the scale of its tensor
                flip = (x >= 0) != (mine != 0)
                assert np.all(np.abs(x[flip]) <= rel * np.abs(x).max()), key
            else:
                assert pool_near_tie(x, mine, key[2], rel), key


class FlaxNN:
    """`flax.linen` with `leaky_relu` taken from a `Replay`."""

    def __init__(self, replay):
        self.leaky_relu = replay.leaky_relu

    def __getattr__(self, name):
        return getattr(flax_nn, name)


def port_step(cfg, jstate, sphere, real, z_d, z_g, pinned_d=None,
              draws=None):
    """One port step from the JAX start `jstate`. Returns (results, the
    EdgeConv2 selections, the max-pool choices, the EMD assignments, the
    signs of D's leaky ReLU inputs), all in call order. With `pinned_d`
    (name -> array), D's parameters take those values right after D's
    Adam step. `draws` (name -> array) are the regularizers' draws handed
    to the step."""
    G, D = Generator(cfg, seed=None), Discriminator(cfg, seed=None)
    G.load_state_dict(state_from_jax(jstate.g_params, jstate.g_stats))
    D.load_state_dict(state_from_jax(jstate.d_params, jstate.d_stats))
    state = create_train_state(cfg, device="cpu", G=G, D=D)
    picks, grads, pools, emds, slopes = [], [], [], [], []

    def recording(fused):
        """EdgeConv2's fused op (kernel B's diff or, under fused_train and
        fused_dphase, concat form, or kernel F's on the band of knn_mode
        approx), recording its picks."""
        def run(x, *args):
            diff, idx = fused(x, *args)
            picks.append(idx.numpy().copy())
            return diff, idx
        return run

    def recording_emd(fn):
        def run(*a, **kw):
            dist, ass = fn(*a, **kw)
            emds.append(ass.numpy().copy())
            return dist, ass
        return run

    def recording_lrelu(x, slope):
        slopes.append((x.detach() >= 0).numpy().astype(np.int32))
        return lrelu(x, slope)

    apply = tstep._apply

    def recording_apply(opt, params, grads_, lr, nan_guard):
        grads.append([g.detach().numpy().copy() for g in grads_])
        apply(opt, params, grads_, lr, nan_guard)
        if pinned_d is not None and opt is state.d_opt:
            with torch.no_grad():
                for name, p in D.named_parameters():
                    p.copy_(torch.from_numpy(pinned_d[name]))

    def arg(t, fn):
        return fn(t.detach().float(), dim=1).numpy().astype(np.int32)

    G.adain2.register_forward_hook(lambda m, a, out: pools.append(
        ("g", arg(out, torch.argmax))))
    adain = tfused._adain

    def recording_adain(p, x, style):
        """The fused forward's AdaIN, recording G's pool after adain2."""
        out = adain(p, x, style)
        if p is G.adain2:
            pools.append(("g", arg(out, torch.argmax)))
        return out

    assert isinstance(D.bn_fc2, MaxPoolBNLReLU)
    D.bn_fc2.register_forward_pre_hook(lambda m, a: pools.append(
        ("d", arg(a[0], torch.argmax), arg(a[0], torch.argmin))))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tedge, "edge_diff_fused",
                   recording(tedge.edge_diff_fused))
        mp.setattr(tedge, "edge_diff_window",
                   recording(tedge.edge_diff_window))
        mp.setattr(tedge, "edge_concat_fused",
                   recording(tedge.edge_concat_fused))
        mp.setattr(tfused, "_adain", recording_adain)
        mp.setattr(tstep, "_apply", recording_apply)
        mp.setattr(tdisc, "lrelu", recording_lrelu)
        mp.setattr(tgp, "emd_auction", recording_emd(tgp.emd_auction))
        mp.setattr(tcutmix, "emd_auction",
                   recording_emd(tcutmix.emd_auction))
        step = tstep.make_train_step(cfg, sphere)
        state, m = step(state, torch.from_numpy(real), torch.from_numpy(z_d),
                        torch.from_numpy(z_g),
                        {k: torch.from_numpy(np.asarray(v))
                         for k, v in (draws or {}).items()})
    assert len(picks) == 2     # EdgeConv2 in the D and in the G phase
    # D on the real batch, the fakes, and the regularizers' inputs
    regs = int(cfg.gan == "wgan" and cfg.lambda_gp > 0) + int(cfg.mix)
    assert [p[0] for p in pools] == ["g"] + ["d"] * (2 + regs) + ["g", "d"]
    out = {key: float(m[key]) for key in ("d_loss", "g_loss", "real_acc",
                                          "fake_acc")}
    out["d_grads"] = dict(zip([n for n, _ in D.named_parameters()],
                              grads[0]))
    out["g_grads"] = dict(zip([n for n, _ in G.named_parameters()],
                              grads[1]))
    for net, mod in (("g", state.G), ("d", state.D)):
        params, stats = trees(mod)
        out[f"{net}_params"], out[f"{net}_stats"] = flat(params), flat(stats)
    return out, picks, pools, emds, slopes


def jax_draws(k_gp, cfg) -> dict:
    """The regularizers' draws of the JAX step from its key `k_gp`
    (`train/step.py:116`): WGAN-GP's alpha (`losses/gp.py:71`) and
    CutMix's lam, anchor and flip (`losses/cutmix.py:50-96`)."""
    B, N = cfg.bs, cfg.np
    k_lam, k_anchor, k_flip = jax.random.split(k_gp, 3)
    return {"alpha": np.array(jax.random.uniform(k_gp, (B, 1, 1),
                                                 dtype=jnp.float32)),
            "lam": np.array(jax.random.uniform(k_lam, (B,))),
            "anchor": np.array(jax.random.randint(k_anchor, (B,), 0, N),
                               np.int64),
            "flip": np.array(jax.random.bernoulli(k_flip))}


# the D phase's choices: EdgeConv2's kNN, the G pool, D's real and fake pools
D_PHASE = [("knn", 0), ("pool", 0, 1)] + [("pool", i, w) for i in (1, 2)
                                          for w in (1, 2)]
# D's max and min pools on the real batch, the choices no generator feeds
REAL_POOLS = [("pool", 1, 1), ("pool", 1, 2)]


def run_both(near_tie=1e-4, tie_keys=None, one_ulp=False, witness=None,
             jax_one_ulp=False, replay_slopes=False, zd_one_ulp=False,
             **kw):
    """One step of each package from the same start: a dict of numpy
    results of the free port run, the pinned port run and the JAX step.
    `near_tie` bounds how far the JAX step's own choices may lie from the
    replayed ones (kNN: exact distances; pools: of the channel's
    max-abs); in float32 the packages' features differ by ~1e-5 of
    that. `near_tie=None` checks nothing; `tie_keys` names the entries
    checked in both runs instead of those below.

    1. The port runs free; its choices are replayed into JAX run A, whose
       D-phase choices are checked for near-ties and whose updated D
       pins the second port run.
    2. The pinned port run's choices are replayed into JAX run B (the same
       compiled step), all of them checked for near-ties. B's D phase is
       A's; its G phase ran against the same D as the pinned run's.

    With `one_ulp`, also port runs like the free one with z_g moved by one
    ulp up and down ("one_ulp": [(results, whether it made the free run's
    discrete choices)]): how far rounding alone moves the G phase.

    With `witness` (a dtype), also the JAX step in that dtype from the same
    start, replaying the choices of run B ("witness"): how far the JAX
    package's own arithmetic moves when its dtype changes.

    With `zd_one_ulp`, also port runs like the free one with z_d moved by
    one ulp up and down ("zd_one_ulp": [(results, whether it made the free
    run's kNN choices)]): how far rounding alone moves the D phase.

    With `jax_one_ulp`, also the JAX step of run B with the real batch
    moved by one ulp up and down, replaying the same choices
    ("jax_one_ulp": [results]): how far rounding alone moves the JAX
    step.

    With `replay_slopes`, the slopes of D's leaky ReLUs are replayed too
    (each JAX slope checked to differ from the port's only where its input
    lies within `near_tie` of 0 on its tensor's scale)."""
    jcfg = JaxConfig(**{**CFG_KW, **kw}, donate_state=False)
    cfg = Config(**{**CFG_KW, **kw})
    jgrads = {"d": [], "g": []}
    jstate, jG, jD, _, _ = jcreate(jcfg, jax.random.PRNGKey(0))
    g_tx, d_tx = recording_tx(jgrads["g"], LR), recording_tx(jgrads["d"], LR)
    jstate = jstate.replace(g_opt=g_tx.init(jstate.g_params),
                            d_opt=d_tx.init(jstate.d_params))
    sphere = jsphere_template(cfg.np)
    real = JaxSynthetic(n_items=cfg.bs, n_points=cfg.np, seed=5).data.copy()
    # the JAX step's codes and draws, from its own key splits
    _, k_zd, k_zg, _, _, k_gp = jax.random.split(jstate.rng, 6)
    z_d, z_g = (np.array(jsample_z(kk, cfg.bs, cfg.np, cfg.nz, cfg.nv))
                for kk in (k_zd, k_zg))
    draws = jax_draws(k_gp, cfg)

    if witness:
        wcfg = JaxConfig(**{**CFG_KW, **kw, "dtype": witness},
                         donate_state=False)
        _, wG, wD, _, _ = jcreate(wcfg, jax.random.PRNGKey(0))

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPGAN_KNN_SELECT", "exact")
        free_run = port_step(cfg, jstate, sphere, real, z_d, z_g,
                             draws=draws)
        free, picks, pools, emds, slopes = free_run
        own = None
        if cfg.knn_mode == "approx":
            # EdgeConv2's band: the JAX step selects with the XLA window
            # selection at the band edge_diff_features normalizes to
            W = tedge.normalize_window(cfg.np, cfg.k, cfg.knn_window)
            own = functools.partial(japprox.knn_indices_window, window=W)
        replay = Replay(own)
        mp.setattr(jdispatch, "knn", replay.knn)
        mp.setattr(japprox, "knn_indices_window",
                   lambda x, k, window=None, block=None: replay.knn(x, k))
        mp.setattr(jlayers, "jnp", replay)
        mp.setattr(jgenerator, "jnp", replay)
        if replay_slopes:
            mp.setattr(jdisc, "nn", FlaxNN(replay))
        mp.setattr(jemd, "emd_auction", replay.emd)
        mp.setattr(jcutmix, "emd_auction", replay.emd)
        # cutmix unjitted, so that no trace cached with the real EMD serves
        mp.setattr(jlosses, "cutmix", jcutmix.cutmix.__wrapped__)
        jstep = jmake_step(jcfg, jG, jD, g_tx, d_tx, jnp.asarray(sphere))

        def jax_run():
            jnew, jm = jstep(jstate, jnp.asarray(real))
            jax.block_until_ready(jnew)
            out = {k: float(jm[k]) for k in ("d_loss", "g_loss", "real_acc",
                                             "fake_acc")}
            out["d_grads"] = flat(jgrads["d"].pop())
            out["g_grads"] = flat(jgrads["g"].pop())
            for key in ("g_params", "g_stats", "d_params", "d_stats"):
                out[key] = flat(jax.device_get(getattr(jnew, key)))
            return out

        replay.load(picks, pools, emds, slopes if replay_slopes else ())
        run_a = jax_run()
        if near_tie:
            replay.assert_near_ties(tie_keys or D_PHASE, near_tie)
        pinned_run = port_step(cfg, jstate, sphere, real, z_d, z_g,
                               pinned_d=run_a["d_params"], draws=draws)
        replay.load(*pinned_run[1:4],
                    pinned_run[4] if replay_slopes else ())
        theirs = jax_run()
        if near_tie:
            replay.assert_near_ties(tie_keys or sorted(replay.table),
                                    near_tie)
        out = {"free": free, "pinned": pinned_run[0], "jax": theirs,
               "emd_inputs": {k: v for k, v in replay.inputs.items()
                              if k[0] == "emd"},
               "emds": emds}
        if jax_one_ulp:
            exact, out["jax_one_ulp"] = real, []
            for eps in (2.0 ** -23, -2.0 ** -23):
                real = (exact * (1 + eps)).astype(np.float32)
                out["jax_one_ulp"].append(jax_run())
            real = exact
        if witness:
            jgrads = {"d": [], "g": []}
            g_tx = recording_tx(jgrads["g"], LR)
            d_tx = recording_tx(jgrads["d"], LR)
            jstate = jstate.replace(g_opt=g_tx.init(jstate.g_params),
                                    d_opt=d_tx.init(jstate.d_params))
            jstep = jmake_step(wcfg, wG, wD, g_tx, d_tx, jnp.asarray(sphere))
            # a new trace counts anew
            replay.n_knn = replay.n_pool = replay.n_emd = replay.n_lrelu = 0
            out["witness"] = jax_run()
        if zd_one_ulp:
            out["zd_one_ulp"] = []
            for eps in (2.0 ** -23, -2.0 ** -23):
                ulp = port_step(cfg, jstate, sphere, real,
                                (z_d * (1 + eps)).astype(np.float32), z_g,
                                draws=draws)
                same = all(np.array_equal(a, b)
                           for a, b in zip(free_run[1], ulp[1]))
                out["zd_one_ulp"].append((ulp[0], same))
        if one_ulp:
            out["one_ulp"] = []
            for eps in (2.0 ** -23, -2.0 ** -23):
                ulp = port_step(cfg, jstate, sphere, real, z_d,
                                (z_g * (1 + eps)).astype(np.float32),
                                draws=draws)
                same = (all(np.array_equal(a, b)
                            for a, b in zip(free_run[1], ulp[1]))
                        and all(np.array_equal(a[1], b[1])
                                for a, b in zip(free_run[2], ulp[2])))
                out["one_ulp"].append((ulp[0], same))
    assert theirs["d_loss"] == run_a["d_loss"]
    theirs["start_g"] = flat(jstate.g_params)
    return out


def grad_scale(grads, name):
    """Max-abs of the gradient `name`; for a bias that feeds a training
    BatchNorm (exact gradient zero), that of its layer's kernel."""
    scale = np.abs(grads[name]).max()
    if PRE_BN_BIAS.search(name):
        scale = max(scale, np.abs(grads[name[:-4] + "kernel"]).max())
    return scale


@pytest.fixture(scope="module")
def f32_step():
    return run_both(dtype="float32")


class TestOneStepParity:
    def test_d_phase_loss_and_accuracies(self, f32_step):
        free, theirs = f32_step["free"], f32_step["jax"]
        np.testing.assert_allclose(free["d_loss"], theirs["d_loss"],
                                   rtol=1e-5)
        assert (free["real_acc"], free["fake_acc"]) == \
            (theirs["real_acc"], theirs["fake_acc"])

    def test_d_gradients(self, f32_step):
        """Every element within 1e-3 of its tensor's max-abs and each
        tensor within 2e-4 in relative L2 norm. Where an input of D's
        leaky ReLUs lies within rounding of 0, the packages take different
        slopes for that element; those few elements (under 1% of bn3's
        and mlp3's) differ by up to 4e-4 of the max-abs here, the rest by
        under 1e-4."""
        ours, theirs = f32_step["free"]["d_grads"], f32_step["jax"]["d_grads"]
        assert set(ours) == set(theirs)
        for name in ours:
            a, b = ours[name], theirs[name]
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-3 * grad_scale(theirs, name),
                                       err_msg=name)
            if not PRE_BN_BIAS.search(name):
                assert np.linalg.norm(a - b) <= 2e-4 * np.linalg.norm(b), name

    def test_g_phase(self, f32_step):
        """g_loss within 5e-5 relative; G's gradients within 1e-2 of each
        tensor's norm (relative L2) and 2e-2 of its max-abs, elementwise.
        These bounds are the G phase's own conditioning at this size, not
        a difference of the packages: a one-ulp change of z_g moves the
        port's G gradients by 4.5e-3 in relative L2 and 8.6e-3 of the
        max-abs with every discrete choice the same, and g_loss by 1.2e-5
        where it flips a max pool (`report` below, on these inputs),
        through BatchNorm over a batch of 4 and the cancellation of
        `E[x^2] - mean^2`. The packages differ by as much: 4.5e-3, 6.9e-3
        and 1.2e-5."""
        ours, theirs = f32_step["pinned"], f32_step["jax"]
        np.testing.assert_allclose(ours["g_loss"], theirs["g_loss"],
                                   rtol=5e-5)
        assert set(ours["g_grads"]) == set(theirs["g_grads"])
        for name, a in ours["g_grads"].items():
            b = theirs["g_grads"][name]
            np.testing.assert_allclose(
                a, b, rtol=0, atol=2e-2 * grad_scale(theirs["g_grads"], name),
                err_msg=name)
            if not PRE_BN_BIAS.search(name):
                assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b), name

    @pytest.mark.parametrize("net", ["d", "g"])
    def test_parameters_after_step(self, f32_step, net):
        """Within 2 lr + 2e-6: Adam's first step moves a parameter with a
        near-zero gradient by +-lr on the sign of rounding noise. D's from
        the free run, G's from the pinned run (its G phase saw JAX's D)."""
        theirs = f32_step["jax"]
        ours = f32_step["free" if net == "d" else "pinned"][f"{net}_params"]
        assert set(ours) == set(theirs[f"{net}_params"])
        for name, v in ours.items():
            np.testing.assert_allclose(
                v, theirs[f"{net}_params"][name], rtol=0,
                atol=2 * LR + 2e-6, err_msg=name)
        if net == "g":
            assert all(not np.array_equal(v, theirs["start_g"][name])
                       for name, v in ours.items())

    @pytest.mark.parametrize("net", ["d", "g"])
    def test_running_stats(self, f32_step, net):
        """G's statistics went through two training forwards (D phase,
        G phase) and D's through three (real, fake, G-phase fake), the
        last against JAX's updated D (the pinned run)."""
        ours = f32_step["pinned"][f"{net}_stats"]
        theirs = f32_step["jax"][f"{net}_stats"]
        assert set(ours) == set(theirs)
        for name, v in ours.items():
            np.testing.assert_allclose(v, theirs[name], rtol=0, atol=2e-4,
                                       err_msg=name)


def grad_errors(ours, theirs):
    """(largest error over a tensor's max-abs, largest relative L2 error)
    over the gradient tensors of one network, as the tests measure them."""
    elem = max(np.abs(a - theirs[n]).max() / grad_scale(theirs, n)
               for n, a in ours.items())
    l2 = max(np.linalg.norm(a - theirs[n]) / np.linalg.norm(theirs[n])
             for n, a in ours.items() if not PRE_BN_BIAS.search(n))
    return float(elem), float(l2)


def report(dtype):
    """Prints the measured gaps of one step between the packages, the
    port's own response to a one-ulp change of z_g and, outside float32,
    each package's distance to the JAX float32 step on the same choices."""
    f32 = dtype == "float32"
    r = run_both(tie_keys=None if f32 else REAL_POOLS, one_ulp=True,
                 witness=None if f32 else "float32", dtype=dtype)
    free, pinned, theirs = r["free"], r["pinned"], r["jax"]
    rel = lambda a, b: abs(a - b) / abs(b)
    print(f"[{dtype}] d_loss {rel(free['d_loss'], theirs['d_loss']):.3g}, "
          f"g_loss {rel(pinned['g_loss'], theirs['g_loss']):.3g} relative")
    print(f"[{dtype}] D gradients (elementwise, L2): "
          f"{grad_errors(free['d_grads'], theirs['d_grads'])}")
    print(f"[{dtype}] G gradients (elementwise, L2): "
          f"{grad_errors(pinned['g_grads'], theirs['g_grads'])}")
    def cos(a, b):
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    names = sorted(n for n in pinned["g_grads"] if not PRE_BN_BIAS.search(n))
    whole = [np.concatenate([run["g_grads"][n].ravel() for n in names])
             for run in (pinned, theirs)]
    d_cos = min(cos(g.ravel(), theirs["d_grads"][n].ravel())
                for n, g in free["d_grads"].items()
                if not PRE_BN_BIAS.search(n))
    print(f"[{dtype}] cosine: least of D's tensors {d_cos:.5f}, G's whole "
          f"gradient {cos(*whole):.5f}")
    for net, run in (("d", free), ("g", pinned)):
        print(f"[{dtype}] {net} weights after the step: max "
              f"{max(np.abs(v - theirs[net + '_params'][n]).max() for n, v in run[net + '_params'].items()):.3g}")
    print(f"[{dtype}] statistics: max "
          f"{max(np.abs(v - theirs[k][n]).max() for k in ('g_stats', 'd_stats') for n, v in pinned[k].items()):.3g}")
    for ulp, same in r["one_ulp"]:
        print(f"[{dtype}] port, one ulp of z_g (same choices: {same}): "
              f"g_loss {rel(ulp['g_loss'], free['g_loss']):.3g}, G "
              f"gradients {grad_errors(ulp['g_grads'], free['g_grads'])}")
    if f32:
        return
    wit = r["witness"]
    l2 = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    w = whole + [np.concatenate([wit["g_grads"][n].ravel() for n in names])]
    ratio = max((l2(pinned["g_grads"][n], wit["g_grads"][n])
                 / l2(theirs["g_grads"][n], wit["g_grads"][n]), n)
                for n in names)
    print(f"[{dtype}] to the float32 step: g_loss port "
          f"{rel(pinned['g_loss'], wit['g_loss']):.3g}, JAX "
          f"{rel(theirs['g_loss'], wit['g_loss']):.3g}; G's whole gradient "
          f"(relative L2) port {l2(w[0], w[2]):.3g}, JAX {l2(w[1], w[2]):.3g};"
          f" largest per-tensor ratio port/JAX {ratio[0]:.3g} ({ratio[1]})")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train_step.py
    for dt in ("float32", "mixed_edge"):
        report(dt)
