"""The port's parallel training steps, sampler, Trainer and protocol on
gloo ranks of the CPU, against the port's one-process functions:

- the data-parallel step (`make_train_step(cfg, sphere, mesh)`) on a (2,)
  mesh, with BatchNorm synchronized (`bn_stats="global"`) against the
  one-process step, and per replica (`per_shard`) against the one-process
  step with two statistic groups;
- the point-sharded step (`make_train_step_pointsharded`) on a 2 x 2
  (data, points) mesh against the one-process step, plain and under
  --attn, --mix, per_shard, --n_mix and WGAN-GP with and without
  --gp_mapping (`tests/test_points_sharding.py`'s cases and tolerances);
- the point-sharded sampler, one Trainer epoch on a 2 x 2 mesh, and
  `evaluate --mesh_points 2`.

Both sides start from the same weights, batch, codes and draws; their
optimizers are plain SGD at lr 1e-2, so that the G phase runs against a
D moved by the gradients and not by Adam's signs of rounding noise. The
selection is exact (SPGAN_KNN_SELECT=exact) in both. Each world size runs
its cases in one spawn (`torch_parallel_workers.py`).
"""

import os
import re

import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data import SyntheticDataset
from sp_gan_tpu_torch.data.sphere import sphere_template
from sp_gan_tpu_torch.eval.metrics import pairwise_emd_matrix
from sp_gan_tpu_torch.ops.emd import auction_scaled_jacobi
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist
from sp_gan_tpu_torch.parallel import backend_for
from sp_gan_tpu_torch.train.state import create_train_state
from sp_gan_tpu_torch.train.step import make_sample_fn
from sp_gan_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)   # six test workers share the host's cores

BASE = dict(np=64, bs=16, nk=8, nz=16, dtype="float32", lr_g=1e-2,
            lr_d=1e-2)
# dense biases that feed a training BatchNorm: their exact gradient is 0
PRE_BN_BIAS = re.compile(r"(^|\.)(conv_w1|conv_w2|conv_x|global1|global2|"
                         r"mlp\d|fc2)\.bias$")
DP_CASES = {"global": dict(bs=8),
            "per_shard": dict(bs=8, bn_stats="per_shard", mesh_shape=(2,))}
# name -> (flags, the step draws its own codes, CutMix aligned by the
# scaled Jacobi auction on the one-process side)
PS_CASES = {"plain": ({}, False, False),
            "attn": (dict(attn=True), False, False),
            "mix": (dict(mix=True), False, True),
            "per_shard": (dict(bn_stats="per_shard"), False, False),
            "n_mix": (dict(n_mix=True), True, False),
            "wgan": (dict(gan="wgan"), False, False),
            "gp_mapping": (dict(gan="wgan", gp_mapping=True,
                                gp_emd_iters=300), False, False)}



def step_inputs(kw, seed=0, draw_codes=False):
    cfg = Config(**kw)
    rng = np.random.default_rng(seed)
    B, N = cfg.bs, cfg.np
    z = [np.broadcast_to(rng.standard_normal((B, 1, cfg.nz)) * cfg.nv,
                         (B, N, cfg.nz)).astype(np.float32)
         for _ in range(2)]
    return {"real": SyntheticDataset(B, N, seed=seed).data.astype(np.float32),
            "z_d": None if draw_codes else z[0],
            "z_g": None if draw_codes else z[1],
            "draws": {"alpha": rng.uniform(size=(B, 1, 1)).astype(np.float32),
                      "lam": rng.uniform(size=B).astype(np.float32),
                      "anchor": rng.integers(0, N, B),
                      "flip": np.array(rng.uniform() < 0.5)}}


def reference(kw, inp, jacobi_mix=False, one_ulp=False, pinned=None):
    """The one-process step on the same inputs; per_shard takes the mesh's
    two statistic groups (`cfg.bn_groups`). `pinned`: see
    `workers.run_step`. With `one_ulp`, also the runs with z_g (the codes
    the step drew, where it drew them) moved by one ulp up and down
    ("own")."""
    from sp_gan_tpu_torch.train import step as step_mod
    if kw.get("bn_stats") == "per_shard":
        kw = {**kw, "mesh_shape": (2,)}
    codes, sample_z = [], step_mod.sample_z

    def recording(*a, **k):
        z = sample_z(*a, **k)
        codes.append(z.numpy().copy())
        return z

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(step_mod, "sample_z", recording)
        out = workers.run_step(Config(**kw), inp["real"], inp["z_d"],
                               inp["z_g"], inp["draws"],
                               jacobi_mix=jacobi_mix, pinned=pinned)
    if one_ulp:
        z_d = codes[0] if inp["z_d"] is None else inp["z_d"]
        z_g = codes[-1] if inp["z_g"] is None else inp["z_g"]
        out["own"] = [workers.run_step(
            Config(**kw), inp["real"], z_d,
            (z_g * (1 + eps)).astype(np.float32), inp["draws"],
            jacobi_mix=jacobi_mix, pinned=pinned)
            for eps in (2.0 ** -23, -2.0 ** -23)]
    return out


@pytest.fixture(scope="module")
def exact_select():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPGAN_KNN_SELECT", "exact")
        yield


@pytest.fixture(scope="module")
def two(exact_select, tmp_path_factory):
    """The (2,) runs: the data-parallel cases and the sharded protocol."""
    cases = {n: ({**BASE, **kw}, step_inputs({**BASE, **kw}))
             for n, kw in DP_CASES.items()}
    d = tmp_path_factory.mktemp("protocol")
    rng = np.random.default_rng(1)
    gen = rng.standard_normal((2, 64, 3)).astype(np.float32)
    ref = rng.standard_normal((3, 64, 3)).astype(np.float32)
    np.save(d / "gen.npy", gen)
    np.save(d / "ref.npy", ref)
    protocol = {"gen": gen, "ref": ref, "iters": 1000,
                "gen_path": str(d / "gen.npy"),
                "ref_path": str(d / "ref.npy")}
    ranks = workers.spawn(2, "step2", cases, protocol)
    refs = {n: reference(kw, inp) for n, (kw, inp) in cases.items()}
    return cases, ranks, refs, protocol


@pytest.fixture(scope="module")
def four(exact_select, tmp_path_factory):
    """The 2 x 2 runs: the point-sharded cases, the sampler, the Trainer."""
    cases = {}
    for n, (kw, draw, jac) in PS_CASES.items():
        kw = {**BASE, **kw}
        cases[n] = (kw, step_inputs(kw, draw_codes=draw), jac)
    sampler = {"cfg": dict(np=64, bs=4, nk=8, nz=16, dtype="float32"),
               "z": (0.2 * np.random.default_rng(3).standard_normal(
                   (4, 64, 16))).astype(np.float32)}
    log_dir = str(tmp_path_factory.mktemp("run"))
    ranks = workers.spawn(4, "step4", cases, sampler, log_dir)
    refs = {}
    for n, (kw, inp, jac) in cases.items():
        refs[n] = reference(kw, inp, jac)
        # the D phase on the point-sharded run's fakes, the G phase
        # against its updated D
        refs[n]["pinned"] = reference(
            kw, inp, jac, True,
            (whole_block(ranks, n, "fake"), ranks[0][n]["params"]))
    return cases, ranks, refs, sampler, log_dir


def whole_block(ranks, case, key):
    """The whole batch of a 2 x 2 mesh's [B / 2, N / 2, ...] blocks."""
    return np.concatenate([np.concatenate(
        [ranks[2 * d + p][case][key] for p in range(2)], axis=1)
        for d in range(2)], axis=0)


def assert_losses(ours, ref, rtol, keys=("d_loss", "g_loss")):
    """Within rtol of the one-process losses; g_loss also within twice
    the one-process step's own one-ulp response where `ref` has it."""
    for k in keys:
        own = max((abs(o["loss"][k] - ref["loss"][k])
                   for o in ref.get("own", ())), default=0.0)
        assert abs(ours["loss"][k] - ref["loss"][k]) \
            <= 1e-6 + rtol * abs(ref["loss"][k]) + 2 * own, k


def assert_grads(ours, ref, rtol=2e-2, atol=1e-3, aggregate=5e-3,
                 phases=("d_grads", "g_grads")):
    """Each gradient element within atol + rtol of the one-process one,
    and each tensor's mean absolute error within `aggregate` of its mean
    magnitude (a wrong scale of a collective moves every element by a
    factor of 2 to 4). Isolated max-pool and leaky ReLU flips on rounding
    near-ties move single elements, which the elementwise bound allows.
    Where `ref` has its own one-ulp runs ("own"), G's gradients may also
    lie twice as far as those runs lie from it, element by element and in
    the mean: at bs 4 a pool or kNN near-tie that one ulp of z_g flips
    moves whole columns of G's gradients (under --n_mix a third of some
    tensors' elements beyond the bound above)."""
    for phase in phases:
        for name, a in ours[phase].items():
            b = ref[phase][name]
            own = np.zeros_like(b)
            if phase == "g_grads" and "own" in ref:
                own = np.max([np.abs(o[phase][name] - b)
                              for o in ref["own"]], axis=0)
            err = np.abs(a - b)
            assert np.all(err <= atol + rtol * np.abs(b) + 2 * own), \
                f"{phase} {name}: {err.max()}"
            denom = np.abs(b).mean()
            if denom > 1e-5 and not PRE_BN_BIAS.search(name):
                assert err.mean() / denom < aggregate \
                    + 2 * own.mean() / denom, f"{phase} {name}"


def assert_stats(ours, ref, rtol=1e-3, atol=2e-5):
    for name, v in ours["stats"].items():
        np.testing.assert_allclose(v, ref["stats"][name], rtol=rtol,
                                   atol=atol, err_msg=name)


def assert_ranks_agree(ranks, key):
    """Parameters and buffers equal on every rank after the step."""
    for r in ranks[1:]:
        for part in ("params", "stats"):
            for name, v in ranks[0][key][part].items():
                np.testing.assert_array_equal(r[key][part][name], v,
                                              err_msg=f"{part} {name}")


@pytest.mark.parametrize("case", sorted(DP_CASES))
def test_data_parallel_step_matches_one_process(two, case):
    _, ranks, refs, _ = two
    ours, ref = ranks[0][case], refs[case]
    assert_losses(ours, ref, 1e-5)
    assert ours["loss"]["real_acc"] == ref["loss"]["real_acc"]
    assert ours["loss"]["fake_acc"] == ref["loss"]["fake_acc"]
    assert_grads(ours, ref)
    assert_stats(ours, ref)
    assert_ranks_agree(ranks, case)


def grad_gaps(ours, ref):
    """(the largest error over its tensor's max-abs, the largest relative
    L2 error) of one network's gradients; a bias that feeds a training
    BatchNorm (exact gradient 0) is scaled by its kernel's max-abs and
    left out of the L2. A tensor whose gradient is 0 (attention's, behind
    its gain of 0) must stay 0."""
    def over(err, scale):
        return err / scale if scale else (0.0 if not err else np.inf)

    elem = l2 = 0.0
    for name, a in ours.items():
        b = ref[name]
        scale = np.abs(b).max()
        if PRE_BN_BIAS.search(name):
            scale = max(scale, np.abs(ref[name[:-4] + "kernel"]).max())
        else:
            l2 = max(l2, over(np.linalg.norm(a - b), np.linalg.norm(b)))
        elem = max(elem, over(np.abs(a - b).max(), scale))
    return elem, l2


@pytest.mark.parametrize("case", sorted(PS_CASES))
def test_point_sharded_step_matches_one_process(four, case):
    """Each phase against the one-process step on the sharded run's inputs
    ("pinned": the D phase takes the sharded run's fakes, the G phase its
    updated D): d_loss within 1e-5, g_loss within 2e-4; both networks'
    gradients within 2e-2 of each tensor's max-abs and 1e-2 in relative
    L2 (the G phase's bounds of tests/test_torch_train_step.py), or for
    G twice the pinned step's own response to one ulp of z_g if larger.
    The clouds of the generator at its start are tight
    clusters, so the max pools over their points hold near-ties that the
    sharded moments round the other way: a flip moves a gradient column
    (measured up to 1e-2 of a D tensor's max-abs, 4e-3 in L2); a wrong
    scale of a collective moves every element by a factor of 2 to 4. D
    itself on equal inputs is held within 1e-5
    (`test_point_sharded_discriminator_matches_one_process`). The running
    averages within 1e-3 + 2e-5 (G's global BatchNorm over a few clouds
    turns the sharded sums' rounding into up to 1e-4 of its output). The
    parameters and buffers are equal on every rank. The free run's losses
    are also held, within 2e-2: under --mix the alignment is a discrete
    choice that flips on the rounding of the fakes, and under per_shard
    the statistics of 8 clouds a replica amplify that rounding. Under
    --gp_mapping (300 rounds, the default) the pairing flips so that one
    ulp of z_d moves the one-process d_loss by 3.7% (at 100 rounds; 0.3-
    0.5% at 2000), and the free run's losses are held within 5e-2 (a
    penalty off by the points' factor is off by 2 to 4 times)."""
    _, ranks, refs, _, _ = four
    ours, free, pinned = ranks[0][case], refs[case], refs[case]["pinned"]
    assert_ranks_agree(ranks, case)
    assert_losses(ours, free, 5e-2 if case == "gp_mapping" else 2e-2)
    np.testing.assert_allclose(ours["loss"]["d_loss"],
                               pinned["loss"]["d_loss"], rtol=1e-5)
    elem, l2 = grad_gaps(ours["d_grads"], pinned["d_grads"])
    assert elem <= 2e-2 and l2 <= 1e-2, (elem, l2)
    own = [grad_gaps(o["g_grads"], pinned["g_grads"])
           for o in pinned.get("own", ())]
    bound = (max([2e-2] + [2 * o[0] for o in own]),
             max([1e-2] + [2 * o[1] for o in own]))
    elem, l2 = grad_gaps(ours["g_grads"], pinned["g_grads"])
    assert elem <= bound[0] and l2 <= bound[1], (elem, l2, bound)
    assert_losses(ours, pinned, 2e-4, ("g_loss",))
    assert_stats(ours, pinned)


def test_point_sharded_discriminator_matches_one_process(four):
    """D's training forward and backward on a 2 x 2 mesh (BatchNorm over
    every rank, fc2's pool over the points) against D on the whole batch:
    logits, the gradients of a loss of them and the running averages,
    within 1e-5 of each tensor's max-abs."""
    from sp_gan_tpu_torch.nn import Discriminator
    _, ranks, _, _, _ = four
    real = SyntheticDataset(16, 64, seed=4).data.astype(np.float32)
    D = Discriminator(Config(**BASE), seed=1)
    logits = D(torch.from_numpy(real), train=True)
    grads = torch.autograd.grad((logits ** 2).mean(), list(D.parameters()))
    ours = ranks[0]["disc"]
    np.testing.assert_allclose(ours["logits"], logits.detach().numpy(),
                               rtol=0, atol=1e-5 * logits.abs().max().item())
    grads = dict(zip(ours["names"], (g.numpy() for g in grads)))
    for name, a in zip(ours["names"], ours["grads"]):
        b = grads[name]
        scale = np.abs(b).max()
        if PRE_BN_BIAS.search(name):      # exact gradient 0
            scale = max(scale, np.abs(grads[name[:-4] + "kernel"]).max())
        assert np.abs(a - b).max() <= 1e-5 * scale, name
    for name, v in D.named_buffers():
        np.testing.assert_allclose(ours["buffers"][name], v.numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_point_sharded_sampler_matches_one_process(four):
    _, ranks, _, sampler, _ = four
    cfg = Config(**sampler["cfg"])
    state = create_train_state(cfg, device="cpu")
    ref = make_sample_fn(cfg, sphere_template(cfg.np))(
        state, torch.from_numpy(sampler["z"])).numpy()
    got = np.concatenate([np.concatenate(
        [ranks[2 * d + p]["sampler"] for p in range(2)], axis=1)
        for d in range(2)], axis=0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5)


def test_trainer_epoch_on_2x2_mesh_writes_once(four):
    """An epoch of two steps on the point-sharded step; only rank 0
    writes (one log line an epoch, one checkpoint, one snapshot); every
    rank ends with the same weights and generates finite clouds."""
    _, ranks, _, _, log_dir = four
    assert [r["trainer"]["is_main"] for r in ranks] == [True] + [False] * 3
    assert all(r["trainer"]["step"] == 2 for r in ranks)
    for r in ranks[1:]:
        for name, v in ranks[0]["trainer"]["params"].items():
            np.testing.assert_array_equal(r["trainer"]["params"][name], v)
    for r in ranks:
        pcs = r["trainer"]["pcs"]
        assert pcs.shape == (2, 32, 3) and np.isfinite(pcs).all()
    with open(os.path.join(log_dir, "log_train.txt")) as f:
        assert sum(line.startswith("Epoch:") for line in f) == 1
    assert os.path.isdir(os.path.join(log_dir, "src_snapshot"))
    assert any(n.startswith("ckpt_epoch_") for n in os.listdir(log_dir))


def test_point_sharded_protocol_matches_unsharded(two):
    """`pairwise_emd_matrix(mesh=)` on 2 ranks equals, pair by pair, the
    scaled Jacobi auction on the whole distances (round for round, up to
    the order of the mean), and lies within 1e-2 of the port's protocol
    (kernel E's block Gauss-Seidel auction: another matching within the
    same eps); `evaluate --mesh_points 2` reports the unsharded CLI's
    Chamfer metrics and its EMD keys."""
    from sp_gan_tpu_torch import evaluate
    _, ranks, _, protocol = two
    gen, ref = (torch.from_numpy(protocol[k]) for k in ("gen", "ref"))
    iters = protocol["iters"]
    def jacobi_entry(g, r):
        a = auction_scaled_jacobi(pairwise_sqdist(g, r), 0.005, iters, 4)
        return float(torch.sqrt(((g - r[a.long()]) ** 2).sum(-1)).mean())

    jac = np.array([[jacobi_entry(g, r) for r in ref] for g in gen])
    for r in ranks:
        np.testing.assert_allclose(r["protocol"]["matrix"], jac, rtol=1e-6)
    np.testing.assert_allclose(ranks[0]["protocol"]["matrix"],
                               pairwise_emd_matrix(gen, ref, 0.005, iters),
                               rtol=1e-2)
    plain = evaluate.main(["--gen", protocol["gen_path"], "--ref",
                           protocol["ref_path"], "--emd", "--emd_iters",
                           str(iters), "--device", "cpu"])
    cli = ranks[0]["protocol"]["cli"]
    assert set(cli) == set(plain)
    for k in ("JSD", "COV-CD", "MMD-CD", "1NN-CD"):
        assert cli[k] == plain[k], k
    assert all(np.isfinite(cli[k]) for k in ("COV-EMD", "MMD-EMD",
                                             "1NN-EMD"))


def test_backend_follows_the_device():
    assert backend_for("cpu") == "gloo"
    assert backend_for("cuda") == "nccl"
    with pytest.raises(ValueError):
        backend_for("meta")


def test_mesh_of_several_ranks_needs_a_launch(tmp_path, monkeypatch):
    """mesh_shape (2,) without a launch's RANK and WORLD_SIZE raises, and
    so does a WORLD_SIZE other than prod(mesh_shape)."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    cfg = Config(np=32, bs=4, nk=8, nz=16, log_dir=str(tmp_path),
                 mesh_shape=(2,))
    data = SyntheticDataset(n_items=8, n_points=32)
    with pytest.raises(RuntimeError, match="torchrun"):
        Trainer(cfg, dataset=data, device="cpu", logs=False)
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="the launch has 3"):
        Trainer(cfg, dataset=data, device="cpu", logs=False)
