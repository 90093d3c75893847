"""Rank programs of the parallel tests (`tests/test_torch_parallel_*.py`),
run on gloo ranks of the CPU.

Not a test module: the spawn start method imports it in every child, so
the suites live here and not in the test files (which import JAX). `spawn`
starts `world` ranks that meet through a `file://` rendezvous in a
temporary directory (no port), runs one suite on each and returns every
rank's results, a dict of numpy arrays and numbers. Each suite runs all
the cases of its test module in that one spawn.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# seconds a rank waits for the others at a collective
TIMEOUT_S = 120


def spawn(world: int, suite: str, *args) -> list:
    """Runs `SUITES[suite](rank, world, *args)` on `world` gloo ranks and
    returns their results in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_main, args=(world, tmp, suite, args), nprocs=world,
                 join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _main(rank: int, world: int, tmp: str, suite: str, args) -> None:
    import datetime
    import sys
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, "rendezvous"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        res = SUITES[suite](rank, world, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.barrier()   # every rank's collectives done before any leaves
    finally:
        dist.destroy_process_group()
    _wait_all(tmp, "torn_down", rank, world)
    # gloo's loop threads can outlive destroy_process_group, and the
    # interpreter's teardown at exit then sometimes destroys one that is
    # still joinable: std::terminate, "terminate called without an active
    # exception", SIGABRT after the suite has passed (about one spawn in a
    # hundred of the BatchNorm suite on a loaded host). The results are on
    # disk and every rank has torn down, so the rank ends here, skipping
    # that teardown. A suite that raises still ends through it, with its
    # traceback.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _wait_all(tmp: str, name: str, rank: int, world: int) -> None:
    """Marks `name` done for this rank and waits, up to TIMEOUT_S, until
    every rank of the spawn has marked it."""
    import time
    open(os.path.join(tmp, f"{name}{rank}"), "w").close()
    end = time.monotonic() + TIMEOUT_S
    while time.monotonic() < end and not all(
            os.path.exists(os.path.join(tmp, f"{name}{r}"))
            for r in range(world)):
        time.sleep(0.01)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _rows(x, parts, index):
    n = x.shape[1] // parts
    return x[:, index * n:(index + 1) * n]


# ---------------------------------------------------------------- ops
def ops_suite(rank, world, inp):
    """The point-sharded ops with the points cut over 2 ranks (two groups,
    ranks 0-1 and 2-3) and over 4; WGAN-GP and CutMix on a 2 x 2 mesh."""
    from sp_gan_tpu_torch.parallel import make_mesh
    from sp_gan_tpu_torch.parallel import points as pts
    out = {}
    halves = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    for P in (2, 4):
        group = dist.group.WORLD if P == 4 else halves[rank // 2]
        p = rank % P
        x = torch.from_numpy(_rows(inp["x"], P, p))
        y = torch.from_numpy(_rows(inp["y"], P, p))
        k = inp["k"]
        out[f"{P}/knn"] = _np(pts.knn_pointsharded(x, k, group))
        xg = x.clone().requires_grad_(True)
        ee = pts.edge_features_pointsharded(xg, k, group)
        (ee * torch.from_numpy(_rows(inp["w_edge"], P, p))).sum().backward()
        out[f"{P}/edge"], out[f"{P}/edge_grad"] = _np(ee), _np(xg.grad)
        d1, d2 = pts.chamfer_pointsharded(x, y, group)
        out[f"{P}/d1"], out[f"{P}/d2"] = _np(d1), _np(d2)
        xg = torch.from_numpy(_rows(inp["gx"], P, p)).requires_grad_(True)
        yg = torch.from_numpy(_rows(inp["gy"], P, p)).requires_grad_(True)
        dd, asg = pts.emd_auction_local(xg, yg, 0.005, 5000, group)
        dd.sum().backward()
        out[f"{P}/emd_dist"], out[f"{P}/emd_asg"] = _np(dd), _np(asg)
        out[f"{P}/emd_gx"] = _np(xg.grad)
        out[f"{P}/emd_gy_none"] = yg.grad is None
        for name in ("h", "h_tie"):
            h = torch.from_numpy(_rows(inp[name], P, p)).requires_grad_(True)
            g = pts.global_max_points(h, group)
            # the P ranks hold a copy each: each differentiates its share
            ((g * torch.from_numpy(inp["w_max"])).sum() / P).backward()
            out[f"{P}/{name}_max"], out[f"{P}/{name}_grad"] = _np(g), \
                _np(h.grad)
    mesh = make_mesh((2, 2), ("data", "points"), "cpu")
    out.update(_gp_cutmix(mesh, inp))
    return out


def toy_critic(w, sync=None, points=None):
    """A critic with BatchNorm-like statistics over the whole batch and a
    nonlinearity, as the JAX package's sharded GP test takes it: its
    moments averaged over `sync`, its per-cloud sum over `points`."""
    from sp_gan_tpu_torch.parallel.mesh import all_reduce_mean, all_reduce_sum

    def d(pts):
        mu = all_reduce_mean(pts.mean(dim=(0, 1), keepdim=True), sync)
        var = all_reduce_mean(((pts - mu) ** 2).mean(dim=(0, 1),
                                                     keepdim=True), sync)
        h = torch.tanh(w * (pts - mu) / torch.sqrt(var + 1e-5))
        return all_reduce_sum(h.sum(dim=(1, 2)), points)
    return d


def _gp_cutmix(mesh, inp):
    """WGAN-GP (with and without the EMD pairing) and CutMix of the rank's
    block of real, fake [4, 64, 3] on a 2 x 2 mesh: the penalty, its
    gradient in the critic's weight averaged over the mesh, CutMix's
    outputs."""
    from sp_gan_tpu_torch.losses.cutmix import cutmix
    from sp_gan_tpu_torch.losses.gp import wgan_gp
    from sp_gan_tpu_torch.parallel import shard_batch
    from sp_gan_tpu_torch.parallel.mesh import mean_gradients
    out = {}
    real = torch.from_numpy(shard_batch(mesh, inp["real"]))
    fake = torch.from_numpy(shard_batch(mesh, inp["fake"]))
    rows = slice(mesh.index("data") * 2, mesh.index("data") * 2 + 2)
    alpha = torch.from_numpy(inp["alpha"][rows])
    for mapping in (False, True):
        w = torch.tensor(1.3, requires_grad=True)
        gp = wgan_gp(toy_critic(w, mesh.world, mesh.group("points")), real,
                     fake, alpha, 10.0, emd_pairing=mapping, emd_iters=100,
                     points_group=mesh.group("points"),
                     data_group=mesh.group("data"))
        (gw,) = torch.autograd.grad(gp, [w])
        (gw,) = mean_gradients([gw], mesh.world, mesh.size)
        out[f"gp{int(mapping)}"] = float(gp.detach())
        out[f"gp{int(mapping)}_dw"] = float(gw)
    mixed, map_s, mask = cutmix(
        real, fake, torch.from_numpy(inp["lam"][rows]),
        torch.from_numpy(inp["anchor"][rows]),
        torch.tensor(bool(inp["flip"])), emd_iters=50,
        points_group=mesh.group("points"))
    out["mix"], out["map_s"], out["mask"] = _np(mixed), _np(map_s), _np(mask)
    return out


# ---------------------------------------------------------------- BatchNorm
def bn_suite(rank, world, inp):
    """SPBatchNorm synchronized over 2 ranks and per replica (running
    averages from rank 0), and the instance norm with the points cut over
    2 ranks, each rank on its half."""
    from sp_gan_tpu_torch.nn.layers import (Scope, SPBatchNorm,
                                            instance_norm_points, sharded)
    from sp_gan_tpu_torch.parallel.mesh import all_reduce_sum, mean_gradients
    out = {}
    x_all = inp["x"]
    half = x_all.shape[0] // world
    x = torch.from_numpy(x_all[rank * half:(rank + 1) * half])
    r = torch.from_numpy(inp["r"][rank * half:(rank + 1) * half])
    for name, scope in (("sync", Scope(bn_sync=dist.group.WORLD)),
                        ("replica", Scope(bn_replica0=dist.group.WORLD))):
        bn = SPBatchNorm(x.shape[-1])
        with torch.no_grad():
            bn.scale.copy_(torch.from_numpy(inp["scale"]))
            bn.bias.copy_(torch.from_numpy(inp["bias"]))
        xg = x.clone().requires_grad_(True)
        with sharded(scope, bn):
            y = bn(xg, train=True)
        # the loss of the whole batch, the same on both ranks
        loss = all_reduce_sum((y * r).sum(), dist.group.WORLD)
        gx, gs, gb = torch.autograd.grad(loss, [xg, bn.scale, bn.bias])
        gs, gb = mean_gradients([gs, gb], dist.group.WORLD, world)
        # each rank's copy of the loss reaches x: the gradient of one
        out[name] = {"y": _np(y), "gx": _np(gx) / world, "gscale": _np(gs),
                     "gbias": _np(gb), "mean": _np(bn.mean),
                     "var": _np(bn.var)}
    h = torch.from_numpy(_rows(inp["h"], world, rank)).requires_grad_(True)
    y = instance_norm_points(h, group=dist.group.WORLD)
    loss = all_reduce_sum(
        (y * torch.from_numpy(_rows(inp["rh"], world, rank))).sum(),
        dist.group.WORLD)
    (gh,) = torch.autograd.grad(loss, [h])
    out["inorm"] = {"y": _np(y), "gh": _np(gh) / world}
    return out


# ---------------------------------------------------------------- steps
def sgd_state(cfg, device="cpu"):
    """A fresh training state of `cfg` whose optimizers are plain SGD at
    lr 1e-2, so that gradients, not Adam's signs, decide the G phase."""
    from sp_gan_tpu_torch.train.state import create_train_state
    st = create_train_state(cfg, device=device)
    st.g_opt = torch.optim.SGD(st.G.parameters(), lr=cfg.lr_g)
    st.d_opt = torch.optim.SGD(st.D.parameters(), lr=cfg.lr_d)
    return st


@contextlib.contextmanager
def recording_grads(store: list, pin=None):
    """Each optimizer step's gradients of the training step, in order, as
    numpy arrays; `pin(opt)` runs right after each step."""
    from sp_gan_tpu_torch.train import step as step_mod
    apply = step_mod._apply

    def rec(opt, params, grads, lr, nan_guard):
        store.append([_np(g) for g in grads])
        apply(opt, params, grads, lr, nan_guard)
        if pin is not None:
            pin(opt)

    step_mod._apply = rec
    try:
        yield
    finally:
        step_mod._apply = apply


def jacobi_emd(xyz1, xyz2, eps=0.005, iters=50, scaled=False):
    """`emd_auction` whose assignment is the scaled Jacobi auction, pair
    by pair (what `emd_auction_local` computes round for round): the
    unsharded twin of the point-sharded CutMix's alignment."""
    from sp_gan_tpu_torch.ops.emd import auction_scaled_jacobi, scaled_phases
    from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist
    d = pairwise_sqdist(xyz1.detach(), xyz2.detach())
    asg = torch.stack([auction_scaled_jacobi(d[b], eps, iters,
                                             scaled_phases(iters))
                       for b in range(d.shape[0])])
    matched = torch.gather(xyz2, 1, asg.long()[..., None].expand(-1, -1, 3))
    return ((xyz1 - matched) ** 2).sum(-1), asg


def run_step(cfg, real, z_d, z_g, draws, mesh=None, points=False,
             jacobi_mix=False, pinned=None):
    """One step of a fresh SGD state of `cfg` (on the mesh's rank with
    `real` the whole batch, of which the step takes the rank's block):
    losses, both phases' gradients, parameters, running averages and the
    D phase's fakes (the rank's block). Codes of None are drawn by the
    step. With `pinned` (another run's whole-batch D-phase fakes and its
    parameters as this returns them) the D phase takes those fakes and D
    takes that run's parameters right after its update, so that each
    phase here sees the other run's inputs."""
    import importlib

    from sp_gan_tpu_torch.data.sphere import sphere_template
    from sp_gan_tpu_torch.parallel import shard_batch
    from sp_gan_tpu_torch.train.step import (make_train_step,
                                             make_train_step_pointsharded)
    st = sgd_state(cfg)
    sphere = sphere_template(cfg.np)
    step = (make_train_step_pointsharded(cfg, sphere, mesh) if points
            else make_train_step(cfg, sphere, mesh))
    mine = real if mesh is None else shard_batch(mesh, real)
    grads = []
    # the module (the package exports a function of its name)
    cutmix_mod = importlib.import_module("sp_gan_tpu_torch.losses.cutmix")
    emd = cutmix_mod.emd_auction
    if jacobi_mix:
        cutmix_mod.emd_auction = jacobi_emd
    codes = [None if z is None else torch.from_numpy(z) for z in (z_d, z_g)]

    def pin(opt):
        if pinned is not None and opt is st.d_opt:
            with torch.no_grad():
                for n, p in st.D.named_parameters():
                    p.copy_(torch.from_numpy(pinned[1]["D." + n]))

    fakes = []

    def fake_hook(module, args, out):
        """The D phase's generator forward (the first), pinned."""
        if not fakes:
            fakes.append(_np(out))
            if pinned is not None:
                return torch.from_numpy(pinned[0])

    st.G.register_forward_hook(fake_hook)

    try:
        with recording_grads(grads, pin):
            st, m = step(st, torch.from_numpy(mine), *codes,
                         {k: torch.from_numpy(np.asarray(v))
                          for k, v in draws.items()})
    finally:
        cutmix_mod.emd_auction = emd
    return {"loss": {k: float(v) for k, v in m.items()}, "fake": fakes[0],
            "d_grads": dict(zip([n for n, _ in st.D.named_parameters()],
                                grads[0])),
            "g_grads": dict(zip([n for n, _ in st.G.named_parameters()],
                                grads[1])),
            "params": {n: _np(p) for n, p in
                       list(st.G.named_parameters())
                       + [("D." + n, p) for n, p in st.D.named_parameters()]},
            "stats": {n: _np(b) for n, b in
                      list(st.G.named_buffers())
                      + [("D." + n, b) for n, b in st.D.named_buffers()]}}


def _cfg(kw):
    from sp_gan_tpu_torch.config import Config
    return Config(**kw)


def step2_suite(rank, world, cases, protocol):
    """The data-parallel step on a (2,) mesh for each case (config
    keywords and inputs), and `evaluate --mesh_points 2` with the
    point-sharded protocol's matrix."""
    from sp_gan_tpu_torch.parallel import make_mesh
    mesh = make_mesh((2,), ("data",), "cpu")
    out = {}
    for name, (kw, inp) in cases.items():
        out[name] = run_step(_cfg(kw), inp["real"], inp["z_d"], inp["z_g"],
                             inp["draws"], mesh)
    out["protocol"] = _protocol(protocol)
    return out


def _protocol(inp):
    from sp_gan_tpu_torch import evaluate
    from sp_gan_tpu_torch.eval.metrics import pairwise_emd_matrix
    from sp_gan_tpu_torch.parallel import make_mesh
    mesh = make_mesh((2,), ("points",), "cpu")
    gen, ref = torch.from_numpy(inp["gen"]), torch.from_numpy(inp["ref"])
    m = pairwise_emd_matrix(gen, ref, 0.005, inp["iters"], mesh=mesh)
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        cli = evaluate.main(["--gen", inp["gen_path"], "--ref",
                             inp["ref_path"], "--emd", "--emd_iters",
                             str(inp["iters"]), "--mesh_points", "2",
                             "--device", "cpu"])
    return {"matrix": m, "cli": cli}


def step4_suite(rank, world, cases, sampler, trainer_dir):
    """The point-sharded step on a 2 x 2 mesh for each case, the
    point-sharded sampler, and one Trainer epoch on a 2 x 2 mesh."""
    from sp_gan_tpu_torch.parallel import make_mesh, shard_batch
    mesh = make_mesh((2, 2), ("data", "points"), "cpu")
    out = {}
    for name, (kw, inp, jac) in cases.items():
        out[name] = run_step(_cfg(kw), inp["real"], inp["z_d"], inp["z_g"],
                             inp["draws"], mesh, points=True,
                             jacobi_mix=jac)
    out["disc"] = _discriminator(mesh)
    out["sampler"] = _sampler(mesh, sampler)
    out["trainer"] = _trainer(mesh, trainer_dir)
    return out


def _discriminator(mesh):
    """D of the step tests' configuration on the rank's block of 16 clouds,
    under the point-sharded step's scope: logits of the whole batch, the
    gradients of their mean square (averaged over the mesh) and the
    running averages."""
    from sp_gan_tpu_torch.data import SyntheticDataset
    from sp_gan_tpu_torch.nn import Discriminator
    from sp_gan_tpu_torch.parallel import shard_batch
    from sp_gan_tpu_torch.parallel.mesh import all_gather_cat, mean_gradients
    from sp_gan_tpu_torch.train.step import bn_scope
    cfg = _cfg(dict(np=64, bs=16, nk=8, nz=16, dtype="float32"))
    real = SyntheticDataset(16, 64, seed=4).data.astype(np.float32)
    D = Discriminator(cfg, seed=1)
    from sp_gan_tpu_torch.nn.layers import sharded
    with sharded(bn_scope(cfg, mesh, points=True), D):
        logits = all_gather_cat(D(torch.from_numpy(shard_batch(mesh, real)),
                                  train=True), mesh.group("data"), dim=0)
        grads = torch.autograd.grad((logits ** 2).mean(),
                                    list(D.parameters()))
    grads = mean_gradients(grads, mesh.world, mesh.size)
    return {"logits": _np(logits), "grads": [_np(g) for g in grads],
            "names": [n for n, _ in D.named_parameters()],
            "buffers": {n: _np(b) for n, b in D.named_buffers()}}


def _sampler(mesh, inp):
    from sp_gan_tpu_torch.data.sphere import sphere_template
    from sp_gan_tpu_torch.parallel import shard_batch
    from sp_gan_tpu_torch.train.state import create_train_state
    from sp_gan_tpu_torch.train.step import make_sample_fn_pointsharded
    cfg = _cfg(inp["cfg"])
    st = create_train_state(cfg, device="cpu")
    fn = make_sample_fn_pointsharded(cfg, sphere_template(cfg.np), mesh)
    return _np(fn(st, torch.from_numpy(shard_batch(mesh, inp["z"]))))


def _trainer(mesh, log_dir):
    from sp_gan_tpu_torch.config import Config
    from sp_gan_tpu_torch.data import SyntheticDataset
    from sp_gan_tpu_torch.train.trainer import Trainer
    cfg = Config(np=32, bs=4, nk=8, nz=16, max_epoch=1, snapshot=1,
                 log_dir=log_dir, mesh_shape=(2, 2),
                 mesh_axes=("data", "points"), dtype="float32")
    tr = Trainer(cfg, dataset=SyntheticDataset(n_items=8, n_points=32),
                 device="cpu")
    try:
        st = tr.train()
        pcs = tr.generate(2)
    finally:
        tr.close()
    return {"step": st.step, "pcs": pcs, "is_main": tr.is_main,
            "params": {n: _np(p) for n, p in st.G.named_parameters()}}


SUITES = {"ops": ops_suite, "bn": bn_suite, "step2": step2_suite,
          "step4": step4_suite}
