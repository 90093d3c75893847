"""The generator's bf16 arithmetic under `dtype="mixed_edge"` (the default),
held against the float32 computation with the JAX package's own bf16 error
as the yardstick.

Two computations in one dtype cannot be held to each other tighter than
the bf16 rounding they both carry, and the G phase of a step at bs=4 turns
that rounding into gradients tens of degrees apart (AdaIN normalizes
EdgeConv1's output per channel over the points and multiplies its bf16
error). So these tests compare distances to the float32 result of the
same JAX function on the same inputs and choices: the port's bf16 result
must lie no farther from it than the JAX package's bf16 result does. A
fault in the port's bf16 path (a missing term, a wrong cast or scale)
moves the port away from float32 and fails them.

The port keeps the f32 sums of the dense layers that feed an EdgeBlock
BatchNorm unrounded, as XLA does for the JAX package; rounding them to
bf16 first made its EdgeBlock two to three times farther from float32
than JAX's (`report` below prints both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_gan_tpu.config import Config as JaxConfig
from sp_gan_tpu.data import sphere_template
from sp_gan_tpu.nn import generator as jgenerator
from sp_gan_tpu.nn import layers as jlayers
from sp_gan_tpu.ops import dispatch as jdispatch
from sp_gan_tpu.train.state import create_train_state as jcreate
from sp_gan_tpu_torch.compat import state_from_jax, trees
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.nn import Generator, layers
from sp_gan_tpu_torch.ops import edge as tedge
from sp_gan_tpu_torch.train.step import template_edges
from test_torch_train_step import PRE_BN_BIAS, Replay, flat

torch.set_num_threads(2)   # six test workers share the host's cores

KW = dict(np=256, bs=4, nk=8)


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def edge_block_outputs(seed, round_sums=False):
    """EdgeConv1 as the training step runs it (batch 1, the template's f32
    edges, training mode) from weights drawn from `seed`: {"port": the
    port in bf16, ("jax", mixed): JAX in bf16 (True) and float32 (False)}.
    `round_sums` rounds the port's BatchNorm inputs to bf16."""
    sph = torch.from_numpy(sphere_template(256))
    _, ee = template_edges(sph, 4)
    x = sph[None]
    out = {}
    for mixed in (True, False):
        blk = layers.EdgeBlock(3, 64, 4, mixed=mixed)
        blk.init_weights(np.random.default_rng(seed))
        for sub in (blk.conv_w1, blk.conv_w2, blk.conv_x):
            sub.init_weights(np.random.default_rng(seed + 1))
        params, stats = trees(blk)
        theirs, _ = jax.jit(lambda v, x, ee: jlayers.EdgeBlock(
            3, 64, 4, mixed=mixed).apply(v, x, True, None, ee,
                                         mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats},
            jnp.asarray(x.numpy()), jnp.asarray(ee.numpy()))
        out["jax", mixed] = np.asarray(theirs)
        if mixed:
            with pytest.MonkeyPatch.context() as mp:
                for dense in (blk.conv_w1, blk.conv_w2, blk.conv_x):
                    if round_sums:
                        mp.setattr(dense, "forward", rounded(dense.forward))
                out["port"] = blk(x, train=True, ee=ee).detach().numpy()
    return out


def rounded(forward):
    return lambda *a, **kw: forward(*a, **kw).to(torch.bfloat16).float()


@pytest.mark.parametrize("seed", [21, 5])
def test_edge_block_forward(seed):
    """EdgeConv1 in bf16 lies no farther from JAX's float32 output than
    JAX's bf16 output does (`report` prints the distances)."""
    out = edge_block_outputs(seed)
    exact = out["jax", False]
    assert rel(out["port"], exact) <= rel(out["jax", True], exact)


@pytest.fixture(scope="module")
def g_vjp():
    """G's training forward and its VJP for one fixed cotangent on the
    output, from JAX-initialised weights: the port in mixed_edge, JAX in
    mixed_edge and in float32. EdgeConv2's neighbors and the global pool's
    choices are the port's, replayed into both JAX runs."""
    jstate, _, _, _, _ = jcreate(JaxConfig(**KW, donate_state=False),
                                 jax.random.PRNGKey(0))
    cfg = Config(**KW)
    G = Generator(cfg, seed=None)
    G.load_state_dict(state_from_jax(jstate.g_params, jstate.g_stats))
    sph = torch.from_numpy(sphere_template(cfg.np))
    idx, ee = template_edges(sph, cfg.k)
    rng = np.random.default_rng(3)
    z = np.broadcast_to(rng.standard_normal((cfg.bs, 1, cfg.nz)) * cfg.nv,
                        (cfg.bs, cfg.np, cfg.nz)).astype(np.float32)
    ct = rng.standard_normal((cfg.bs, cfg.np, 3)).astype(np.float32)
    x = sph[None].expand(cfg.bs, -1, -1)
    picks, pools = [], []
    fused = tedge.edge_diff_fused

    def recording(xx, k, out_dtype=None):
        diff, i = fused(xx, k, out_dtype)
        picks.append(i.numpy().copy())
        return diff, i

    G.adain2.register_forward_hook(lambda m, a, o: pools.append(
        ("g", o.detach().float().argmax(1).numpy().astype(np.int32))))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPGAN_KNN_SELECT", "exact")
        mp.setattr(tedge, "edge_diff_fused", recording)
        out = G(x, torch.from_numpy(z), train=True, edge1_idx=idx,
                edge1_ee=ee, template_batch_const=True)
        names = [n for n, _ in G.named_parameters()]
        grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                    list(G.parameters()))
        res = {"port": dict(zip(names, (g.numpy() for g in grads)))}
        replay = Replay()
        replay.load(picks, pools)
        mp.setattr(jdispatch, "knn", replay.knn)
        mp.setattr(jlayers, "jnp", replay)
        mp.setattr(jgenerator, "jnp", replay)
        for dtype in ("mixed_edge", "float32"):
            jG = jgenerator.Generator(JaxConfig(**KW, dtype=dtype))
            replay.n_knn = replay.n_pool = 0        # a new trace

            def fwd(p):
                o, _ = jG.apply(
                    {"params": p, "batch_stats": jstate.g_stats},
                    jnp.asarray(x.numpy()), jnp.asarray(z), train=True,
                    edge1_idx=jnp.asarray(idx.numpy()),
                    edge1_ee=jnp.asarray(ee.numpy()),
                    template_batch_const=True, mutable=["batch_stats"])
                return o.astype(jnp.float32)

            _, vjp = jax.vjp(jax.jit(fwd), jstate.g_params)
            res[dtype] = flat(jax.device_get(vjp(jnp.asarray(ct))[0]))
    return res


def test_g_backward(g_vjp):
    """G's gradient in bf16, as a whole, lies no farther from JAX's float32
    gradient (relative L2) than JAX's own bf16 gradient does, and each
    tensor no farther than 1.5 times JAX's distance or 1%. Measured: 0.36
    against 0.50 as a whole; per tensor 0.61 to 1.20 times JAX's distance
    (the tail layers, which see the bf16 error only through their
    inputs, lie near 1), and tail3's bias at 0.001 against 0.001. Biases
    that feed a training BatchNorm (exact gradient 0) are left out."""
    exact, theirs = g_vjp["float32"], g_vjp["mixed_edge"]
    names = sorted(n for n in exact if not PRE_BN_BIAS.search(n))

    def whole(run):
        return np.concatenate([run[n].ravel() for n in names])

    assert rel(whole(g_vjp["port"]), whole(exact)) <= \
        rel(whole(theirs), whole(exact))
    for name in names:
        assert rel(g_vjp["port"][name], exact[name]) <= max(
            1.5 * rel(theirs[name], exact[name]), 0.01), name


def report():
    """Prints the distances the tests above hold, measured on the CPU."""
    for seed in (21, 5):
        out = edge_block_outputs(seed)
        exact = out["jax", False]
        rounded_sums = edge_block_outputs(seed, round_sums=True)["port"]
        print(f"EdgeConv1 (seed {seed}), relative L2 to JAX float32: port "
              f"{rel(out['port'], exact):.3g}, JAX bf16 "
              f"{rel(out['jax', True], exact):.3g}, port with its BatchNorm "
              f"inputs rounded to bf16 {rel(rounded_sums, exact):.3g}")
    res = g_vjp.__wrapped__()
    exact, theirs = res["float32"], res["mixed_edge"]
    names = sorted(n for n in exact if not PRE_BN_BIAS.search(n))
    whole = {k: np.concatenate([res[k][n].ravel() for n in names])
             for k in res}
    ratios = [rel(res["port"][n], exact[n]) / rel(theirs[n], exact[n])
              for n in names]
    print(f"G's backward, relative L2 to JAX float32: port "
          f"{rel(whole['port'], whole['float32']):.3g}, JAX bf16 "
          f"{rel(whole['mixed_edge'], whole['float32']):.3g}; per tensor "
          f"port/JAX {min(ratios):.3g} to {max(ratios):.3g}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train_mixed_vjp.py
    report()
