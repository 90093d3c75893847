"""The port's fused train-mode EdgeBlock (`ops/edgeblock_train.py`, kernels
I-L and kernel C's bf16 mode through their plain versions on the CPU)
against the JAX package's `sp_gan_tpu/ops/pallas/edgeblock_train.py` run
in Pallas interpret mode, on the same edge tensor and weights (drawn with
numpy, carried over with `compat.trees`).

In float32 the two compute the same function in the same steps: the
statistics and the forward must agree within 2e-4 and every gradient
within 1e-3 of each tensor's max-abs. With bf16 edges both round every
matmul operand to bf16, at the same places but after sums taken in other
orders, so a one-ulp difference before a rounding point becomes a bf16
ulp after it; there the yardstick is the JAX package's own bf16 error:
the port's distance (relative L2) from the JAX float32 result must not
exceed JAX's bf16 distance from it by more than a factor of 1.1, plus
1e-6 for f32 sums in another order (d_out_bias is a sum of d_out alone,
which no bf16 rounding reaches: JAX's bf16 and f32 values are equal).
Measured on these inputs: the port's distance is JAX's within 0.1% for
every statistic, the output, every gradient and d_ee (1e-4 to 5e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sp_gan_tpu.ops import edge_features as j_edge_features
from sp_gan_tpu.ops.pairwise import knn_indices as j_knn
from sp_gan_tpu.ops.pallas import edgeblock_train as jebt
from sp_gan_tpu.ops.pallas.edgeblock import edge_tail_pallas
from sp_gan_tpu_torch.compat import trees
from sp_gan_tpu_torch.nn import layers
from sp_gan_tpu_torch.ops import edgeblock_train as tebt
from sp_gan_tpu_torch.ops.kernels import edgeblock_train as kebt
from sp_gan_tpu_torch.ops.kernels.edgeblock import edge_tail, edge_tail_plain

torch.set_num_threads(2)   # six test workers share the host's cores

B, N, C, F, K = 2, 64, 8, 64, 4
BF16_FACTOR = 1.1


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def block(seed: int, c: int = C, f: int = F, k: int = K) -> layers.EdgeBlock:
    """A port EdgeBlock with every parameter drawn from `seed`, the
    BatchNorm gammas and betas away from 1 and 0."""
    rng = np.random.default_rng(seed)
    blk = layers.EdgeBlock(c, f, k)
    for m in blk.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(rng)
    with torch.no_grad():
        for bn in (blk.bn_w1, blk.bn_w2, blk.bn_x):
            n = bn.scale.shape[0]
            bn.scale.copy_(torch.from_numpy(
                (1 + 0.3 * rng.standard_normal(n)).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(
                (0.3 * rng.standard_normal(n)).astype(np.float32)))
    return blk


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((B, N, C)).astype(np.float32))
    ee = np.array(j_edge_features(x, K, idx=j_knn(x, K)))
    cot = rng.standard_normal((B, N, F)).astype(np.float32)
    blk = block(3)
    params, _ = trees(blk)
    return blk, params, ee, cot


def jax_run(params, ee, cot, bf16: bool):
    """(stats, out, d_params, d_ee) of the JAX package in interpret mode."""
    e = jnp.asarray(ee)
    if bf16:
        e = e.astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        stats = jax.jit(lambda p, e: jebt.edge_block_train_stats(p, e, K))(
            params, e)
        out, _ = jax.jit(lambda p, e: jebt.edge_block_train_forward(
            p, e, K))(params, e)
        d_params, d_ee = jebt.edge_block_train_backward(
            params, e, stats, jnp.asarray(cot), K)
    flat = {f"{a}.{b}": np.asarray(v, np.float32)
            for a, d in d_params.items() if isinstance(d, dict)
            for b, v in d.items()}
    flat.update({n: np.asarray(d_params[n], np.float32)
                 for n in ("out_kernel", "out_bias")})
    return ({bn: tuple(np.asarray(t) for t in stats[bn]) for bn in stats},
            np.asarray(out), flat, np.asarray(d_ee.astype(jnp.float32)))


def port_run(blk, ee, cot, bf16: bool):
    e = torch.from_numpy(ee)
    if bf16:
        e = e.to(torch.bfloat16)
    p = tebt.block_params(blk)
    stats = tebt.edge_block_train_stats(p, e, K)
    out, _ = tebt.edge_block_train_forward(p, e, K)
    d_params, d_ee = tebt.edge_block_train_backward(
        p, e, stats, torch.from_numpy(cot), K)
    assert d_ee.dtype == e.dtype
    return ({bn: tuple(t.numpy() for t in stats[bn]) for bn in stats},
            out.numpy(), {n: g.numpy() for n, g in d_params.items()},
            d_ee.float().numpy())


@pytest.fixture(scope="module")
def runs(setup):
    blk, params, ee, cot = setup
    return {(who, bf16): run(*args, bf16)
            for bf16 in (False, True)
            for who, run, args in (("jax", jax_run, (params, ee, cot)),
                                   ("port", port_run, (blk, ee, cot)))}


def _close(ours, theirs, tol, what):
    scale = max(float(np.abs(theirs).max()), 1e-30)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=tol * scale,
                               err_msg=what)


class TestFloat32:
    def test_stats(self, runs):
        """The three BNs' batch mean and var within 2e-4 of max-abs."""
        ours, theirs = runs["port", False][0], runs["jax", False][0]
        for bn in ("bn_w1", "bn_w2", "bn_x"):
            for i, what in enumerate(("mean", "var")):
                _close(ours[bn][i], theirs[bn][i], 2e-4, f"{bn} {what}")

    def test_forward(self, runs):
        _close(runs["port", False][1], runs["jax", False][1], 2e-4, "out")

    def test_backward(self, runs):
        """Every parameter gradient and d_ee within 1e-3 of max-abs; the
        conv biases that feed a train-mode BN are exactly zero in both."""
        ours, theirs = runs["port", False], runs["jax", False]
        assert set(ours[2]) == set(theirs[2]) == set(tebt.PARAM_NAMES)
        for name in tebt.PARAM_NAMES:
            if name.startswith("conv") and name.endswith("bias"):
                assert not ours[2][name].any() and not theirs[2][name].any()
                continue
            _close(ours[2][name], theirs[2][name], 1e-3, name)
        _close(ours[3], theirs[3], 1e-3, "d_ee")


class TestBfloat16:
    def _check(self, ours, theirs, exact, what):
        assert rel(ours, exact) <= BF16_FACTOR * rel(theirs, exact) + 1e-6, \
            what

    def test_stats_and_forward(self, runs):
        """bf16 edges: the port's statistics and output lie no farther
        from JAX's float32 result than 1.1 times JAX's bf16 ones do."""
        ours, theirs = runs["port", True], runs["jax", True]
        exact = runs["jax", False]
        for bn in ("bn_w1", "bn_w2", "bn_x"):
            for i in range(2):
                self._check(ours[0][bn][i], theirs[0][bn][i], exact[0][bn][i],
                            bn)
        self._check(ours[1], theirs[1], exact[1], "out")

    def test_backward(self, runs):
        ours, theirs = runs["port", True], runs["jax", True]
        exact = runs["jax", False]
        for name in tebt.PARAM_NAMES:
            if name.startswith("conv") and name.endswith("bias"):
                assert not ours[2][name].any()
                continue
            self._check(ours[2][name], theirs[2][name], exact[2][name], name)
        self._check(ours[3], theirs[3], exact[3], "d_ee")


def test_edge_tail_bf16_matches_jax():
    """Kernel C's bf16 mode (its plain version) against the JAX kernel's
    in interpret mode: the same roundings (operands, the activations
    before @ w2 and v before @ wout, wout itself left f32), sums in
    another order: within 1e-5 of the output's max-abs."""
    rng = np.random.default_rng(1)
    a = lambda *s: rng.standard_normal(s).astype(np.float32)
    F2 = F // 2
    ee = a(B, N, K, 2 * C)
    args = [a(C, F2) * 0.3, a(2, F2), a(F2, F) * 0.3, a(2, F),
            a(2 * C, F) * 0.3, a(2, F), a(K, F, F) * 0.3, a(1, F)]
    with pltpu.force_tpu_interpret_mode():
        theirs = np.asarray(jax.jit(lambda e, *w: edge_tail_pallas(
            e, *w, k=K))(jnp.asarray(ee).astype(jnp.bfloat16), *args))
    ours = edge_tail(torch.from_numpy(ee).to(torch.bfloat16),
                     *map(torch.from_numpy, args), k=K).numpy()
    _close(ours, theirs, 1e-5, "edge_tail bf16")
    # the f32 mode is unchanged: bf16 and f32 differ by bf16 rounding
    f32 = edge_tail_plain(torch.from_numpy(ee),
                          *map(torch.from_numpy, args), k=K).numpy()
    assert 1e-4 < rel(ours, f32) < 1e-1


def torch_oracle(blk: layers.EdgeBlock, ee: torch.Tensor, k: int,
                 neg: float = 0.01, eps: float = 1e-5) -> torch.Tensor:
    """Plain autograd train-mode EdgeBlock on the edge tensor, two-pass
    variance (the oracle `xla_block_from_ee` of
    tests/test_edgeblock_train_fused.py, in torch)."""
    C2 = ee.shape[-1]

    def bn(h, norm):
        mean = h.mean(dim=(0, 1, 2))
        var = ((h - mean) ** 2).mean(dim=(0, 1, 2))
        return (h - mean) * torch.rsqrt(var + eps) * norm.scale + norm.bias

    lrelu = lambda v: torch.where(v >= 0, v, neg * v)
    diff = ee[..., C2 // 2:]
    h1 = diff @ blk.conv_w1.kernel + blk.conv_w1.bias
    y1 = lrelu(bn(h1, blk.bn_w1))
    h2 = y1 @ blk.conv_w2.kernel + blk.conv_w2.bias
    w = torch.softmax(lrelu(bn(h2, blk.bn_w2)), dim=2)
    hx = ee @ blk.conv_x.kernel + blk.conv_x.bias
    u = lrelu(bn(hx, blk.bn_x)) * w
    return torch.einsum("bnkc,kco->bno", u, blk.out_kernel) + blk.out_bias


def test_fused_edge_block_autograd(setup):
    """`FusedEdgeBlock` under autograd against the plain autograd oracle,
    float32: the output within 2e-4 and every gradient (into the
    EdgeBlock's own parameters, and d_ee) within 2e-3 of max-abs, the
    oracle's tolerance in tests/test_edgeblock_train_fused.py (the fused
    block's variances are E[h^2] - E[h]^2, the oracle's two-pass). The
    conv biases' gradients are exactly zero; the statistics carry none."""
    blk, _, ee, cot = setup
    ct = torch.from_numpy(cot)
    params = [p for _, p in blk.named_parameters()]
    e1 = torch.from_numpy(ee).requires_grad_()
    out, stats = tebt.fused_edge_block(tebt.block_params(blk), e1, K)
    assert all(not t.requires_grad for pair in stats.values() for t in pair)
    grads = torch.autograd.grad((out * ct).sum(), params + [e1])
    e2 = torch.from_numpy(ee).requires_grad_()
    ref = torch_oracle(blk, e2, K)
    ref_grads = torch.autograd.grad((ref * ct).sum(), params + [e2])
    _close(out.detach().numpy(), ref.detach().numpy(), 2e-4, "out")
    names = [n for n, _ in blk.named_parameters()] + ["d_ee"]
    for name, g, r in zip(names, grads, ref_grads):
        if name.startswith("conv") and name.endswith("bias"):
            assert not g.any(), name
            assert float(r.abs().max()) < 1e-4, name
            continue
        _close(g.numpy(), r.numpy(), 2e-3, name)
    # the gradients land in the EdgeBlock's own parameters
    out, _ = tebt.fused_edge_block(tebt.block_params(blk),
                                   torch.from_numpy(ee), K)
    (out * ct).sum().backward()
    assert torch.equal(blk.conv_w1.kernel.grad, grads[names.index(
        "conv_w1.kernel")])
    blk.zero_grad(set_to_none=True)


def test_no_grad_keeps_nothing(setup):
    """Under no_grad (the D phase) the forward leaves no graph behind."""
    blk, _, ee, _ = setup
    with torch.no_grad():
        out, _ = tebt.fused_edge_block(tebt.block_params(blk),
                                       torch.from_numpy(ee), K)
    assert out.grad_fn is None and not out.requires_grad


def test_wrapper_refuses_bad_inputs(setup):
    blk, _, ee, _ = setup
    p = {n: t.detach() for n, t in tebt.block_params(blk).items()}
    e = torch.from_numpy(ee)
    a1 = torch.zeros(2, F // 2)
    with pytest.raises(ValueError, match="k=3"):
        kebt.edge_train_stats2(e, p["conv_w1.kernel"], a1,
                               p["conv_w2.kernel"], 3)
    with pytest.raises(TypeError, match="ee must be"):
        kebt.edge_train_stats2(e.half(), p["conv_w1.kernel"], a1,
                               p["conv_w2.kernel"], K)
    with pytest.raises(ValueError, match="a1 must be"):
        kebt.edge_train_stats2(e, p["conv_w1.kernel"], a1[:, :2],
                               p["conv_w2.kernel"], K)


# the default training step's EdgeConv2 widths (C 64, F2 64, F 128, k 10)
# at a small B and N
WC, WF, WK, WB, WN = 64, 128, 10, 2, 64


def train_inputs(blk, ee: torch.Tensor, d_out: torch.Tensor, k: int):
    """The f32 operands kernels J and L take at this block and edge tensor:
    the weights and the affines of the port's own batch statistics."""
    p = {n: t.detach() for n, t in tebt.block_params(blk).items()}
    stats = tebt.edge_block_train_stats(p, ee, k)
    a1, a2, ax, gb2x, gb1 = tebt._fold_all(p, stats, 1e-5)
    w1, w2, wx, wout = tebt._weights(p)
    return dict(ee=ee, d_out=d_out, w1=w1, a1=a1, w2=w2, a2=a2, wx=wx,
                ax=ax, gb2x=gb2x, gb1=gb1, wout=wout, k=k)


def plain_j_k_l(i: dict) -> dict:
    """Kernels J, K and L's plain versions, in the order the backward runs
    them."""
    chain = (i["w1"], i["a1"], i["w2"], i["a2"], i["wx"], i["ax"])
    sums, d_wout, d_bout, d_u = kebt.edge_train_bwd1_plain(
        i["ee"], i["d_out"], *chain, i["gb2x"], i["wout"], i["k"])
    s1, d_w2 = kebt.edge_train_bwd2_plain(i["ee"], d_u, *chain, i["gb2x"],
                                          sums, i["gb1"], i["k"])
    d_ee, d_w1, d_wx = kebt.edge_train_bwd3_plain(
        i["ee"], d_u, *chain, i["gb2x"], sums, i["gb1"], s1, i["k"])
    return dict(sums=sums, d_wout=d_wout, d_bout=d_bout, s1=s1, d_w2=d_w2,
                d_ee=d_ee.float(), d_w1=d_w1, d_wx=d_wx)


# the outputs of each backward pass, by kernel
PASS_OUTPUTS = {"J": ("sums", "d_wout", "d_bout"), "K": ("s1", "d_w2"),
                "L": ("d_ee", "d_w1", "d_wx")}


@pytest.fixture(scope="module")
def full_width():
    """(the plain versions' outputs, {bf16: JAX's}) at the default step's
    widths: JAX backward passes 1-3 in interpret mode on f32 and bf16
    edges, the plain versions on the bf16 edges."""
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((WB, WN, WC)).astype(np.float32))
    ee = np.array(j_edge_features(x, WK, idx=j_knn(x, WK)))
    cot = rng.standard_normal((WB, WN, WF)).astype(np.float32)
    blk = block(5, WC, WF, WK)
    params, _ = trees(blk)
    theirs = {}
    for bf16 in (False, True):
        e = jnp.asarray(ee).astype(jnp.bfloat16 if bf16 else jnp.float32)
        with pltpu.force_tpu_interpret_mode():
            stats = jax.jit(lambda p, e: jebt.edge_block_train_stats(
                p, e, WK))(params, e)
            d, d_ee = jebt.edge_block_train_backward(
                params, e, stats, jnp.asarray(cot), WK)
        theirs[bf16] = {
            "sums": np.stack([d["bn_w2"]["bias"], d["bn_w2"]["scale"],
                              d["bn_x"]["bias"], d["bn_x"]["scale"]]),
            "d_wout": d["out_kernel"], "d_bout": d["out_bias"],
            "s1": np.stack([d["bn_w1"]["bias"], d["bn_w1"]["scale"]]),
            "d_w2": d["conv_w2"]["kernel"],
            "d_ee": d_ee.astype(jnp.float32),
            "d_w1": d["conv_w1"]["kernel"], "d_wx": d["conv_x"]["kernel"]}
    ours = plain_j_k_l(train_inputs(
        blk, torch.from_numpy(ee).to(torch.bfloat16),
        torch.from_numpy(cot), WK))
    return ours, theirs


@pytest.mark.parametrize("kernel", list(PASS_OUTPUTS))
def test_plain_j_l_match_jax_at_full_width(full_width, kernel):
    """Kernels J, K and L's plain versions (what the card holds the
    kernels to) against JAX backward passes 1, 2 and 3 in interpret mode,
    at the default step's widths with bf16 edges: by the file's bf16
    yardstick, each output of J (the BN2 and BNx sums, d_wout, d_bout), of
    K (the BN1 sums, d_w2) and of L (d_ee, d_w1, d_wx) no farther from
    JAX's float32 result than 1.1 times JAX's bf16 one, plus 1e-6."""
    ours, theirs = full_width
    for name in PASS_OUTPUTS[kernel]:
        exact = np.asarray(theirs[False][name], np.float32)
        assert rel(ours[name].numpy(), exact) <= BF16_FACTOR * rel(
            np.asarray(theirs[True][name], np.float32), exact) + 1e-6, name


# bf16 cases of I, J, K, L and C on the card: (C, F2, F, k, B, N)
BF16_CASES = {
    "default widths": (64, 64, 128, 10, 2, 256),
    "k 20": (64, 64, 128, 20, 2, 128),
    "k 7": (64, 64, 128, 7, 2, 128),
    "k 32": (64, 64, 128, 32, 1, 64),
    "F 64": (64, 32, 64, 10, 2, 256),
    "ragged last tile": (64, 64, 128, 10, 2, 125),
    "zero padding": (12, 8, 64, 10, 2, 128),
    "too wide for the tensor cores' layout": (256, 64, 128, 10, 1, 64),
    "C's FMA widths": (6, 12, 64, 10, 2, 128),
}
# the kernels a case runs where not all five take its widths: kernel C
# refuses C = 256 (its FMA kernels' f32 weights do not fit in shared memory
# either; I's tensor cores take it, holding no wx and half of ee), I, J, K
# and L refuse C and F2 that C's FMA kernels take in bf16 mode (C's tensor
# cores take F = 128 only; at F = 64 it runs its FMA kernels)
BF16_KERNELS = {"too wide for the tensor cores' layout": "IJKL",
                "C's FMA widths": "C"}
# kernel C's contraction in bf16 mode (out - bout) against its plain
# version's, in relative L2: wout carried as a bf16 pair keeps about 16
# bits, and rounded to one bf16 it lies beyond this limit
TAIL_PAIR_TOL = 5e-4


def bf16_case_args(case: str, device: str) -> dict:
    """The inputs of a BF16_CASES case, drawn from seed 1 on `device`: the
    bf16 ee, the chain (w1, a1, w2, a2, wx, ax), gb2x, gb1, wout, d_out
    and bout."""
    Cc, F2, Fc, k, Bc, Nc = BF16_CASES[case]
    g = torch.Generator(device=device).manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    ee = r(Bc, Nc, k, 2 * Cc).to(torch.bfloat16)
    aff = lambda n: torch.stack([1 + 0.1 * r(n), 0.1 * r(n)])
    chain = (r(Cc, F2) / 8, aff(F2), r(F2, Fc) / 8, aff(Fc),
             r(2 * Cc, Fc) / 11, aff(Fc))
    gb2x, gb1 = torch.cat([aff(Fc), aff(Fc)]), aff(F2)
    wout = r(k, Fc, Fc) / 36
    d_out = r(Bc, Nc, Fc)
    return dict(ee=ee, chain=chain, gb2x=gb2x, gb1=gb1, wout=wout,
                d_out=d_out, bout=r(1, Fc), k=k)


def tail_contraction_rel(out, ref, bout):
    """Relative L2 of kernel C's contraction: out - bout against ref - bout."""
    ref = ref - bout
    return float((out - bout - ref).norm() / ref.norm())


@pytest.mark.parametrize(
    "case", [c for c in BF16_CASES if "C" in BF16_KERNELS.get(c, "IJKLC")])
def test_tail_pair_limit_tells_pair_from_single_bf16(case):
    """The card's limit on kernel C's bf16 contraction sees how wout is
    carried: on each case's inputs, the plain version with wout as its
    bf16 pair hi + lo lies within TAIL_PAIR_TOL of the plain version, and
    with wout rounded to one bf16 beyond it (measured on these inputs
    1.6e-3 to 1.7e-3 with one bf16, about 2e-6 with the pair)."""
    a = bf16_case_args(case, "cpu")
    hi = a["wout"].bfloat16().float()
    pair = hi + (a["wout"] - hi).bfloat16().float()
    args = lambda w: (a["ee"], *a["chain"], w, a["bout"], a["k"])
    ref = edge_tail_plain(*args(a["wout"]))
    assert tail_contraction_rel(edge_tail_plain(*args(pair)), ref,
                                a["bout"]) <= TAIL_PAIR_TOL / 10
    assert tail_contraction_rel(edge_tail_plain(*args(hi)), ref,
                                a["bout"]) > 2 * TAIL_PAIR_TOL


@pytest.mark.cuda
class TestOnCard:
    def test_kernels_match_plain_versions(self):
        """I-L and kernel C's bf16 mode against their plain versions on
        the card, f32 within 1e-4 of each output's max-abs (sum order),
        and bit-identical over two launches."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (kernels have no CPU mode)")
        torch.backends.cuda.matmul.allow_tf32 = False
        g = torch.Generator(device="cuda").manual_seed(0)
        r = lambda *s: torch.randn(*s, generator=g, device="cuda")
        Cc, F2, Fc, k = 64, 64, 128, 10
        ee = r(2, 128, k, 2 * Cc)
        w1, w2, wx = r(Cc, F2) / 8, r(F2, Fc) / 8, r(2 * Cc, Fc) / 11
        aff = lambda n: torch.stack([1 + 0.1 * r(n), 0.1 * r(n)])
        a1, a2, ax, gb1 = aff(F2), aff(Fc), aff(Fc), aff(F2)
        gb2x = torch.cat([aff(Fc), aff(Fc)])
        wout, d_out = r(k, Fc, Fc) / 36, r(2, 128, Fc)
        j = kebt.edge_train_bwd1(ee, d_out, w1, a1, w2, a2, wx, ax, gb2x,
                                 wout, k)
        calls = {
            "stats2": (kebt.edge_train_stats2, kebt.edge_train_stats2_plain,
                       (ee, w1, a1, w2, k)),
            "bwd1": (kebt.edge_train_bwd1, kebt.edge_train_bwd1_plain,
                     (ee, d_out, w1, a1, w2, a2, wx, ax, gb2x, wout, k)),
            "bwd2": (kebt.edge_train_bwd2, kebt.edge_train_bwd2_plain,
                     (ee, j[3], w1, a1, w2, a2, wx, ax, gb2x, j[0], gb1, k)),
        }
        s1 = kebt.edge_train_bwd2(*calls["bwd2"][2])[0]
        calls["bwd3"] = (kebt.edge_train_bwd3, kebt.edge_train_bwd3_plain,
                         (ee, j[3], w1, a1, w2, a2, wx, ax, gb2x, j[0], gb1,
                          s1, k))
        for name, (fn, plain, args) in calls.items():
            a, b = fn(*args), fn(*args)
            ref = plain(*args)
            a, b, ref = ([t] if torch.is_tensor(t) else list(t)
                         for t in (a, b, ref))
            for x, y, z in zip(a, b, ref):
                assert torch.equal(x, y), name
                torch.testing.assert_close(
                    x, z, rtol=0, atol=1e-4 * float(z.abs().max()))

    @pytest.mark.parametrize("case", list(BF16_CASES))
    def test_bf16_j_l_match_plain_versions(self, case):
        """Kernels I, J, K and L and kernel C in bf16 mode (the tensor
        cores) against their plain versions on the card: each output
        within 5e-3 relative L2 (the sum orders differ, and where they
        straddle a bf16 rounding point an operand moves by a bf16 ulp),
        C's contraction within TAIL_PAIR_TOL (it carries wout as a bf16
        pair), and bit-identical over two launches. The cases take the
        default step's widths, k = 20, 7 and 32 (the generic template, k
        bounded by 32), F = 64, a point count that leaves each kernel a
        ragged last tile, C and F2 that the kernels pad with zeros, a C
        whose weights do not fit in shared memory (J's, K's and L's FMA
        paths in bf16 mode; I's tensor cores still take it), and a C and
        F2 that only kernel C takes (its FMA path in bf16 mode)."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (kernels have no CPU mode)")
        torch.backends.cuda.matmul.allow_tf32 = False
        a = bf16_case_args(case, "cuda")
        ee, chain, gb2x, gb1, wout, k = (
            a[n] for n in ("ee", "chain", "gb2x", "gb1", "wout", "k"))
        i_args = (ee, *chain[:3], k)
        i_ref = (kebt.edge_train_stats2_plain(*i_args),)
        j_args = (ee, a["d_out"], *chain, gb2x, wout, k)
        sums, _, _, d_u = j_ref = kebt.edge_train_bwd1_plain(*j_args)
        k_args = (ee, d_u, *chain, gb2x, sums, gb1, k)
        k_ref = kebt.edge_train_bwd2_plain(*k_args)
        l_args = (ee, d_u, *chain, gb2x, sums, gb1, k_ref[0], k)
        l_ref = kebt.edge_train_bwd3_plain(*l_args)
        c_args = (ee, *chain, wout, a["bout"], k)
        c_ref = (edge_tail_plain(*c_args),)
        for tag, fn, args, ref in (
                ("I", lambda *a: (kebt.edge_train_stats2(*a),), i_args,
                 i_ref),
                ("J", kebt.edge_train_bwd1, j_args, j_ref),
                ("K", kebt.edge_train_bwd2, k_args, k_ref),
                ("L", kebt.edge_train_bwd3, l_args, l_ref),
                ("C", lambda *a: (edge_tail(*a),), c_args, c_ref)):
            if tag not in BF16_KERNELS.get(case, "IJKLC"):
                continue
            out, again = fn(*args), fn(*args)
            for n, (t, t2, z) in enumerate(zip(out, again, ref)):
                assert torch.equal(t, t2), f"{case}: {tag}[{n}]"
                t, z = t.float(), z.float()
                err = float((t - z).norm() / z.norm())
                assert err <= 5e-3, f"{case}: {tag}[{n}] {err}"
        if "C" in BF16_KERNELS.get(case, "IJKLC"):
            err = tail_contraction_rel(edge_tail(*c_args), c_ref[0],
                                       a["bout"])
            assert err <= TAIL_PAIR_TOL, f"{case}: C's contraction {err}"
