"""The fused training path past k = 32 (the generator's --nk up to 128) on
the CPU, where the port runs the plain versions of kernels I-L and of
kernel C's bf16 mode, against the JAX package:

- the wrappers' limits, checked before any launch: k <= 64 on f32 and
  bf16 edges (the FMA kernels and the tensor cores), and the words of
  each refusal (`_refusal`: past k = 64, past a block's shared memory); on
  CPU tensors the plain versions at any k, and no launch;
- the fused train-mode generator forward at --nk 80 (N 128, batch 4,
  `Config()` widths: EdgeConv2 through the fused EdgeBlock at k = 40), its
  VJP and its running statistics, in float32 and mixed_edge, against
  `sp_gan_tpu.nn.fused_train` with the port's picks and pools replayed, at
  the tolerances of tests/test_torch_fused_train.py's TestFusedGenerator;
- one float32 `fused_train=True` step and one `fused_dphase=True` step at
  --nk 80 against the JAX step at the bounds of
  tests/test_torch_train_step.py, D's and G's gradients also at the step's
  own one-ulp response, as tests/test_torch_knn_wide_k.py holds the
  default step at --nk 80.

Kernels I-L's plain versions against the Pallas kernels at k = 33, 40 and
64 are tests/test_torch_edgeblock_train_wide_k.py's.
"""

import numpy as np
import pytest
import torch

import test_torch_edgeblock_train as ebt_base
import test_torch_fused_train as fused_base
import test_torch_knn_wide_k as wide_base
import test_torch_train_step as base
from sp_gan_tpu_torch.ops import kernels
from sp_gan_tpu_torch.ops.kernels import edgeblock_train as kebt

torch.set_num_threads(2)   # six test workers share the host's cores

# a small block for the limits' CPU checks: C, F (F2 = F / 2)
SC, SF = 8, 64


class TestLimits:
    def test_both_modes_take_k_up_to_64(self):
        """Both modes take k <= 64 (--nk 128) for each of I-L: past k = 32
        the FMA kernels take f32 edges on their shared-memory design, as
        the tensor cores take bf16 ones."""
        assert kebt.MAX_K == {torch.float32: 64, torch.bfloat16: 64}
        for p in range(4):
            kebt.check_kernel_limits(p, 64, torch.bfloat16)
            kebt.check_kernel_limits(p, 64, torch.float32)

    @pytest.mark.parametrize("pass_", range(4))
    @pytest.mark.parametrize("k, dtype, limit", [
        (65, torch.float32, "k <= 64 (--nk <= 128) in f32 mode"),
        (65, torch.bfloat16, "k <= 64 (--nk <= 128) in bf16 mode")])
    def test_refused_past_the_limit(self, pass_, k, dtype, limit):
        """f32 and bf16 at k = 65 are refused before a launch, naming the
        kernel, the limit and the --nk they came from."""
        with pytest.raises(ValueError) as e:
            kebt.check_kernel_limits(pass_, k, dtype)
        msg = str(e.value)
        assert limit in msg and f"(from --nk {2 * k})" in msg
        assert "IJKL"[pass_] in msg.split()[1]

    @pytest.mark.parametrize("bf16", [False, True])
    def test_refusal_words(self, bf16):
        """`_refusal`, the error of a call no engine takes: past k = 64
        it is the k limit's; within it, at L's widths past the FMA kernels'
        shared memory (C = 232, F2 = 64, F = 128, k = 64: one point's rows
        and intermediates need 2C + 448 floats a row, 232,448 bytes hold
        C <= 228), it names the widths, the widest C an engine takes there
        and what the shared memory must hold, by engine."""
        mode = "bf16" if bf16 else "f32"
        msg = str(kebt._refusal(3, 24, 2048, 64, 64, 128, 65, bf16))
        assert msg == (f"kernel L (edge_train_bwd3) takes k <= 64 (--nk <= "
                       f"128) in {mode} mode on CUDA; got k=65 (from --nk "
                       "130)")
        msg = str(kebt._refusal(3, 24, 2048, 232, 64, 128, 64, bf16, 228))
        assert msg.startswith(
            f"kernel L (edge_train_bwd3) in {mode} mode takes C <= 228 at "
            "F2=64, F=128, k=64 (from --nk 128): a block's shared memory "
            "must hold ")
        assert msg.endswith("got C=232")
        assert "the FMA kernels' one point's rows" in msg
        assert ("tensor cores' weights" in msg) == bf16

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_cpu_tensors_take_the_plain_versions_at_any_k(self, dtype):
        """The limits are the kernels': on CPU tensors each wrapper runs its
        plain version at k = 65 and launches nothing."""
        k = 65
        blk = ebt_base.block(1, SC, SF, k)
        g = torch.Generator().manual_seed(0)
        ee = torch.randn(1, 4, k, 2 * SC, generator=g).to(dtype)
        d_out = torch.randn(1, 4, SF, generator=g)
        inp = ebt_base.train_inputs(blk, ee, d_out, k)
        chain = tuple(inp[n] for n in ("w1", "a1", "w2", "a2", "wx", "ax"))
        sums, _, _, d_u = kebt.edge_train_bwd1_plain(
            ee, d_out, *chain, inp["gb2x"], inp["wout"], k)
        s1 = kebt.edge_train_bwd2_plain(ee, d_u, *chain, inp["gb2x"], sums,
                                        inp["gb1"], k)[0]
        calls = {
            "edge_train_stats2": (ee, inp["w1"], inp["a1"], inp["w2"], k),
            "edge_train_bwd1": (ee, d_out, *chain, inp["gb2x"], inp["wout"],
                                k),
            "edge_train_bwd2": (ee, d_u, *chain, inp["gb2x"], sums,
                                inp["gb1"], k),
            "edge_train_bwd3": (ee, d_u, *chain, inp["gb2x"], sums,
                                inp["gb1"], s1, k)}
        kernels.reset_launch_counts()
        for name, args in calls.items():
            ours = getattr(kebt, name)(*args)
            plain = getattr(kebt, name + "_plain")(*args)
            ours = [ours] if torch.is_tensor(ours) else ours
            plain = [plain] if torch.is_tensor(plain) else plain
            assert all(torch.equal(a, b) for a, b in zip(ours, plain)), name
        assert not any(kernels.launch_counts().values())


def test_plain_versions_run_in_float64():
    """On float64 operands the plain versions of I-L compute in float64,
    the oracle chip_smoke.py holds the FMA engine's f32 mode to: every
    output float64, and within 1e-5 relative L2 of the f32 run on the
    same values (k = 40, a small block)."""
    k = 40
    blk = ebt_base.block(2, SC, SF, k)
    g = torch.Generator().manual_seed(2)
    ee = torch.randn(1, 4, k, 2 * SC, generator=g)
    inp = ebt_base.train_inputs(blk, ee, torch.randn(1, 4, SF, generator=g),
                                k)
    inp = {n: v.detach() if torch.is_tensor(v) else v
           for n, v in inp.items()}
    f32 = ebt_base.plain_j_k_l(inp)
    f64 = ebt_base.plain_j_k_l({n: v.double() if torch.is_tensor(v) else v
                                for n, v in inp.items()})
    f32["stats2"] = kebt.edge_train_stats2_plain(
        ee, inp["w1"], inp["a1"], inp["w2"], k)
    f64["stats2"] = kebt.edge_train_stats2_plain(
        ee.double(), inp["w1"].double(), inp["a1"].double(),
        inp["w2"].double(), k)
    for name, v in f64.items():
        # the helper hands d_ee back as f32, from the f64 run's values
        assert v.dtype == torch.float64 or name == "d_ee", name
        assert ebt_base.rel(f32[name].double().numpy(), v.numpy()) <= 1e-5, \
            name


# ------------------------------------------- the fused generator at --nk 80
NK80_KW = dict(np=128, nk=80)


@pytest.fixture(scope="module")
def generator_runs():
    return fused_base.run_generators(NK80_KW, 4)


class TestFusedGeneratorNk80(fused_base.TestFusedGenerator):
    """tests/test_torch_fused_train.py's TestFusedGenerator at --nk 80 (k =
    40 in both EdgeBlocks, EdgeConv2 through the fused EdgeBlock and its
    plain kernels) at N 128, a batch of 4 and `Config()` widths, at its
    tolerances: float32 output and running statistics within 2e-4, the
    gradients within 2e-2 of max-abs and 1e-2 relative L2 or twice the
    port's own one-ulp response (`test_float32`); under mixed_edge see
    `test_mixed_edge`."""

    def test_mixed_edge(self, generator_runs):
        """Under mixed_edge the port's running statistics and whole
        gradient lie no farther (relative L2) from JAX's float32 run on the
        same choices than 1.1 times JAX's mixed_edge run does (plus 1e-6),
        and each gradient tensor and the output no farther than 1.5 times
        JAX's distance or 1e-2, the per-tensor rule of
        tests/test_torch_train_mixed_vjp.py. At --nk 80 the output is held
        as one tensor: the port's and JAX's bf16 outputs lie as far from
        each other (6.5e-2) as either lies from float32, so their two
        distances are independent draws, whose ratio measured 0.93 to 1.25
        over nearby choice sets (the port's EdgeConv2 in the two-pass
        plain form instead of the fused one: 1.19). Measured: output 6.8e-2
        against JAX's 5.5e-2, whole gradient 0.62 against 0.77, every
        tensor and statistic within its bound."""
        ours, theirs = generator_runs["port", "mixed_edge"], \
            generator_runs["jax", "mixed_edge"]
        wit = generator_runs["witness"]
        rel = fused_base.rel

        def check(a, b, c, what):
            assert rel(a, c) <= 1.1 * rel(b, c) + 1e-6, what

        def per_tensor(a, b, c, what):
            assert rel(a, c) <= max(1.5 * rel(b, c), 1e-2), what

        per_tensor(ours["out"], theirs["out"], wit["out"], "out")
        names = sorted(n for n in wit["grads"]
                       if not base.PRE_BN_BIAS.search(n))
        whole = [np.concatenate([r["grads"][n].ravel() for n in names])
                 for r in (ours, theirs, wit)]
        check(*whole, "G's gradient")
        for n in names:
            per_tensor(ours["grads"][n], theirs["grads"][n], wit["grads"][n],
                       n)
        for n in wit["stats"]:
            check(ours["stats"][n], theirs["stats"][n], wit["stats"][n], n)


# -------------------------------------------------- the fused step at --nk 80
@pytest.fixture(scope="module", params=["fused_train", "fused_dphase"])
def fused_nk80_step(request):
    res = base.run_both(dtype="float32", nk=80, np=128, zd_one_ulp=True,
                        one_ulp=True, replay_slopes=True,
                        **{request.param: True})
    return request.param, res


class TestFusedNk80StepParity(fused_base.TestFusedStepParity):
    """One float32 step at --nk 80 (k = 40) with `fused_train=True` (the
    port's G through the fused forward in both phases) and one with
    `fused_dphase=True` (in the D phase), its EdgeBlock kernels' plain
    versions, at N 128, bs 4, against the JAX step at the bounds of
    tests/test_torch_train_step.py, D's leaky ReLU slopes replayed, D's
    gradients also within twice the port's own response to one ulp of z_d
    (`test_d_gradients`) and G's within twice its response to one ulp of
    z_g (`test_g_phase`). Under `fused_train` EdgeConv2's conv biases stay
    still (their fused gradient is exactly zero); under `fused_dphase` the
    G phase is the module's, and every parameter moves."""

    @pytest.fixture
    def f32_step(self, fused_nk80_step):
        return fused_nk80_step[1]

    @pytest.mark.parametrize("net", ["d", "g"])
    def test_parameters_after_step(self, f32_step, fused_nk80_step, net):
        """`fused_train`: TestFusedStepParity's check; `fused_dphase`:
        tests/test_torch_train_step.py's (the G phase unfused)."""
        if fused_nk80_step[0] == "fused_train":
            super().test_parameters_after_step(f32_step, net)
        else:
            base.TestOneStepParity.test_parameters_after_step(
                self, f32_step, net)

    def test_d_gradients(self, f32_step):
        """As tests/test_torch_knn_wide_k.py holds the default step at
        --nk 80: every element within 1e-3 of its tensor's max-abs and each
        tensor within 2e-4 in relative L2, or, where larger, within twice
        the port's own response to one ulp of z_d. D's leaky ReLU slopes
        are replayed into the JAX step (`run_both(replay_slopes=True)`, as
        the WGAN-GP step test replays them): the D phase's fakes come from
        the fused forward here and from JAX's module forward there, and an
        input of D's leaky ReLUs within rounding of 0 otherwise takes the
        other slope in one of them, which put the packages' D gradients 2.1e-4
        to 4.1e-4 apart in relative L2, past this bound; on the replayed
        slopes they lie within 4% of it."""
        wide_base.TestNk80StepParity.test_d_gradients(self, f32_step)

    def test_g_phase(self, f32_step):
        """g_loss within 5e-5 relative. G's gradients within the bounds of
        tests/test_torch_train_step.py (2e-2 of a tensor's max-abs, 1e-2
        relative L2) or, where larger, twice the port's own response to one
        ulp of z_g with every discrete choice the same, as
        tests/test_torch_n_mix.py holds its step."""
        ours, theirs = f32_step["pinned"], f32_step["jax"]
        np.testing.assert_allclose(ours["g_loss"], theirs["g_loss"],
                                   rtol=5e-5)
        own = [base.grad_errors(u["g_grads"], f32_step["free"]["g_grads"])
               for u, same in f32_step["one_ulp"] if same]
        assert own, "no one-ulp run kept every choice"
        elem, l2 = base.grad_errors(ours["g_grads"], theirs["g_grads"])
        assert elem <= max(2e-2, 2 * max(o[0] for o in own)), elem
        assert l2 <= max(1e-2, 2 * max(o[1] for o in own)), l2
