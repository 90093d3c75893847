"""The fused training path past k = 32 (the generator's --nk up to 128) on
the CPU, where the port runs the plain versions of kernels I-L and of
kernel C's bf16 mode, against the JAX package:

- the wrappers' limits, checked before any launch: k <= 64 on bf16 edges
  (the tensor cores), k <= 32 on f32 edges (the FMA kernels); on CPU
  tensors the plain versions at any k, and no launch;
- the fused train-mode generator forward at --nk 80 (N 128, batch 4,
  `Config()` widths: EdgeConv2 through the fused EdgeBlock at k = 40), its
  VJP and its running statistics, in float32 and mixed_edge, against
  `sp_gan_tpu.nn.fused_train` with the port's picks and pools replayed, at
  the tolerances of tests/test_torch_fused_train.py's TestFusedGenerator;
- one `fused_train=True` step at --nk 80 against the JAX step at the
  bounds of tests/test_torch_train_step.py, D's and G's gradients also at
  the step's own one-ulp response, as tests/test_torch_knn_wide_k.py
  holds the default step at --nk 80.

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
    def test_bf16_takes_k_up_to_64_f32_up_to_32(self):
        """The check passes bf16 edges at k = 64 (--nk 128) for each of
        I-L, on the tensor cores, and f32 edges at k = 32 (--nk 64), the
        largest the FMA kernels take."""
        assert kebt.MAX_K == {torch.float32: 32, torch.bfloat16: 64}
        for p in range(4):
            kebt.check_kernel_limits(p, 64, torch.bfloat16)
            kebt.check_kernel_limits(p, 32, torch.float32)

    @pytest.mark.parametrize("pass_", range(4))
    @pytest.mark.parametrize("k, dtype, limit", [
        (33, torch.float32, "k <= 32 (--nk <= 64) in f32 mode"),
        (65, torch.bfloat16, "k <= 64 (--nk <= 128) in bf16 mode")])
    def test_refused_past_the_limit(self, pass_, k, dtype, limit):
        """f32 at k = 33 and bf16 at k = 65 are refused before a launch,
        naming the kernel, the limit and the --nk they came from."""
        with pytest.raises(ValueError) as e:
            kebt.check_kernel_limits(pass_, k, dtype)
        msg = str(e.value)
        assert limit in msg and f"(from --nk {2 * k})" in msg
        assert "IJKL"[pass_] in msg.split()[1]

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
@pytest.fixture(scope="module")
def fused_nk80_step():
    return base.run_both(dtype="float32", fused_train=True, nk=80, np=128,
                         zd_one_ulp=True, one_ulp=True, replay_slopes=True)


class TestFusedNk80StepParity(fused_base.TestFusedStepParity):
    """One `fused_train=True` float32 step at --nk 80 (k = 40; the port's G
    through the fused forward in both phases, its EdgeBlock kernels' plain
    versions) at N 128, bs 4, against the JAX step at the bounds of
    tests/test_torch_train_step.py, EdgeConv2's conv biases still (their
    fused gradient is exactly zero), D's leaky ReLU slopes replayed, D's
    gradients also within twice the port's own response to one ulp of z_d
    (`test_d_gradients`) and G's within twice its response to one ulp of
    z_g (`test_g_phase`)."""

    @pytest.fixture
    def f32_step(self, fused_nk80_step):
        return fused_nk80_step

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
