"""Kernel M's plain version (`ops/kernels/scatter.py::edge_scatter_bwd_plain`,
the backward of the concat-form edge op) against the JAX package's
`edge_scatter_bwd_pallas` (interpret mode, jitted, as tests/test_pallas.py
runs it), the SPGAN_EDGE_BWD switch of `EdgeConcat`, and a --fused_train
step with the switch against the same step without it.

Kernel M itself runs only on a GPU (`cuda` marker); chip_smoke.py holds it
against its plain version there.
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
from sp_gan_tpu.data.h5 import SyntheticDataset as JaxSynthetic
from sp_gan_tpu.data.noise import sample_z as jsample_z
from sp_gan_tpu.ops.pallas import scatter as jscatter
from sp_gan_tpu.train.state import create_train_state as jcreate
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.ops import edge as tedge
from sp_gan_tpu_torch.ops import kernels
from sp_gan_tpu_torch.ops.kernels import (edge_scatter_bwd,
                                          edge_scatter_bwd_plain)

torch.set_num_threads(2)   # six test workers share the host's cores


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def inputs(B, N, k, C, dtype, seed=0):
    """d_ee [B, N, k, 2C] in `dtype` and kNN-like idx [B, N, k] int32."""
    rng = np.random.default_rng(seed)
    d_ee = torch.from_numpy(rng.standard_normal((B, N, k, 2 * C)).astype(
        np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, N, (B, N, k)).astype(np.int32))
    return d_ee, idx


class TestKernelMPlain:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("N", [128, 256])
    @pytest.mark.parametrize("C", [8, 64])
    def test_matches_pallas(self, dtype, N, C):
        """Within 1e-5 relative L2 of the Pallas kernel at t_tile=64: both
        sum in f32 (the TPU kernel's bf16 one-hot matmuls are exact, its
        f32 input split in three exact bf16 parts), in other orders."""
        d_ee, idx = inputs(2, N, 5, C, dtype)
        ours = edge_scatter_bwd_plain(d_ee, idx)
        fn = jax.jit(lambda a, b: jscatter.edge_scatter_bwd_pallas(
            a, b, t_tile=64))
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        with pltpu.force_tpu_interpret_mode():
            theirs = np.asarray(fn(jnp.asarray(d_ee.float().numpy(), jdt),
                                   jnp.asarray(idx.numpy())))
        assert ours.shape == (2, N, C) and ours.dtype == torch.float32
        assert rel(ours.numpy(), theirs) <= 1e-5

    def test_definition(self):
        """The neighbor half summed by target plus the own rows' central
        half minus neighbor half, in float64."""
        d_ee, idx = inputs(2, 64, 4, 8, torch.float32, seed=3)
        g = d_ee.double().numpy()
        want = (g[..., :8] - g[..., 8:]).sum(axis=2)
        for b in range(2):
            np.add.at(want[b], idx[b].numpy().reshape(-1),
                      g[b, ..., 8:].reshape(-1, 8))
        np.testing.assert_allclose(edge_scatter_bwd_plain(d_ee, idx).numpy(),
                                   want, rtol=0, atol=1e-5)

    def test_wrapper_takes_the_plain_version_on_cpu(self):
        d_ee, idx = inputs(1, 32, 3, 4, torch.bfloat16, seed=4)
        kernels.reset_launch_counts()
        assert torch.equal(edge_scatter_bwd(d_ee, idx),
                           edge_scatter_bwd_plain(d_ee, idx))
        assert edge_scatter_bwd.launches == 0

    @pytest.mark.parametrize("bad", ["odd", "idx_shape", "idx_dtype"])
    def test_wrapper_refuses(self, bad):
        d_ee, idx = inputs(1, 16, 3, 4, torch.float32)
        if bad == "odd":
            d_ee = d_ee[..., :7]
        elif bad == "idx_shape":
            idx = idx[:, :8]
        else:
            idx = idx.long()
        with pytest.raises((ValueError, TypeError)):
            edge_scatter_bwd(d_ee.contiguous(), idx.contiguous())


class TestSwitch:
    def _grad(self, x, k):
        xg = torch.from_numpy(x).requires_grad_()
        ee, _ = tedge.edge_concat_fused(xg, k, torch.float32)
        g = torch.from_numpy(np.random.default_rng(1).standard_normal(
            ee.shape).astype(np.float32))
        (ee * g).sum().backward()
        return xg.grad.numpy()

    def test_on_and_off_agree(self, monkeypatch):
        """`EdgeConcat`'s backward with SPGAN_EDGE_BWD=pallas (kernel M's
        plain version on the CPU) and without (the default branch): within
        1e-5 relative L2 on f32 edges (f32 sums in other orders)."""
        monkeypatch.setenv("SPGAN_KNN_SELECT", "exact")
        x = np.random.default_rng(0).standard_normal((2, 64, 16)).astype(
            np.float32)
        off = self._grad(x, 4)
        monkeypatch.setenv("SPGAN_EDGE_BWD", "pallas")
        on = self._grad(x, 4)
        assert rel(on, off) <= 1e-5

    def test_bad_value_raises(self, monkeypatch):
        monkeypatch.setenv("SPGAN_EDGE_BWD", "triton")
        with pytest.raises(ValueError, match="SPGAN_EDGE_BWD"):
            tedge.edge_bwd_mode()
        x = np.zeros((1, 16, 16), np.float32) + np.arange(16)[:, None]
        with pytest.raises(ValueError, match="SPGAN_EDGE_BWD"):
            self._grad(x.astype(np.float32), 4)

    def test_default_is_xla(self, monkeypatch):
        monkeypatch.delenv("SPGAN_EDGE_BWD", raising=False)
        assert tedge.edge_bwd_mode() == "xla"


def test_fused_step_with_switch(monkeypatch):
    """A --fused_train float32 step at N=256, bs=4 with SPGAN_EDGE_BWD=
    pallas against the same step without it, from the same JAX start:
    the D phase (which runs no edge backward) equal, G's gradients within
    tests/test_torch_fused_train.py's bounds (2e-2 of a tensor's max-abs,
    1e-2 relative L2). Only the sum order of EdgeConv2's edge backward
    differs, so they agree far closer."""
    kw = dict(base.CFG_KW, dtype="float32", fused_train=True)
    cfg = Config(**kw)
    jstate, _, _, _, _ = jcreate(JaxConfig(**kw, donate_state=False),
                                 jax.random.PRNGKey(0))
    sphere = sphere_template(cfg.np)
    real = JaxSynthetic(n_items=cfg.bs, n_points=cfg.np, seed=5).data.copy()
    _, k_zd, k_zg, _, _, _ = jax.random.split(jstate.rng, 6)
    z_d, z_g = (np.array(jsample_z(kk, cfg.bs, cfg.np, cfg.nz, cfg.nv))
                for kk in (k_zd, k_zg))
    monkeypatch.setenv("SPGAN_KNN_SELECT", "exact")
    off = base.port_step(cfg, jstate, sphere, real, z_d, z_g)
    monkeypatch.setenv("SPGAN_EDGE_BWD", "pallas")
    on = base.port_step(cfg, jstate, sphere, real, z_d, z_g)
    assert all(np.array_equal(a, b) for a, b in zip(on[1], off[1]))
    assert on[0]["d_loss"] == off[0]["d_loss"]
    for name, g in off[0]["d_grads"].items():
        np.testing.assert_array_equal(on[0]["d_grads"][name], g)
    elem, l2 = base.grad_errors(on[0]["g_grads"], off[0]["g_grads"])
    assert elem <= 2e-2 and l2 <= 1e-2, (elem, l2)


@pytest.mark.cuda
def test_kernel_m_matches_plain_on_cuda():
    """Kernel M against its plain version on CPU copies (the same sums in
    the same order): bit-equal, in f32 and bf16 (chip_smoke.py does the
    same at the --fused_train step's shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    for dtype in (torch.float32, torch.bfloat16):
        d_ee, idx = inputs(2, 256, 10, 64, dtype)
        got = edge_scatter_bwd(d_ee.cuda(), idx.cuda()).cpu()
        assert torch.equal(got, edge_scatter_bwd_plain(d_ee, idx))
