"""Shape generation from a trained generator, the port of the serving part
of `sp_gan_tpu/manipulate.py` (`Manipulator.generate`, the `simple_gen`
routine of the reference's `model_test.py`).

`Manipulator.generate` loops over batches of 64 codes, runs the generator
in eval mode on the broadcast sphere template and normalizes the clouds.
Like the JAX Manipulator on a TPU, it serves every configuration that
`nn.fused_eval.supports_fused` accepts (the defaults among them) through
the fused eval forward, and the others through `Generator.forward`. The
JAX package takes the fused path only where Pallas runs; the port's
kernels all have CPU twins, so it takes it on every device.
The JAX package's scanned bulk path (`_generate_scanned`) exists to cut
XLA dispatches and is not ported. The editing routines (interpolation, part
edit, flip, exchange) come in a later slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sp_gan_tpu_torch.compat import generator_state_from_jax
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data.noise import sample_z
from sp_gan_tpu_torch.data.sphere import sphere_template
from sp_gan_tpu_torch.device import resolve_device
from sp_gan_tpu_torch.nn.fused_eval import (generator_forward_eval,
                                            supports_fused)
from sp_gan_tpu_torch.nn.generator import Generator


def normalize_point_cloud(pc: torch.Tensor) -> torch.Tensor:
    """Center each cloud on its centroid and scale its furthest point to
    radius 1; [N, 3] or [B, N, 3]."""
    pc = pc - pc.mean(dim=-2, keepdim=True)
    m = torch.sqrt((pc ** 2).sum(dim=-1)).amax(dim=-1)
    return pc / (m[..., None, None] + 1e-12)


class Manipulator:
    """Serves a generator: `generate` for batches of shapes, `forward` for
    given codes. Runs on `device` (default cuda; raises without a GPU
    unless given device="cpu")."""

    def __init__(self, cfg: Config, generator: Generator,
                 sphere: Optional[np.ndarray] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ball = (sphere if sphere is not None
                     else sphere_template(cfg.np, cfg.template))
        self.sphere = torch.as_tensor(np.asarray(self.ball, np.float32),
                                      device=self.device)
        self.G = generator.to(self.device).eval()
        self.fused = supports_fused(cfg)
        # every routine forwards the broadcast template, so the unfused
        # path runs the first EdgeConv at batch 1
        self.b1 = cfg.edge1_b1 and not cfg.use_head

    @torch.inference_mode()
    def _forward(self, z) -> torch.Tensor:
        if not isinstance(z, torch.Tensor):
            z = torch.from_numpy(np.array(z, dtype=np.float32))
        z = z.to(self.device, torch.float32)
        x = self.sphere[None].expand(z.shape[0], -1, -1)
        if self.fused:
            return generator_forward_eval(self.G, x, z)
        return self.G(x, z, train=False, template_batch_const=self.b1)

    def forward(self, z) -> np.ndarray:
        """Clouds [B, N, 3] for codes z [B, N, nz] (array or tensor)."""
        return self._forward(z).cpu().numpy()

    def sample_codes(self, n: int, seed: int = 0,
                     per_point: Optional[bool] = None) -> torch.Tensor:
        """Codes [n, N, nz] on the device from a generator seeded with
        `seed`; per_point=None follows cfg.n_rand."""
        if per_point is None:
            per_point = self.cfg.n_rand
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return sample_z(gen, n, self.cfg.np, self.cfg.nz, sigma=self.cfg.nv,
                        n_rand=per_point)

    def generate(self, n: int, seed: int = 0, normalize: bool = True,
                 batch: int = 64) -> np.ndarray:
        """n shapes [n, N, 3]: batch b of `batch` codes is drawn with seed
        `seed + b * batch`, as in the JAX package."""
        if n <= 0:
            return np.zeros((0, self.cfg.np, 3), np.float32)
        outs = [self._forward(self.sample_codes(min(batch, n - lo), seed + lo))
                for lo in range(0, n, batch)]
        pcs = torch.cat(outs, dim=0)
        if normalize:
            pcs = normalize_point_cloud(pcs)
        return pcs.cpu().numpy()


def load_jax_generator(g_params, g_stats, cfg: Config) -> Generator:
    """A `Generator` holding the weights of JAX trees (g_params, g_stats)."""
    G = Generator(cfg, seed=None)
    G.load_state_dict(generator_state_from_jax(g_params, g_stats),
                      strict=True)
    return G


def from_checkpoint(ckpt_path: str, cfg: Config, use_ema: bool = False,
                    device=None) -> Manipulator:
    """A Manipulator serving the generator of a JAX checkpoint (`use_ema`:
    its EMA weights)."""
    from sp_gan_tpu_torch.train.checkpoint import load_generator
    device = resolve_device(device)
    params, stats = load_generator(ckpt_path, use_ema=use_ema)
    return Manipulator(cfg, load_jax_generator(params, stats, cfg),
                       device=device)
