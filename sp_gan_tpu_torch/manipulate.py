"""Shape generation and manipulation from a trained generator, the port of
`sp_gan_tpu/manipulate.py` and of the root `manipulate.py` CLI.

Every routine of the reference's `model_test.py` is an edit of the codes z
over the fixed ordering of the sphere template, then a forward:

  simple_gen                  -> Manipulator.generate
  draw_correspondense         -> Manipulator.correspondence
  draw_shape_intepolate       -> Manipulator.shape_interpolate
  draw_part_shape_inte        -> Manipulator.part_interpolate
                                 (styles blended: .style_interpolate)
  draw_part_shape_inte_detail -> Manipulator.part_interpolate_detail
  draw_part_edit              -> Manipulator.part_edit
  draw_part_flip              -> Manipulator.part_flip
  draw_part_exchange          -> Manipulator.part_exchange
  draw_edit_inte              -> Manipulator.edit_interpolate

The masks (`half_space_mask`, `region_mask`) are numpy; the code edits
(`blend_z`, `replace_z`, `flip_z`, `exchange_z`) run on tensors, on the
Manipulator's device. Like the JAX Manipulator on a TPU, every forward
serves the configurations that `nn.fused_eval.supports_fused` accepts (the
defaults among them) through the fused eval forward, and the others
through `Generator.forward`; the port's kernels all have CPU twins, so it
takes the fused path on every device. `style_interpolate` blends the
styles of two codes inside the generator, which the fused path does not
take, so it runs `Generator.forward(z2=...)` at batch 1, as the JAX
routine does. The JAX package's scanned bulk path (`_generate_scanned`,
`wire_dtype`) exists to cut XLA dispatches and is not ported.

CLI (needs matplotlib for its figures; on the GPU unless `--device cpu`):

    python -m sp_gan_tpu_torch.manipulate --log_dir runs/run \\
        --routine all --out_dir figs
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from sp_gan_tpu_torch.compat import generator_state_from_jax
from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data.augment import normalize_point_cloud
from sp_gan_tpu_torch.data.noise import sample_z
from sp_gan_tpu_torch.data.sphere import sphere_sqdist, sphere_template
from sp_gan_tpu_torch.device import resolve_device
from sp_gan_tpu_torch.nn.fused_eval import (generator_forward_eval,
                                            supports_fused)
from sp_gan_tpu_torch.nn.generator import Generator

ROUTINES = ("correspondence", "interpolate", "part_interpolate",
            "style_interpolate", "part_interpolate_detail", "part_edit",
            "part_flip", "part_exchange", "edit_interpolate")


# ---------------------------------------------------------------- masks
def half_space_mask(ball: np.ndarray, axis: int = 0, threshold: float = 0.0,
                    positive: bool = True) -> np.ndarray:
    """{0, 1}^N int32 mask of the template points on one side of an axis
    plane."""
    side = ball[:, axis] > threshold
    return (side if positive else ~side).astype(np.int32)


def region_mask(ball: np.ndarray, anchor: int, num: int) -> np.ndarray:
    """{0, 1}^N int32 mask of the `num` template points nearest to point
    `anchor`, ranked by numpy's default `argsort` of its `sphere_sqdist`
    row, as the JAX package ranks them (so ties fall alike)."""
    d = sphere_sqdist(ball)[anchor]
    idx = np.argsort(d)[:num]
    mask = np.zeros(len(ball), np.int32)
    mask[idx] = 1
    return mask


# ---------------------------------------------------------------- z edits
def _mask(mask, z: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(mask), device=z.device).reshape(1, -1, 1)


def blend_z(z1: torch.Tensor, z2: torch.Tensor, mask,
            alpha: float) -> torch.Tensor:
    """z1 outside the mask; (1 - a) z1 + a z2 inside it."""
    m = _mask(mask, z1).to(z1.dtype)
    return z1 * (1 - m * alpha) + z2 * (m * alpha)


def replace_z(z1: torch.Tensor, z2: torch.Tensor, mask) -> torch.Tensor:
    """z2 inside the mask, z1 outside."""
    return torch.where(_mask(mask, z1).bool(), z2, z1)


def flip_z(z: torch.Tensor, mask) -> torch.Tensor:
    """The code negated inside the mask."""
    return torch.where(_mask(mask, z).bool(), -z, z)


def exchange_z(za: torch.Tensor, zb: torch.Tensor, mask):
    """The two shapes' codes swapped inside the mask: (za', zb')."""
    m = _mask(mask, za).bool()
    return torch.where(m, zb, za), torch.where(m, za, zb)


# ---------------------------------------------------------------- Manipulator
class Manipulator:
    """Serves a generator: `generate` for batches of shapes, `forward` for
    given codes, and the editing routines. Runs on `device` (default cuda;
    raises without a GPU unless given device="cpu"). Every routine returns
    numpy arrays."""

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

    def correspondence(self, n: int = 4, seed: int = 0):
        """n shapes and per-point colors: the template's coordinates mapped
        to [0, 1]^3. Returns (clouds [n, N, 3], colors [n, N, 3])."""
        pcs = self.generate(n, seed)
        colors = (self.ball - self.ball.min(0)) / np.ptp(self.ball, 0)
        return pcs, np.broadcast_to(colors[None], pcs.shape).copy()

    def _pair(self, seed_a: int, seed_b: int):
        return self.sample_codes(1, seed_a), self.sample_codes(1, seed_b)

    def shape_interpolate(self, seed_a: int = 0, seed_b: int = 1,
                          steps: int = 6) -> np.ndarray:
        """The codes of two shapes interpolated: [steps, N, 3]."""
        za, zb = self._pair(seed_a, seed_b)
        zs = torch.cat([za * (1 - float(a)) + zb * float(a)
                        for a in np.linspace(0.0, 1.0, steps)])
        return self.forward(zs)

    def part_interpolate(self, mask, seed_a: int = 0, seed_b: int = 1,
                         steps: int = 6) -> np.ndarray:
        """The codes interpolated inside `mask` only: [steps, N, 3]."""
        za, zb = self._pair(seed_a, seed_b)
        zs = torch.cat([blend_z(za, zb, mask, float(a))
                        for a in np.linspace(0, 1, steps)])
        return self.forward(zs)

    @torch.inference_mode()
    def style_interpolate(self, mask, seed_a: int = 0, seed_b: int = 1,
                          steps: int = 6) -> np.ndarray:
        """The styles the head makes of two codes blended inside `mask`
        (`Generator.interpolate(use_latent=True)`), one forward of batch 1
        a step through `Generator.forward`: [steps, N, 3]."""
        za, zb = self._pair(seed_a, seed_b)
        x = self.sphere[None]
        sel = torch.as_tensor(np.asarray(mask), device=self.device)
        return torch.cat([self.G(x, za, train=False, z2=zb, blend_mask=sel,
                                 blend_alpha=float(a))
                          for a in np.linspace(0.0, 1.0, steps)]
                         ).cpu().numpy()

    def part_interpolate_detail(self, seed_a: int = 0, seed_b: int = 1,
                                alphas: Sequence[float] = (1.0, 0.75, 0.5,
                                                           0.25, 0.0),
                                mask_sizes: Sequence[int] = (0, 512, 1024,
                                                             1536, 2048),
                                normalize: bool = True):
        """A sweep of blend weight by region size: region j is the last
        `mask_sizes[j]` template points, inside it z = a z_a + (1 - a) z_b
        (a weights code A, as the reference does). With `normalize` the
        clouds are normalized and scaled by 0.75, as the reference draws
        them. Returns (shape_row [len(alphas), N, 3], grid [len(alphas),
        len(mask_sizes), N, 3], region masks [len(mask_sizes), N])."""
        N = self.cfg.np
        za, zb = self._pair(seed_a, seed_b)
        masks = np.zeros((len(mask_sizes), N), np.int32)
        for j, m in enumerate(mask_sizes):
            if m > 0:
                masks[j, N - m:] = 1
        mix = [a * za + (1 - a) * zb for a in alphas]
        shape_row = self._forward(torch.cat(mix))
        inside = torch.as_tensor(masks, device=self.device)[:, :, None] > 0
        grid = torch.stack([self._forward(torch.where(inside, zm, za))
                            for zm in mix])
        if normalize:
            shape_row = 0.75 * normalize_point_cloud(shape_row)
            grid = 0.75 * normalize_point_cloud(grid)
        return shape_row.cpu().numpy(), grid.cpu().numpy(), masks

    def part_edit(self, mask, seed: int = 0,
                  n_variants: int = 4) -> np.ndarray:
        """The shape kept, the masked part's codes drawn anew with seeds
        `seed + 101 + i`: [1 + n_variants, N, 3], the original first."""
        z = self.sample_codes(1, seed)
        zs = [z] + [replace_z(z, self.sample_codes(1, seed + 101 + i), mask)
                    for i in range(n_variants)]
        return self.forward(torch.cat(zs))

    def part_flip(self, axis: int = 0, seed: int = 0,
                  n: int = 4) -> np.ndarray:
        """n shapes with their codes negated on a half-space: [2n, N, 3],
        the n originals, then the n flipped."""
        mask = half_space_mask(self.ball, axis=axis)
        z = self.sample_codes(n, seed)
        return self.forward(torch.cat([z, flip_z(z, mask)]))

    def part_exchange(self, mask, seed_a: int = 0,
                      seed_b: int = 1) -> np.ndarray:
        """A region's codes swapped between two shapes: [4, N, 3], a, b,
        a with b's part, b with a's part."""
        za, zb = self._pair(seed_a, seed_b)
        zab, zba = exchange_z(za, zb, mask)
        return self.forward(torch.cat([za, zb, zab, zba]))

    def edit_interpolate(self, mask, seed: int = 0, seed_edit: int = 7,
                         steps: int = 6) -> np.ndarray:
        """A part edit reached in steps: the codes inside `mask` blended
        toward those of `seed_edit`: [steps, N, 3]."""
        z, z2 = self._pair(seed, seed_edit)
        zs = torch.cat([blend_z(z, z2, mask, float(a))
                        for a in np.linspace(0, 1, steps)])
        return self.forward(zs)


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


# ---------------------------------------------------------------- CLI
def run_routine(man: Manipulator, r: str, mask, seed: int, steps: int):
    """(clouds, colors or None) of routine `r` with the CLI's arguments."""
    if r == "correspondence":
        pcs, colors = man.correspondence(4, seed)
        return list(pcs), list(colors)
    if r == "interpolate":
        return list(man.shape_interpolate(seed, seed + 1, steps)), None
    if r == "part_interpolate":
        return list(man.part_interpolate(mask, seed, seed + 1, steps)), None
    if r == "style_interpolate":
        return list(man.style_interpolate(mask, seed, seed + 1, steps)), None
    if r == "part_interpolate_detail":
        shape_row, grid, _ = man.part_interpolate_detail(seed, seed + 1)
        rows = [shape_row] + [grid[i] for i in range(grid.shape[0])]
        return [pc for row in rows for pc in row], None
    if r == "part_edit":
        return list(man.part_edit(mask, seed)), None
    if r == "part_flip":
        return list(man.part_flip(seed=seed)), None
    if r == "part_exchange":
        return list(man.part_exchange(mask, seed, seed + 1)), None
    if r == "edit_interpolate":
        return list(man.edit_interpolate(mask, seed, steps=steps)), None
    raise ValueError(f"unknown routine {r}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="shape manipulation figures from a checkpoint")
    p.add_argument("--log_dir", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--ema", action="store_true",
                   help="use the EMA generator weights from the checkpoint")
    p.add_argument("--routine", default="correspondence",
                   help=f"one of {', '.join(ROUTINES)}, or all")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    routines = list(ROUTINES) if args.routine == "all" else [args.routine]
    for r in routines:
        if r not in ROUTINES:
            raise SystemExit(f"unknown routine {r}")
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise SystemExit("sp_gan_tpu_torch.manipulate draws its figures "
                         f"with matplotlib, which is not installed ({e})")

    from sp_gan_tpu_torch.train.checkpoint import latest_checkpoint
    from sp_gan_tpu_torch.viz.plot import (plot_three_views,
                                           plot_three_views_color)

    with open(os.path.join(args.log_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    ckpt = args.ckpt or latest_checkpoint(args.log_dir)
    if not ckpt:
        raise SystemExit(f"no checkpoint in {args.log_dir}")
    man = from_checkpoint(ckpt, cfg, use_ema=args.ema, device=args.device)
    out_dir = args.out_dir or os.path.join(args.log_dir, "manipulate")
    os.makedirs(out_dir, exist_ok=True)
    mask = region_mask(man.ball, anchor=0, num=cfg.np // 3)
    for r in routines:
        path = os.path.join(out_dir, f"{r}.png")
        pcs, colors = run_routine(man, r, mask, args.seed, args.steps)
        if colors is not None:
            plot_three_views_color(path, pcs, colors=colors)
        else:
            plot_three_views(path, pcs)
        print("wrote", path)


if __name__ == "__main__":
    main()
