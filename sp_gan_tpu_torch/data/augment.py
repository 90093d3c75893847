"""Point-cloud augmentations, the port of `sp_gan_tpu/data/augment.py`.

Each augmentation is split in two:

- a pure function that takes the drawn values (angles, scales, noise,
  offsets, masks, permutations) and applies them: `rotate_y`, `scale`,
  `augment`, `shuffle_points`, `jitter`, `translate`,
  `rotate_perturbation`, `point_dropout`;
- a `*_batch` wrapper that draws those values from an explicit
  `torch.Generator` on the cloud's device and calls it.

The pure functions keep the JAX package's order and forms (rotation about
y, then scale; `_rot_y`'s matrix and its `einsum("bnc,bcd->bnd")`; in
`rotate_perturbation`, `rz @ ry @ rx` and `einsum("bnc,bdc->bnd")`), so
fed the JAX package's own draws they give its results. Clouds are
[B, N, 3].
"""

from __future__ import annotations

import math

import torch


def normalize_point_cloud(pc: torch.Tensor) -> torch.Tensor:
    """Center each cloud on its centroid and scale its furthest point to
    radius 1; [N, 3] or [B, N, 3]."""
    pc = pc - pc.mean(dim=-2, keepdim=True)
    m = torch.sqrt((pc ** 2).sum(dim=-1)).amax(dim=-1)
    return pc / (m[..., None, None] + 1e-12)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float,
             device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


# ----------------------------------------------------------- the live path
def rot_y(angles: torch.Tensor) -> torch.Tensor:
    """[B] angles -> [B, 3, 3] rotations about the up (y) axis."""
    c, s = torch.cos(angles), torch.sin(angles)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1),
                        torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def rotate_y(pc: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Each cloud rotated about y by its angle [B]."""
    return torch.einsum("bnc,bcd->bnd", pc, rot_y(angles))


def scale(pc: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Each cloud times its scale s [B, 1, 1]."""
    return pc * s


def augment(pc: torch.Tensor, angles: torch.Tensor,
            s: torch.Tensor) -> torch.Tensor:
    """The live `--augment` pipeline: rotation about y, then scale."""
    return scale(rotate_y(pc, angles), s)


def rotate_y_batch(gen: torch.Generator, pc: torch.Tensor) -> torch.Tensor:
    """Each cloud rotated about y by an angle uniform in [0, 2 pi)."""
    return rotate_y(pc, _uniform(gen, (pc.shape[0],), 0.0, 2.0 * math.pi,
                                 pc.device))


def scale_batch(gen: torch.Generator, pc: torch.Tensor, lo: float = 0.8,
                hi: float = 1.25) -> torch.Tensor:
    """Each cloud scaled by a factor uniform in [lo, hi)."""
    return scale(pc, _uniform(gen, (pc.shape[0], 1, 1), lo, hi, pc.device))


def augment_batch(gen: torch.Generator, pc: torch.Tensor,
                  enabled: bool = True) -> torch.Tensor:
    """`augment` on angles, then scales, drawn from `gen`; `pc` itself
    when not `enabled`."""
    if not enabled:
        return pc
    B = pc.shape[0]
    angles = _uniform(gen, (B,), 0.0, 2.0 * math.pi, pc.device)
    return augment(pc, angles, _uniform(gen, (B, 1, 1), 0.8, 1.25,
                                        pc.device))


def shuffle_points(pc: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Each cloud's points in the order of its permutation perm [B, N]."""
    B, N, C = pc.shape
    return torch.gather(pc, 1, perm[..., None].expand(B, N, C))


def shuffle_points_batch(gen: torch.Generator,
                         pc: torch.Tensor) -> torch.Tensor:
    """Each cloud's points in a random order of its own (the order of
    uniform draws, sorted)."""
    B, N, _ = pc.shape
    return shuffle_points(pc, torch.rand(B, N, generator=gen,
                                         device=pc.device).argsort(1))


# ------------------------------------------------------------------ extras
def jitter(pc: torch.Tensor, normal: torch.Tensor, sigma: float = 0.01,
           clip: float = 0.05) -> torch.Tensor:
    """Each point moved by sigma times its standard normal draws
    (`normal`, pc's shape), clipped to [-clip, clip]."""
    return pc + torch.clamp(sigma * normal, -clip, clip)


def jitter_batch(gen: torch.Generator, pc: torch.Tensor, sigma: float = 0.01,
                 clip: float = 0.05) -> torch.Tensor:
    return jitter(pc, torch.randn(pc.shape, generator=gen, device=pc.device),
                  sigma, clip)


def translate(pc: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Each cloud shifted by its offset t [B, 1, 3]."""
    return pc + t


def translate_batch(gen: torch.Generator, pc: torch.Tensor,
                    translate_range: float = 0.1) -> torch.Tensor:
    """Each cloud shifted by an offset uniform in [-range, range)^3."""
    return translate(pc, _uniform(gen, (pc.shape[0], 1, 3), -translate_range,
                                  translate_range, pc.device))


def rotate_perturbation(pc: torch.Tensor,
                        angles: torch.Tensor) -> torch.Tensor:
    """Each cloud rotated by rz @ ry @ rx of its angles [B, 3] (about x,
    y and z)."""
    c, s = torch.cos(angles), torch.sin(angles)
    z, o = torch.zeros_like(c[:, 0]), torch.ones_like(c[:, 0])

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    cx, cy, cz = c.unbind(1)
    sx, sy, sz = s.unbind(1)
    rx = mat([[o, z, z], [z, cx, -sx], [z, sx, cx]])
    ry = mat([[cy, z, sy], [z, o, z], [-sy, z, cy]])
    rz = mat([[cz, -sz, z], [sz, cz, z], [z, z, o]])
    return torch.einsum("bnc,bdc->bnd", pc, rz @ ry @ rx)


def rotate_perturbation_batch(gen: torch.Generator, pc: torch.Tensor,
                              angle_sigma: float = 0.06,
                              angle_clip: float = 0.18) -> torch.Tensor:
    """Small rotations: angles angle_sigma times standard normal draws,
    clipped to [-angle_clip, angle_clip]."""
    normal = torch.randn(pc.shape[0], 3, generator=gen, device=pc.device)
    return rotate_perturbation(
        pc, torch.clamp(angle_sigma * normal, -angle_clip, angle_clip))


def point_dropout(pc: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    """The points where drop [B, N] is true replaced by the cloud's first
    point."""
    return torch.where(drop[..., None], pc[:, :1, :], pc)


def random_point_dropout(gen: torch.Generator, pc: torch.Tensor,
                         max_dropout_ratio: float = 0.875) -> torch.Tensor:
    """Each cloud drops a fraction uniform in [0, max_dropout_ratio) of its
    points (each point with that chance)."""
    B, N, _ = pc.shape
    ratio = torch.rand(B, 1, generator=gen, device=pc.device) \
        * max_dropout_ratio
    u = torch.rand(B, N, generator=gen, device=pc.device)
    return point_dropout(pc, u <= ratio)
