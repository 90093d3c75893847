"""GAN generator and discriminator objectives, the port of
`sp_gan_tpu/losses/gan.py`: {ls, wgan, hinge, gan, real}, with the
reference's label smoothing and label flips. The label noise is drawn from
a `torch.Generator` that the caller passes in (the JAX package draws it
from a PRNG key, so the two packages' noisy labels differ; parity holds
with the noise off).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Losses = Tuple[torch.Tensor, Dict[str, torch.Tensor]]


def _smooth_labels(gen: torch.Generator, shape, lo: float = 0.9,
                   hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return lo + (hi - lo) * u


def _noisy_labels(gen: torch.Generator, y: torch.Tensor,
                  p_flip: float = 0.05) -> torch.Tensor:
    """Flip each label iid with probability p_flip."""
    flip = torch.rand(y.shape, generator=gen, device=gen.device) < p_flip
    return torch.where(flip, 1.0 - y, y)


def _need(gen: Optional[torch.Generator]) -> torch.Generator:
    if gen is None:
        raise ValueError("noise_label needs a torch.Generator")
    return gen


def _acc(pred: torch.Tensor) -> torch.Tensor:
    return pred.float().mean()


def gen_loss(d_real: Optional[torch.Tensor], d_fake: torch.Tensor,
             gan: str = "ls", weight: float = 1.0, noise_label: bool = False,
             gen: Optional[torch.Generator] = None) -> Losses:
    """Generator objective; d_* are logits [B, 1] or [B]."""
    d_fake = d_fake.reshape(-1)
    gan = gan.lower()
    if gan in ("wgan", "hinge"):
        loss = -d_fake.mean() * weight
    elif gan == "ls":
        label = torch.ones_like(d_fake)
        if noise_label:
            label = _noisy_labels(_need(gen), label, 0.05)
        loss = ((d_fake - label) ** 2).mean() * weight
    elif gan == "gan":
        loss = (-F.logsigmoid(d_fake)).mean() * weight
    elif gan == "real":
        if d_real is None:
            raise ValueError("gan=real needs d_real")
        d_real = d_real.reshape(-1)
        d_loss = ((d_real - d_fake.mean() + 1.0) ** 2).mean()
        g_loss = ((d_fake - d_real.mean() - 1.0) ** 2).mean()
        loss = 0.5 * (g_loss + d_loss) * weight
    else:
        raise NotImplementedError(f"gan={gan}")
    return loss, {"g_loss": loss}


def dis_loss(d_real: torch.Tensor, d_fake: torch.Tensor, gan: str = "ls",
             weight: float = 1.0, noise_label: bool = False,
             gen: Optional[torch.Generator] = None) -> Losses:
    """Discriminator objective; the info carries real and fake accuracy as
    the reference reports them (threshold 0.5 for ls, else 0)."""
    d_real = d_real.reshape(-1)
    d_fake = d_fake.reshape(-1)
    gan = gan.lower()
    real_acc, fake_acc = _acc(d_real >= 0), _acc(d_fake < 0)
    if gan == "wgan":
        loss = (d_fake.mean() - d_real.mean()) * weight
    elif gan == "hinge":
        loss = (F.relu(1.0 - d_real).mean()
                + F.relu(1.0 + d_fake).mean()) * weight
        both = ((d_real >= 0).sum() + (d_fake < 0).sum()).float() \
            / (d_real.shape[0] + d_fake.shape[0])
        real_acc = fake_acc = both
    elif gan == "ls":
        real_label = torch.ones_like(d_real)
        if noise_label:
            g = _need(gen)
            real_label = _noisy_labels(g, _smooth_labels(g, d_real.shape),
                                       0.05)
        loss = (((d_real - real_label) ** 2).mean()
                + (d_fake ** 2).mean()) * weight
        real_acc, fake_acc = _acc(d_real >= 0.5), _acc(d_fake < 0.5)
    elif gan == "gan":
        loss = ((-F.logsigmoid(d_real)).mean()
                + (-F.logsigmoid(-d_fake)).mean()) * weight
    elif gan == "real":
        loss = 0.5 * (((d_real - d_fake.mean() - 1.0) ** 2).mean()
                      + ((d_fake - d_real.mean() + 1.0) ** 2).mean()) * weight
    else:
        raise NotImplementedError(f"gan={gan}")
    return loss, {"d_loss": loss, "real_acc": real_acc, "fake_acc": fake_acc}


def mix_loss(d_mix: torch.Tensor, gan: str = "ls",
             weight: float = 1.0) -> Losses:
    """CutMix discriminator loss: mixed clouds are labeled fake."""
    d_mix = d_mix.reshape(-1)
    gan = gan.lower()
    if gan == "ls":
        loss = (d_mix ** 2).mean() * weight
    elif gan == "gan":
        loss = (-F.logsigmoid(-d_mix)).mean() * weight
    else:
        raise NotImplementedError(f"gan={gan}")
    return loss, {"mix_loss": loss}
