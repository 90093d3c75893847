"""Generator, discriminator and their layers."""

from sp_gan_tpu_torch.nn.discriminator import Discriminator
from sp_gan_tpu_torch.nn.generator import Generator

__all__ = ["Discriminator", "Generator"]
