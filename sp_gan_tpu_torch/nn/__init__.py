"""Generator, discriminator and their layers; the point-network layers
are in `nn.pointnet`."""

from sp_gan_tpu_torch.nn.discriminator import Discriminator
from sp_gan_tpu_torch.nn.generator import Generator
from sp_gan_tpu_torch.nn.layers import (AdaptivePointNorm, Attention,
                                        EdgeBlock, EqualDense, TorchDense,
                                        instance_norm_points)

__all__ = ["AdaptivePointNorm", "Attention", "Discriminator", "EdgeBlock",
           "EqualDense", "Generator", "TorchDense", "instance_norm_points"]
