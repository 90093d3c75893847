"""Generator and its layers."""

from sp_gan_tpu_torch.nn.generator import Generator

__all__ = ["Generator"]
