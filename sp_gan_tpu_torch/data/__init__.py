"""Sphere templates and latent-code sampling."""

from sp_gan_tpu_torch.data.noise import sample_z
from sp_gan_tpu_torch.data.sphere import (fibonacci_sphere, pc_normalize,
                                          sphere_template)

__all__ = ["fibonacci_sphere", "pc_normalize", "sample_z", "sphere_template"]
