"""Sphere templates, latent-code sampling and training data."""

from sp_gan_tpu_torch.data.h5 import (H5Dataset, SyntheticDataset,
                                      SyntheticMultiClassDataset)
from sp_gan_tpu_torch.data.noise import masked_z, mix_codes, sample_z
from sp_gan_tpu_torch.data.sphere import (fibonacci_sphere, pc_normalize,
                                          sphere_sqdist, sphere_template)

__all__ = ["H5Dataset", "SyntheticDataset", "SyntheticMultiClassDataset",
           "fibonacci_sphere", "masked_z", "mix_codes", "pc_normalize",
           "sample_z", "sphere_sqdist", "sphere_template"]
