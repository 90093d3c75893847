"""sp_gan_tpu_torch: the PyTorch/CUDA port of `sp_gan_tpu` for one NVIDIA
H100 (Hopper, sm_90a).

Module names mirror the JAX package's. The port imports `torch` and never
`jax` nor `sp_gan_tpu`. The Pallas TPU kernels on its path are hand-written
CUDA under `csrc/`, built with nvcc into a C-ABI library on first use
(`ops/kernels/_build.py`); each has a plain PyTorch twin that serves CPU
tensors.
"""

from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.device import resolve_device

__all__ = ["Config", "resolve_device"]
