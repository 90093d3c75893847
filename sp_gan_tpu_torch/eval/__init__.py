"""Evaluation: generative metrics (JSD, MMD, COV, 1-NN over CD and EMD)
and FPD, the port of `sp_gan_tpu/eval`."""

from sp_gan_tpu_torch.eval.fpd import FPD, frechet_distance
from sp_gan_tpu_torch.eval.metrics import (compute_all_metrics, coverage,
                                           f_score, jsd, knn_two_sample,
                                           mmd, pairwise_cd_matrix,
                                           pairwise_emd_matrix,
                                           per_class_metrics)

__all__ = [
    "pairwise_cd_matrix", "pairwise_emd_matrix", "coverage", "mmd",
    "knn_two_sample", "jsd", "f_score", "compute_all_metrics",
    "per_class_metrics", "frechet_distance", "FPD",
]
