"""Frechet Point Distance, the port of `sp_gan_tpu/eval/fpd.py`: DGCNN
activations -> (mu, sigma) -> Frechet distance, against reference clouds
or a statistics file (npz with `mu`/`sigma`, or `m`/`s`).

scipy is imported inside `frechet_distance`: it is an optional extra of
the package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sp_gan_tpu_torch.compat import state_from_jax
from sp_gan_tpu_torch.device import resolve_device
from sp_gan_tpu_torch.eval.dgcnn import DGCNNFeat


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)). `sqrtm` is called
    without `disp`, which newer scipy no longer takes; the matrix is the
    one `disp=False` returned."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def activation_statistics(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    acts = np.asarray(acts)
    return acts.mean(axis=0), np.cov(acts, rowvar=False)


def load_stats(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of a statistics file."""
    blob = np.load(path)
    mu = blob["mu"] if "mu" in blob else blob["m"]
    sigma = blob["sigma"] if "sigma" in blob else blob["s"]
    return mu, sigma


class FPD:
    """FPD evaluator on `device` (default cuda). `variables` are the JAX
    extractor's flax variables ({"params", "batch_stats"} as nested numpy
    dicts); without them the DGCNN is drawn from `seed` with flax's
    default initializers (`random_features`: a valid two-sample statistic,
    not comparable to a trained extractor's)."""

    def __init__(self, variables=None, k: int = 40, feat_dims: int = 1024,
                 batch_size: int = 32, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.random_features = variables is None
        self.model = DGCNNFeat(k=k, feat_dims=feat_dims,
                               seed=seed if variables is None else None)
        if variables is not None:
            self.model.load_state_dict(
                state_from_jax(variables["params"],
                               variables.get("batch_stats", {})),
                strict=True)
        self.model.to(self.device).eval()
        self.batch_size = batch_size

    def activations(self, clouds) -> np.ndarray:
        outs = []
        with torch.inference_mode():
            for lo in range(0, len(clouds), self.batch_size):
                batch = clouds[lo:lo + self.batch_size]
                if not isinstance(batch, torch.Tensor):
                    batch = torch.from_numpy(np.array(batch, np.float32))
                outs.append(self.model(batch.to(self.device)).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def __call__(self, gen_clouds, ref_clouds=None,
                 stats_path: Optional[str] = None) -> float:
        """FPD of generated clouds against reference clouds or a
        statistics file."""
        mu1, s1 = activation_statistics(self.activations(gen_clouds))
        if stats_path is not None:
            mu2, s2 = load_stats(stats_path)
        else:
            if ref_clouds is None:
                raise ValueError("FPD needs ref_clouds or stats_path")
            mu2, s2 = activation_statistics(self.activations(ref_clouds))
        return frechet_distance(mu1, s1, mu2, s2)

    @classmethod
    def from_torch(cls, weights_path: str, k: int = 40,
                   feat_dims: int = 1024, batch_size: int = 32) -> "FPD":
        raise NotImplementedError(
            "reference DGCNN .pth/.pkl weights need compat.convert_dgcnn, "
            "which is not ported yet (ROADMAP Queue 1, utilities and "
            "compat)")

    def save_statistics(self, clouds, path: str) -> None:
        mu, sigma = activation_statistics(self.activations(clouds))
        np.savez(path, mu=mu, sigma=sigma)


def fpd_from_weights(path: str, device=None) -> FPD:
    """FPD with the extractor of `path`: a pickle of flax variables
    ({"params", "batch_stats"}, with the `k` and `feat_dims` it was trained
    at, as the JAX package writes them), else reference torch weights
    (`FPD.from_torch`, not ported)."""
    import pickle
    with open(path, "rb") as f:
        try:
            blob = pickle.load(f)
        except pickle.UnpicklingError:     # e.g. a torch zip archive
            blob = None
    if not (isinstance(blob, dict) and "params" in blob):
        return FPD.from_torch(path)
    return FPD(variables={k: blob[k] for k in ("params", "batch_stats")
                          if k in blob},
               k=int(blob.get("k", 40)),
               feat_dims=int(blob.get("feat_dims", 1024)), device=device)
