"""Generative point-cloud metrics, the port of `sp_gan_tpu/eval/metrics.py`:
the pairwise Chamfer and EMD matrices on the device, and the summary
statistics (COV, MMD, 1-NN, JSD, F-score) on the host.

The Chamfer matrix is plain PyTorch (the JAX package's is XLA). The EMD
matrix solves each pair with `ops.emd.emd_auction`, whose scaled solver is
kernel E on CUDA. Both matrices come back as numpy arrays. Inputs may be
numpy arrays (taken to the CPU) or tensors (used on their device);
`compute_all_metrics` takes everything to its `device`, cuda unless the
caller names another.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from sp_gan_tpu_torch.device import resolve_device
from sp_gan_tpu_torch.ops.emd import emd_auction
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist
from sp_gan_tpu_torch.ops.voxel import voxel_occupancy

CD_CHUNK_BYTES = 2 << 30      # distance block per Chamfer call, as in JAX
EMD_CHUNK_BYTES = 4 << 30     # distance matrices per EMD solve call


def _tensor(x, device=None) -> torch.Tensor:
    """x as an f32 tensor on `device` (default: its own, or the CPU)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


def pairwise_cd_matrix(gen, ref, col_chunk: int = 0) -> np.ndarray:
    """[S1, N, 3] x [S2, M, 3] -> [S1, S2] of mean Chamfer distance
    (mean over gen points of the nearest ref point's squared distance,
    plus the same the other way), a row at a time. `col_chunk` bounds the
    distance block of one call to [col_chunk, N, M]; 0 takes the largest
    chunk under 2 GB."""
    gen = _tensor(gen)
    ref = _tensor(ref, gen.device)
    S2, N, M = ref.shape[0], gen.shape[1], ref.shape[1]
    if col_chunk <= 0:
        col_chunk = max(1, min(S2, CD_CHUNK_BYTES // max(N * M * 4, 1)))
    while S2 % col_chunk:
        col_chunk -= 1
    out = torch.empty((gen.shape[0], S2), dtype=torch.float32,
                      device=gen.device)
    with torch.no_grad():
        for i in range(gen.shape[0]):
            for lo in range(0, S2, col_chunk):
                d = pairwise_sqdist(gen[i][None], ref[lo:lo + col_chunk])
                out[i, lo:lo + col_chunk] = (d.amin(dim=-1).mean(dim=-1)
                                             + d.amin(dim=-2).mean(dim=-1))
    return out.cpu().numpy()


def emd_pairs_per_call(s2: int, n: int, m: int, row_batch: int = 8) -> int:
    """Pairs per solve call of `pairwise_emd_matrix`: `row_batch` rows of
    s2 pairs, at most 4 GB of distance matrices."""
    return max(1, min(row_batch * s2, EMD_CHUNK_BYTES // (n * m * 4)))


def pairwise_emd_matrix(gen, ref, eps: float = 0.005, iters: int = 50,
                        row_batch: int = 8, scaled: bool = True, mesh=None,
                        mesh_axis: str = "points") -> np.ndarray:
    """[S1, N, 3] x [S2, N, 3] -> [S1, S2] of mean L2 EMD. The S1 * S2
    pairs are solved in row-major order, `emd_pairs_per_call` at a time.
    scaled=True (the default) is the eps-scaling auction, kernel E on
    CUDA. The point-sharded solver (`mesh=`) is not ported."""
    if mesh is not None:
        raise NotImplementedError("the point-sharded EMD (mesh=, "
                                  "--mesh_points) is not ported")
    gen = _tensor(gen)
    ref = _tensor(ref, gen.device)
    S1, S2 = gen.shape[0], ref.shape[0]
    per = emd_pairs_per_call(S2, gen.shape[1], ref.shape[1], row_batch)
    out = torch.empty(S1 * S2, dtype=torch.float32, device=gen.device)
    with torch.no_grad():
        for lo in range(0, S1 * S2, per):
            pairs = torch.arange(lo, min(lo + per, S1 * S2),
                                 device=gen.device)
            d, _ = emd_auction(gen[pairs // S2], ref[pairs % S2], eps,
                               iters, scaled)
            out[lo:lo + len(pairs)] = torch.sqrt(
                torch.clamp(d, min=0.0)).mean(dim=-1)
    return out.reshape(S1, S2).cpu().numpy()


def coverage(dists: np.ndarray) -> float:
    """COV: fraction of refs matched as some gen's nearest ref."""
    dists = np.asarray(dists)
    return float(len(np.unique(dists.argmin(axis=1)))) / dists.shape[1]


def mmd(dists: np.ndarray) -> float:
    """MMD: mean over refs of their closest gen."""
    return float(np.asarray(dists).min(axis=0).mean())


def per_class_metrics(dists: np.ndarray, labels: np.ndarray,
                      n_classes: int) -> dict:
    """A pooled gen-by-ref distance matrix sliced by reference class:
    per class, MMD-CD, COV-CD (refs of the class matched under the pooled
    nearest-ref assignment), COV-CD-within (each gen's nearest ref inside
    the class) and gen_share (share of gens whose pooled nearest ref is of
    the class). A class with no references gets NaN for the first three
    (the JAX function divides by zero there) and gen_share 0."""
    dists = np.asarray(dists)
    labels = np.asarray(labels)
    nearest_ref = dists.argmin(axis=1)
    out = {}
    for c in range(n_classes):
        cols = np.flatnonzero(labels == c)
        share = float(np.isin(nearest_ref, cols).mean())
        if len(cols) == 0:
            out[f"class{c}"] = {"MMD-CD": float("nan"),
                                "COV-CD": float("nan"),
                                "COV-CD-within": float("nan"),
                                "gen_share": share}
            continue
        matched = np.unique(nearest_ref[np.isin(nearest_ref, cols)])
        out[f"class{c}"] = {
            "MMD-CD": mmd(dists[:, cols]),
            "COV-CD": float(len(matched) / len(cols)),
            "COV-CD-within": coverage(dists[:, cols]),
            "gen_share": share,
        }
    return out


def knn_two_sample(mxx: np.ndarray, mxy: np.ndarray, myy: np.ndarray,
                   k: int = 1) -> float:
    """1-NN two-sample accuracy; 0.5 is ideal."""
    mxx, mxy, myy = map(np.asarray, (mxx, mxy, myy))
    n0, n1 = mxx.shape[0], myy.shape[0]
    label = np.concatenate([-np.ones(n0), np.ones(n1)])
    m = np.block([[mxx, mxy], [mxy.T, myy]])
    np.fill_diagonal(m, np.inf)
    nn_idx = np.argsort(m, axis=0)[:k]                 # k smallest per column
    count = label[nn_idx].sum(axis=0)
    pred = np.where(count >= 0, 1.0, -1.0)
    return float((pred == label).mean())


def jsd(clouds1, clouds2, res: int = 28, warn: bool = True) -> float:
    """Jensen-Shannon divergence, in bits, between the voxel occupancy
    distributions of two sets of clouds inside the [-0.5, 0.5] cube;
    points outside are dropped (with a warning)."""
    p, q = (_tensor(c) for c in (clouds1, clouds2))
    for name, c in (("clouds1", p), ("clouds2", q)):
        if warn and bool((c.abs() > 0.5).any()):
            warnings.warn(f"JSD: {name} has points outside [-0.5, 0.5]; "
                          "they are excluded from the occupancy histogram")
    p = voxel_occupancy(p, res=res).cpu().numpy().astype(np.float64)
    q = voxel_occupancy(q, res=res).cpu().numpy().astype(np.float64)
    p, q = p / max(p.sum(), 1), q / max(q.sum(), 1)

    def entropy(d):
        nz = d[d > 0]
        return float(-(nz * np.log2(nz)).sum())

    m = 0.5 * (p + q)
    return entropy(m) - 0.5 * (entropy(p) + entropy(q))


def f_score(pred, gt, threshold: float = 0.001) -> np.ndarray:
    """F-score per cloud at a squared-distance threshold: [B]."""
    pred = _tensor(pred)
    gt = _tensor(gt, pred.device)
    with torch.no_grad():
        d = pairwise_sqdist(pred, gt)
        ld = d.amin(dim=-1)
        rd = d.amin(dim=-2)
        precision = 100.0 * (rd < threshold).float().mean(dim=1)
        recall = 100.0 * (ld < threshold).float().mean(dim=1)
        f = 2 * precision * recall / (precision + recall + 1e-7)
    return f.cpu().numpy()


def compute_all_metrics(sample_pcs, ref_pcs, normalize: bool = False,
                        use_emd: bool = False, emd_eps: float = 0.002,
                        emd_iters: int = 10000, mesh=None,
                        jsd_scale: float = 0.5,
                        device=None) -> Dict[str, float]:
    """The reference evaluation protocol: JSD, COV-CD, MMD-CD and 1NN-CD,
    and with `use_emd` COV-EMD, MMD-EMD and 1NN-EMD at the reference's
    test regime (eps 0.002, 10000 iterations; fewer underestimate EMD).
    `normalize` centers and scales each generated cloud to radius 1.
    `jsd_scale` scales both sets before the voxel histogram, which covers
    [-0.5, 0.5]; the scale is recorded in the output. Runs on `device`
    (default cuda; raises without a GPU)."""
    from sp_gan_tpu_torch.manipulate import normalize_point_cloud

    if mesh is not None:
        raise NotImplementedError("the point-sharded EMD (mesh=, "
                                  "--mesh_points) is not ported")
    dev = resolve_device(device)
    gen = _tensor(sample_pcs, dev)
    ref = _tensor(ref_pcs, dev)
    if normalize:
        gen = normalize_point_cloud(gen)

    gg = pairwise_cd_matrix(gen, gen)
    tt = pairwise_cd_matrix(ref, ref)
    gt = pairwise_cd_matrix(gen, ref)
    out = {
        "JSD": jsd(jsd_scale * gen, jsd_scale * ref,
                   warn=(jsd_scale == 1.0)),
        "jsd_scale": jsd_scale,
        "COV-CD": coverage(gt),
        "MMD-CD": mmd(gt),
        "1NN-CD": knn_two_sample(gg, gt, tt, 1),
    }
    if use_emd:
        gg_e = pairwise_emd_matrix(gen, gen, emd_eps, emd_iters)
        tt_e = pairwise_emd_matrix(ref, ref, emd_eps, emd_iters)
        gt_e = pairwise_emd_matrix(gen, ref, emd_eps, emd_iters)
        out.update({
            "COV-EMD": coverage(gt_e),
            "MMD-EMD": mmd(gt_e),
            "1NN-EMD": knn_two_sample(gg_e, gt_e, tt_e, 1),
        })
    return out
