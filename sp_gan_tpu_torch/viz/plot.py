"""Point-cloud figures, the port of `sp_gan_tpu/viz/plot.py`: matplotlib
grids of clouds from three viewpoints (`plot_grid`, `plot_three_views`,
`plot_three_views_color`) and a numpy z-buffer splat renderer
(`draw_point_cloud`, `point_cloud_three_views`).

matplotlib is imported (with the Agg backend) inside the functions that
draw with it, so the module imports without it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


_VIEWS = ((30, -45), (30, 45), (30, 90))  # elev, azim triples


def _scatter(ax, pc, color=None, cmap="Reds", size=3.0, lims=0.5):
    ax.view_init(*_VIEWS[0])
    if color is None:
        color = pc[:, 0]
    ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], c=color, s=size, cmap=cmap,
               vmin=-1.0, vmax=0.6 if np.ndim(color) == 1 else None)
    for setter in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
        setter(-lims, lims)
    ax.set_axis_off()


def plot_grid(path: str, rows: Sequence[np.ndarray],
              titles: Optional[Sequence[Sequence[str]]] = None,
              cmap: str = "Reds", size: float = 3.0):
    """rows: list of [ncols, N, 3] arrays -> one figure, one row each."""
    plt = _pyplot()
    nrows, ncols = len(rows), rows[0].shape[0]
    fig = plt.figure(figsize=(ncols * 2, nrows * 2))
    for i, row in enumerate(rows):
        for j in range(ncols):
            ax = fig.add_subplot(nrows, ncols, i * ncols + j + 1,
                                 projection="3d")
            _scatter(ax, row[j], cmap=cmap, size=size)
            if titles is not None:
                ax.set_title(titles[i][j], fontsize=8)
    fig.subplots_adjust(left=0, right=1, bottom=0, top=0.95,
                        wspace=0, hspace=0.05)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_three_views(path: str, pcds: Sequence[np.ndarray],
                     titles: Optional[Sequence[str]] = None,
                     cmap: str = "Reds", size: float = 3.0):
    """Each cloud rendered from 3 viewpoints: rows = views, cols = clouds."""
    plt = _pyplot()
    n = len(pcds)
    fig = plt.figure(figsize=(n * 2, len(_VIEWS) * 2))
    for vi, (elev, azim) in enumerate(_VIEWS):
        for ci, pc in enumerate(pcds):
            ax = fig.add_subplot(len(_VIEWS), n, vi * n + ci + 1,
                                 projection="3d")
            ax.view_init(elev, azim)
            ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], c=pc[:, 0], s=size,
                       cmap=cmap)
            for setter in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
                setter(-0.5, 0.5)
            ax.set_axis_off()
            if vi == 0 and titles is not None:
                ax.set_title(titles[ci], fontsize=8)
    fig.subplots_adjust(left=0, right=1, bottom=0, top=0.95, wspace=0, hspace=0)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_three_views_color(path: str, pcds: Sequence[np.ndarray],
                           titles: Optional[Sequence[str]] = None,
                           colors: Optional[Sequence[np.ndarray]] = None,
                           size: float = 3.0):
    """RGB-per-point variant (sphere-correspondence coloring,
    visu_utils.py:287; colors in [0,1]^3 per point)."""
    plt = _pyplot()
    n = len(pcds)
    fig = plt.figure(figsize=(n * 2, len(_VIEWS) * 2))
    for vi, (elev, azim) in enumerate(_VIEWS):
        for ci, pc in enumerate(pcds):
            ax = fig.add_subplot(len(_VIEWS), n, vi * n + ci + 1,
                                 projection="3d")
            ax.view_init(elev, azim)
            c = None if colors is None else np.clip(colors[ci], 0, 1)
            ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], c=c, s=size)
            for setter in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
                setter(-0.5, 0.5)
            ax.set_axis_off()
            if vi == 0 and titles is not None:
                ax.set_title(titles[ci], fontsize=8)
    fig.subplots_adjust(left=0, right=1, bottom=0, top=0.95, wspace=0, hspace=0)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def draw_point_cloud(points: np.ndarray, canvas_size: int = 500,
                     space: float = 200.0, diameter: int = 25,
                     xrot: float = 0.0, yrot: float = 0.0, zrot: float = 0.0,
                     normalize: bool = True) -> np.ndarray:
    """Software splat renderer: points -> grayscale image [canvas, canvas].

    Same contract as visu_utils.draw_point_cloud (:316): rotate, z-sort,
    splat gaussian disks scaled by depth.
    """
    image = np.zeros((canvas_size, canvas_size))
    if points is None or len(points) == 0:
        return image
    pts = points.copy()
    if normalize:
        pts = pts - pts.mean(axis=0)
        pts /= (np.max(np.linalg.norm(pts, axis=1)) + 1e-9)

    for ang, axes in ((zrot, (0, 1)), (yrot, (0, 2)), (xrot, (1, 2))):
        if ang:
            c, s = np.cos(ang), np.sin(ang)
            a, b = axes
            ra, rb = pts[:, a] * c - pts[:, b] * s, pts[:, a] * s + pts[:, b] * c
            pts[:, a], pts[:, b] = ra, rb

    order = np.argsort(pts[:, 2])          # back to front
    pts = pts[order]

    r = diameter // 2
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    disk = np.exp(-(xx ** 2 + yy ** 2) / (r ** 2 / 4.0))
    disk[xx ** 2 + yy ** 2 > r ** 2] = 0

    half = canvas_size // 2
    px = (pts[:, 0] * space + half).astype(int)
    py = (pts[:, 1] * space + half).astype(int)
    depth = (pts[:, 2] - pts[:, 2].min()) / (np.ptp(pts[:, 2]) + 1e-9)
    for i in range(len(pts)):
        x0, y0 = px[i] - r, py[i] - r
        if x0 < 0 or y0 < 0 or x0 + disk.shape[0] > canvas_size \
                or y0 + disk.shape[1] > canvas_size:
            continue
        image[y0:y0 + disk.shape[0], x0:x0 + disk.shape[1]] = np.maximum(
            image[y0:y0 + disk.shape[0], x0:x0 + disk.shape[1]],
            disk * (0.3 + 0.7 * depth[i]))
    m = image.max()
    return image / m if m > 0 else image


def point_cloud_three_views(points: np.ndarray) -> np.ndarray:
    """Three rotated renders side by side (visu_utils.py:390)."""
    views = [
        draw_point_cloud(points, xrot=110 / 180 * np.pi, yrot=0,
                         zrot=135 / 180 * np.pi),
        draw_point_cloud(points, xrot=70 / 180 * np.pi, yrot=0,
                         zrot=135 / 180 * np.pi),
        draw_point_cloud(points, xrot=180 / 180 * np.pi, yrot=0,
                         zrot=90 / 180 * np.pi),
    ]
    return np.concatenate(views, axis=1)
