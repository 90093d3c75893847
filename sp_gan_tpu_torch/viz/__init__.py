"""Point-cloud figures and file IO, the port of `sp_gan_tpu/viz`."""

from sp_gan_tpu_torch.viz.io import (load_pcd, load_ply, load_xyz, save_ply,
                                     save_xyz)
from sp_gan_tpu_torch.viz.plot import (draw_point_cloud, plot_grid,
                                       plot_three_views,
                                       plot_three_views_color,
                                       point_cloud_three_views)

__all__ = [
    "plot_grid", "plot_three_views", "plot_three_views_color",
    "point_cloud_three_views", "draw_point_cloud",
    "save_xyz", "load_xyz", "save_ply", "load_ply", "load_pcd",
]
