"""Device ops of the port (``pointunet_tpu/ops``): the reference's public
names. The kernels' wrappers (``knn_cuda``, ``scatter_sorted``,
``conv_cuda``, ``scatter_window``) are submodules; nothing is built or
loaded on import."""
from .knn import knn, knn_batch, knn_with_distances
from .knn_grid import knn_grid
from .knn_window import knn_cell_window
from .sampling import DeviceCloud, sample_cloud_device
from .gather import (
    gather_neighbour,
    max_pool_neighbours,
    nearest_interpolation,
    relative_pos_encoding,
)
from .pyramid import Pyramid, build_pyramid, build_pyramid_batch
from .pyramid_sharded import build_pyramid_sharded
from .subsample import grid_subsample, grid_subsample_fixed, grid_subsample_numpy
from .scatter import scatter_labels_to_volume, scatter_probs_to_volume

__all__ = [
    "knn",
    "knn_batch",
    "knn_with_distances",
    "knn_grid",
    "knn_cell_window",
    "DeviceCloud",
    "sample_cloud_device",
    "gather_neighbour",
    "max_pool_neighbours",
    "nearest_interpolation",
    "relative_pos_encoding",
    "Pyramid",
    "build_pyramid",
    "build_pyramid_batch",
    "build_pyramid_sharded",
    "grid_subsample",
    "grid_subsample_fixed",
    "grid_subsample_numpy",
    "scatter_labels_to_volume",
    "scatter_probs_to_volume",
]
