"""Host-side volume I/O (``pointunet_tpu/data``): numpy only."""
from . import nifti
from .ply import read_ply, write_ply
from .pointcloud import (
    PointCloud,
    context_aware_sample,
    sample_cloud,
    volume_to_points,
)
from .volume import (
    crop_brain_region,
    extract_roi,
    insert_roi,
    intensity_normalize_full,
    intensity_normalize_nonzero,
    nonzero_bbox,
    rescale_pancreas_hu,
)

__all__ = [
    "nifti",
    "read_ply",
    "write_ply",
    "PointCloud",
    "context_aware_sample",
    "sample_cloud",
    "volume_to_points",
    "crop_brain_region",
    "extract_roi",
    "insert_roi",
    "intensity_normalize_full",
    "intensity_normalize_nonzero",
    "nonzero_bbox",
    "rescale_pancreas_hu",
]
