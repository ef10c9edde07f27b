from .end2end import PointUnetPipeline
from .postprocess import fill_holes, largest_components, postprocess_brats

__all__ = [
    "PointUnetPipeline",
    "fill_holes",
    "largest_components",
    "postprocess_brats",
]
