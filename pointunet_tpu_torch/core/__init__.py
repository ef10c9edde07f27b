from .config import (
    MeshConfig,
    PointSegConfig,
    SaliencyConfig,
    TrainConfig,
    brats_pointseg_config,
    brats_saliency_config,
    pancreas_pointseg_config,
    pancreas_saliency_config,
)

__all__ = [
    "MeshConfig",
    "PointSegConfig",
    "SaliencyConfig",
    "TrainConfig",
    "brats_pointseg_config",
    "brats_saliency_config",
    "pancreas_pointseg_config",
    "pancreas_saliency_config",
]
