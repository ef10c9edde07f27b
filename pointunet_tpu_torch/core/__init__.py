from .config import (
    MeshConfig,
    PointSegConfig,
    SaliencyConfig,
    TrainConfig,
    block64_pointseg_config,
    brats_pointseg_config,
    brats_saliency_config,
    pancreas_pointseg_config,
    pancreas_saliency_config,
)
from .checkpoint import BestMetricCheckpointer
from .debug import StepTimer, enable_nan_trap, format_eta, profile_trace

__all__ = [
    "MeshConfig",
    "PointSegConfig",
    "SaliencyConfig",
    "TrainConfig",
    "block64_pointseg_config",
    "brats_pointseg_config",
    "brats_saliency_config",
    "pancreas_pointseg_config",
    "pancreas_saliency_config",
    "BestMetricCheckpointer",
    "StepTimer",
    "enable_nan_trap",
    "format_eta",
    "profile_trace",
]
