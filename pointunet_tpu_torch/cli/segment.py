"""Model construction for the fused (``--fast``) path (``pointunet_tpu/cli/segment.py``).

Only ``build_pipeline`` of the BraTS fast path is ported so far: the
models the serving path runs, randomly initialised from seed 0, as the
reference does when it is given no checkpoint. Loading trained
checkpoints waits until the port has checkpoint I/O.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import (
    PointSegConfig,
    SaliencyConfig,
    brats_pointseg_config,
    brats_saliency_config,
)
from ..models.randlanet import RandLANet, init_randlanet
from ..models.saliency_unet import SaliencyUNet, init_saliency_unet


class Pipeline(NamedTuple):
    saliency_model: SaliencyUNet
    pointseg_model: RandLANet
    scfg: SaliencyConfig
    pcfg: PointSegConfig


def build_pipeline(n_point: int) -> Pipeline:
    """BraTS configs and models of the fast path: the bf16 saliency net
    with its spatial-attention gate at stride 2, and the point net at
    ``n_point`` points, whose dtype is auto (bf16 on CUDA, f32 on the
    CPU)."""
    scfg = brats_saliency_config(use_bfloat16=True, sa_gate_stride=2)
    pcfg = brats_pointseg_config(num_points=n_point)
    gen = torch.Generator().manual_seed(0)
    return Pipeline(
        init_saliency_unet(scfg, gen), init_randlanet(pcfg, gen), scfg, pcfg
    )
