"""Configuration dataclasses for the port.

A jax-free copy of ``pointunet_tpu/core/config.py``: importing the
reference's ``pointunet_tpu.core`` pulls in its checkpoint module (orbax,
jax), which a machine running only the port does not have. The fields and
defaults are the reference's, field for field (tests/test_torch_serve.py
holds them equal), except that ``TrainConfig`` has no ``mesh``: nothing of
the reference reads that field (its trainers take a mesh argument), and
the port's ``PointSegTrainer`` takes ``mesh=`` as the reference's does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class PointSegConfig:
    """RandLA-Net point-segmentation config (defaults: BraTS)."""

    name: str = "BraTS20"
    k_n: int = 16                      # KNN neighbours
    num_layers: int = 5                # encoder/decoder depth
    num_points: int = 365_000          # fixed point budget per cloud
    num_classes: int = 4
    num_features: int = 4              # intensity channels (t1ce,t1,flair,t2)
    sub_grid_size: float = 0.01        # offline grid-subsample cell size
    batch_size: int = 1
    val_batch_size: int = 1
    train_steps: int = 295             # steps per epoch
    val_steps: int = 74
    sub_sampling_ratio: Tuple[int, ...] = (4, 4, 4, 4, 2)
    d_out: Tuple[int, ...] = (16, 64, 128, 256, 512)   # per-layer feature dims
    learning_rate: float = 1e-4
    lr_decay: float = 0.95             # per-epoch multiplicative decay
    max_epoch: int = 100
    dropout_rate: float = 0.5
    bn_momentum: float = 0.99
    ignored_label_inds: Tuple[int, ...] = ()
    class_counts: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    # dtype policy: None = auto, which in the port means bf16 when the
    # tensors are on CUDA and f32 on the CPU. True/False force the dtype.
    use_bfloat16: Optional[bool] = None

    @property
    def level_sizes(self) -> Tuple[int, ...]:
        """Point counts entering each encoder level, plus the bottleneck size."""
        sizes = [self.num_points]
        for r in self.sub_sampling_ratio:
            sizes.append(sizes[-1] // r)
        return tuple(sizes)

    def class_weights(self) -> Tuple[float, ...]:
        total = float(sum(self.class_counts))
        return tuple(1.0 / (c / total + 0.02) for c in self.class_counts)


def brats_pointseg_config(**overrides) -> PointSegConfig:
    return dataclasses.replace(PointSegConfig(), **overrides)


def block64_pointseg_config(**overrides) -> PointSegConfig:
    """BraTS_Block64: clouds of 64^3 blocks with their class counts."""
    base = PointSegConfig(
        name="BraTS_Block64",
        num_points=180_000,
        class_counts=(1403.0, 22.0, 80.0, 11.0),
    )
    return dataclasses.replace(base, **overrides)


def pancreas_pointseg_config(**overrides) -> PointSegConfig:
    base = PointSegConfig(
        name="Pancreas",
        num_points=180_000,
        num_classes=2,
        num_features=1,          # single CT intensity channel
        learning_rate=1e-3,
        class_counts=(1.0, 1.0),
    )
    return dataclasses.replace(base, **overrides)


@dataclass(frozen=True)
class SaliencyConfig:
    """3D attention U-Net config."""

    num_class: int = 2
    in_channels: int = 1               # 4 for BraTS (modalities), 1 for Pancreas
    depth: int = 5
    base_filter: int = 16
    filter_grow: bool = True
    residual: bool = True
    deep_supervision: bool = True      # used by the plain unet3d variant
    instance_norm: bool = True
    ca_attention: bool = True
    sa_attention: bool = True
    # spatial-attention gate resolution divisor: 1 runs the gate convs at
    # full resolution, 2 on a 2x-avg-pooled input with the 1-channel gate
    # resized back (the inference default); parameters are identical
    sa_gate_stride: int = 1
    patch_size: Tuple[int, int, int] = (64, 160, 160)
    inference_patch_size: Tuple[int, int, int] = (64, 160, 160)
    batch_size: int = 2
    base_lr: float = 0.01
    steps_per_epoch: int = 250
    max_epoch: int = 200
    eval_epoch: int = 10
    data_sampling: str = "one_positive"  # random | one_positive | all_positive
    mixup: bool = False
    intensity_norm: str = "modality"
    multi_view: bool = False
    direction: str = "axial"             # axial | sagittal | coronal
    test_flip: bool = False
    advance_postprocessing: bool = False
    xstep: int = 48
    ystep: int = 118
    zstep: int = 118
    weight_decay: float = 1e-5
    # bf16 conv compute with f32 parameters and normalisation statistics
    use_bfloat16: bool = False
    remat: bool = True
    lr_schedule: Tuple[Tuple[int, float], ...] = (
        (20, 0.001), (70, 0.0005), (110, 0.0001), (150, 5e-5), (280, 1e-5),
    )


def brats_saliency_config(**overrides) -> SaliencyConfig:
    return dataclasses.replace(
        SaliencyConfig(num_class=2, in_channels=4), **overrides
    )


def pancreas_saliency_config(**overrides) -> SaliencyConfig:
    return dataclasses.replace(
        SaliencyConfig(num_class=2, in_channels=1), **overrides
    )


@dataclass(frozen=True)
class MeshConfig:
    """Layout of the (data, point) mesh of ``parallel/mesh.py``.

    data: data parallelism over volumes/clouds (batch axis).
    point: ranks that share one cloud's pyramid searches (each takes a
           slab of the query rows of the large levels).
    """

    data: int = 1
    point: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.point


@dataclass(frozen=True)
class TrainConfig:
    """Shared training-loop knobs: the reference's, without ``mesh``
    (nothing in the reference reads ``TrainConfig.mesh``: its trainer
    takes the mesh as an argument, and so does the port's) and
    ``donate_state`` (the trainer mutates its state in place)."""

    seed: int = 0
    log_every: int = 10
    checkpoint_dir: str = "model_logs"
    max_to_keep: int = 100
    debug_nans: bool = False
    profile_dir: str = ""
    # background host prefetch depth for batch iterators; 0 disables
    prefetch_buffers: int = 4
