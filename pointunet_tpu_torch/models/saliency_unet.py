"""Saliency-attention 3-D U-Net (``pointunet_tpu/models/saliency_unet.py``).

* ``SaliencyUNet``, the attention variant: residual encoder with filter
  growth, CFE atrous context blocks (rates 3/5/7) on the three deepest
  scales, channel attention on the fused high-level features and a
  spatial attention gate on the low-level ones;
* ``UNet3D``, the plain variant with deep supervision.

Both run channels-first: input (B, C, D, H, W), logits (B, num_class, D,
H, W) in f32. With ``config.remat`` and the model in train mode, the
blocks the reference wraps in ``nn.remat`` (every ConvNormRelu,
UNetBlock, CFE3D, UpsampleConv and SpatialAttention3D call) run under
``torch.utils.checkpoint`` when autograd records: their activations are
recomputed in the backward instead of kept (a batch norm's running
statistics are updated by the forward only). The wrapping happens in
``forward``, so parameter names are the same either way.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import trace
from ..core.config import SaliencyConfig
from .attention3d import ChannelWiseAttention3D, SpatialAttention3D
from .fastconv import Conv, _nearest_upsample
from .naming import FlaxNamed
from .norms import NormRelu, running_stats_frozen


def _avg_pool(x: torch.Tensor, s: int) -> torch.Tensor:
    """s^3 VALID average pool of (B, C, D, H, W) as a reshape-mean, which
    every backend runs in bf16 (CPU has no bf16 avg_pool3d)."""
    b, c, d, h, w = x.shape
    d, h, w = d // s, h // s, w // s
    x = x[:, :, :d * s, :h * s, :w * s]
    return x.reshape(b, c, d, s, h, s, w, s).mean(dim=(3, 5, 7))


def strided_gate(sa: nn.Module, x: torch.Tensor, stride: int,
                 run) -> torch.Tensor:
    """The spatial attention gate at ``stride`` > 1: ``run(sa, .)`` (the
    gate's convs, broadcast off) on the stride^3-pooled input, its
    1-channel gate resized back to x's (D, H, W) trilinearly."""
    gate = run(sa, _avg_pool(x, stride))
    return F.interpolate(gate, size=x.shape[2:], mode="trilinear",
                         align_corners=False)


def _remat(enable: bool, module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module(x)``; with ``enable`` and autograd recording, its
    activations are recomputed in the backward (``checkpoint``)."""
    if enable and torch.is_grad_enabled():
        return checkpoint(module, x, use_reentrant=False,
                          context_fn=_recompute_context)
    return module(x)


def _recompute_context():
    """``checkpoint``'s contexts: none for the forward, frozen batch-norm
    running statistics for the recomputation."""
    return contextlib.nullcontext(), running_stats_frozen()


class ConvNormRelu(FlaxNamed):
    def __init__(
        self,
        in_features: int,
        features: int,
        kernel=(3, 3, 3),
        strides=(1, 1, 1),
        dilation=(1, 1, 1),
        instance_norm: bool = True,
        dtype: Optional[torch.dtype] = None,
        use_bias: bool = True,
        upsample: int = 1,
    ):
        super().__init__()
        self.child("Conv", Conv(
            in_features, features, kernel, strides=strides,
            kernel_dilation=dilation, upsample=upsample, use_bias=use_bias,
            dtype=dtype,
        ), "conv")
        self.child("NormRelu", NormRelu(features, instance_norm), "norm")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class UNetBlock(FlaxNamed):
    """Two 3x3x3 convs with optional residual add."""

    def __init__(self, in_features, features, residual=True,
                 instance_norm=True, dtype=None):
        super().__init__()
        self.residual = residual
        self.convs = [
            self.child("ConvNormRelu", ConvNormRelu(
                cin, features, instance_norm=instance_norm, dtype=dtype,
            ))
            for cin in (in_features, features)
        ]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for conv in self.convs:
            h = conv(h)
        return x + h if self.residual else h


class CFE3D(FlaxNamed):
    """Context feature extraction: 1x1 conv + three atrous 3x3x3 convs
    (rates 3, 5, 7), concatenated: 4 * features channels."""

    def __init__(self, in_features, features=32, instance_norm=True,
                 dtype=None):
        super().__init__()
        self.branches = [self.child("ConvNormRelu", ConvNormRelu(
            in_features, features, kernel=(1, 1, 1), use_bias=False,
            instance_norm=instance_norm, dtype=dtype,
        ))]
        for rate in (3, 5, 7):
            self.branches.append(self.child("ConvNormRelu", ConvNormRelu(
                in_features, features, dilation=(rate,) * 3, use_bias=False,
                instance_norm=instance_norm, dtype=dtype,
            )))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([b(x) for b in self.branches], dim=1)


class UpsampleConv(FlaxNamed):
    """Nearest upsample + 3x3x3 conv."""

    def __init__(self, in_features, scale, features, instance_norm=True,
                 dtype=None):
        super().__init__()
        self.child("ConvNormRelu", ConvNormRelu(
            in_features, features, upsample=scale,
            instance_norm=instance_norm, dtype=dtype,
        ), "cnr")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cnr(x)


class _Encoder(FlaxNamed):
    """Init conv + depth x (block, strided downsample); returns the
    per-scale features and their channel counts."""

    def __init__(self, config: SaliencyConfig):
        super().__init__()
        cfg = self.config = config
        inorm = cfg.instance_norm
        dt = torch.bfloat16 if cfg.use_bfloat16 else None
        self.child("ConvNormRelu", ConvNormRelu(
            cfg.in_channels, cfg.base_filter, instance_norm=inorm, dtype=dt,
        ), "init")
        ch = cfg.base_filter
        self.stages = []
        self.channels = []
        for d in range(cfg.depth):
            filters = (
                cfg.base_filter * (2 ** d) if cfg.filter_grow
                else cfg.base_filter
            )
            # (names count per class, so creating the 1x1 match before the
            # block leaves both names as the reference assigns them)
            match = None
            if cfg.residual and ch != filters:
                match = self.child("ConvNormRelu", ConvNormRelu(
                    ch, filters, kernel=(1, 1, 1), instance_norm=inorm,
                    dtype=dt,
                ))
                ch = filters
            block = self.child("UNetBlock", UNetBlock(
                ch, filters, residual=cfg.residual,
                instance_norm=inorm, dtype=dt,
            ))
            self.channels.append(filters)
            down = None
            if d != cfg.depth - 1:
                down = self.child("ConvNormRelu", ConvNormRelu(
                    filters, filters * 2, strides=(2, 2, 2),
                    instance_norm=inorm, dtype=dt,
                ))
                ch = filters * 2
            self.stages.append((match, block, down))

    def forward(self, x: torch.Tensor):
        remat = self.config.remat and self.training
        with trace.annotate("saliency.encoder.init"):
            x = _remat(remat, self.init, x)
        down = []
        for i, (match, block, strided) in enumerate(self.stages):
            with trace.annotate(f"saliency.encoder.block{i}"):
                if match is not None:
                    x = _remat(remat, match, x)
                x = _remat(remat, block, x)
            down.append(x)
            if strided is not None:
                with trace.annotate(f"saliency.encoder.down{i}"):
                    x = _remat(remat, strided, x)
        return down


class SaliencyUNet(FlaxNamed):
    """unet3d_attention: (B, C, D, H, W) -> (B, num_class, D, H, W) f32."""

    def __init__(self, config: SaliencyConfig):
        super().__init__()
        cfg = self.config = config
        inorm = cfg.instance_norm
        dt = torch.bfloat16 if cfg.use_bfloat16 else None
        self.child("_Encoder", _Encoder(cfg), "encoder")
        ch = self.encoder.channels

        def cnr(alias, cin, cout, **kw):
            self.child("ConvNormRelu", ConvNormRelu(
                cin, cout, instance_norm=inorm, dtype=dt, **kw
            ), alias)

        def up(alias, cin, scale, cout):
            self.child("UpsampleConv", UpsampleConv(
                cin, scale, cout, inorm, dt
            ), alias)

        # creation order fixes the flax names (ConvNormRelu_0 .. _3, ...)
        cnr("c1", ch[0], 64)
        cnr("c2", ch[1], 64)
        self.cfe = [
            self.child("CFE3D", CFE3D(c, 32, inorm, dt)) for c in ch[2:5]
        ]
        up("up_c5", 128, 4, 128)
        up("up_c4", 128, 2, 128)
        self.ca = self.sa = None
        if cfg.ca_attention:
            self.child(
                "ChannelWiseAttention3D", ChannelWiseAttention3D(384), "ca"
            )
        cnr("c345", 384, 64, kernel=(1, 1, 1))
        up("up_c345", 64, 4, 64)
        if cfg.sa_attention:
            self.child("SpatialAttention3D", SpatialAttention3D(
                64, inorm, dtype=dt, broadcast=cfg.sa_gate_stride == 1,
            ), "sa")
        up("up_c2", 64, 2, 64)
        cnr("c12", 128, 64)
        self.child("Conv", Conv(128, cfg.num_class, 3, dtype=dt), "head")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """While a profiler runs, each child module's call is a range
        ``saliency.<name>`` (``core.trace.annotate``; the encoder's stages
        ``saliency.encoder.<part>``), which places its kernels."""
        cfg = self.config
        remat = cfg.remat and self.training

        def run(module, h, name=None):
            if name is None:
                return _remat(remat, module, h)
            with trace.annotate(f"saliency.{name}"):
                return _remat(remat, module, h)

        with trace.annotate("saliency.encoder"):
            down = self.encoder(x)
        c1 = run(self.c1, down[0], "c1")
        c2 = run(self.c2, down[1], "c2")
        c3, c4, c5 = (run(cfe, d, f"cfe_c{i}")
                      for i, (cfe, d) in enumerate(zip(self.cfe, down[2:5]), 3))
        c5 = run(self.up_c5, c5, "up_c5")
        c4 = run(self.up_c4, c4, "up_c4")
        c345 = torch.cat([c3, c4, c5], dim=1)
        if self.ca is not None:
            with trace.annotate("saliency.ca"):
                c345 = self.ca(c345)
        c345 = run(self.up_c345, run(self.c345, c345, "c345"), "up_c345")

        if self.sa is not None:
            s = cfg.sa_gate_stride
            with trace.annotate("saliency.sa"):
                if s > 1:
                    # (broadcasts over C in the multiply below)
                    sa = strided_gate(self.sa, c345, s, run)
                else:
                    sa = run(self.sa, c345)

        c2 = run(self.up_c2, c2, "up_c2")
        c12 = run(self.c12, torch.cat([c1, c2], dim=1), "c12")
        if self.sa is not None:
            c12 = sa.to(c12.dtype) * c12
        fea = torch.cat([c12, c345], dim=1)
        with trace.annotate("saliency.head"):
            return self.head(fea).float()


class UNet3D(FlaxNamed):
    """unet3d with deep supervision: (B, C, D, H, W) -> (B, num_class, D,
    H, W) f32. The decoder upsamples, concatenates the encoder's feature
    of the same scale and runs a 3x3x3 and a 1x1x1 ConvNormRelu; scales 1
    and 2 of a depth-5 net add a 1x1x1 class prediction, summed and
    upsampled on the way to full resolution."""

    def __init__(self, config: SaliencyConfig):
        super().__init__()
        cfg = self.config = config
        inorm = cfg.instance_norm
        dt = torch.bfloat16 if cfg.use_bfloat16 else None
        self.child("_Encoder", _Encoder(cfg), "encoder")
        filters = self.encoder.channels
        self.stages = []
        for d in range(cfg.depth - 2, -1, -1):
            f = filters[d]
            up = self.child("UpsampleConv", UpsampleConv(
                filters[d + 1], 2, f, inorm, dt
            ))
            conv = self.child("ConvNormRelu", ConvNormRelu(
                2 * f, f, instance_norm=inorm, dtype=dt
            ))
            proj = self.child("ConvNormRelu", ConvNormRelu(
                f, f, kernel=(1, 1, 1), instance_norm=inorm, dtype=dt
            ))
            pred = None
            if cfg.deep_supervision and 0 < d < 3:
                pred = self.child("Conv", Conv(f, cfg.num_class, 1, dtype=dt))
            self.stages.append((up, conv, proj, pred))
        self.child("Conv", Conv(filters[0], cfg.num_class, 1, dtype=dt), "head")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.config.remat and self.training
        down = self.encoder(x)
        layer = down[-1]
        deep = None
        for (up, conv, proj, pred), skip in zip(self.stages, down[-2::-1]):
            layer = torch.cat([_remat(remat, up, layer), skip], dim=1)
            layer = _remat(remat, proj, _remat(remat, conv, layer))
            if pred is not None:
                p = pred(layer)
                deep = _nearest_upsample(p if deep is None else deep + p, 2)
        logits = self.head(layer)
        if deep is not None:
            logits = logits + deep
        return logits.float()


def _glorot_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``glorot_uniform`` on a torch-layout weight: Linear (out, in) or
    Conv3d (out, in, *k)."""
    rf = math.prod(w.shape[2:]) if w.ndim > 2 else 1
    fan_out, fan_in = w.shape[0] * rf, w.shape[1] * rf
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)


def init_saliency_unet(
    config: SaliencyConfig, generator: torch.Generator,
    attention: bool = True,
) -> nn.Module:
    """A ``SaliencyUNet`` (``attention``) or ``UNet3D`` with the
    reference's initialisation drawn from ``generator`` (CPU):
    glorot-uniform convs and dense layers, zero biases, unit/zero norm
    affines. In eval mode."""
    model = (SaliencyUNet if attention else UNet3D)(config)
    for m in model.modules():
        if isinstance(m, (Conv, nn.Linear)):
            _glorot_uniform_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return model.eval()
