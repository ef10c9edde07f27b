"""RandLA-Net point segmentation network (``pointunet_tpu/models/randlanet.py``).

Features (B, N, C_in) and a batched ``Pyramid`` of per-level xyz /
neighbour / pool / up-sample indices in, logits (B, N, num_classes) f32
out. Every "1x1 conv" over points is a Linear; batch norm uses eps 1e-6
and ``cfg.bn_momentum``; activations are leaky_relu(0.2); the attentive
pooling's softmax runs over the K axis.

``model.train()`` selects the training forward: batch norm on batch
statistics (updating the running ones), dropout before the head with a
keep-mask drawn from the caller's ``torch.Generator``. While autograd is
on, every K-neighbour feature gather of the encoder (the two in each
``LocalFeatureAggregation`` and the pool gather) goes through
``ops.scatter_sorted.sorted_gather``, whose backward runs the sorted
scatter kernel (kernel 2) on the large levels; it needs the level-0
search grid, which is computed only then. The xyz gathers need no
gradient and the up-sample's gradient is ``index_add_``, as in the
reference.

dtype policy: ``use_bfloat16`` None means auto: bf16 when the features are
on CUDA, f32 on the CPU. In bf16 the layers compute in bf16 while xyz,
the relative-position encoding and the head's last Linear stay f32. The
reference's double-bf16 xyz gather table is a TPU gather workaround and is
not ported: the f32 xyz rows are gathered directly.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..core.config import PointSegConfig
from ..ops.gather import encode_neighbor_xyz, gather_neighbour
from ..ops.knn_window import _grid_resolution
from ..ops.pyramid import Pyramid
from ..ops.scatter_sorted import sorted_gather
from .naming import FlaxNamed
from .norms import BatchNorm


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M, K) -> (B, M, K, C)."""
    return torch.stack([gather_neighbour(t, i) for t, i in zip(table, idx)])


def _sorted_gather(table, idx, support_xyz, query_xyz, grid, query_sorted=True):
    """``_gather`` whose backward is the sorted scatter; the plain gather
    when ``grid`` (lo (B, 3), span (B, 3), r0, level) is None."""
    if grid is None:
        return _gather(table, idx)
    lo, span, r0, level = grid
    return torch.stack([
        sorted_gather(t, i, s, q, lo[b], span[b], r0, level, query_sorted)
        for b, (t, i, s, q) in enumerate(zip(table, idx, support_xyz, query_xyz))
    ])


def search_grid(xyz0: torch.Tensor):
    """The pyramid's level-0 search grid of (B, N, 3) level-0 points: (lo
    (B, 3), span (B, 3), r0), as ``build_pyramid`` computes it (min and
    max do not depend on the row order)."""
    lo = xyz0.amin(dim=1)
    span = torch.clamp(xyz0.amax(dim=1) - lo, min=1e-6)
    return lo, span, _grid_resolution(xyz0.shape[1], 1.8)


def _linear(layer: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    b = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), b)


class SharedMLP(FlaxNamed):
    """Linear + BatchNorm + leaky_relu(0.2) (``activation=False``: none)."""

    def __init__(self, in_features: int, features: int, momentum: float,
                 activation: bool = True):
        super().__init__()
        self.activation = activation
        self.child("Dense", nn.Linear(in_features, features), "dense")
        self.child("BatchNorm", BatchNorm(features, 1e-6, momentum), "bn")

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        x = self.bn(_linear(self.dense, x, dt))
        if self.activation:
            x = F.leaky_relu(x, 0.2)
        return x


class AttPooling(FlaxNamed):
    """Attentive pooling over K: softmax(W f) over K, weighted sum, MLP."""

    def __init__(self, d: int, d_out: int, momentum: float):
        super().__init__()
        self.child("Dense", nn.Linear(d, d, bias=False), "score")
        self.child("SharedMLP", SharedMLP(d, d_out, momentum), "mlp")

    def forward(self, feature_set: torch.Tensor, dt) -> torch.Tensor:
        # feature_set: (B, N, K, d)
        scores = torch.softmax(_linear(self.score, feature_set, dt), dim=-2)
        agg = (scores * feature_set).sum(dim=-2)            # (B, N, d)
        return self.mlp(agg, dt)


class LocalFeatureAggregation(FlaxNamed):
    """Two rounds of (spatial encoding, neighbour gather, attentive pool)."""

    def __init__(self, d_out: int, momentum: float):
        super().__init__()
        h = d_out // 2
        m = momentum
        self.child("SharedMLP", SharedMLP(10, h, m), "mlp1")
        self.child("AttPooling", AttPooling(2 * h, h, m), "pool1")
        self.child("SharedMLP", SharedMLP(h, h, m), "mlp2")
        self.child("AttPooling", AttPooling(2 * h, d_out, m), "pool2")

    def forward(self, xyz, feature, neigh_idx, grid, dt):
        # xyz (B, N, 3) f32; feature (B, N, d_out // 2); neigh_idx (B, N, K)
        neigh_xyz = _gather(xyz, neigh_idx)                 # (B, N, K, 3)
        f_neigh = _sorted_gather(feature, neigh_idx, xyz, xyz, grid)
        f_xyz = self.mlp1(encode_neighbor_xyz(xyz, neigh_xyz), dt)
        f_agg = self.pool1(torch.cat([f_neigh, f_xyz], dim=-1), dt)
        f_xyz = self.mlp2(f_xyz, dt)
        f_neigh = _sorted_gather(f_agg, neigh_idx, xyz, xyz, grid)
        return self.pool2(torch.cat([f_neigh, f_xyz], dim=-1), dt)


class DilatedResBlock(FlaxNamed):
    """mlp(d/2) -> LFA -> mlp(2d, linear) + shortcut(2d, linear) -> leaky."""

    def __init__(self, d_in: int, d_out: int, momentum: float):
        super().__init__()
        m = momentum
        self.child("SharedMLP", SharedMLP(d_in, d_out // 2, m), "mlp1")
        self.child(
            "LocalFeatureAggregation", LocalFeatureAggregation(d_out, m), "lfa"
        )
        self.child(
            "SharedMLP",
            SharedMLP(d_out, 2 * d_out, m, activation=False), "mlp2",
        )
        self.child(
            "SharedMLP",
            SharedMLP(d_in, 2 * d_out, m, activation=False),
            "shortcut",
        )

    def forward(self, xyz, feature, neigh_idx, grid, dt):
        f_pc = self.mlp1(feature, dt)
        f_pc = self.lfa(xyz, f_pc, neigh_idx, grid, dt)
        f_pc = self.mlp2(f_pc, dt)
        return F.leaky_relu(f_pc + self.shortcut(feature, dt), 0.2)


def _max_pool(feature, pool_idx, xyz, sub_xyz, grid) -> torch.Tensor:
    """(B, N, d), (B, M, K) -> (B, M, d): max over gathered neighbours.
    The kept points (queries) are stored in the next level's order, so
    the sorted backward re-sorts them (``query_sorted=False``)."""
    return _sorted_gather(
        feature, pool_idx, xyz, sub_xyz, grid, query_sorted=False
    ).amax(dim=-2)


def _interp(feature: torch.Tensor, interp_idx: torch.Tensor) -> torch.Tensor:
    """(B, M, d), (B, N, 1) -> (B, N, d): nearest-neighbour up-sample."""
    return _gather(feature, interp_idx)[:, :, 0]


class RandLANet(FlaxNamed):
    """Encoder-decoder over the decimation pyramid.

    ``data_group``: the process group of the ranks that hold the other
    rows of the batch (a mesh's data axis). Every ``BatchNorm`` then
    takes the statistics of the global batch, and the dropout mask is
    drawn for the global batch from the shared generator, of which this
    rank keeps its rows, so that a data-parallel step computes what one
    process computes on the whole batch."""

    def __init__(self, config: PointSegConfig, data_group=None):
        super().__init__()
        cfg = self.config = config
        self.data_group = data_group
        m = cfg.bn_momentum
        self.child("Dense", nn.Linear(3 + cfg.num_features, 8), "fc0")
        self.child("BatchNorm", BatchNorm(8, 1e-6, m), "bn0")
        d_in, skip_ch = 8, []
        self.encoder = []
        for i in range(cfg.num_layers):
            self.encoder.append(self.child(
                "DilatedResBlock", DilatedResBlock(d_in, cfg.d_out[i], m)
            ))
            d_in = 2 * cfg.d_out[i]
            if i == 0:
                skip_ch.append(d_in)
            skip_ch.append(d_in)
        self.child("SharedMLP", SharedMLP(d_in, d_in, m), "bottleneck")
        self.decoder = []
        for j in range(cfg.num_layers):
            c_skip = skip_ch[-j - 2]
            self.decoder.append(self.child(
                "SharedMLP", SharedMLP(c_skip + d_in, c_skip, m)
            ))
            d_in = c_skip
        self.child("SharedMLP", SharedMLP(d_in, 64, m), "fc1")
        self.child("SharedMLP", SharedMLP(64, 32, m), "fc2")
        self.child("Dense", nn.Linear(32, cfg.num_classes), "head")
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group = data_group

    def compute_dtype(self, device: torch.device) -> torch.dtype:
        bf16 = self.config.use_bfloat16
        if bf16 is None:
            bf16 = device.type == "cuda"
        return torch.bfloat16 if bf16 else torch.float32

    def forward(
        self,
        features: torch.Tensor,   # (B, N, 3 + num_features) = cat(xyz, mods)
        pyramid: Pyramid,         # batched (leading B on every leaf)
        generator: Optional[torch.Generator] = None,  # dropout, train mode
    ) -> torch.Tensor:
        cfg = self.config
        dt = self.compute_dtype(features.device)
        # the sorted-scatter backward needs the search grid; serving
        # (autograd off) skips it
        search = search_grid(pyramid.xyz[0]) if torch.is_grad_enabled() else None
        feature = F.leaky_relu(self.bn0(_linear(self.fc0, features, dt)), 0.2)

        skips = []
        for i, block in enumerate(self.encoder):
            g = None if search is None else (*search, i)
            f_enc = block(pyramid.xyz[i], feature, pyramid.neigh_idx[i], g, dt)
            feature = _max_pool(
                f_enc, pyramid.sub_idx[i], pyramid.xyz[i], pyramid.xyz[i + 1], g
            )
            if i == 0:
                skips.append(f_enc)
            skips.append(feature)

        feature = self.bottleneck(feature, dt)
        for j, mlp in enumerate(self.decoder):
            f_interp = _interp(feature, pyramid.interp_idx[-j - 1])
            feature = mlp(torch.cat([skips[-j - 2], f_interp], dim=-1), dt)

        x = self.fc2(self.fc1(feature, dt), dt)
        p = cfg.dropout_rate
        if self.training and p > 0:
            keep = self._dropout_keep(x.shape, x.device, p, generator)
            x = torch.where(keep, x / (1.0 - p), x.new_zeros(()))
        # the last Linear stays f32
        return F.linear(x.float(), self.head.weight, self.head.bias)

    def _dropout_keep(self, shape, device, p: float, generator):
        """Keep-mask of this rank's (B, N, C) rows: drawn for the global
        batch (data group size x B rows) and sliced at this rank's."""
        size, rank = 1, 0
        if self.data_group is not None:
            size = dist.get_world_size(self.data_group)
            rank = dist.get_rank(self.data_group)
        full = (shape[0] * size,) + tuple(shape[1:])
        keep = torch.empty(full, device=device).bernoulli_(
            1.0 - p, generator=generator)
        return keep[rank * shape[0]:(rank + 1) * shape[0]].bool()


def _he_truncated_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax variance_scaling(2.0, "fan_out", "truncated_normal") on a
    Linear weight (out, in): std sqrt(2 / fan_out) / 0.8796..., cut at
    +-2 std (the inverse-CDF draw of torch's trunc_normal_)."""
    std = math.sqrt(2.0 / w.shape[0]) / 0.87962566103423978
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    with torch.no_grad():
        w.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
        w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


def _glorot_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)


def init_randlanet(
    config: PointSegConfig, generator: torch.Generator, data_group=None
) -> RandLANet:
    """A ``RandLANet`` with the reference's initialisation drawn from
    ``generator`` (CPU): He truncated-normal over fan_out for the
    SharedMLP Linears and the head, glorot-uniform for fc0 and the
    attention scores, zero biases, identity batch norms. In eval mode."""
    model = RandLANet(config, data_group)
    glorot = {id(model.fc0)} | {
        id(m.score) for m in model.modules() if isinstance(m, AttPooling)
    }
    for m in model.modules():
        if isinstance(m, nn.Linear):
            if id(m) in glorot:
                _glorot_uniform_(m.weight, generator)
            else:
                _he_truncated_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return model.eval()
