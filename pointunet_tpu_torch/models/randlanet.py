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
scatter kernel (kernel 2) on the large levels and ``ops.gather.row_sum``
on the others; it needs the level-0 search grid, which is computed only
then. The xyz gathers need no gradient; the up-sample's gather
(``ops.gather.RowGather``) takes ``row_sum`` too, where the reference's
is XLA's scatter. ``row_sum`` adds each row's terms in a fixed order in
f32, and kernel 2 has no atomics either, so a train step gives the same
bits on every run.

With a ``point_group`` (a mesh's point axis), rank p computes only slab
p of every level's cell-sorted rows (``ops/pyramid_sharded.py:
slab_sizes``, the slabs the sharded pyramid searches): its features in,
its logits out. The pyramid and every level's xyz stay whole on every
rank. Each gather reads the whole source table, made whole by a
differentiable all-gather over the point group
(``parallel.collectives.all_gather_rows_grad``) whose backward sums the
table's cotangent over the group: the two LFA gathers (queries: the
slab's rows), the pool gather (queries: the slab of the next level) and
the up-sample (queries: the slab of the level below). The sorted
scatter's plan is built from the queries' own cell prefix sums, so it
runs on a slab of queries as on a whole level.

dtype policy: ``use_bfloat16`` None means auto: bf16 when the features are
on CUDA, f32 on the CPU. In bf16 the layers compute in bf16 while xyz,
the relative-position encoding and the head's last Linear stay f32. The
reference's double-bf16 xyz gather table is a TPU gather workaround and is
not ported: the f32 xyz rows are gathered directly.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..core.config import PointSegConfig
from ..ops.gather import RowGather, encode_neighbor_xyz, gather_neighbour
from ..ops.knn_window import _grid_resolution
from ..ops.pyramid import Pyramid
from ..ops.pyramid_sharded import slab_sizes
from ..ops.scatter_sorted import sorted_gather
from ..parallel.collectives import all_gather_rows_grad
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


class Slab(NamedTuple):
    """This rank's part of one level: its ``rows`` (a slice of the level's
    sorted rows) and ``whole``, which makes a (B, rows, C) activation the
    level's whole (B, N, C) table."""
    rows: slice
    whole: Callable[[torch.Tensor], torch.Tensor]


WHOLE = Slab(slice(None), lambda f: f)     # one process: every row


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

    def forward(self, xyz, feature, neigh_idx, grid, dt, slab=WHOLE):
        # xyz (B, N, 3) f32, the whole level; feature (B, M, d_out // 2)
        # and neigh_idx (B, M, K): the M rows of ``slab``
        q_xyz = xyz[:, slab.rows]
        neigh_xyz = _gather(xyz, neigh_idx)                 # (B, M, K, 3)
        f_neigh = _sorted_gather(slab.whole(feature), neigh_idx, xyz, q_xyz,
                                 grid)
        f_xyz = self.mlp1(encode_neighbor_xyz(q_xyz, neigh_xyz), dt)
        f_agg = self.pool1(torch.cat([f_neigh, f_xyz], dim=-1), dt)
        f_xyz = self.mlp2(f_xyz, dt)
        f_neigh = _sorted_gather(slab.whole(f_agg), neigh_idx, xyz, q_xyz,
                                 grid)
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

    def forward(self, xyz, feature, neigh_idx, grid, dt, slab=WHOLE):
        f_pc = self.mlp1(feature, dt)
        f_pc = self.lfa(xyz, f_pc, neigh_idx, grid, dt, slab)
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
    """(B, M, d), (B, N, 1) -> (B, N, d): nearest-neighbour up-sample,
    its gradient summed by ``row_sum``."""
    return torch.stack([RowGather.apply(t, i[:, 0])
                        for t, i in zip(feature, interp_idx)])


class RandLANet(FlaxNamed):
    """Encoder-decoder over the decimation pyramid.

    On a mesh: ``data_group``, the ranks that hold the other clouds of
    the batch (the data axis); ``point_group``, the ranks that hold the
    same clouds and split every level's rows into slabs (the point axis;
    see the module docstring); ``mesh_group``, the ranks of both, which
    hold between them the rows of the global batch. Every ``BatchNorm``
    takes the statistics of the global batch over ``mesh_group``, and the
    dropout mask is drawn for the global batch's whole level-0 rows from
    the shared generator, of which this rank keeps its clouds and its
    slab, so that a mesh step computes what one process computes on the
    whole batch."""

    def __init__(self, config: PointSegConfig, data_group=None,
                 point_group=None, mesh_group=None):
        super().__init__()
        if mesh_group is None and (data_group, point_group) != (None, None):
            raise ValueError("RandLANet: a mesh axis needs the mesh_group")
        cfg = self.config = config
        self.data_group = data_group
        self.point_group = point_group
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
                m.group = mesh_group

    def compute_dtype(self, device: torch.device) -> torch.dtype:
        bf16 = self.config.use_bfloat16
        if bf16 is None:
            bf16 = device.type == "cuda"
        return torch.bfloat16 if bf16 else torch.float32

    def slab(self, n: int) -> Slab:
        """This rank's slab of a level of ``n`` rows (``WHOLE`` without a
        point group)."""
        group = self.point_group
        if group is None:
            return WHOLE
        sizes = slab_sizes(n, dist.get_world_size(group))
        part = dist.get_rank(group)
        lo = sum(sizes[:part])

        def whole(f):
            return all_gather_rows_grad(
                f.transpose(0, 1), sizes, group).transpose(0, 1)

        return Slab(slice(lo, lo + sizes[part]), whole)

    def forward(
        self,
        features: torch.Tensor,   # (B, M, 3 + num_features) = cat(xyz, mods):
                                  #   level 0's rows, this rank's slab of them
        pyramid: Pyramid,         # batched (leading B on every leaf), whole
        generator: Optional[torch.Generator] = None,  # dropout, train mode
    ) -> torch.Tensor:
        cfg = self.config
        dt = self.compute_dtype(features.device)
        slabs = [self.slab(x.shape[1]) for x in pyramid.xyz]
        rows = range(pyramid.xyz[0].shape[1])[slabs[0].rows]
        if features.shape[1] != len(rows):
            raise ValueError(
                f"RandLANet: features hold {features.shape[1]} rows, this "
                f"rank's slab of level 0 has {len(rows)}")
        # the sorted-scatter backward needs the search grid; serving
        # (autograd off) skips it
        search = search_grid(pyramid.xyz[0]) if torch.is_grad_enabled() else None
        feature = F.leaky_relu(self.bn0(_linear(self.fc0, features, dt)), 0.2)

        skips = []
        for i, block in enumerate(self.encoder):
            g = None if search is None else (*search, i)
            here, nxt = slabs[i], slabs[i + 1].rows
            f_enc = block(pyramid.xyz[i], feature,
                          pyramid.neigh_idx[i][:, here.rows], g, dt, here)
            feature = _max_pool(
                here.whole(f_enc), pyramid.sub_idx[i][:, nxt],
                pyramid.xyz[i], pyramid.xyz[i + 1][:, nxt], g
            )
            if i == 0:
                skips.append(f_enc)
            skips.append(feature)

        feature = self.bottleneck(feature, dt)
        for j, mlp in enumerate(self.decoder):
            level = len(self.decoder) - 1 - j
            f_interp = _interp(slabs[level + 1].whole(feature),
                               pyramid.interp_idx[level][:, slabs[level].rows])
            feature = mlp(torch.cat([skips[-j - 2], f_interp], dim=-1), dt)

        x = self.fc2(self.fc1(feature, dt), dt)
        p = cfg.dropout_rate
        if self.training and p > 0:
            keep = self._dropout_keep(
                x.shape, x.device, p, generator, pyramid.xyz[0].shape[1],
                slabs[0].rows)
            x = torch.where(keep, x / (1.0 - p), x.new_zeros(()))
        # the last Linear stays f32
        return F.linear(x.float(), self.head.weight, self.head.bias)

    def _dropout_keep(self, shape, device, p: float, generator, n0: int,
                      rows: slice = WHOLE.rows):
        """Keep-mask of this rank's (B, M, C) rows: drawn for the global
        batch (data group size x B clouds of all ``n0`` level-0 rows) and
        sliced at this rank's clouds and its slab ``rows``."""
        size, rank = 1, 0
        if self.data_group is not None:
            size = dist.get_world_size(self.data_group)
            rank = dist.get_rank(self.data_group)
        full = (shape[0] * size, n0) + tuple(shape[2:])
        keep = torch.empty(full, device=device).bernoulli_(
            1.0 - p, generator=generator)
        return keep[rank * shape[0]:(rank + 1) * shape[0], rows].bool()


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
    config: PointSegConfig, generator: torch.Generator, data_group=None,
    point_group=None, mesh_group=None,
) -> RandLANet:
    """A ``RandLANet`` with the reference's initialisation drawn from
    ``generator`` (CPU): He truncated-normal over fan_out for the
    SharedMLP Linears and the head, glorot-uniform for fc0 and the
    attention scores, zero biases, identity batch norms. In eval mode."""
    model = RandLANet(config, data_group, point_group, mesh_group)
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
