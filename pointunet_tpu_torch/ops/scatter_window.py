"""Windowed gather gradient on unsorted clouds: kernel 4 and its plain
version (``pointunet_tpu/ops/scatter_window.py``).

The gradient of a K-neighbour row gather ``table[idx]`` is a scatter-add
of the (Nq, K, C) cotangents into (Ns, C) rows. For clouds in any order,
the reference sorts support and queries by raster cell on a grid of
``_grid_resolution(Ns, 1.8)``; a tile of 128 cell-sorted support rows then
reads only 9 reverse windows of the cell-sorted flat (q, k) rows, one per
(dx, dy) column offset, each ``wqk`` rows long (sized from the mean
density with slack 6.0), its start aligned down to 128, overlaps with
earlier windows skipped through ascending-start thresholds. A
contribution outside every window of its tile is dropped: that is the
contract of this approximate op, so the port computes the reference's
windows bit for bit (``_plan``) and does not widen them.

* ``windowed_scatter_plain`` sums the windows in plain torch (f32), tile
  by tile. The CPU path and the comparison on the card use it.
* ``window_owner_plain`` gives each flat row its owner (its sorted
  support position when the row lies in a window of that position's
  tile, else -1): the function the kernel's one pass computes. Summing
  the rows by owner equals ``windowed_scatter_plain`` (a CPU test).
* ``windowed_scatter`` is the wrapper: the plain version for CPU tensors;
  for CUDA tensors it launches the kernels of ``csrc/scatter_window.cu``
  or raises. ``LAUNCHES`` counts its calls on the card (one a call: a
  max, the owner pass and a conversion).
* ``windowed_scatter_add`` plans, sums and unsorts: the (Ns, C) gradient.
* ``windowed_gather`` is the row gather whose backward runs it on CUDA
  tensors when ``POINTUNET_WINDOWED_SCATTER=1``, ``idx.numel() >=
  MIN_ROWS`` and the cotangent is (Nq, K, C), and otherwise
  ``gather.row_sum`` (an f32 sum a row in a fixed order), where the
  reference's custom VJP runs XLA's scatter. The model does not call
  it (the reference's neither): the sorted pyramid's gathers use
  ``ops/scatter_sorted.py``.

What bounds the kernel on the H100 is bytes (ct, idx, inv and the plan
read once, the gradient written once: ~0.07 ms at 365k x 16 x 8). The
first design walked each tile's windows, ~40x the rows a tile owns, with
a dependent idx -> inv load per row. The kernel now resolves each flat
row's owner in one coalesced pass and adds it there as exact 64-bit fixed
point (scale from one max |ct| pass, so no sum overflows; integer sums do
not depend on the order, so every launch gives the same bits), then
converts to f32 once. The source note gives the error bound: ~1e-12 of
max |ct| a term, far inside the 1e-6 x max |exact| bar.
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from . import cuda_build
from .gather import gather_neighbour, row_sum
from .knn_cuda import cell_prefix_sums
from .knn_window import _grid_resolution, _round_up
from .scatter_sorted import window_passes

# kernel launches made by ``windowed_scatter`` in this process
LAUNCHES = 0

S_TILE = 128             # sorted support rows a tile (the kernel's kTile)
# the backward takes the kernel only from this many flat rows on
MIN_ROWS = 262_144
SOURCE = cuda_build.CSRC / "scatter_window.cu"
_ARGTYPES = (
    [ctypes.c_void_p] * 7
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p]
)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return cuda_build.load(SOURCE, "scatter_window_launch", _ARGTYPES)


def _reverse_window_rows(ns: int, nq: int, k: int, resolution: int,
                         slack: float = 6.0) -> int:
    """Flat rows a reverse window spans (the reference's sizing: the mean
    number of query rows a tile's cells and halo hold, times ``slack``)."""
    per_cell_q = nq / float(resolution ** 3)
    span_cells = S_TILE / max(ns / float(resolution ** 3), 1e-6)
    exp_rows = (span_cells + 3.0) * per_cell_q + 64.0
    wq = _round_up(int(slack * exp_rows), 128)
    wqk = _round_up(wq * k, 128) + 128
    return min(wqk, _round_up(nq * k, 128) + 128)


class Plan(NamedTuple):
    ct: torch.Tensor         # (Nq * K, C) f32 rows of the cell-sorted queries
    idx: torch.Tensor        # (Nq * K,) int32 support ids, same order
    inv: torch.Tensor        # (Ns,) int32 sorted position of each support id
    qw0: torch.Tensor        # (nt, 9) int32 window starts, 128-aligned
    qthr: torch.Tensor       # (nt, 9) int32 rows an earlier window covered
    wqk: int                 # rows a window spans


def _plan(
    ct: torch.Tensor,            # (Nq, K, C)
    idx: torch.Tensor,           # (Nq, K) support ids
    support_xyz: torch.Tensor,   # (Ns, 3)
    query_xyz: torch.Tensor,     # (Nq, 3)
    resolution: int,
    wqk: int,
) -> Plan:
    """The reference's sorts, windows and thresholds, bit for bit: cells
    ``floor((xyz - lo) / span * r)`` in f32 over the support's box, stable
    sorts (as ``jnp.argsort``), tile cells padded with r^3 - 1."""
    nq, k, c = ct.shape
    ns = support_xyz.shape[0]
    r = resolution
    dev = ct.device
    support_xyz = support_xyz.float()
    lo = support_xyz.min(0).values
    span = (support_xyz.max(0).values - lo).clamp(min=1e-6)

    def cell_of(pts):
        cc = torch.floor((pts.float() - lo) / span * r).to(torch.int32)
        cc = cc.clamp(0, r - 1)
        return (cc[:, 0] * r + cc[:, 1]) * r + cc[:, 2]

    s_ids = cell_of(support_xyz)
    s_order = torch.argsort(s_ids, stable=True)
    s_sorted = s_ids[s_order]
    q_ids = cell_of(query_xyz)
    q_order = torch.argsort(q_ids, stable=True)
    q_cell_start = cell_prefix_sums(q_ids[q_order], r)

    ct_q = ct.float().reshape(nq, k * c)[q_order].reshape(nq * k, c)
    idx_q = idx.to(torch.int32).reshape(nq, k)[q_order].reshape(nq * k)

    nt = -(-ns // S_TILE)
    tile_cell_lo = s_sorted[torch.arange(nt, device=dev) * S_TILE].long()
    offs = torch.tensor(
        [dx * r * r + dy * r for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
        dtype=torch.long, device=dev,
    )
    cells = (tile_cell_lo[:, None] - offs[None, :] - 1).clamp(0, r ** 3 - 1)
    q_start = q_cell_start[cells]                            # (nt, 9) int32
    qw0 = (q_start * k) & ~127                               # lane-aligned
    # offsets descend in start order: walking them in ascending start,
    # each window skips the rows an earlier one already covered
    qthr = torch.empty_like(qw0)
    covered = torch.full((nt,), -1, dtype=torch.int32, device=dev)
    for o in range(8, -1, -1):
        s = qw0[:, o]
        qthr[:, o] = (covered - s).clamp(0, wqk)
        covered = torch.maximum(covered, s + wqk)
    inv = torch.empty(ns, dtype=torch.int32, device=dev)
    inv[s_order] = torch.arange(ns, dtype=torch.int32, device=dev)
    return Plan(ct_q.contiguous(), idx_q.contiguous(), inv,
                qw0.contiguous(), qthr.contiguous(), wqk)


def _window_bounds(plan: Plan):
    """Per tile, the 9 windows' [start, end) flat rows in ascending start
    (offset 8 first), cut at the last real row: (nt, 9) int64 each."""
    nqk = plan.ct.shape[0]
    w0 = plan.qw0.long().flip(1)
    start = w0 + plan.qthr.long().flip(1)
    end = (w0 + plan.wqk).clamp(max=nqk)
    return start, torch.maximum(end, start)


def windowed_scatter_plain(plan: Plan, ns: int) -> torch.Tensor:
    """The kernel's function in plain torch: (Ns, C) f32 in sorted-support
    order. Every tile lists the flat rows of its windows and keeps those
    whose index's sorted position falls in the tile, so a contribution
    outside the windows is dropped here as it is in the kernel."""
    ct, idx, inv = plan.ct, plan.idx, plan.inv
    out = torch.zeros((ns, ct.shape[1]), dtype=torch.float32,
                      device=ct.device)
    start, end = _window_bounds(plan)
    for win, p in window_passes(start.reshape(-1), (end - start).reshape(-1)):
        j = idx[p].long()
        valid = (j >= 0) & (j < ns)
        row = torch.where(valid, inv[j.clamp(0, ns - 1)].long(), -1)
        lo = win // 9 * S_TILE                          # the window's tile
        keep = (row >= lo) & (row < lo + S_TILE)
        out.index_add_(0, row[keep], ct[p[keep]])
    return out


def window_owner_plain(plan: Plan, ns: int) -> torch.Tensor:
    """(Nq*K,) int64: each flat row's sorted support position ``inv[idx]``
    when the row lies in some ``[qw0, min(qw0 + wqk, Nq*K))`` of that
    position's tile, else -1. The thresholds only remove overlaps of
    windows walked in ascending start, so this is the same test as "in
    some thresholded window", and summing ``ct`` by owner is
    ``windowed_scatter_plain``."""
    nqk = plan.ct.shape[0]
    j = plan.idx.long()
    valid = (j >= 0) & (j < ns)
    pos = torch.where(valid, plan.inv[j.clamp(0, ns - 1)].long(), -1)
    w0 = plan.qw0.long()[pos.clamp(min=0) // S_TILE]            # (nqk, 9)
    p = torch.arange(nqk, device=pos.device)[:, None]
    inside = ((p >= w0) & (p < (w0 + plan.wqk).clamp(max=nqk))).any(1)
    return torch.where(valid & inside, pos, -1)


def windowed_scatter(plan: Plan, ns: int) -> torch.Tensor:
    """Windowed scatter-add along ``plan`` (see the module docstring):
    (Ns, C) f32 in sorted-support order.

    CPU tensors take the plain version. CUDA tensors launch the kernel;
    anything the kernel does not take raises."""
    global LAUNCHES
    tensors = (plan.ct, plan.idx, plan.inv, plan.qw0, plan.qthr)
    if all(t.device.type == "cpu" for t in tensors):
        return windowed_scatter_plain(plan, ns)
    dev = plan.ct.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "windowed_scatter: inputs must all be on the CPU or all on one "
            f"CUDA device, got {[str(t.device) for t in tensors]}"
        )
    if plan.ct.ndim != 2 or ns < 1:
        raise ValueError(
            f"windowed_scatter: ct must be (Nq*K, C) and the support "
            f"non-empty, got {tuple(plan.ct.shape)} and Ns={ns}"
        )
    nqk, c = plan.ct.shape
    nt = -(-ns // S_TILE)
    for name, t, dt, shape in (
        ("ct", plan.ct, torch.float32, (nqk, c)),
        ("idx", plan.idx, torch.int32, (nqk,)),
        ("inv", plan.inv, torch.int32, (ns,)),
        ("qw0", plan.qw0, torch.int32, (nt, 9)),
        ("qthr", plan.qthr, torch.int32, (nt, 9)),
    ):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"windowed_scatter: {name} must be contiguous {dt} {shape}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
    out = torch.empty((ns, c), dtype=torch.float32, device=dev)
    # scratch: the fixed-point sums and the max |ct| bits
    acc = torch.empty((ns, c), dtype=torch.int64, device=dev)
    bits = torch.empty((1,), dtype=torch.int32, device=dev)
    fn = load_library().scatter_window_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(
            plan.ct.data_ptr(), plan.idx.data_ptr(), plan.inv.data_ptr(),
            plan.qw0.data_ptr(), acc.data_ptr(), bits.data_ptr(),
            out.data_ptr(), ns, nqk, c, plan.wqk, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"windowed_scatter: kernel launch failed, CUDA error {rc}"
        )
    LAUNCHES += 1
    return out


def windowed_scatter_add(
    ct: torch.Tensor,            # (Nq, K, C) cotangents
    idx: torch.Tensor,           # (Nq, K) support ids
    support_xyz: torch.Tensor,   # (Ns, 3)
    query_xyz: torch.Tensor,     # (Nq, 3)
    n_support: int,
    alpha: float = 1.8,
) -> torch.Tensor:
    """Sum the ct rows into (Ns, C) f32 along the reverse windows: the
    gradient of a row gather (exact when every index lies in a window of
    its tile)."""
    nq, k, _ = ct.shape
    resolution = _grid_resolution(n_support, alpha)
    wqk = _reverse_window_rows(n_support, nq, k, resolution)
    plan = _plan(ct, idx, support_xyz, query_xyz, resolution, wqk)
    return windowed_scatter(plan, n_support)[plan.inv.long()]


class WindowedGather(torch.autograd.Function):
    """``table[idx]`` whose backward runs the windowed scatter on CUDA
    tensors when ``POINTUNET_WINDOWED_SCATTER=1`` and ``idx.numel() >=
    MIN_ROWS``, and ``gather.row_sum`` otherwise."""

    @staticmethod
    def forward(ctx, table, idx, support_xyz, query_xyz):
        ctx.save_for_backward(idx, support_xyz, query_xyz)
        ctx.n_support = table.shape[0]
        return gather_neighbour(table, idx)

    @staticmethod
    def backward(ctx, ct):
        idx, support_xyz, query_xyz = ctx.saved_tensors
        n = ctx.n_support
        if (ct.is_cuda and idx.numel() >= MIN_ROWS and ct.ndim == 3
                and os.environ.get("POINTUNET_WINDOWED_SCATTER", "0") == "1"):
            grad = windowed_scatter_add(
                ct, idx, support_xyz, query_xyz, n
            ).to(ct.dtype)
        else:
            grad = row_sum(ct, idx, n).to(ct.dtype)
        return grad, None, None, None


def windowed_gather(
    table: torch.Tensor,         # (Ns, C)
    idx: torch.Tensor,           # (Nq, K) support ids
    support_xyz: torch.Tensor,   # (Ns, 3)
    query_xyz: torch.Tensor,     # (Nq, 3)
) -> torch.Tensor:
    """(Ns, C), (Nq, K) -> (Nq, K, C) row gather with the windowed-scatter
    backward (see ``WindowedGather``)."""
    return WindowedGather.apply(table, idx, support_xyz, query_xyz)
