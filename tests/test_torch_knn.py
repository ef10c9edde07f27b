"""Port KNN (pointunet_tpu_torch/ops/knn*.py) against the reference.

The CUDA kernel has no CPU mode; on the CPU the wrapper runs its plain
version, which the card compares with the kernel row for row
(chip_smoke.py). Here the plain version is held against the reference's
Pallas kernel in TPU interpret mode, on the same sorted inputs, by
tie-aware recall against exact KNN: the port reads the exact 27-cell
spans while the TPU kernel reads windows of a fixed width, so the port's
recall must be at least the kernel's.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pointunet_tpu.ops.knn import knn as jax_knn
from pointunet_tpu.ops.knn_pallas import knn_pallas_core
from pointunet_tpu.ops.knn_window import _grid_resolution
from pointunet_tpu_torch.ops import knn_cuda
from pointunet_tpu_torch.ops.knn import knn
from torch_parity import tie_aware_recall

torch.set_num_threads(1)


def _sorted_cloud(pts, r):
    """Cell-sort ``pts`` on an r^3 grid: (sorted pts, cells, ids)."""
    lo = pts.min(0)
    span = np.maximum(pts.max(0) - lo, 1e-6)
    c3 = np.clip(np.floor((pts - lo) / span * r).astype(np.int32), 0, r - 1)
    ids = (c3[:, 0] * r + c3[:, 1]) * r + c3[:, 2]
    order = np.argsort(ids, kind="stable")
    return pts[order], c3[order], ids[order].astype(np.int32)


def _dense_ball_cloud(rng, side=24, radius=6, keep=0.35):
    """Voxel centres of a side^3 grid: a random ``keep`` share plus every
    voxel of a ball, the chip smoke's cloud at a small size."""
    g = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), -1)
    g = g.reshape(-1, 3)
    ball = ((g - side / 2) ** 2).sum(1) < radius ** 2
    pick = ball | (rng.uniform(size=len(g)) < keep)
    pts = g[pick][rng.permutation(int(pick.sum()))]
    return (pts / side).astype(np.float32)


def _sorted_inputs(pts):
    """(sp, cell_start, qc, r) of a self search over ``pts``."""
    r = _grid_resolution(len(pts), 1.8)
    sp, sc, ids = _sorted_cloud(pts, r)
    counts = np.bincount(ids, minlength=r ** 3)
    cell_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return (torch.from_numpy(sp), torch.from_numpy(cell_start),
            torch.from_numpy(sc), r)


def _voxel_cloud(rng, n=512):
    coords = np.unique(rng.integers(0, 20, (2000, 3)), axis=0)
    return (coords[rng.permutation(len(coords))[:n]] / 20.0).astype(
        np.float32
    )


@pytest.mark.parametrize("k", [1, 16])
def test_plain_cell_window_vs_pallas_interpret(rng, k):
    pts = _voxel_cloud(rng)
    n = len(pts)
    r = _grid_resolution(n, 1.8)
    sp, sc, ids = _sorted_cloud(pts, r)
    counts = np.bincount(ids, minlength=r ** 3)
    cell_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    # the reference's window sizing (ops/knn_pallas.py knn_pallas)
    tile = 128
    exp_rows = tile + 2.0 * n / r ** 3 + 64.0
    window = 1 << max(7, math.ceil(math.log2(max(4.0 * exp_rows, 128))))
    window = min(window, 1 << math.ceil(math.log2(max(n, 128))))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(knn_pallas_core(
            jnp.asarray(sp), jnp.asarray(sc), jnp.asarray(cell_start),
            jnp.asarray(sp), jnp.asarray(sc), jnp.asarray(ids),
            k, r, tile, window,
        ))
    got = knn_cuda.knn_cell_window(
        torch.from_numpy(sp), torch.from_numpy(cell_start),
        torch.from_numpy(sp), torch.from_numpy(sc), k, r,
    ).numpy()
    assert got.shape == ref.shape == (n, k)
    assert got.dtype == np.int32
    assert got.min() >= 0 and got.max() < n
    rec_port = tie_aware_recall(sp, sp, k, got)
    rec_ref = tie_aware_recall(sp, sp, k, ref)
    assert rec_port >= rec_ref, (rec_port, rec_ref)
    assert rec_port > 0.97
    # nearest first: the query itself leads its own row
    assert (got[:, 0] == np.arange(n)).all()


@pytest.mark.parametrize("k", [1, 16, 40])
def test_exact_knn_matches_reference(rng, k):
    support = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    query = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    ref = np.asarray(jax_knn(jnp.asarray(support), jnp.asarray(query), k))
    got = knn(torch.from_numpy(support), torch.from_numpy(query), k).numpy()
    assert got.shape == ref.shape == (200, k)
    assert got.dtype == np.int32
    k_eff = min(k, len(support))
    assert tie_aware_recall(support, query, k_eff, got[:, :k_eff]) == 1.0
    assert tie_aware_recall(support, query, k_eff, ref[:, :k_eff]) == 1.0
    # fewer support points than k: trailing columns repeat the last one
    np.testing.assert_array_equal(
        got[:, k_eff:], np.repeat(got[:, k_eff - 1:k_eff], k - k_eff, 1)
    )


def test_missing_slot_fill_rule():
    """Slots with no neighbour take the first neighbour found, and a query
    whose 27 cells hold no support point gets row 0 everywhere."""
    r = 8
    support = np.array(
        [[0.05, 0.05, 0.05], [0.06, 0.05, 0.05], [0.95, 0.95, 0.95]],
        np.float32,
    )
    cells = np.floor(support * r).astype(np.int32)
    ids = (cells[:, 0] * r + cells[:, 1]) * r + cells[:, 2]
    assert (np.diff(ids) >= 0).all()
    counts = np.bincount(ids, minlength=r ** 3)
    cell_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    query = np.array([[0.07, 0.05, 0.05], [0.5, 0.5, 0.5]], np.float32)
    qc = np.floor(query * r).astype(np.int32)
    got = knn_cuda.knn_cell_window(
        torch.from_numpy(support), torch.from_numpy(cell_start),
        torch.from_numpy(query), torch.from_numpy(qc), 4, r,
    ).numpy()
    np.testing.assert_array_equal(got, [[1, 0, 1, 1], [0, 0, 0, 0]])


def test_wrapper_plain_on_cpu_and_never_falls_back_elsewhere():
    """CPU tensors take the plain version (no launch is counted); tensors
    anywhere but the CPU must reach the kernel or raise, never the plain
    version."""
    sp = torch.rand(64, 3)
    r = 3
    c3 = torch.clamp((sp * r).floor().int(), 0, r - 1)
    ids = (c3[:, 0] * r + c3[:, 1]) * r + c3[:, 2]
    order = torch.argsort(ids, stable=True)
    sp, c3, ids = sp[order].contiguous(), c3[order].contiguous(), ids[order]
    cs = knn_cuda.cell_prefix_sums(ids, r)
    before = knn_cuda.LAUNCHES
    out = knn_cuda.knn_cell_window(sp, cs, sp, c3, 4, r)
    assert out.shape == (64, 4) and knn_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        knn_cuda.knn_cell_window(
            sp.to("meta"), cs.to("meta"), sp.to("meta"), c3.to("meta"), 4, r,
        )
    assert knn_cuda.LAUNCHES == before


def test_cell_prefix_sums():
    ids = torch.tensor([0, 0, 2, 5, 5, 5, 7], dtype=torch.int32)
    cs = knn_cuda.cell_prefix_sums(ids, 2)
    assert cs.dtype == torch.int32
    np.testing.assert_array_equal(cs.numpy(), [0, 2, 2, 3, 3, 3, 6, 6, 7])


@pytest.mark.parametrize("cloud,tile", [
    ("voxels", 64), ("dense_ball", 64), ("dense_ball", 7), ("line", 64),
])
def test_tile_windows_hold_every_span(rng, cloud, tile):
    """The kernel's tile plan: for every tile of ``tile`` sorted queries
    and every (dx, dy), the staged window is exactly the least start and
    greatest end of the tile's non-empty spans, so it holds each query's
    exact span (nothing is truncated), on clouds whose tiles straddle
    columns and touch the grid's edges."""
    pts = {
        "voxels": lambda: _voxel_cloud(rng),
        "dense_ball": lambda: _dense_ball_cloud(rng),
        # one point a column along x: every tile straddles many columns
        "line": lambda: np.stack([np.linspace(0, 1, 300),
                                  rng.uniform(0, 1, 300),
                                  rng.uniform(0, 1, 300)], 1).astype(
                                      np.float32),
    }[cloud]()
    sp, cell_start, qc, r = _sorted_inputs(pts)
    win = knn_cuda.tile_windows_plain(qc, cell_start, r, tile)
    start, length = knn_cuda._spans(qc, cell_start, r)
    n = len(pts)
    assert win.shape == (-(-n // tile), 9, 2)
    straddle = edge = 0
    for t in range(win.shape[0]):
        rows = slice(t * tile, min(n, (t + 1) * tile))
        s, ln = start[rows], length[rows]
        live = ln > 0
        for c in range(9):
            if live[:, c].any():
                assert win[t, c, 0] == s[live[:, c], c].min()
                assert win[t, c, 1] == (s + ln)[live[:, c], c].max()
            else:
                assert win[t, c].tolist() == [0, 0]
        assert ((s >= win[t, :, 0]) | ~live).all()
        assert ((s + ln <= win[t, :, 1]) | ~live).all()
        cols = qc[rows, :2].unique(dim=0)
        straddle += len(cols) > 1
        edge += bool(((qc[rows, :2] == 0) | (qc[rows, :2] == r - 1)).any())
    assert straddle > 0 and edge > 0


def _keys_select(sp, cell_start, qp, qc, k, r):
    """The kernel's selection in plain torch: every candidate of a query
    (its 9 exact spans) keyed by (bits of d^2) << 32 | row, the k least
    keys by one sort of int64, empty slots filled by the first."""
    start, length = knn_cuda._spans(qc, cell_start, r)
    out = torch.zeros((qp.shape[0], k), dtype=torch.int32)
    for q in range(qp.shape[0]):
        rows = torch.cat([torch.arange(int(a), int(a + ln))
                          for a, ln in zip(start[q], length[q])])
        if rows.numel() == 0:
            continue
        e = qp[q] - sp[rows]
        d2 = e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2]
        keys = (d2.view(torch.int32).long() << 32) | rows
        best = torch.sort(keys).values[:k] & 0xFFFFFFFF
        out[q, :best.numel()] = best.to(torch.int32)
        out[q, best.numel():] = best[0].to(torch.int32)
    return out


@pytest.mark.parametrize("k", [1, 16])
@pytest.mark.parametrize("cloud", ["voxels", "dense_ball"])
def test_packed_key_selection_equals_plain(rng, k, cloud):
    """Ordering by the packed key (d^2 bits, row) is ordering by (d^2,
    row): the k least keys equal ``knn_cell_window_plain`` on every row,
    on voxel clouds full of distance ties."""
    pts = _voxel_cloud(rng) if cloud == "voxels" else _dense_ball_cloud(rng)
    sp, cell_start, qc, r = _sorted_inputs(pts)
    want = knn_cuda.knn_cell_window_plain(sp, cell_start, sp, qc, k, r)
    got = _keys_select(sp, cell_start, sp, qc, k, r)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if k == 16:
        # ties inside the lists, decided by the lower row
        e = sp[:, None, :] - sp[want.long()]
        d2 = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]
        tie = d2[:, 1:] == d2[:, :-1]
        assert tie.any()
        assert (want[:, 1:][tie] > want[:, :-1][tie]).all()


def test_box_bound_never_exceeds_a_rows_d2(rng):
    """The kernel's pruning bound: the f32 distance from a query to a box,
    each difference, product and sum rounded as for a row, is at most the
    d^2 of every point in the box (rounding is monotone), so skipping a
    box farther than the k-th key never changes the result."""
    pts = torch.from_numpy(_dense_ball_cloud(rng))
    q = torch.from_numpy(rng.uniform(-0.2, 1.2, (512, 3)).astype(np.float32))
    for lo in range(0, len(pts), 97):
        box = pts[lo:lo + 97]
        bmin, bmax = box.min(0).values, box.max(0).values
        e = torch.where(q < bmin, bmin - q,
                        torch.where(q > bmax, q - bmax, torch.zeros(())))
        bound = e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2]
        d = q[:, None, :] - box[None]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        assert (bound[:, None] <= d2).all()
