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
