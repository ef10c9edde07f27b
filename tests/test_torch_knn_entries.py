"""The port's KNN entries outside the pyramid against the reference's:
``ops/knn_window.py:knn_cell_window`` (the search of XLA ops),
``ops/knn_grid.py:knn_grid`` and the standalone ``knn_cuda.knn_pallas``.

The same numpy clouds (``default_rng`` seeds) go through both packages on
the CPU. Bars:

* ``knn_cell_window`` and ``knn_grid``: the same neighbour set on every
  row up to distance ties: each row's squared distances, recomputed in
  f64 and sorted, equal the reference's within 1e-6 (the expansion and
  the difference form round differently in f32, which may swap two
  candidates whose distances differ by less; coordinates lie in [0, 2]),
  and every row pads the same number of slots with its first neighbour
  where the reference pads (fewer than k candidates in its cells);
* ``knn_pallas`` on the CPU (kernel 1's plain version) and the
  reference's ``knn_pallas`` on the CPU (its fallback to the search of
  XLA ops): tie-aware recall >= 0.99 against the exact KNN each, as
  tests/test_knn_window.py holds the reference, and rows returned in the
  caller's query order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointunet_tpu.ops.knn_grid import knn_grid as ref_knn_grid
from pointunet_tpu.ops.knn_pallas import knn_pallas as ref_knn_pallas
from pointunet_tpu.ops.knn_window import knn_cell_window as ref_knn_window
from pointunet_tpu_torch.ops import knn_cuda
from pointunet_tpu_torch.ops.knn_grid import knn_grid
from pointunet_tpu_torch.ops.knn_window import knn_cell_window
from torch_parity import tie_aware_recall, voxel_block

torch.set_num_threads(1)


def _row_d2(support, query, idx):
    """(Nq, k) f64 squared distances of each row's neighbours, sorted."""
    s = np.asarray(support, np.float64)
    q = np.asarray(query, np.float64)
    diff = s[np.asarray(idx)] - q[:, None, :]
    return np.sort((diff * diff).sum(-1), axis=1)


def _pads(idx):
    """Slots after the first that repeat the row's first neighbour."""
    idx = np.asarray(idx)
    return (idx[:, 1:] == idx[:, :1]).sum(1)


def assert_same_sets(support, query, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.int32
    np.testing.assert_allclose(_row_d2(support, query, got),
                               _row_d2(support, query, want), atol=1e-6)
    np.testing.assert_array_equal(_pads(got), _pads(want))


def voxel_cloud(n, seed, side=24):
    """``n`` distinct voxels of a side^3 block, shuffled, in [0, 1)."""
    rng = np.random.default_rng(seed)
    pts = voxel_block((side,) * 3, rng)
    return pts[:n].astype(np.float32)


def uniform_cloud(n, seed, scale=(1.0, 1.0, 1.0)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, 3)) * scale).astype(np.float32)


def _window_case(name):
    """(support, query, k, keyword arguments) of a ``knn_cell_window``
    case; 4,096-point clouds."""
    vox, uni = voxel_cloud(4096, 0), uniform_cloud(4096, 1)
    if name == "voxel_self":
        return vox, vox, 16, {}
    if name == "uniform_self":
        return uni, uni, 16, {}
    if name == "voxel_up":
        return vox[:1024], vox, 1, {}
    if name == "uniform_up":
        return uni[:1024], uni, 1, {}
    if name == "support_valid":
        # a sparse valid set: rows with fewer than k candidates pad
        valid = np.random.default_rng(2).uniform(size=4096) < 0.1
        return uni, uni[:2048], 16, {"support_valid": valid}
    if name == "resolution":
        aniso = uniform_cloud(4096, 3, (1.0, 1.4, 1.8))
        return aniso, aniso, 16, {"resolution": (6, 8, 10)}
    if name == "tiny":
        return uni[:7], uni[:33], 16, {}
    raise KeyError(name)


@pytest.mark.parametrize("name", ["voxel_self", "uniform_self", "voxel_up",
                                  "uniform_up", "support_valid",
                                  "resolution", "tiny"])
def test_knn_cell_window_matches_reference(name):
    support, query, k, kw = _window_case(name)
    want = ref_knn_window(
        jnp.asarray(support), jnp.asarray(query), k,
        **{key: jnp.asarray(v) if key == "support_valid" else v
           for key, v in kw.items()})
    got = knn_cell_window(
        torch.from_numpy(support), torch.from_numpy(query), k,
        **{key: torch.from_numpy(v) if key == "support_valid" else v
           for key, v in kw.items()})
    assert_same_sets(support, query, got.numpy(), want)
    if name == "support_valid":
        assert _pads(want).sum() > 0          # the case reaches the padding
        valid = kw["support_valid"]
        found = got.numpy()[_pads(got.numpy()) < k - 1]
        assert valid[found].all()


def _grid_case(name):
    """The cases of tests/test_knn_grid.py: (support, query, k)."""
    rng = np.random.default_rng(0)
    if name == "volumetric":
        coords = np.unique(rng.integers(0, 48, (30000, 3)), axis=0)
        pts = (coords[rng.permutation(len(coords))[:8000]] / 48.0).astype(
            np.float32)
        return pts, pts, 8
    if name == "self_neighbour":
        pts = rng.uniform(0, 1, (2000, 3)).astype(np.float32)
        return pts, pts, 4
    if name == "uniform":
        return (rng.uniform(0, 1, (5000, 3)).astype(np.float32),
                rng.uniform(0, 1, (1000, 3)).astype(np.float32), 16)
    if name == "one_nn":
        return (rng.uniform(0, 1, (3000, 3)).astype(np.float32),
                rng.uniform(0, 1, (6000, 3)).astype(np.float32), 1)
    if name == "tiny_support":
        return (rng.uniform(0, 1, (5, 3)).astype(np.float32),
                rng.uniform(0, 1, (50, 3)).astype(np.float32), 16)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["volumetric", "self_neighbour", "uniform",
                                  "one_nn", "tiny_support"])
def test_knn_grid_matches_reference(name):
    support, query, k = _grid_case(name)
    want = ref_knn_grid(jnp.asarray(support), jnp.asarray(query), k)
    got = knn_grid(torch.from_numpy(support), torch.from_numpy(query), k)
    assert_same_sets(support, query, got.numpy(), want)
    if name == "self_neighbour":
        np.testing.assert_array_equal(got.numpy()[:, 0], np.arange(2000))


@pytest.mark.parametrize("k", [16, 1])
def test_knn_pallas_standalone(k):
    """Shuffled rows of a voxel cloud: both entries recall the exact
    neighbours, and the port returns rows in the caller's order."""
    rng = np.random.default_rng(5)
    pts = voxel_cloud(4096, 4)
    support = pts[rng.permutation(4096)]
    query = pts[rng.permutation(4096)] if k == 16 else pts
    if k == 1:
        support = support[:1024]
    before = knn_cuda.LAUNCHES
    got = knn_cuda.knn_pallas(torch.from_numpy(support),
                              torch.from_numpy(query), k)
    assert knn_cuda.LAUNCHES == before        # the plain version on the CPU
    assert got.shape == (query.shape[0], k) and got.dtype == torch.int32
    want = np.asarray(ref_knn_pallas(
        jnp.asarray(support), jnp.asarray(query), k))
    for idx in (got.numpy(), want):
        assert tie_aware_recall(support, query, k, idx) >= 0.99
    # the caller's order: the rows of a permuted query set permute alike
    perm = rng.permutation(query.shape[0])
    again = knn_cuda.knn_pallas(torch.from_numpy(support),
                                torch.from_numpy(query[perm]), k)
    torch.testing.assert_close(again, got[perm], rtol=0, atol=0)
    # a support smaller than k pads its columns, as the reference
    small = knn_cuda.knn_pallas(torch.from_numpy(support[:5]),
                                torch.from_numpy(query[:40]), 16)
    ref_small = np.asarray(ref_knn_pallas(
        jnp.asarray(support[:5]), jnp.asarray(query[:40]), 16))
    assert_same_sets(support[:5], query[:40], small.numpy(), ref_small)
