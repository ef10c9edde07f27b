"""Port pyramid (pointunet_tpu_torch/ops/pyramid.py) against the reference.

The integer bookkeeping is compared bit for bit: ``order``, the per-level
cell-sorted xyz (which are the decimated subsets). Neighbour indices are
compared by tie-aware recall against exact KNN. At 24,576 points level 0
runs the port's cell-window search (the kernel's plain version on the
CPU) while the reference's CPU path runs its own approximate XLA search,
so the port is held against exact KNN, not against the reference's
indices: the self search must be exact, and the 1-NN up search, whose
27 cells can miss a kept point more than a cell away after the random
decimation, must recall at least what the reference's Pallas kernel
(TPU interpret mode) recalls on the same sorted inputs.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pointunet_tpu.ops.knn_pallas import knn_pallas_core
from pointunet_tpu.ops.knn_window import _round_up
from pointunet_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from pointunet_tpu_torch.ops import knn_cuda, pyramid as tpyr
from torch_parity import tie_aware_recall, voxel_block

torch.set_num_threads(1)

K = 16
RATIOS = (4, 4, 4, 4, 2)


def _cloud(kind, rng):
    """uniform_4096: every level searches exactly. voxels_24576: every
    voxel of a (32, 32, 24) block, shuffled, so the decimation is random;
    level 0 runs the cell-window search."""
    if kind == "uniform_4096":
        return rng.uniform(0, 1, (4096, 3)).astype(np.float32)
    return voxel_block((32, 32, 24), rng)


def _pallas_recall(sp, s_ids, qp, qc3, k, r):
    """Tie-aware recall of the reference's Pallas kernel (interpret mode)
    on one of the port's sorted searches, with the window sizing of the
    reference pyramid's TPU path (pointunet_tpu/ops/pyramid.py
    ``_search_sorted``)."""
    sp, qp = sp.numpy(), qp.numpy()
    s_ids = s_ids.numpy().astype(np.int32)
    qc = qc3.numpy().astype(np.int32)
    sc = np.stack([s_ids // (r * r), (s_ids // r) % r, s_ids % r], 1)
    q_ids = ((qc[:, 0] * r + qc[:, 1]) * r + qc[:, 2]).astype(np.int32)
    cell_start = knn_cuda.cell_prefix_sums(torch.from_numpy(s_ids), r).numpy()
    ns, nq = len(sp), len(qp)
    tile = min(128, max(_round_up(nq, 8), 8))
    exp_rows = tile * (ns / nq) + 2.0 * ns / r ** 3 + 64.0
    window = 1 << max(7, math.ceil(math.log2(max(4.0 * exp_rows, 128))))
    window = min(window, 1 << math.ceil(math.log2(max(ns, 128))))
    with pltpu.force_tpu_interpret_mode():
        ref = knn_pallas_core(
            jnp.asarray(sp), jnp.asarray(sc.astype(np.int32)),
            jnp.asarray(cell_start), jnp.asarray(qp), jnp.asarray(qc),
            jnp.asarray(q_ids), k, r, tile, window,
        )
    return tie_aware_recall(sp, qp, k, np.asarray(ref))


@pytest.mark.parametrize("kind", ["uniform_4096", "voxels_24576"])
def test_pyramid_matches_reference(rng, kind, monkeypatch):
    xyz = _cloud(kind, rng)
    searches = []
    search = tpyr._search_sorted
    monkeypatch.setattr(
        tpyr, "_search_sorted",
        lambda *a: searches.append(a) or search(*a),
    )
    ref = jax_build_pyramid(jnp.asarray(xyz), K, RATIOS)
    got = tpyr.build_pyramid(torch.from_numpy(xyz), K, RATIOS)
    # level 0 of the larger cloud goes through the cell-window search
    assert [a[4] for a in searches] == (
        [] if kind == "uniform_4096" else [K, 1]
    )

    np.testing.assert_array_equal(got.order.numpy(), np.asarray(ref.order))
    assert got.order.dtype == torch.int32
    assert len(got.xyz) == len(ref.xyz) == len(RATIOS) + 1
    for a, b in zip(got.xyz, ref.xyz):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for i in range(len(RATIOS)):
        x, sub = got.xyz[i].numpy(), got.xyz[i + 1].numpy()
        for name, idx, shape in (
            ("neigh", got.neigh_idx[i], ref.neigh_idx[i].shape),
            ("sub", got.sub_idx[i], ref.sub_idx[i].shape),
            ("interp", got.interp_idx[i], ref.interp_idx[i].shape),
        ):
            assert tuple(idx.shape) == tuple(shape), (name, i)
            assert idx.dtype == torch.int32, (name, i)
        assert tie_aware_recall(x, x, K, got.neigh_idx[i]) == 1.0
        assert tie_aware_recall(x, sub, K, got.sub_idx[i]) == 1.0
        up = tie_aware_recall(sub, x, 1, got.interp_idx[i])
        if i == 0 and searches:
            # measured: 2-3 misses of 24,576 queries, the same as the
            # reference's kernel
            pallas = _pallas_recall(*searches[1])
            assert up >= pallas and up >= 0.9995, (up, pallas)
        else:
            assert up == 1.0


def test_pyramid_batch_and_take_level0(rng):
    xyz = rng.uniform(0, 1, (2, 1024, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 1024, 4)).astype(np.float32)
    pyr = tpyr.build_pyramid_batch(torch.from_numpy(xyz), K, RATIOS)
    assert pyr.order.shape == (2, 1024)
    assert [tuple(a.shape) for a in pyr.neigh_idx] == [
        (2, n, K) for n in (1024, 256, 64, 16, 4)
    ]
    one = tpyr.build_pyramid(torch.from_numpy(xyz[1]), K, RATIOS)
    for a, b in zip(pyr.interp_idx, one.interp_idx):
        np.testing.assert_array_equal(a[1].numpy(), b.numpy())
    sorted_feats = tpyr.take_level0(pyr, torch.from_numpy(feats))
    for b in range(2):
        np.testing.assert_array_equal(
            sorted_feats[b].numpy(), feats[b][pyr.order[b].numpy()]
        )
        np.testing.assert_array_equal(
            tpyr.take_level0(pyr, torch.from_numpy(xyz))[b].numpy(),
            pyr.xyz[0][b].numpy(),
        )


def test_pyramid_rejects_too_few_points():
    with pytest.raises(ValueError, match="empties the pyramid"):
        tpyr.build_pyramid(torch.rand(100, 3), K, RATIOS)


def test_level_resolutions_match_reference():
    from pointunet_tpu.ops.pyramid import _level_resolutions as ref

    for r0 in (2, 17, 40, 41):
        assert tpyr._level_resolutions(r0, 5) == ref(r0, 5)
    assert K in knn_cuda.KERNEL_KS and 1 in knn_cuda.KERNEL_KS
