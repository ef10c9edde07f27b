"""Port sorted scatter (pointunet_tpu_torch/ops/scatter_sorted.py) against
the reference and the exact scatter.

The CUDA kernel cannot run here; its plain version walks the same tiles
and windows, so a window that missed a contribution would drop it here as
well. Tolerances:

* cells: bit-equal (integer results of the same f32 operations);
* plain scatter vs f64 ``index_add_``: max error <= 1e-6 x max |exact|,
  the rounding of f32 sums of up to a few dozen terms in another order;
* ``sorted_gather``'s forward: bit-equal to ``jnp.take`` (a copy);
  its gradient vs ``jax.vjp`` of the reference (XLA's scatter on the
  CPU): the same 1e-6 relative bound, for the same reason;
* ``gradcheck`` in f64 at its default tolerances (atol 1e-5, rtol 1e-3),
  which the f32 accumulation of the planned path meets by ~100x;
* bf16 ct against ``ct.float()`` through the same plan, and ct read
  through the query permutation against the permuted copy: bit-equal
  (the same f32 values summed in the same order);
* ``sorted_gather``'s bf16 gradient against the reference's VJP on the
  same (bf16-representable) values in f32, rounded to bf16: within one
  bf16 ulp (both are f32 sums, in other orders, rounded once to bf16, as
  the reference's TPU kernel path does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointunet_tpu.ops.knn_window import _grid_resolution as jax_grid_resolution
from pointunet_tpu.ops.scatter_sorted import (
    S_TILE as JAX_S_TILE,
    _cells_at_level as jax_cells_at_level,
    sorted_gather as jax_sorted_gather,
)
from pointunet_tpu_torch.ops import pyramid as tpyr
from pointunet_tpu_torch.ops import scatter_sorted as ss
from pointunet_tpu_torch.ops.knn_cuda import cell_prefix_sums
from pointunet_tpu_torch.ops.knn_window import _grid_resolution
from torch_parity import voxel_block

torch.set_num_threads(1)

REL = 1e-6


def _sorted_contract_cloud(rng, n, k, clustered=False):
    """A cell-sorted cloud and, per query, k rows drawn from its 27-cell
    window: the invariant the windowed search guarantees (the idea of
    tests/test_scatter_sorted.py). Returns (pts, cell ids, idx (n, k),
    lo, span, r0), numpy."""
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    if clustered:
        m = n // 3
        pts[:m] = 0.5 + rng.standard_normal((m, 3)).astype(np.float32) * 0.02
        pts = np.clip(pts, 0.0, 1.0)
    r0 = _grid_resolution(n, 1.8)
    lo = pts.min(0)
    span = np.maximum(pts.max(0) - lo, 1e-6)
    c3 = np.clip(np.floor((pts - lo) / span * r0).astype(np.int32), 0, r0 - 1)
    ids = (c3[:, 0] * r0 + c3[:, 1]) * r0 + c3[:, 2]
    order = np.argsort(ids, kind="stable")
    pts, c3, ids = pts[order], c3[order], ids[order]
    starts = np.searchsorted(ids, np.arange(r0 ** 3 + 1))
    idx = np.zeros((n, k), np.int64)
    for q in range(n):
        cx, cy, cz = c3[q]
        z0, z1 = max(cz - 1, 0), min(cz + 1, r0 - 1)
        cand = np.concatenate([
            np.arange(starts[base + z0], starts[base + z1 + 1])
            for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            if 0 <= cx + dx < r0 and 0 <= cy + dy < r0
            for base in [((cx + dx) * r0 + cy + dy) * r0]
        ])
        idx[q] = rng.choice(cand, size=k, replace=True)
    return pts, ids, idx, lo, span, r0


def _exact(idx, ct, ns):
    ct = torch.as_tensor(np.asarray(ct)).double().reshape(-1, ct.shape[-1])
    idx = torch.as_tensor(np.asarray(idx)).long().reshape(-1)
    return torch.zeros(ns, ct.shape[1], dtype=torch.float64).index_add_(0, idx, ct)


def _assert_close(got, want):
    got = torch.as_tensor(np.array(got)).double()
    want = torch.as_tensor(np.array(want)).double()
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= REL * float(want.abs().max()), err


@pytest.fixture
def planned_everywhere(monkeypatch):
    """Lower the size gate so that small synthetic clouds take the planned
    path; valid only because their indices obey the 27-cell window."""
    monkeypatch.setattr(ss, "MIN_ROWS", 0)
    monkeypatch.setattr(ss, "GRID_THRESHOLD", 0)
    calls = []
    plain = ss.scatter_sorted_plain

    def spy(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(ss, "scatter_sorted_plain", spy)
    return calls


def test_cells_at_level_matches_reference_and_pyramid(rng, monkeypatch):
    xyz = voxel_block((32, 32, 24), rng)
    n = xyz.shape[0]
    r0 = _grid_resolution(n, 1.8)
    assert r0 == jax_grid_resolution(n, 1.8)
    lo = xyz.min(0)
    span = np.maximum(xyz.max(0) - lo, 1e-6)
    # the pyramid's own cells at levels 0-2: lower its threshold so that
    # all three levels take the cell-window search, and capture the
    # support cells each self search was given
    monkeypatch.setattr(tpyr, "GRID_THRESHOLD", 1000)
    seen = []
    search = tpyr._search_sorted

    def record(sp, s_ids, qp, qc3, k, r):
        if k > 1:
            seen.append((sp, s_ids, r))
        return search(sp, s_ids, qp, qc3, k, r)

    monkeypatch.setattr(tpyr, "_search_sorted", record)
    tpyr.build_pyramid(torch.from_numpy(xyz), 16, (4, 4, 4, 4, 2))
    assert len(seen) == 3
    for level, (sp, s_ids, r) in enumerate(seen):
        got, r_got = ss._cells_at_level(
            sp, torch.from_numpy(lo), torch.from_numpy(span), r0, level
        )
        want, r_want = jax_cells_at_level(
            jnp.asarray(sp.numpy()), jnp.asarray(lo), jnp.asarray(span), r0,
            level,
        )
        assert r_got == r_want == r
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), s_ids.numpy())


@pytest.mark.parametrize("clustered", [False, True])
def test_plain_scatter_matches_exact(rng, clustered):
    n, k, c = 4096, 8, 5
    pts, ids, idx, lo, span, r0 = _sorted_contract_cloud(rng, n, k, clustered)
    ct = rng.standard_normal((n * k, c)).astype(np.float32)
    got = ss.scatter_sorted(
        torch.from_numpy(ct), torch.from_numpy(idx.reshape(-1).astype(np.int32)),
        torch.from_numpy(ids.astype(np.int32)),
        cell_prefix_sums(torch.from_numpy(ids), r0), k, r0,
    )
    assert got.dtype == torch.float32
    _assert_close(got, _exact(idx, ct, n))


def test_plain_scatter_drops_rows_outside_the_windows(rng):
    """The plan reads only the 27-cell windows: an index outside them is
    not summed (why the gate keeps brute-force levels off this path)."""
    n, k, c = 2048, 4, 3
    pts, ids, idx, lo, span, r0 = _sorted_contract_cloud(rng, n, k)
    far = int(np.argmax(ids))                 # a row of the last cell
    idx[0, 0] = far                           # query 0 lies in cell ids[0]
    ct = np.ones((n * k, c), np.float32)
    got = ss.scatter_sorted_plain(
        torch.from_numpy(ct), torch.from_numpy(idx.reshape(-1).astype(np.int32)),
        torch.from_numpy(ids.astype(np.int32)),
        cell_prefix_sums(torch.from_numpy(ids), r0), k, r0,
    )
    want = _exact(idx, ct, n)
    assert float(want[far, 0] - got[far, 0]) == 1.0


@pytest.mark.parametrize("clustered", [False, True])
def test_scatter_add_sorted_unsorted_queries(rng, clustered):
    """The pool gather: queries are a subset in another order; the scatter
    re-sorts them by their cell at the support's grid."""
    n, k, c = 4096, 8, 6
    pts, ids, idx, lo, span, r0 = _sorted_contract_cloud(rng, n, k, clustered)
    keep = rng.permutation(n)[: n // 4]       # queries in a shuffled order
    ct = rng.standard_normal((len(keep), k, c)).astype(np.float32)
    got = ss.scatter_add_sorted(
        torch.from_numpy(ct), torch.from_numpy(idx[keep]),
        torch.from_numpy(pts), torch.from_numpy(pts[keep]),
        torch.from_numpy(lo), torch.from_numpy(span), r0, 0,
        query_sorted=False,
    )
    _assert_close(got, _exact(idx[keep], ct, n))


@pytest.mark.parametrize("query_sorted", [True, False])
def test_sorted_gather_matches_reference(rng, planned_everywhere, query_sorted):
    n, k, c = 2048, 8, 5
    pts, ids, idx, lo, span, r0 = _sorted_contract_cloud(rng, n, k)
    q = np.arange(n) if query_sorted else rng.permutation(n)[: n // 2]
    table = rng.standard_normal((n, c)).astype(np.float32)
    ct = rng.standard_normal((len(q), k, c)).astype(np.float32)

    out, vjp = jax.vjp(
        lambda t: jax_sorted_gather(
            t, jnp.asarray(idx[q], jnp.int32), jnp.asarray(pts),
            jnp.asarray(pts[q]), jnp.asarray(lo), jnp.asarray(span), r0, 0,
            query_sorted,
        ),
        jnp.asarray(table),
    )
    want_grad = vjp(jnp.asarray(ct))[0]

    t = torch.from_numpy(table).requires_grad_(True)
    got = ss.sorted_gather(
        t, torch.from_numpy(idx[q]), torch.from_numpy(pts),
        torch.from_numpy(pts[q]), torch.from_numpy(lo),
        torch.from_numpy(span), r0, 0, query_sorted,
    )
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.from_numpy(ct))
    assert len(planned_everywhere) == 1       # the planned path ran
    _assert_close(t.grad, want_grad)


def test_sorted_gather_gate_takes_index_add_below_it(rng, monkeypatch):
    calls = []
    monkeypatch.setattr(
        ss, "scatter_sorted_plain", lambda *a: calls.append(a) or None
    )
    n, k, c = 512, 4, 3
    pts, ids, idx, lo, span, r0 = _sorted_contract_cloud(rng, n, k)
    t = torch.zeros(n, c, requires_grad=True)
    out = ss.sorted_gather(
        t, torch.from_numpy(idx), torch.from_numpy(pts), torch.from_numpy(pts),
        torch.from_numpy(lo), torch.from_numpy(span), r0, 0,
    )
    ct = torch.from_numpy(rng.standard_normal((n, k, c)).astype(np.float32))
    out.backward(ct)
    assert calls == []
    _assert_close(t.grad, _exact(idx, ct.numpy(), n))


@pytest.mark.parametrize("planned", [True, False])
def test_sorted_gather_gradcheck(rng, monkeypatch, planned):
    if planned:
        monkeypatch.setattr(ss, "MIN_ROWS", 0)
        monkeypatch.setattr(ss, "GRID_THRESHOLD", 0)
    n, k, c = 96, 4, 2
    pts, ids, idx, lo, span, r0 = _sorted_contract_cloud(rng, n, k)
    args = tuple(torch.from_numpy(a) for a in (idx, pts, pts, lo, span))
    table = torch.from_numpy(rng.standard_normal((n, c))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda t: ss.sorted_gather(t, *args, r0, 0), (table,)
    )


def test_wrapper_plain_on_cpu_and_never_falls_back_elsewhere(rng):
    n, k, c = 256, 4, 3
    pts, ids, idx, lo, span, r0 = _sorted_contract_cloud(rng, n, k)
    ct = torch.ones(n * k, c)
    i32 = torch.from_numpy(idx.reshape(-1).astype(np.int32))
    s_ids = torch.from_numpy(ids.astype(np.int32))
    qcs = cell_prefix_sums(s_ids, r0)
    before = ss.LAUNCHES
    out = ss.scatter_sorted(ct, i32, s_ids, qcs, k, r0)
    assert out.shape == (n, c) and ss.LAUNCHES == before
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ss.scatter_sorted(ct.to("meta"), i32, s_ids, qcs, k, r0)
    assert ss.LAUNCHES == before


def test_tile_is_the_reference_tile():
    """The plan's tiles are the TPU kernel's: 128 sorted support rows."""
    assert ss.S_TILE == JAX_S_TILE == 128


def _plan_inputs(rng, n, k, c, clustered=False):
    pts, ids, idx, lo, span, r0 = _sorted_contract_cloud(rng, n, k, clustered)
    s_ids = torch.from_numpy(ids.astype(np.int32))
    return (pts, ids, idx, torch.from_numpy(idx.reshape(-1).astype(np.int32)),
            s_ids, cell_prefix_sums(s_ids, r0), r0)


@pytest.mark.parametrize("clustered", [False, True])
def test_bf16_ct_sums_as_its_f32_copy(rng, clustered):
    """ct is read in its own type and widened: bf16 ct gives the bits of
    ``ct.float()`` through the same plan, and both equal the exact
    scatter of those values."""
    n, k, c = 4096, 8, 6
    pts, ids, idx, i32, s_ids, qcs, r0 = _plan_inputs(rng, n, k, c, clustered)
    ct = torch.from_numpy(
        rng.standard_normal((n * k, c)).astype(np.float32)).bfloat16()
    got = ss.scatter_sorted(ct, i32, s_ids, qcs, k, r0)
    assert got.dtype == torch.float32
    assert torch.equal(got, ss.scatter_sorted(ct.float(), i32, s_ids, qcs,
                                              k, r0))
    _assert_close(got, _exact(idx, ct.float().numpy(), n))


@pytest.mark.parametrize("clustered", [False, True])
def test_permuted_read_equals_the_materialised_copy(rng, clustered):
    """The pool gather's ct is read through the query permutation
    (``q_perm``) instead of being copied in sorted order: the same bits."""
    n, k, c = 4096, 8, 5
    pts, ids, idx, i32, s_ids, qcs, r0 = _plan_inputs(rng, n, k, c, clustered)
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    # ct in the queries' own order: row q of ct is sorted query perm^-1[q]
    ct_sorted = torch.from_numpy(
        rng.standard_normal((n, k, c)).astype(np.float32))
    ct_own = torch.empty_like(ct_sorted)
    ct_own[perm.long()] = ct_sorted
    got = ss.scatter_sorted_plain(ct_own.reshape(-1, c), i32, s_ids, qcs, k,
                                  r0, perm)
    want = ss.scatter_sorted_plain(ct_sorted.reshape(-1, c), i32, s_ids, qcs,
                                   k, r0)
    assert torch.equal(got, want)


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("query_sorted", [True, False])
def test_sorted_gather_bf16_grad_matches_reference(rng, planned_everywhere,
                                                   query_sorted):
    n, k, c = 2048, 8, 5
    pts, ids, idx, lo, span, r0 = _sorted_contract_cloud(rng, n, k)
    q = np.arange(n) if query_sorted else rng.permutation(n)[: n // 2]
    table = torch.from_numpy(
        rng.standard_normal((n, c)).astype(np.float32)).bfloat16()
    ct = torch.from_numpy(
        rng.standard_normal((len(q), k, c)).astype(np.float32)).bfloat16()

    _, vjp = jax.vjp(
        lambda t: jax_sorted_gather(
            t, jnp.asarray(idx[q], jnp.int32), jnp.asarray(pts),
            jnp.asarray(pts[q]), jnp.asarray(lo), jnp.asarray(span), r0, 0,
            query_sorted,
        ),
        jnp.asarray(table.float().numpy()),
    )
    want = torch.from_numpy(np.asarray(
        vjp(jnp.asarray(ct.float().numpy()))[0])).bfloat16().float().numpy()

    t = table.clone().requires_grad_(True)
    got = ss.sorted_gather(
        t, torch.from_numpy(idx[q]), torch.from_numpy(pts),
        torch.from_numpy(pts[q]), torch.from_numpy(lo),
        torch.from_numpy(span), r0, 0, query_sorted,
    )
    got.backward(ct)
    assert len(planned_everywhere) == 1       # the planned path ran
    assert t.grad.dtype == torch.bfloat16
    g = t.grad.float().numpy()
    assert (np.abs(g - want) <= _bf16_ulp(np.maximum(np.abs(g),
                                                     np.abs(want)))).all()
