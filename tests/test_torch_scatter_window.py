"""Port windowed scatter (pointunet_tpu_torch/ops/scatter_window.py) against
the reference's Pallas kernel in interpret mode and the exact scatter.

The CUDA kernel cannot run here; its plain version walks the same tiles
and windows, and chip_smoke.py holds the kernel to it on the card. The
windows decide the result (a contribution outside every window of its
tile is dropped), so the plan must equal the reference's bit for bit.
Tolerances:

* window sizing, sorts, starts and thresholds: equal (integers);
* plain vs the reference kernel (a one-hot matmul at HIGHEST, ~1e-6 of
  the exact sum): max error <= 1e-6 x max |reference|, at the reference's
  window size and at a window cut to a sixteenth of it, on a uniform cloud
  and on one with a dense cluster. Where the windows are too short for
  the density (the cut windows; the cluster, whose density is far
  above the mean the windows are sized from) rows are dropped, and both
  must drop the same ones;
* plain vs the f64 ``index_add_``: the same 1e-6 relative bound (f32
  sums of a few dozen terms in another order);
* ``window_owner_plain`` (the kernel's owner pass: a flat row's sorted
  position when the row lies in an unthresholded window of that
  position's tile, else -1): the rows it keeps are the rows the
  thresholded windows keep, exactly (counts with ct = 1 are equal
  integers), and ``ct`` summed by owner with ``index_add_`` is within
  1e-6 x max |exact| of the plain version and of the reference kernel;
* ``windowed_gather``: forward equal to ``index_select``; backward (on
  the CPU always ``index_add_``) equal to ``index_add_``'s gradient.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointunet_tpu.ops import scatter_window as ref
from pointunet_tpu_torch.ops import scatter_window as sw
from pointunet_tpu_torch.ops.knn import knn
from pointunet_tpu_torch.ops.knn_window import _grid_resolution
from torch_parity import voxel_block

torch.set_num_threads(1)

REL = 1e-6


@pytest.fixture
def interpret(monkeypatch):
    """The reference's kernel in interpret mode, re-jitted so that the
    patched ``pallas_call`` is traced."""
    monkeypatch.setattr(
        ref.pl, "pallas_call",
        functools.partial(ref.pl.pallas_call, interpret=True),
    )
    monkeypatch.setattr(
        ref, "_windowed_scatter_impl",
        jax.jit(ref._windowed_scatter_impl.__wrapped__, static_argnames=(
            "n_support", "k", "resolution", "wqk", "c_pad")),
    )


def _cloud(rng, n, clustered):
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    if clustered:
        m = n // 3
        pts[:m] = np.clip(
            0.5 + rng.standard_normal((m, 3)).astype(np.float32) * 0.03,
            0.0, 1.0,
        )
    return pts


def _case(rng, n, k, c, clustered):
    pts = _cloud(rng, n, clustered)
    idx = knn(torch.from_numpy(pts), torch.from_numpy(pts), k).numpy()
    ct = rng.standard_normal((n, k, c)).astype(np.float32)
    return pts, idx.astype(np.int32), ct


def _exact(idx, ct, ns):
    c = ct.shape[-1]
    return torch.zeros(ns, c, dtype=torch.float64).index_add_(
        0, torch.from_numpy(idx.reshape(-1)).long(),
        torch.from_numpy(ct.reshape(-1, c)).double(),
    )


def _assert_close(got, want):
    got = torch.as_tensor(np.array(got)).double()
    want = torch.as_tensor(np.array(want)).double()
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= REL * float(want.abs().max()), err


@pytest.mark.parametrize("ns,nq,k", [
    (3000, 3000, 8), (365_000, 365_000, 16), (91_250, 22_812, 16), (500, 40, 4),
])
def test_reverse_window_rows_match_reference(ns, nq, k):
    r = _grid_resolution(ns, 1.8)
    assert sw._reverse_window_rows(ns, nq, k, r) == ref._reverse_window_rows(
        ns, nq, k, r)


@pytest.mark.parametrize("clustered", [False, True])
@pytest.mark.parametrize("window", ["reference", "cut"])
def test_plain_matches_reference_kernel(rng, interpret, clustered, window):
    n, k, c = 3000, 8, 4
    pts, idx, ct = _case(rng, n, k, c, clustered)
    r = _grid_resolution(n, 1.8)
    wqk = ref._reverse_window_rows(n, n, k, r)
    if window == "cut":                           # rows get dropped
        wqk = wqk // 16 // 128 * 128 + 128
    want = ref._windowed_scatter_impl(
        jnp.asarray(ct.reshape(n * k, c)), jnp.asarray(idx.reshape(-1)),
        jnp.asarray(pts), jnp.asarray(pts), n_support=n, k=k, resolution=r,
        wqk=wqk, c_pad=-(-c // 8) * 8 + 8,
    )
    t = torch.from_numpy
    plan = sw._plan(t(ct), t(idx), t(pts), t(pts), r, wqk)
    got = sw.windowed_scatter(plan, n)[plan.inv.long()]
    _assert_close(got, want)
    exact = _exact(idx, ct, n)
    dropped = float((exact - got.double()).abs().max())
    if window == "cut" or clustered:
        assert dropped > 1e-3                     # the windows decided
    else:
        assert dropped <= REL * float(exact.abs().max())


@pytest.mark.parametrize("clustered", [False, True])
@pytest.mark.parametrize("window", ["reference", "cut"])
def test_owner_sum_matches_windows(rng, interpret, clustered, window):
    """The union-of-windows equivalence the kernel's one pass relies on,
    on the cases of ``test_plain_matches_reference_kernel``."""
    n, k, c = 3000, 8, 4
    pts, idx, ct = _case(rng, n, k, c, clustered)
    r = _grid_resolution(n, 1.8)
    wqk = ref._reverse_window_rows(n, n, k, r)
    if window == "cut":
        wqk = wqk // 16 // 128 * 128 + 128
    t = torch.from_numpy
    plan = sw._plan(t(ct), t(idx), t(pts), t(pts), r, wqk)
    owner = sw.window_owner_plain(plan, n)
    kept = owner >= 0
    if window == "cut" or clustered:
        assert not kept.all()                     # the windows decided
    # the same rows: counts of kept rows per owner, exact integers
    ones = sw.Plan(torch.ones_like(plan.ct[:, :1]), *plan[1:])
    counts = torch.bincount(owner[kept], minlength=n).float()
    assert torch.equal(sw.windowed_scatter_plain(ones, n)[:, 0], counts)
    got = torch.zeros((n, c)).index_add_(0, owner[kept], plan.ct[kept])
    _assert_close(got, sw.windowed_scatter_plain(plan, n))
    want = ref._windowed_scatter_impl(
        jnp.asarray(ct.reshape(n * k, c)), jnp.asarray(idx.reshape(-1)),
        jnp.asarray(pts), jnp.asarray(pts), n_support=n, k=k, resolution=r,
        wqk=wqk, c_pad=-(-c // 8) * 8 + 8,
    )
    _assert_close(got[plan.inv.long()], want)


def test_owner_drops_ids_out_of_range(rng):
    n, k, c = 600, 4, 2
    pts, idx, ct = _case(rng, n, k, c, False)
    idx[0, 0], idx[1, 1] = -1, n
    t = torch.from_numpy
    r = _grid_resolution(n, 1.8)
    plan = sw._plan(t(ct), t(idx), t(pts), t(pts), r,
                    sw._reverse_window_rows(n, n, k, r))
    owner = sw.window_owner_plain(plan, n)
    bad = (plan.idx < 0) | (plan.idx >= n)
    assert int(bad.sum()) == 2 and bool((owner[bad] == -1).all())
    kept = owner >= 0
    got = torch.zeros((n, c)).index_add_(0, owner[kept], plan.ct[kept])
    _assert_close(got, sw.windowed_scatter_plain(plan, n))


@pytest.mark.parametrize("cloud", ["uniform", "voxels"])
def test_windowed_scatter_add_matches_exact(rng, cloud):
    """Queries a subset of the support in another order (a pool gather),
    on clouds whose density the windows' slack covers: uniform points and
    every voxel of a block (the pipeline's voxel-cloud contract)."""
    k, c = 8, 5
    if cloud == "uniform":
        pts = _cloud(rng, 4000, False)
    else:
        pts = voxel_block((16, 16, 16), rng)
    n = len(pts)
    q = rng.permutation(n)[: n // 3]
    idx = knn(torch.from_numpy(pts), torch.from_numpy(pts[q]), k).numpy()
    ct = rng.standard_normal((len(q), k, c)).astype(np.float32)
    got = sw.windowed_scatter_add(
        torch.from_numpy(ct), torch.from_numpy(idx), torch.from_numpy(pts),
        torch.from_numpy(pts[q]), n,
    )
    assert got.dtype == torch.float32 and got.shape == (n, c)
    _assert_close(got, _exact(idx, ct, n))


def test_plan_drops_indices_outside_the_windows(rng):
    """A neighbour far from its query lies outside every window of its
    tile: the plan drops it, as the reference's does."""
    n, k, c = 2000, 4, 3
    pts, idx, _ = _case(rng, n, k, c, False)
    far = int(np.argmax(pts.sum(1)))
    near = int(np.argmin(pts.sum(1)))
    idx[near, 0] = far
    ct = np.ones((n, k, c), np.float32)
    got = sw.windowed_scatter_add(
        torch.from_numpy(ct), torch.from_numpy(idx), torch.from_numpy(pts),
        torch.from_numpy(pts), n,
    )
    exact = _exact(idx, ct, n)
    assert float(exact[far, 0] - got[far, 0]) == 1.0


def test_windowed_gather_forward_and_backward(rng, monkeypatch):
    n, k, c = 1500, 8, 4
    pts, idx, ct = _case(rng, n, k, c, False)
    table = torch.from_numpy(
        rng.standard_normal((n, c)).astype(np.float32)).requires_grad_(True)
    args = (torch.from_numpy(idx), torch.from_numpy(pts),
            torch.from_numpy(pts))
    # the kernel's gate is CUDA tensors: on the CPU the backward is
    # index_add_ even with the variable set and the size gate lowered
    monkeypatch.setenv("POINTUNET_WINDOWED_SCATTER", "1")
    monkeypatch.setattr(sw, "MIN_ROWS", 0)
    calls = []
    monkeypatch.setattr(sw, "windowed_scatter_add",
                        lambda *a: calls.append(a))
    out = sw.windowed_gather(table, *args)
    want = table.detach().index_select(
        0, torch.from_numpy(idx.reshape(-1)).long()).reshape(n, k, c)
    assert torch.equal(out.detach(), want)
    out.backward(torch.from_numpy(ct))
    assert calls == []
    _assert_close(table.grad, _exact(idx, ct, n))


def test_wrapper_plain_on_cpu_and_never_falls_back_elsewhere(rng):
    n, k, c = 600, 4, 3
    pts, idx, ct = _case(rng, n, k, c, False)
    t = torch.from_numpy
    r = _grid_resolution(n, 1.8)
    plan = sw._plan(t(ct), t(idx), t(pts), t(pts), r,
                    sw._reverse_window_rows(n, n, k, r))
    before = sw.LAUNCHES
    assert sw.windowed_scatter(plan, n).shape == (n, c)
    assert sw.LAUNCHES == before
    meta = sw.Plan(*(a.to("meta") if torch.is_tensor(a) else a for a in plan))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        sw.windowed_scatter(meta, n)
    assert sw.LAUNCHES == before
