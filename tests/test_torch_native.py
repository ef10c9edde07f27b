"""The port's native host ops (pointunet_tpu_torch/native.py, built from
its copy of csrc/pointops.cpp) on the cases of tests/test_native.py, and
grid subsampling against the reference's numpy path.

The library builds with the host's C++ compiler at the first call, so
these run wherever g++ is (``native.available()`` is False without a
compiler or a build that loads; then the module is skipped as
test_native.py skips without its build). Bars: the KNN results hold the exact neighbour sets; the
native grid subsampling, which sums in f32 and orders cells by its hash
map, gives the numpy path's cells and labels exactly and its means
within 1e-4 relative (test_native.py's bar), and on a voxel cloud
(integer coordinates, sums exact in f32) its points bit for bit; the
port's ``grid_subsample``, numpy only, is bit-equal to the reference's
numpy path.
"""
from pathlib import Path

import numpy as np
import pytest

from pointunet_tpu.ops import subsample as ref_subsample
from pointunet_tpu_torch import native
from pointunet_tpu_torch.ops import subsample

REPO = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C++ compiler to build the native ops"
)


def _brute_knn(support, query, k):
    d = ((query[:, None] - support[None]) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def _sorted_rows(*arrays):
    """Each array's rows in the lexicographic order of the first's."""
    order = np.lexsort(arrays[0].T)
    return [a[order] for a in arrays]


def test_source_is_the_reference_copy():
    assert (native.SOURCE.read_bytes()
            == (REPO / "csrc" / "pointops.cpp").read_bytes())


def test_native_knn_exact(rng):
    support = rng.uniform(0, 1, (4000, 3)).astype(np.float32)
    query = rng.uniform(0, 1, (257, 3)).astype(np.float32)
    idx = native.knn(support, query, 8)
    ref = _brute_knn(support, query, 8)
    assert idx.shape == (257, 8) and idx.dtype == np.int32
    # ties may be ordered differently: compare as sets
    assert all(set(idx[i]) == set(ref[i]) for i in range(len(query)))


def test_native_knn_batch(rng):
    support = rng.uniform(0, 1, (3, 1000, 3)).astype(np.float32)
    query = rng.uniform(0, 1, (3, 64, 3)).astype(np.float32)
    idx = native.knn_batch(support, query, 4)
    assert idx.shape == (3, 64, 4)
    for b in range(3):
        ref = _brute_knn(support[b], query[b], 4)
        assert all(set(idx[b, i]) == set(ref[i]) for i in range(64))


def test_native_knn_distance_pick(rng):
    """Picked queries are support points whose own index is in their
    neighbour row, distinct while nq << n, and deterministic per seed."""
    pts = rng.uniform(0, 1, (2, 400, 3)).astype(np.float32)
    nq, k = 24, 6
    q, idx = native.knn_batch_distance_pick(pts, nq, k, seed=7)
    assert q.shape == (2, nq, 3) and idx.shape == (2, nq, k)
    assert idx.min() >= 0 and idx.max() < 400
    for b in range(2):
        for j in range(nq):
            d = ((pts[b] - q[b, j]) ** 2).sum(-1)
            self_id = int(np.argmin(d))
            assert d[self_id] == 0.0 and self_id in idx[b, j]
        assert len({tuple(v) for v in q[b]}) == nq
    q2, idx2 = native.knn_batch_distance_pick(pts, nq, k, seed=7)
    np.testing.assert_array_equal(q, q2)
    np.testing.assert_array_equal(idx, idx2)
    q3, _ = native.knn_batch_distance_pick(pts, nq, k, seed=8)
    assert not np.array_equal(q, q3)


def test_native_points_only(rng):
    pts = rng.uniform(0, 1, (1000, 3)).astype(np.float32)
    sub = native.grid_subsample(pts, None, None, 0.2)
    assert sub.ndim == 2 and sub.shape[1] == 3 and sub.shape[0] < 1000
    np.testing.assert_allclose(
        *(_sorted_rows(sub)[0], _sorted_rows(
            ref_subsample.grid_subsample_numpy(pts, grid_size=0.2))[0]),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("grid", [0.05, 0.1])
def test_grid_subsample_native_matches_reference_numpy(rng, grid):
    """``ops/subsample.py:grid_subsample`` takes the native path here."""
    pts = rng.uniform(0, 1, (5000, 3)).astype(np.float32)
    feats = rng.standard_normal((5000, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 5000).astype(np.int32)
    got = subsample.grid_subsample(pts, feats, labels, grid)
    want = ref_subsample.grid_subsample_numpy(pts, feats, labels, grid)
    assert [a.dtype for a in got] == [a.dtype for a in want]
    assert got[0].shape == want[0].shape
    g_p, g_f, g_l = _sorted_rows(*got)
    w_p, w_f, w_l = _sorted_rows(*want)
    np.testing.assert_allclose(g_p, w_p, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_f, w_f, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(g_l, w_l)


def test_grid_subsample_native_bit_equal_on_voxels(rng):
    """Voxel coordinates: every sum is exact in f32 and each mean is one
    correctly rounded division on both paths (f64 then f32 rounds the
    same), so the cells' points are equal bit for bit."""
    vox = rng.integers(0, 40, (20000, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 20000).astype(np.int32)
    got = native.grid_subsample(vox, None, labels, 4.0)
    want = ref_subsample.grid_subsample_numpy(vox, None, labels, 4.0)
    g_p, g_l = _sorted_rows(*got)
    w_p, w_l = _sorted_rows(*want)
    np.testing.assert_array_equal(g_p, w_p)
    np.testing.assert_array_equal(g_l, w_l)


@pytest.mark.parametrize("grid", [0.05, 0.11])
def test_grid_subsample_equals_reference_numpy(rng, grid):
    pts = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    feats = rng.standard_normal((3000, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 3000).astype(np.int32)
    got = subsample.grid_subsample(pts, feats, labels, grid)
    want = ref_subsample.grid_subsample_numpy(pts, feats, labels, grid)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_unavailable_without_a_compiler(monkeypatch, rng):
    """Without a compiler ``available()`` is False and the functions
    raise, naming why; ``grid_subsample`` does not depend on it."""
    from pointunet_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "cxx", lambda: None)
    native._load.cache_clear()
    try:
        assert not native.available()
        pts = rng.uniform(0, 1, (500, 3)).astype(np.float32)
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            native.knn(pts, pts, 2)
        np.testing.assert_array_equal(
            subsample.grid_subsample(pts, grid_size=0.2),
            ref_subsample.grid_subsample_numpy(pts, grid_size=0.2))
    finally:
        native._load.cache_clear()


def test_unavailable_when_the_build_fails(tmp_path, monkeypatch):
    """A compile that fails leaves ``available()`` False, once, with the
    compiler's message, instead of raising at every call."""
    from pointunet_tpu_torch.ops import cuda_build

    fake = tmp_path / "cxx"
    fake.write_text("#!/bin/sh\necho 'internal compiler error' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    native._load.cache_clear()
    try:
        assert not native.available()
        with pytest.raises(RuntimeError, match="internal compiler error"):
            native.num_threads()
    finally:
        native._load.cache_clear()


def test_cached_library_that_does_not_load_is_passed_over(tmp_path,
                                                          monkeypatch):
    """A library under the OpenMP build's name that does not load (built
    on a host with an OpenMP runtime, copied to one without) gives way to
    the build without OpenMP, under a name of its own."""
    import ctypes

    from pointunet_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    stale = cuda_build.host_library_path(
        native.SOURCE, cuda_build.cxx(),
        cuda_build.HOST_FLAGS + ("-fopenmp",))
    stale.parent.mkdir()
    stale.write_bytes(b"not a shared library")
    so = cuda_build.build_host(native.SOURCE)
    assert so != stale and so.exists()
    lib = ctypes.CDLL(str(so))
    lib.pointops_num_threads.restype = ctypes.c_int
    assert lib.pointops_num_threads() == 1


def test_build_without_openmp(tmp_path, monkeypatch):
    """A compiler without an OpenMP runtime (``-fopenmp`` fails, as on a
    host whose g++ lacks libgomp) builds the library without it: one
    thread, the same neighbours."""
    import ctypes
    import shutil

    from pointunet_tpu_torch.ops import cuda_build

    fake = tmp_path / "cxx"
    fake.write_text(
        "#!/bin/sh\n"
        "for a in \"$@\"; do [ \"$a\" = -fopenmp ] && "
        "{ echo 'cannot read spec file libgomp.spec' >&2; exit 1; }; done\n"
        f"exec {shutil.which('g++')} \"$@\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    lib = ctypes.CDLL(str(cuda_build.build_host(native.SOURCE)))
    lib.pointops_num_threads.restype = ctypes.c_int
    assert lib.pointops_num_threads() == 1
    other = tmp_path / "other.cpp"
    other.write_text("int f() { return 0; }\n")
    monkeypatch.setattr(cuda_build, "cxx", lambda: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        cuda_build.build_host(other)
