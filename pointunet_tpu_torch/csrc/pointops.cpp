// Host-side native point ops: KD-tree KNN + grid subsampling.
//
// TPU-native framework note: the DEVICE compute path does KNN on-chip
// (pointunet_tpu/ops/knn.py). This library serves the HOST data-prep role
// the reference filled with nanoflann + a Cython binding
// (reference PointSegment/utils/nearest_neighbors/knn_.cxx,
// cpp_wrappers/cpp_subsampling/grid_subsampling.cpp): offline tools,
// projection indices, CPU fallbacks. Exposed through ctypes (no pybind11
// in this image); see pointunet_tpu/native.py.
//
// Build: make -C csrc   (g++ -O3 -fopenmp -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ----------------------------------------------------------------------
// KD-tree (3-D, median split, iterative heap-based query)
// ----------------------------------------------------------------------

struct KDTree {
  // nodes laid out as an implicit structure over a permutation of points
  const float* pts;  // (n, 3)
  std::vector<int> index;     // permutation: subtree ranges are contiguous
  std::vector<int> split_dim; // per subtree root position
  int n;

  KDTree(const float* pts_, int n_) : pts(pts_), n(n_) {
    index.resize(n);
    for (int i = 0; i < n; ++i) index[i] = i;
    split_dim.assign(n, 0);
    build(0, n);
  }

  void build(int lo, int hi) {
    if (hi - lo <= 1) return;
    // pick dim with max spread
    float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = lo; i < hi; ++i) {
      const float* p = pts + 3 * index[i];
      for (int d = 0; d < 3; ++d) {
        mn[d] = std::min(mn[d], p[d]);
        mx[d] = std::max(mx[d], p[d]);
      }
    }
    int dim = 0;
    float spread = -1.0f;
    for (int d = 0; d < 3; ++d)
      if (mx[d] - mn[d] > spread) { spread = mx[d] - mn[d]; dim = d; }
    int mid = (lo + hi) / 2;
    std::nth_element(
        index.begin() + lo, index.begin() + mid, index.begin() + hi,
        [&](int a, int b) { return pts[3 * a + dim] < pts[3 * b + dim]; });
    split_dim[mid] = dim;
    build(lo, mid);
    build(mid + 1, hi);
  }

  // max-heap of (dist2, idx) with capacity k
  void query(const float* q, int k,
             std::priority_queue<std::pair<float, int>>& heap) const {
    search(0, n, q, k, heap);
  }

  void search(int lo, int hi, const float* q, int k,
              std::priority_queue<std::pair<float, int>>& heap) const {
    if (hi <= lo) return;
    if (hi - lo <= 32) {  // leaf: linear scan
      for (int i = lo; i < hi; ++i) {
        const float* p = pts + 3 * index[i];
        float d2 = 0;
        for (int d = 0; d < 3; ++d) {
          float diff = p[d] - q[d];
          d2 += diff * diff;
        }
        if ((int)heap.size() < k) heap.emplace(d2, index[i]);
        else if (d2 < heap.top().first) { heap.pop(); heap.emplace(d2, index[i]); }
      }
      return;
    }
    int mid = (lo + hi) / 2;
    int dim = split_dim[mid];
    const float* p = pts + 3 * index[mid];
    float d2 = 0;
    for (int d = 0; d < 3; ++d) {
      float diff = p[d] - q[d];
      d2 += diff * diff;
    }
    if ((int)heap.size() < k) heap.emplace(d2, index[mid]);
    else if (d2 < heap.top().first) { heap.pop(); heap.emplace(d2, index[mid]); }

    float delta = q[dim] - p[dim];
    int near_lo = delta < 0 ? lo : mid + 1;
    int near_hi = delta < 0 ? mid : hi;
    int far_lo = delta < 0 ? mid + 1 : lo;
    int far_hi = delta < 0 ? hi : mid;
    search(near_lo, near_hi, q, k, heap);
    if ((int)heap.size() < k || delta * delta < heap.top().first)
      search(far_lo, far_hi, q, k, heap);
  }
};

}  // namespace

extern "C" {

// KNN of queries against support; out is (nq, k) int32, sorted by distance.
// Equivalent role to cpp_knn_batch_omp (reference knn_.cxx:104-137).
void pointops_knn(const float* support, int ns, const float* query, int nq,
                  int k, int32_t* out) {
  if (ns <= 0 || nq <= 0 || k <= 0) return;
  int kk = std::min(k, ns);
  KDTree tree(support, ns);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int i = 0; i < nq; ++i) {
    std::priority_queue<std::pair<float, int>> heap;
    tree.query(query + 3 * i, kk, heap);
    int m = (int)heap.size();
    std::vector<std::pair<float, int>> items(m);
    for (int j = m - 1; j >= 0; --j) { items[j] = heap.top(); heap.pop(); }
    for (int j = 0; j < k; ++j)
      out[(size_t)i * k + j] = items[std::min(j, m - 1)].second;
  }
}

// Batched variant: support (b, ns, 3), query (b, nq, 3), out (b, nq, k).
void pointops_knn_batch(const float* support, const float* query, int b,
                        int ns, int nq, int k, int32_t* out) {
  for (int i = 0; i < b; ++i)
    pointops_knn(support + (size_t)i * ns * 3, ns,
                 query + (size_t)i * nq * 3, nq, k,
                 out + (size_t)i * nq * k);
}

// Coverage-greedy query picking + KNN (equivalent role to the reference's
// cpp_knn_batch_distance_pick, knn_.cxx:138-270): repeatedly pick a random
// point among the least-covered ones, emit it and its k nearest neighbors,
// and raise the coverage count of those neighbors so later picks spread
// over the cloud. Deterministic via an explicit seed (the reference seeded
// from time(0)). out_queries (nq, 3) f32, out_idx (nq, k) int32.
void pointops_knn_distance_pick(const float* points, int n, int nq, int k,
                                uint64_t seed, float* out_queries,
                                int32_t* out_idx) {
  if (n <= 0 || nq <= 0 || k <= 0) return;
  int kk = std::min(k, n);
  KDTree tree(points, n);
  std::vector<int> used(n, 0);
  uint64_t rng = seed ? seed : 0x9e3779b97f4a7c15ull;
  auto next_rand = [&rng]() {
    // splitmix64
    rng += 0x9e3779b97f4a7c15ull;
    uint64_t z = rng;
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  };
  std::vector<int> candidates;
  candidates.reserve(n);
  for (int q = 0; q < nq; ++q) {
    int low = *std::min_element(used.begin(), used.end());
    candidates.clear();
    for (int i = 0; i < n; ++i)
      if (used[i] == low) candidates.push_back(i);
    int pick = candidates[next_rand() % candidates.size()];

    const float* p = points + 3 * pick;
    std::priority_queue<std::pair<float, int>> heap;
    tree.query(p, kk, heap);
    int m = (int)heap.size();
    std::vector<std::pair<float, int>> items(m);
    for (int j = m - 1; j >= 0; --j) { items[j] = heap.top(); heap.pop(); }
    for (int j = 0; j < k; ++j) {
      int id = items[std::min(j, m - 1)].second;
      out_idx[(size_t)q * k + j] = id;
    }
    for (int j = 0; j < m; ++j) used[items[j].second]++;
    used[pick] += 100;  // a picked center is effectively spent
    for (int d = 0; d < 3; ++d) out_queries[3 * q + d] = p[d];
  }
}

// Batched variant: points (b, n, 3) -> queries (b, nq, 3), idx (b, nq, k).
void pointops_knn_distance_pick_batch(const float* points, int b, int n,
                                      int nq, int k, uint64_t seed,
                                      float* out_queries, int32_t* out_idx) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int i = 0; i < b; ++i)
    pointops_knn_distance_pick(
        points + (size_t)i * n * 3, n, nq, k, seed + (uint64_t)i * 1315423911u,
        out_queries + (size_t)i * nq * 3, out_idx + (size_t)i * nq * k);
}

// Grid subsampling: barycenter per occupied cell, mean features, majority
// labels (equivalent role to reference grid_subsampling.cpp:5-104).
// Returns the number of cells; call once with counts_only=1 to size
// buffers, then again to fill them.
int pointops_grid_subsample(const float* points, int n, const float* features,
                            int fdim, const int32_t* labels, int n_classes,
                            float grid_size, int counts_only,
                            float* out_points, float* out_features,
                            int32_t* out_labels) {
  if (n <= 0) return 0;
  float mn[3] = {1e30f, 1e30f, 1e30f};
  for (int i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) mn[d] = std::min(mn[d], points[3 * i + d]);

  auto cell_of = [&](const float* p) -> uint64_t {
    uint64_t c[3];
    for (int d = 0; d < 3; ++d)
      c[d] = (uint64_t)std::floor((p[d] - mn[d]) / grid_size);
    return (c[0] << 42) | (c[1] << 21) | c[2];
  };

  struct Cell {
    int count = 0;
    float psum[3] = {0, 0, 0};
    std::vector<float> fsum;
    std::vector<int> votes;
  };
  std::unordered_map<uint64_t, Cell> cells;
  cells.reserve((size_t)n / 4);
  for (int i = 0; i < n; ++i) {
    Cell& c = cells[cell_of(points + 3 * i)];
    if (c.count == 0) {
      if (features) c.fsum.assign(fdim, 0.f);
      if (labels) c.votes.assign(std::max(n_classes, 1), 0);
    }
    c.count++;
    for (int d = 0; d < 3; ++d) c.psum[d] += points[3 * i + d];
    if (features)
      for (int f = 0; f < fdim; ++f) c.fsum[f] += features[(size_t)i * fdim + f];
    if (labels) {
      int lab = labels[i];
      if (lab >= 0 && lab < n_classes) c.votes[lab]++;
    }
  }
  int m = (int)cells.size();
  if (counts_only) return m;

  int i = 0;
  for (auto& kv : cells) {
    const Cell& c = kv.second;
    for (int d = 0; d < 3; ++d) out_points[3 * i + d] = c.psum[d] / c.count;
    if (features && out_features)
      for (int f = 0; f < fdim; ++f)
        out_features[(size_t)i * fdim + f] = c.fsum[f] / c.count;
    if (labels && out_labels) {
      int best = 0;
      for (int l = 1; l < n_classes; ++l)
        if (c.votes[l] > c.votes[best]) best = l;
      out_labels[i] = best;
    }
    ++i;
  }
  return m;
}

int pointops_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
