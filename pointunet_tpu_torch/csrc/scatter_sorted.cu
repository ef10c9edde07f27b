// Sorted-contract scatter-add (the gather's gradient), for Hopper (sm_90a).
//
// Replaces pointunet_tpu/ops/scatter_sorted.py:_scatter_sorted_impl and its
// kernel body _kernel_factory, planned there by _plan. Same function:
//     grad[s, :] = sum over flat rows p with idx[p] == s of ct[p, :]
// for ct (nq * k, c) f32 cotangent rows of cell-sorted queries and idx
// (nq * k,) rows of the cell-sorted support, produced by the cell-window
// search (every neighbour of a query lies in the 27 cells around it).
//
// The plan is the TPU kernel's; its layout is not. One block owns a tile
// of S_TILE consecutive sorted support rows (and up to CB channels). The
// tile's rows lie in cells [c_lo, c_hi], so for each column offset
// off = dx * r^2 + dy * r a contribution can come only from queries in
// cells [c_lo - off - 1, c_hi - off + 1] (z rides the +-1 halo), whose
// flat rows are one contiguous range read from the query cell prefix sums.
// The 9 ranges are walked in descending off, so their starts and ends
// ascend; each start is clipped to the end already covered, so the block
// reads every flat row at most once. The TPU's 128-lane-aligned starts,
// 2048-lane chunks, packed ct^T + f32-index rows and chunk-padded
// thresholds are TPU artefacts and are not carried over.
//
// Exact and deterministic without atomics: a warp reads 32 flat rows'
// idx at a time, takes those that fall in the tile (ballot), loads only
// their ct rows (LPM lanes a row, one channel a lane) and adds them, in
// ascending flat-row order, to its own shared-memory copy of the tile.
// The block then sums its warps' copies in warp order. Which warp reads
// which flat row is fixed by the plan, so every launch on the same inputs
// gives the same bits. The plain version (ops/scatter_sorted.py,
// scatter_sorted_plain) walks the same tiles and ranges.
//
// What bounds it on the H100: bytes. The compulsory traffic is ct read
// once, idx read once and grad written once (about 66 us for the level-0
// self gather, 5.84M x 8 channels, at 3.35 TB/s). This kernel reads idx
// once per tile whose ranges cover it (about 9-14 times; idx is small and
// stays in the 50 MB L2) and each ct row once, by the one tile that owns
// its index; the per-warp add loop is latency-bound. Reading bf16 ct
// directly, TMA-staged idx and wider row groups are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // support rows a block owns
constexpr int kWarps = 4;      // warps a block
constexpr int kChannels = 32;  // channels a block (grid.y splits wider c)

template <int LPM>
__global__ void __launch_bounds__(kWarps * 32) scatter_sorted_kernel(
    const float* __restrict__ ct,            // (nqk, c)
    const int* __restrict__ idx,             // (nqk,)
    const int* __restrict__ s_ids,           // (ns,) sorted support cells
    const int* __restrict__ q_cell_start,    // (r^3 + 1,) query prefix sums
    float* __restrict__ out,                 // (ns, c)
    int ns, int c, int k, int r) {
  extern __shared__ float acc[];             // (kWarps, kTile, cb)
  const int row_lo = blockIdx.x * kTile;
  const int row_hi = min(row_lo + kTile, ns);
  const int c0 = blockIdx.y * kChannels;
  const int cb = min(kChannels, c - c0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kWarps * kTile * cb; i += blockDim.x) {
    acc[i] = 0.0f;
  }
  __syncthreads();

  float* mine = acc + warp * kTile * cb;
  constexpr int kGroups = 32 / LPM;          // ct rows a warp step adds
  const int group = lane / LPM;
  const int sub = lane % LPM;                // this lane's channel
  const long long v = static_cast<long long>(r) * r * r;
  const long long c_lo = s_ids[row_lo];
  const long long c_hi = s_ids[row_hi - 1];

  long long covered = 0;
  for (int dx = 1; dx >= -1; --dx) {
    for (int dy = 1; dy >= -1; --dy) {
      const long long off = static_cast<long long>(dx) * r * r +
                            static_cast<long long>(dy) * r;
      const long long a = min(max(c_lo - off - 1, 0LL), v);
      const long long b = min(max(c_hi - off + 2, 0LL), v);
      const long long end = static_cast<long long>(q_cell_start[b]) * k;
      const long long start =
          max(static_cast<long long>(q_cell_start[a]) * k, covered);
      covered = max(covered, end);
      for (long long p0 = start + 32LL * warp; p0 < end;
           p0 += 32LL * kWarps) {
        const long long p = p0 + lane;
        const int j = p < end ? idx[p] : -1;
        unsigned hits = __ballot_sync(0xffffffffu, j >= row_lo && j < row_hi);
        while (hits) {
          // lane group g takes the g-th lowest hit still pending
          unsigned m = hits;
          for (int g = 0; g < group; ++g) m &= m - 1;
          const int src = m ? __ffs(m) - 1 : -1;
          for (int g = 0; g < kGroups; ++g) hits &= hits - 1;
          const int row = __shfl_sync(0xffffffffu, j, src < 0 ? 0 : src);
          const bool live = src >= 0 && sub < cb;
          const float val =
              live ? ct[(p0 + src) * c + c0 + sub] : 0.0f;
          // groups add in ascending flat-row order; one group's lanes
          // touch distinct channels
          for (int g = 0; g < kGroups; ++g) {
            if (live && group == g) mine[(row - row_lo) * cb + sub] += val;
            __syncwarp();
          }
        }
      }
    }
  }
  __syncthreads();

  const int rows = row_hi - row_lo;
  for (int i = threadIdx.x; i < rows * cb; i += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += acc[w * kTile * cb + i];
    out[static_cast<long long>(row_lo + i / cb) * c + c0 + i % cb] = s;
  }
}

template <int LPM>
void launch(const float* ct, const int* idx, const int* s_ids,
            const int* qcs, float* out, int ns, int c, int k, int r,
            cudaStream_t stream) {
  const dim3 grid((ns + kTile - 1) / kTile, (c + kChannels - 1) / kChannels);
  const int cb = c < kChannels ? c : kChannels;
  const size_t smem = sizeof(float) * kWarps * kTile * cb;
  scatter_sorted_kernel<LPM><<<grid, kWarps * 32, smem, stream>>>(
      ct, idx, s_ids, qcs, out, ns, c, k, r);
}

}  // namespace

// Plain C entry point, loaded with ctypes (ops/scatter_sorted.py). Launches
// on ``stream`` and does not synchronise. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int scatter_sorted_launch(
    const void* ct, const void* idx, const void* s_ids,
    const void* q_cell_start, void* out, int ns, int c, int k, int r,
    void* stream) {
  if (ns < 1 || c < 1 || k < 1 || r < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* ctv = static_cast<const float*>(ct);
  const int* iv = static_cast<const int*>(idx);
  const int* sv = static_cast<const int*>(s_ids);
  const int* qv = static_cast<const int*>(q_cell_start);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // lanes a ct row: the least power of two that holds the block's channels
  const int cb = c < kChannels ? c : kChannels;
  if (cb <= 1) {
    launch<1>(ctv, iv, sv, qv, o, ns, c, k, r, st);
  } else if (cb <= 2) {
    launch<2>(ctv, iv, sv, qv, o, ns, c, k, r, st);
  } else if (cb <= 4) {
    launch<4>(ctv, iv, sv, qv, o, ns, c, k, r, st);
  } else if (cb <= 8) {
    launch<8>(ctv, iv, sv, qv, o, ns, c, k, r, st);
  } else if (cb <= 16) {
    launch<16>(ctv, iv, sv, qv, o, ns, c, k, r, st);
  } else {
    launch<32>(ctv, iv, sv, qv, o, ns, c, k, r, st);
  }
  return static_cast<int>(cudaGetLastError());
}
