// Sorted-contract scatter-add (the gather's gradient), for Hopper (sm_90a).
//
// Replaces pointunet_tpu/ops/scatter_sorted.py:_scatter_sorted_impl and its
// kernel body _kernel_factory, planned there by _plan. Same function:
//     grad[s, :] = sum over flat rows p with idx[p] == s of ct[p, :]
// for ct (nq * k, c) cotangent rows (f32 or bf16, summed in f32) of
// cell-sorted queries and idx (nq * k,) rows of the cell-sorted support,
// produced by the cell-window search (every neighbour of a query lies in
// the 27 cells around it). With ``q_perm`` the queries are read through a
// permutation: flat row p is ct row q_perm[p / k] * k + p % k (the pool
// gather, whose queries are sorted by the wrapper without moving ct).
//
// The plan is the TPU kernel's; its layout is not. One block owns a tile
// of kTile = 128 consecutive sorted support rows (the TPU's S_TILE) and up
// to 32 channels. The tile's rows lie in cells [c_lo, c_hi], so for each
// column offset off = dx * r^2 + dy * r a contribution can come only from
// queries in cells [c_lo - off - 1, c_hi - off + 1] (z rides the +-1
// halo), whose flat rows are one contiguous range read from the query cell
// prefix sums. The 9 ranges are walked in descending off, so their starts
// and ends ascend; each start is clipped to the end already covered, so the
// block reads every flat row at most once. The TPU's 128-lane-aligned
// starts, 2048-lane chunks, packed ct^T + f32-index rows and chunk-padded
// thresholds are TPU artefacts and are not carried over.
//
// Three phases, no atomics, every launch the same bits:
//  A. all threads stream the ranges' idx, 4 flat rows a thread (16-byte
//     loads); a block-wide scan of the per-thread hit counts appends each
//     hit (local row, flat row) to a shared-memory list in ascending flat
//     row;
//  B. a stable counting sort of the list by local row: each warp counts
//     its contiguous segment per row (match_any: the last lane of a row's
//     peers adds their count, only this warp writes its counts), a prefix
//     over (row, warp) gives every warp's base in each row, and a second
//     walk places each flat row at base + its rank among its peers;
//  C. a group of lanes per row (one channel a lane) sums that row's ct
//     rows in ascending flat row, each read as one contiguous vector of the
//     block's channels and widened to f32, into the tile's sums in shared
//     memory.
// A list that would outgrow its kCap entries is sorted and summed at the
// chunk boundary where it fills, and the next chunks start a new list:
// every row still sums its flat rows in ascending order, so the bits do
// not depend on where the passes split. The tile's sums are written once.
// The plain version (ops/scatter_sorted.py, scatter_sorted_plain) walks the
// same tiles and ranges.
//
// What bounds it on the H100: bytes. The compulsory traffic is ct read
// once, idx read once and grad written once (about 66 us for the level-0
// self gather, 5.84M x 8 f32 channels, at 3.35 TB/s; bf16 ct halves the
// largest term). The block reads idx once per tile whose ranges cover it
// (about 9 times: idx is small and stays in the 50 MB L2) and each ct row
// once, by the one tile that owns its index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kTile = 128;        // support rows a block owns
constexpr int kThreads = 256;     // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kChannels = 32;     // channels a block (grid.y splits wider c)
constexpr int kCap = 4096;        // list entries a pass
constexpr int kChunk = 4 * kThreads;   // flat rows a scan step

struct Smem {
  int list_p[kCap];               // flat rows, ascending
  int sorted_p[kCap];             // the same, grouped by local row
  unsigned char list_r[kCap];     // local rows
  int base[kWarps][kTile];        // counts, then each warp's base a row
  int row_n[kTile];               // entries a row
  int row_start[kTile];           // first sorted entry of a row
  int warp_sums[kWarps];
};

// VEC consecutive ct values widened to f32 (one 16- or 8-byte load for
// VEC = 4: the caller keeps the address aligned)
template <int VEC>
__device__ __forceinline__ void load_ct(const float* p, float (&u)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    u[0] = q.x;
    u[1] = q.y;
    u[2] = q.z;
    u[3] = q.w;
  } else {
    u[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_ct(const __nv_bfloat16* p,
                                        float (&u)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    u[0] = lo.x;
    u[1] = lo.y;
    u[2] = hi.x;
    u[3] = hi.y;
  } else {
    u[0] = __bfloat162float(p[0]);
  }
}

// exclusive prefix of v over the block's threads in thread order, and the
// block's total
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    total += s;
  }
  __syncthreads();                    // warp_sums free for the next scan
  return before + incl - v;
}

// phases B and C on the list's first n entries: sums added to acc
template <typename T, int LPM, int VEC>
__device__ void sort_and_sum(Smem& sm, float* acc, int n, int rows,
                             const T* __restrict__ ct,
                             const int* __restrict__ q_perm, int c, int c0,
                             int cb, int k) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();                    // the list is complete
  for (int r = lane; r < kTile; r += 32) sm.base[warp][r] = 0;
  const int seg = (n + kWarps - 1) / kWarps;
  const int i_lo = min(n, warp * seg);
  const int i_hi = min(n, i_lo + seg);
  const unsigned below = (1u << lane) - 1u;
  __syncwarp();
  // B1: this warp's count of each row in its segment
  for (int i0 = i_lo; i0 < i_hi; i0 += 32) {
    const int i = i0 + lane;
    const int r = i < i_hi ? sm.list_r[i] : kTile + lane;
    const unsigned peers = __match_any_sync(0xffffffffu, r);
    if (i < i_hi && (peers >> lane) == 1u) {       // the last of its peers
      sm.base[warp][r] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  // rows: counts over warps -> each warp's offset in the row; the rows'
  // starts by a scan of their counts (threads 0 .. kTile - 1)
  int count = 0;
  if (threadIdx.x < kTile) {
    for (int w = 0; w < kWarps; ++w) {
      const int v = sm.base[w][threadIdx.x];
      sm.base[w][threadIdx.x] = count;
      count += v;
    }
    sm.row_n[threadIdx.x] = count;
  }
  int total;
  const int start = block_scan(threadIdx.x < kTile ? count : 0,
                               sm.warp_sums, total);
  if (threadIdx.x < kTile) {
    sm.row_start[threadIdx.x] = start;
    for (int w = 0; w < kWarps; ++w) sm.base[w][threadIdx.x] += start;
  }
  __syncthreads();
  // B2: each flat row at its warp's base in its row plus its rank
  for (int i0 = i_lo; i0 < i_hi; i0 += 32) {
    const int i = i0 + lane;
    const int r = i < i_hi ? sm.list_r[i] : kTile + lane;
    const unsigned peers = __match_any_sync(0xffffffffu, r);
    if (i < i_hi) {
      sm.sorted_p[sm.base[warp][r] + __popc(peers & below)] = sm.list_p[i];
    }
    __syncwarp();
    if (i < i_hi && (peers >> lane) == 1u) sm.base[warp][r] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // C: a group of LPM lanes a row, VEC channels a lane, ascending flat
  // rows
  const int sub = threadIdx.x % LPM;
  if (sub * VEC < cb) {
    for (int r = threadIdx.x / LPM; r < rows; r += kThreads / LPM) {
      float* a = acc + r * cb + sub * VEC;
      float s[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) s[v] = a[v];
      const int e0 = sm.row_start[r];
      const int e1 = e0 + sm.row_n[r];
#pragma unroll 8
      for (int e = e0; e < e1; ++e) {
        const int p = sm.sorted_p[e];
        const long long row =
            q_perm == nullptr
                ? static_cast<long long>(p)
                : static_cast<long long>(q_perm[p / k]) * k + p % k;
        float u[VEC];
        load_ct<VEC>(ct + row * c + c0 + sub * VEC, u);
#pragma unroll
        for (int v = 0; v < VEC; ++v) s[v] += u[v];
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) a[v] = s[v];
    }
  }
  __syncthreads();                    // the list and tables are free again
}

template <typename T, int LPM, int VEC>
__global__ void __launch_bounds__(kThreads) scatter_sorted_kernel(
    const T* __restrict__ ct,                // (nqk, c)
    const int* __restrict__ idx,             // (nqk,), 16-byte aligned
    const int* __restrict__ q_perm,          // (nqk / k,) or null
    const int* __restrict__ s_ids,           // (ns,) sorted support cells
    const int* __restrict__ q_cell_start,    // (r^3 + 1,) query prefix sums
    float* __restrict__ out,                 // (ns, c)
    int ns, int c, int k, int r, long long nqk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  float* acc = reinterpret_cast<float*>(smem_raw + sizeof(Smem));
  const int row_lo = blockIdx.x * kTile;
  const int row_hi = min(row_lo + kTile, ns);
  const int rows = row_hi - row_lo;
  const int c0 = blockIdx.y * kChannels;
  const int cb = min(kChannels, c - c0);

  for (int i = threadIdx.x; i < kTile * cb; i += kThreads) acc[i] = 0.0f;

  const long long v = static_cast<long long>(r) * r * r;
  const long long c_lo = s_ids[row_lo];
  const long long c_hi = s_ids[row_hi - 1];
  int tail = 0;                               // list entries this pass
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
      // A: 4 flat rows a thread, from a 4-aligned base
      for (long long base = start & ~3LL; base < end; base += kChunk) {
        const long long p4 = base + 4LL * threadIdx.x;
        int j[4] = {-1, -1, -1, -1};
        if (p4 + 3 < nqk) {
          const int4 q = *reinterpret_cast<const int4*>(idx + p4);
          j[0] = q.x;
          j[1] = q.y;
          j[2] = q.z;
          j[3] = q.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (p4 + e < nqk) j[e] = idx[p4 + e];
          }
        }
        int hit = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool h = p4 + e >= start && p4 + e < end && j[e] >= row_lo &&
                         j[e] < row_hi;
          hit |= static_cast<int>(h) << e;
        }
        int total;
        int at = block_scan(__popc(hit), sm.warp_sums, total);
        if (tail + total > kCap) {            // the same for every thread
          sort_and_sum<T, LPM, VEC>(sm, acc, tail, rows, ct, q_perm, c, c0,
                                    cb, k);
          tail = 0;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (hit >> e & 1) {
            sm.list_p[tail + at] = static_cast<int>(p4 + e);
            sm.list_r[tail + at] = static_cast<unsigned char>(j[e] - row_lo);
            ++at;
          }
        }
        tail += total;
      }
    }
  }
  sort_and_sum<T, LPM, VEC>(sm, acc, tail, rows, ct, q_perm, c, c0, cb, k);

  for (int i = threadIdx.x; i < rows * cb; i += kThreads) {
    out[static_cast<long long>(row_lo + i / cb) * c + c0 + i % cb] = acc[i];
  }
}

template <typename T, int LPM, int VEC>
int launch(const void* ct, const int* idx, const int* q_perm,
           const int* s_ids, const int* qcs, float* out, int ns, int c,
           int k, int r, long long nqk, cudaStream_t stream) {
  auto kernel = scatter_sorted_kernel<T, LPM, VEC>;
  const int cb = c < kChannels ? c : kChannels;
  const size_t smem = sizeof(Smem) + sizeof(float) * kTile * cb;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ns + kTile - 1) / kTile, (c + kChannels - 1) / kChannels);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(ct), idx,
                                           q_perm, s_ids, qcs, out, ns, c, k,
                                           r, nqk);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
using I = std::integral_constant<int, N>;

// lanes a ct row: the least power of two that holds the block's channels,
// 4 a lane where C is a multiple of 4 and ct is aligned for the vectors
template <typename T>
int dispatch(const void* ct, const int* idx, const int* q_perm,
             const int* s_ids, const int* qcs, float* out, int ns, int c,
             int k, int r, long long nqk, cudaStream_t st) {
  const int cb = c < kChannels ? c : kChannels;
  auto go = [&](auto lpm, auto vec) {
    return launch<T, decltype(lpm)::value, decltype(vec)::value>(
        ct, idx, q_perm, s_ids, qcs, out, ns, c, k, r, nqk, st);
  };
  if (c % 4 == 0 &&
      reinterpret_cast<unsigned long long>(ct) % (4 * sizeof(T)) == 0) {
    if (cb <= 4) return go(I<1>{}, I<4>{});
    if (cb <= 8) return go(I<2>{}, I<4>{});
    if (cb <= 16) return go(I<4>{}, I<4>{});
    return go(I<8>{}, I<4>{});
  }
  if (cb <= 1) return go(I<1>{}, I<1>{});
  if (cb <= 2) return go(I<2>{}, I<1>{});
  if (cb <= 4) return go(I<4>{}, I<1>{});
  if (cb <= 8) return go(I<8>{}, I<1>{});
  if (cb <= 16) return go(I<16>{}, I<1>{});
  return go(I<32>{}, I<1>{});
}

}  // namespace

// Plain C entry point, loaded with ctypes (ops/scatter_sorted.py). ``dtype``
// is 0 for f32 ct and 1 for bf16; ``q_perm`` may be null; idx must be
// 16-byte aligned. Launches on ``stream`` and does not synchronise.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int scatter_sorted_launch(
    const void* ct, const void* idx, const void* q_perm, const void* s_ids,
    const void* q_cell_start, void* out, int nq, int ns, int c, int k,
    int r, int dtype, void* stream) {
  if (nq < 1 || ns < 1 || c < 1 || k < 1 || r < 1 ||
      reinterpret_cast<unsigned long long>(idx) % 16 != 0 ||
      static_cast<long long>(nq) * k >= (1LL << 31) ||
      (c + kChannels - 1) / kChannels > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* iv = static_cast<const int*>(idx);
  const int* pv = static_cast<const int*>(q_perm);
  const int* sv = static_cast<const int*>(s_ids);
  const int* qv = static_cast<const int*>(q_cell_start);
  float* o = static_cast<float*>(out);
  const long long nqk = static_cast<long long>(nq) * k;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(ct, iv, pv, sv, qv, o, ns, c, k, r, nqk, st);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(ct, iv, pv, sv, qv, o, ns, c, k, r, nqk,
                                   st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
