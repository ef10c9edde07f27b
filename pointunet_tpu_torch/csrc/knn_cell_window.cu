// Cell-window KNN over clouds sorted by raster cell id, for Hopper (sm_90a).
//
// Replaces pointunet_tpu/ops/knn_pallas.py:knn_pallas_core and its kernel
// body _kernel_factory. Same function, same inputs and the same output row
// space: for every sorted query, the k (1 or 16) nearest support rows among
// the 9 exact (dx, dy) spans
//     cell_start[id(cx+dx, cy+dy, max(cz-1, 0))]
//       .. cell_start[id(cx+dx, cy+dy, min(cz+1, r-1)) + 1]
// whose column lies inside the grid, ordered by (d^2, row), as indices into
// the sorted support; a slot that found no neighbour takes the first
// neighbour found (row 0 if there is none). No span is ever truncated
// (knn_cuda.knn_cell_window_plain is the same function in plain torch).
//
// d^2 is ex*ex + ey*ey + ez*ez in that order with every difference,
// product and sum rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn
// forbid FMA contraction), which is how eager PyTorch evaluates the plain
// version. A candidate's key is (bits of d^2) << 32 | row: d^2 >= +0, so
// the keys order exactly as (d^2, row) and are unique, and the result does
// not depend on the order in which candidates are seen.
//
// What bounds it on the H100: ~8 f32 operations and one 12-byte row a
// candidate, 2.6e8 candidates at the 365k level-0 self search (chip_smoke.py
// phase 2), most of them in the all-voxel tumour ball: by operations,
// ~0.03 ms. The first design (one thread a query, a sorted
// 16-slot list in registers) took 1.02 ms there; without its insertion
// 0.31 ms, with the candidate loads alone 0.30 ms (probe_knn.py): the
// divergent insertion, which a warp runs whenever one lane needs it, set
// its time. This design:
//
// 1. Query tiles. A block takes KNN_TILE consecutive sorted queries. For
//    each (dx, dy) the tile's window is the union of its queries' spans
//    (a block min/max over the queries, on the device: the host never
//    waits). The 9 windows are laid end to end, the query's own column
//    first.
// 2. Staged windows. The window rows are copied once a block into shared
//    memory with cp.async (16-byte copies for each piece's aligned body,
//    4-byte copies for its ragged ends: rows are 12 bytes, so each piece
//    starts at a shared offset congruent to its global offset mod 16). A
//    window longer than a ring slot (KNN_CHUNK rows) streams through two
//    slots, the next chunk's copies in flight while the current one is
//    searched. Each staged piece gets its bounding box.
// 3. Cooperative selection on packed keys. A group of lanes searches one
//    query (16 for k = 16, KNN_UP_LANES for k = 1), taking consecutive
//    candidates one a lane: first its own column (its own cell first),
//    then the other 8 columns as one list. For k = 16 the group's sorted 16-list is held one key a lane; a
//    candidate below the 16th key joins a buffer of 16 in shared memory
//    (ballot + popc), and a full buffer is sorted (bitonic, shuffles) and
//    merged into the list (the least of the list and the reversed buffer,
//    then a bitonic merge). For k = 1 each lane keeps its least key and the
//    group takes the minimum. No lane waits on another lane's insertion.
// 4. Pruning. After the own column, a column whose box lies farther than
//    the current k-th key is not searched: the box's bound is computed
//    with the rows' own rounding, and rounding is monotone, so no row of
//    the box could have entered the list. The result is unchanged.
//
// Lists live in shared memory between chunks, so a window of any length is
// searched without truncation. What still sets the time (probe_knn.py): the
// merges of the list, then the per-tile staging, then the candidate loop.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

// the block's shape, for the self search (k = 16) and the up search
// (k = 1); knn_cuda.TILE and knn_cuda.CHUNK mirror them
#ifndef KNN_TILE
#define KNN_TILE 64        // queries a block
#endif
#ifndef KNN_WARPS
#define KNN_WARPS 16       // warps a block, k = 16
#endif
#ifndef KNN_CHUNK
#define KNN_CHUNK 2048     // support rows a ring slot holds, k = 16
#endif
#ifndef KNN_UP_LANES
#define KNN_UP_LANES 8     // lanes a query, k = 1
#endif
#ifndef KNN_UP_WARPS
#define KNN_UP_WARPS 8
#endif
#ifndef KNN_UP_CHUNK
#define KNN_UP_CHUNK 1024
#endif

namespace {

constexpr int kTile = KNN_TILE;
constexpr int kSeg = 9;
constexpr int kBuf = 16;                 // survivor keys a lane group
constexpr unsigned long long kNone = ~0ull;
constexpr unsigned kFull = 0xffffffffu;

// visiting order of the 9 (dx, dy) columns, s = 3 (dx + 1) + dy + 1: the
// query's own (4), then the 4 that share a face with it, then the corners;
// 4 bits an entry
constexpr unsigned long long kOrder = 0x862075314ull;

__device__ __forceinline__ void seg_offset(int i, int& dx, int& dy) {
  const int s = static_cast<int>((kOrder >> (4 * i)) & 0xf);
  dx = s / 3 - 1;
  dy = s % 3 - 1;
}

// per k: the lanes that search one query together (16 for k = 16: the list
// holds one key a lane), the warps a block, the rows a ring slot holds, and
// the blocks an SM the registers must leave room for (k = 1: as many as its
// shared memory allows; k = 16: 2, as 3 spill the merges' registers)
template <int K>
struct Cfg {
  static constexpr int kLanes = K == 16 ? 16 : KNN_UP_LANES;
  static constexpr int kWarps = K == 16 ? KNN_WARPS : KNN_UP_WARPS;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kChunk = K == 16 ? KNN_CHUNK : KNN_UP_CHUNK;
  static constexpr int kMinBlocks = K == 16 ? 2 : 6;
  // 3 floats a row; each piece starts 16-byte aligned plus up to 3 floats
  // of pad, so it takes at most 3 len + 6 floats
  static constexpr int kSlotFloats = (3 * kChunk + 6 * kSeg + 3) / 4 * 4;
};

template <int K>
struct Smem {
  float slot[2][Cfg<K>::kSlotFloats];
  int piece[2][kSeg][3];        // rows [rs, re) at slot float offset p
  float box[2][kSeg][6];        // each piece's min x, y, z, max x, y, z
  int qspan[kTile][kSeg][2];    // each query's span per column
  int qcell[kTile][2];          // and its own cell
  float qxyz[kTile][3];
  int win[kSeg][2];             // union window per column
  int vstart[kSeg];             // its start in the laid-out windows
  int nchunks;
  unsigned long long list[kTile][K];
  unsigned long long buf[K == 1 ? 1 : Cfg<K>::kWarps][2][kBuf];
  // each lane group's candidate ranges (scan)
  int rng[Cfg<K>::kWarps][32 / Cfg<K>::kLanes][kSeg - 1][4];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? b : a;
}

// ascending bitonic sort of one key a lane across each 16-lane group
__device__ __forceinline__ unsigned long long group_sort(unsigned long long x,
                                                         int gl) {
#pragma unroll
  for (int k = 2; k <= 16; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, x, j);
      const bool up = (gl & k) == 0;
      const bool lower = (gl & j) == 0;
      x = (lower == up) ? umin64(x, o) : umax64(x, o);
    }
  }
  return x;
}

// ascending sort of a bitonic sequence of one key a lane, in each group
__device__ __forceinline__ unsigned long long group_merge(unsigned long long x,
                                                          int gl) {
#pragma unroll
  for (int j = 8; j > 0; j >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, x, j);
    x = (gl & j) == 0 ? umin64(x, o) : umax64(x, o);
  }
  return x;
}

// merge a group's first c (<= 16) buffered keys into its sorted 16-list,
// one key a lane: sort them, take the least of the list and the reversed
// keys (the 16 least of both, as a bitonic sequence), sort that. Every lane
// of the warp calls it (a group with c = 0 keeps its list); returns the
// new list
__device__ __forceinline__ unsigned long long merge16(
    unsigned long long list, const unsigned long long* buf, int c, int gl,
    int base_lane) {
  __syncwarp();
  unsigned long long x = gl < c ? buf[gl] : kNone;
  x = group_sort(x, gl);
  list = umin64(list, __shfl_sync(kFull, x, base_lane + 15 - gl));
  list = group_merge(list, gl);
  __syncwarp();
  return list;
}

// one ring slot's chunk of the laid-out windows: the piece table (warp 0,
// a scan over the 9 columns), then every thread's share of the copies,
// committed as one group
template <int K>
__device__ __forceinline__ void stage(Smem<K>& sm, const float* __restrict__ sp,
                                      int c, int slot) {
  const int t = threadIdx.x;
  if (t < 32) {
    const int v0 = c * Cfg<K>::kChunk, v1 = v0 + Cfg<K>::kChunk;
    int rs = 0, re = 0;
    if (t < kSeg) {
      const int vs = sm.vstart[t], len = sm.win[t][1] - sm.win[t][0];
      const int a = max(v0, vs), b = min(v1, vs + len);
      if (a < b) {
        rs = sm.win[t][0] + (a - vs);
        re = rs + (b - a);
      }
    }
    // room for the rows and up to 3 floats of pad, a multiple of 4 floats
    const int size = re > rs ? (3 * (re - rs) + 6) & ~3 : 0;
    int incl = size;
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (t >= o) incl += v;
    }
    if (t < kSeg) {
      sm.piece[slot][t][0] = rs;
      sm.piece[slot][t][1] = re;
      sm.piece[slot][t][2] = incl - size + ((3 * rs) & 3);  // == 3 rs mod 4
    }
  }
  __syncthreads();
  float* dst = sm.slot[slot];
  for (int i = 0; i < kSeg; ++i) {
    const int* pc = sm.piece[slot][i];
    const long long g0 = 3LL * pc[0], g1 = 3LL * pc[1];
    if (g0 >= g1) continue;
    float* d = dst + pc[2];                          // d[g - g0] holds sp[g]
    const long long a0 = (g0 + 3) & ~3LL;
    if (a0 >= g1) {                                  // shorter than a vector
      if (t < g1 - g0) cp_async4(d + t, sp + g0 + t);
      continue;
    }
    const long long a1 = g1 & ~3LL;
    if (t < a0 - g0) cp_async4(d + t, sp + g0 + t);
    if (t >= 4 && t - 4 < g1 - a1) {
      cp_async4(d + (a1 - g0) + t - 4, sp + a1 + t - 4);
    }
    for (long long v = a0 + 4LL * t; v < a1; v += 4LL * Cfg<K>::kThreads) {
      cp_async16(d + (v - g0), sp + v);
    }
  }
  cp_async_commit();
}

// the bounding box of each staged piece but the own column's (never
// pruned), one warp a piece
template <int K>
__device__ __forceinline__ void piece_boxes(Smem<K>& sm, int slot, int warp,
                                            int lane) {
  for (int i = 1 + warp; i < kSeg; i += Cfg<K>::kWarps) {
    const int rs = sm.piece[slot][i][0], re = sm.piece[slot][i][1];
    const float* rows = sm.slot[slot] + sm.piece[slot][i][2];
    float b[6] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                  -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    for (int row = lane; row < re - rs; row += 32) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        b[a] = fminf(b[a], rows[3 * row + a]);
        b[3 + a] = fmaxf(b[3 + a], rows[3 * row + a]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        b[a] = fminf(b[a], __shfl_xor_sync(kFull, b[a], o));
        b[3 + a] = fmaxf(b[3 + a], __shfl_xor_sync(kFull, b[3 + a], o));
      }
    }
    float v = b[0];
#pragma unroll
    for (int a = 1; a < 6; ++a) v = lane == a ? b[a] : v;
    if (lane < 6) sm.box[slot][i][lane] = v;
  }
}

// the least d^2 the kernel's arithmetic can give between (qx, qy, qz) and
// a point of the box: each |difference| and every product and sum is
// rounded as for a row, and rounding is monotone, so no row of the box
// has a smaller d^2
__device__ __forceinline__ float box_bound(const float* box, float qx,
                                           float qy, float qz) {
  const float q[3] = {qx, qy, qz};
  float e[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    e[a] = q[a] < box[a] ? __fsub_rn(box[a], q[a])
           : q[a] > box[3 + a] ? __fsub_rn(q[a], box[3 + a]) : 0.f;
  }
  return __fadd_rn(__fadd_rn(__fmul_rn(e[0], e[0]), __fmul_rn(e[1], e[1])),
                   __fmul_rn(e[2], e[2]));
}

// the candidates of one query a lane group: ``total`` rows laid out as up
// to 8 ranges {first row, its float offset in the slot, first flat index,
// end flat index}; lane gl takes flat indices gl, gl + kG, ... The group's
// list (k = 16: one key a lane, threshold ``th``, ``n`` keys waiting in
// ``buf``) or least key (k = 1: ``best`` a lane) takes them in.
template <int K>
__device__ __forceinline__ void scan(
    const float* slot, const int (*rng)[4], int total, float qx, float qy,
    float qz, unsigned long long& best, unsigned long long& th, int& n,
    unsigned long long* buf, int gl, int base_lane) {
  constexpr int kG = Cfg<K>::kLanes;
  const int iters = __reduce_max_sync(
      kFull, static_cast<unsigned>(total + kG - 1) / kG);
  int pi = -1, pa = 0, fa = 0, off = 0, end = 0;
  for (int it = 0; it < iters; ++it) {
    const int v = it * kG + gl;
    unsigned long long key = kNone;
    if (v < total) {
      while (v >= end) {
        ++pi;
        pa = rng[pi][0];
        fa = rng[pi][1];
        off = rng[pi][2];
        end = rng[pi][3];
      }
      const float* sr = slot + fa + 3 * (v - off);
      const float ex = __fsub_rn(qx, sr[0]);
      const float ey = __fsub_rn(qy, sr[1]);
      const float ez = __fsub_rn(qz, sr[2]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                __fmul_rn(ez, ez));
      key = (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
            static_cast<unsigned>(pa + v - off);
    }
    if (K == 1) {
      best = umin64(best, key);
    } else {
      // survivors join the group's buffer of 16; the rest wait for the
      // next merge
      const bool pass = key < th;
      const unsigned mask = __ballot_sync(kFull, pass);
      if (mask) {
        const unsigned gm = (mask >> base_lane) & 0xffffu;
        const int pos = n + __popc(gm & ((1u << gl) - 1u));
        if (pass && pos < 16) buf[pos] = key;
        n += __popc(gm);
        if (__any_sync(kFull, n >= 16)) {
          // a full buffer merges 16; the other group merges what it holds,
          // which tightens its k-th key early (merging full buffers only
          // was slower on the H100)
          best = merge16(best, buf, min(n, 16), gl, base_lane);
          th = __shfl_sync(kFull, best, base_lane + 15);
          if (pass && pos >= 16) buf[pos - 16] = key;
          n = max(n - 16, 0);
        }
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(Cfg<K>::kThreads, Cfg<K>::kMinBlocks)
knn_cell_window_kernel(
    const float* __restrict__ sp,          // (ns, 3) sorted support
    const int* __restrict__ cell_start,    // (r^3 + 1,) prefix sums
    const float* __restrict__ qp,          // (nq, 3) sorted queries
    const int* __restrict__ qc,            // (nq, 3) query cells
    int* __restrict__ out,                 // (nq, K)
    int nq, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<K>& sm = *reinterpret_cast<Smem<K>*>(smem_raw);
  const int q0 = blockIdx.x * kTile;
  const int nt = min(kTile, nq - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kThreads = Cfg<K>::kThreads, kWarps = Cfg<K>::kWarps;
  constexpr int kChunk = Cfg<K>::kChunk;
  constexpr int kG = Cfg<K>::kLanes;    // lanes a query
  constexpr int kQW = 32 / kG;          // queries a warp at a time
  const int grp = lane / kG, gl = lane % kG, base_lane = grp * kG;

  if (tid < kSeg) {
    sm.win[tid][0] = INT_MAX;
    sm.win[tid][1] = INT_MIN;
  }
  for (int e = tid; e < kTile * K; e += kThreads) {
    sm.list[e / K][e % K] = kNone;
  }
  for (int e = tid; e < 3 * nt; e += kThreads) {
    sm.qxyz[e / 3][e % 3] = qp[3LL * q0 + e];
  }
  __syncthreads();

  // each query's 9 spans (one thread a query and column), and their union
  // per column
  for (int e = tid; e < kSeg * nt; e += kThreads) {
    const int j = e / kSeg, i = e % kSeg;
    const long long q = q0 + j;
    const int cx = qc[3 * q], cy = qc[3 * q + 1], cz = qc[3 * q + 2];
    const int z0 = max(cz - 1, 0), z1 = min(cz + 1, r - 1);
    int dx, dy;
    seg_offset(i, dx, dy);
    const int x = cx + dx, y = cy + dy;
    int start = 0, end = 0;
    if (x >= 0 && x < r && y >= 0 && y < r && z0 <= z1) {
      const int base = (x * r + y) * r;
      start = cell_start[base + z0];
      end = cell_start[base + z1 + 1];
    }
    sm.qspan[j][i][0] = start;
    sm.qspan[j][i][1] = end;
    if (i == 0) {                        // the own column is in the grid
      const int own = (cx * r + cy) * r + cz;
      sm.qcell[j][0] = cell_start[own];
      sm.qcell[j][1] = cell_start[own + 1];
    }
    if (start < end) {
      atomicMin(&sm.win[i][0], start);
      atomicMax(&sm.win[i][1], end);
    }
  }
  __syncthreads();
  if (tid < 32) {                        // lay the 9 windows end to end
    int len = 0;
    if (tid < kSeg) {
      if (sm.win[tid][0] >= sm.win[tid][1]) sm.win[tid][0] = sm.win[tid][1] = 0;
      len = sm.win[tid][1] - sm.win[tid][0];
    }
    int incl = len;
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (tid >= o) incl += v;
    }
    if (tid < kSeg) sm.vstart[tid] = incl - len;
    if (tid == kSeg - 1) sm.nchunks = (incl + kChunk - 1) / kChunk;
  }
  __syncthreads();

  const int nchunks = sm.nchunks;
  if (nchunks > 0) stage<K>(sm, sp, 0, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int slot = c & 1;
    if (c + 1 < nchunks) {
      stage<K>(sm, sp, c + 1, slot ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    piece_boxes<K>(sm, slot, warp, lane);
    __syncthreads();
    for (int j0 = warp * kQW; j0 < nt; j0 += kWarps * kQW) {
      const int j = j0 + grp;
      const bool live = j < nt;
      const int jj = live ? j : j0;
      const float qx = sm.qxyz[jj][0], qy = sm.qxyz[jj][1], qz = sm.qxyz[jj][2];
      int (*rng)[4] = sm.rng[warp][grp];
      unsigned long long best = live ? sm.list[j][K == 1 ? 0 : gl] : kNone;
      unsigned long long th = K == 1 ? kNone : __shfl_sync(kFull, best, base_lane + 15);
      int n = 0;                          // survivors in the group's buffer
      // the query's own column first: its own cell, then the column's
      // rows below and above it
      int total = 0;
      {
        const int rs = sm.piece[slot][0][0], re = sm.piece[slot][0][1];
        int pa = 0, pb = 0;
        if (live && gl < 3) {
          const int c0 = sm.qcell[j][0], c1 = sm.qcell[j][1];
          pa = max(gl == 0 ? c0 : gl == 1 ? sm.qspan[j][0][0] : c1, rs);
          pb = min(gl == 0 ? c1 : gl == 1 ? c0 : sm.qspan[j][0][1], re);
        }
        const int len = max(pb - pa, 0);
        int incl = len;
#pragma unroll
        for (int o = 1; o < 3; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o, kG);
          if (gl >= o) incl += v;
        }
        if (gl < 3) {
          rng[gl][0] = pa;
          rng[gl][1] = sm.piece[slot][0][2] + 3 * (pa - rs);
          rng[gl][2] = incl - len;
          rng[gl][3] = incl;
        }
        total = __shfl_sync(kFull, incl, base_lane + 2);
      }
      __syncwarp();
      scan<K>(sm.slot[slot], rng, total, qx, qy, qz, best, th, n,
              sm.buf[K == 1 ? 0 : warp][grp], gl, base_lane);
      if (K == 16) {
        // the 16th key is now near its final value: merge, so that it
        // prunes the other columns
        if (__any_sync(kFull, n > 0)) {
          best = merge16(best, sm.buf[warp][grp], n, gl, base_lane);
          th = __shfl_sync(kFull, best, base_lane + 15);
          n = 0;
        }
      } else {
#pragma unroll
        for (int o = kG / 2; o > 0; o >>= 1) {   // the group's least key
          best = umin64(best, __shfl_xor_sync(kFull, best, o));
        }
        th = best;
      }
      // the other 8 columns, one a lane; a column whose box is farther
      // than the k-th key cannot hold a neighbour: left out, with the
      // same result. Their rows are then searched as one list.
      {
        int pa = 0, len = 0, fa = 0;
        if (gl < kSeg - 1 && live) {
          const int i = gl + 1;
          const int rs = sm.piece[slot][i][0], re = sm.piece[slot][i][1];
          pa = max(sm.qspan[j][i][0], rs);
          const int pb = min(sm.qspan[j][i][1], re);
          const bool near = __float_as_uint(box_bound(
              sm.box[slot][i], qx, qy, qz)) <= static_cast<unsigned>(th >> 32);
          if (pa < pb && near) len = pb - pa;
          fa = sm.piece[slot][i][2] + 3 * (pa - rs);
        }
        int incl = len;
#pragma unroll
        for (int o = 1; o < kSeg - 1; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o, kG);
          if (gl >= o) incl += v;
        }
        __syncwarp();
        if (gl < kSeg - 1) {
          rng[gl][0] = pa;
          rng[gl][1] = fa;
          rng[gl][2] = incl - len;
          rng[gl][3] = incl;
        }
        total = __shfl_sync(kFull, incl, base_lane + kSeg - 2);
      }
      __syncwarp();
      scan<K>(sm.slot[slot], rng, total, qx, qy, qz, best, th, n,
              sm.buf[K == 1 ? 0 : warp][grp], gl, base_lane);
      if (K == 1) {
#pragma unroll
        for (int o = kG / 2; o > 0; o >>= 1) {
          best = umin64(best, __shfl_xor_sync(kFull, best, o));
        }
        if (live && gl == 0) sm.list[j][0] = best;
      } else {
        if (__any_sync(kFull, n > 0)) {
          best = merge16(best, sm.buf[warp][grp], n, gl, base_lane);
        }
        if (live) sm.list[j][gl] = best;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // rows out; an empty slot takes the first neighbour (row 0 if none)
  for (int e = tid; e < nt * K; e += kThreads) {
    const int j = e / K;
    const unsigned long long first = sm.list[j][0];
    const unsigned long long key = sm.list[j][e % K];
    const int row0 = first == kNone ? 0 : static_cast<int>(first & 0xffffffffu);
    out[static_cast<long long>(q0) * K + e] =
        key == kNone ? row0 : static_cast<int>(key & 0xffffffffu);
  }
}

template <int K>
int launch(const float* sp, const int* cell_start, const float* qp,
           const int* qc, int* out, int nq, int r, cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(Smem<K>));   // over 48 KB
  const cudaError_t e = cudaFuncSetAttribute(
      knn_cell_window_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (nq + kTile - 1) / kTile;
  knn_cell_window_kernel<K><<<blocks, Cfg<K>::kThreads, bytes, stream>>>(
      sp, cell_start, qp, qc, out, nq, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory a block of the k-instance takes (0 for another k).
extern "C" int knn_cell_window_smem_bytes(int k) {
  return k == 1 ? static_cast<int>(sizeof(Smem<1>))
                : k == 16 ? static_cast<int>(sizeof(Smem<16>)) : 0;
}

// Plain C entry point, loaded with ctypes (ops/knn_cuda.py). Launches on
// ``stream`` and does not synchronise. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for arguments the kernel
// does not take. Only the k the pyramid searches with are instantiated:
// k = 16 (self search) and k = 1 (up search); knn_cuda.KERNEL_KS lists them.
extern "C" int knn_cell_window_launch(
    const void* sp, const void* cell_start, const void* qp, const void* qc,
    void* out, int ns, int nq, int k, int r, void* stream) {
  if (ns < 1 || nq < 0 || r < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq == 0) return 0;
  const float* s = static_cast<const float*>(sp);
  const int* cs = static_cast<const int*>(cell_start);
  const float* qv = static_cast<const float*>(qp);
  const int* qcv = static_cast<const int*>(qc);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1:
      return launch<1>(s, cs, qv, qcv, o, nq, r, st);
    case 16:
      return launch<16>(s, cs, qv, qcv, o, nq, r, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
