// Windowed scatter-add (the gather's gradient on unsorted clouds), for
// Hopper (sm_90a).
//
// Replaces pointunet_tpu/ops/scatter_window.py:_windowed_scatter_impl and
// its kernel body _scatter_kernel_factory. Same function, on the plan the
// wrapper computes exactly as the reference does (ops/scatter_window.py):
//     out[i, :] = sum over the flat rows p of tile t = i / 128's windows
//                 with inv[idx[p]] == i of ct[p, :]
// for ct (nqk, c) f32 cotangent rows and idx (nqk,) support ids, both in
// the cell-sorted query order, inv the sorted position of each support
// id, and out (ns, c) in sorted-support order. Tile t's 9 reverse windows
// are the flat rows [qw0 + qthr, qw0 + wqk) (cut at nqk), walked in
// ascending start (offset 8 down to 0); the thresholds make them
// disjoint. The windows are sized from mean density with slack: a
// contribution outside every window of its tile is dropped, as in the
// reference; the windows are the reference's, bit for bit.
//
// The TPU kernel's packed transposed layout (ct^T rows with the index as
// an f32 value row, c_pad, 8-row id copies) and its one-hot matmul at
// HIGHEST precision are TPU artefacts and are not carried over. Here one
// block owns one tile of 128 sorted support rows (and up to kChannels
// channels) and is its only writer, so there are no atomics: a warp reads
// 32 flat rows' idx at a time, looks up their sorted positions, takes the
// rows whose position falls in the tile (ballot), loads only their ct rows
// (LPM lanes a row, one channel a lane) and adds them in ascending
// flat-row order to its own shared-memory copy of the tile; the block sums
// its warps' copies in warp order. Which warp reads which row is fixed by
// the plan, so every launch on the same inputs gives the same bits.
//
// What bounds it on the H100: bytes. The compulsory traffic is ct, idx,
// inv and the plan read once and out written once (about 0.2 ms at
// 365,000 x 16 x 8 at 3.35 TB/s). The windows overlap: each idx word is
// read by every tile whose windows cover it (tens of times; idx and inv
// stay in the 50 MB L2), each ct row only by the tile that owns its
// index. The per-warp add loop is latency-bound.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;     // sorted support rows a block (S_TILE)
constexpr int kWarps = 4;      // warps a block
constexpr int kChannels = 16;  // channels a block (grid.y splits wider c)

template <int LPM>
__global__ void __launch_bounds__(kWarps * 32) scatter_window_kernel(
    const float* __restrict__ ct,     // (nqk, c) sorted-query flat rows
    const int* __restrict__ idx,      // (nqk,) support ids
    const int* __restrict__ inv,      // (ns,) sorted position of each id
    const int* __restrict__ qw0,      // (nt, 9) window starts
    const int* __restrict__ qthr,     // (nt, 9) rows already covered
    float* __restrict__ out,          // (ns, c) sorted-support rows
    int ns, long long nqk, int c, int wqk) {
  extern __shared__ float acc[];      // (kWarps, kTile, cb)
  const int t = blockIdx.x;
  const int row_lo = t * kTile;
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
  constexpr int kGroups = 32 / LPM;   // ct rows a warp step adds
  const int group = lane / LPM;
  const int sub = lane % LPM;         // this lane's channel

  for (int o = 8; o >= 0; --o) {      // ascending window starts
    const long long w0 = qw0[t * 9 + o];
    const long long start = w0 + qthr[t * 9 + o];
    const long long end = min(w0 + wqk, nqk);
    for (long long p0 = start + 32LL * warp; p0 < end;
         p0 += 32LL * kWarps) {
      const long long p = p0 + lane;
      const int j = p < end ? idx[p] : -1;
      const int pos = (j >= 0 && j < ns) ? inv[j] : -1;
      unsigned hits =
          __ballot_sync(0xffffffffu, pos >= row_lo && pos < row_hi);
      while (hits) {
        // lane group g takes the g-th lowest hit still pending
        unsigned m = hits;
        for (int g = 0; g < group; ++g) m &= m - 1;
        const int src = m ? __ffs(m) - 1 : -1;
        for (int g = 0; g < kGroups; ++g) hits &= hits - 1;
        const int row = __shfl_sync(0xffffffffu, pos, src < 0 ? 0 : src);
        const bool live = src >= 0 && sub < cb;
        const float val = live ? ct[(p0 + src) * c + c0 + sub] : 0.0f;
        // groups add in ascending flat-row order; one group's lanes touch
        // distinct channels
        for (int g = 0; g < kGroups; ++g) {
          if (live && group == g) mine[(row - row_lo) * cb + sub] += val;
          __syncwarp();
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
void launch(const float* ct, const int* idx, const int* inv, const int* qw0,
            const int* qthr, float* out, int ns, long long nqk, int c,
            int wqk, cudaStream_t stream) {
  const dim3 grid((ns + kTile - 1) / kTile, (c + kChannels - 1) / kChannels);
  const int cb = c < kChannels ? c : kChannels;
  const size_t smem = sizeof(float) * kWarps * kTile * cb;
  scatter_window_kernel<LPM><<<grid, kWarps * 32, smem, stream>>>(
      ct, idx, inv, qw0, qthr, out, ns, nqk, c, wqk);
}

}  // namespace

// Plain C entry point, loaded with ctypes (ops/scatter_window.py). Launches
// on ``stream`` and does not synchronise. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int scatter_window_launch(
    const void* ct, const void* idx, const void* inv, const void* qw0,
    const void* qthr, void* out, int ns, long long nqk, int c, int wqk,
    void* stream) {
  if (ns < 1 || nqk < 0 || c < 1 || wqk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* ctv = static_cast<const float*>(ct);
  const int* iv = static_cast<const int*>(idx);
  const int* invv = static_cast<const int*>(inv);
  const int* wv = static_cast<const int*>(qw0);
  const int* tv = static_cast<const int*>(qthr);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // lanes a ct row: the least power of two that holds the block's channels
  const int cb = c < kChannels ? c : kChannels;
  if (cb <= 1) {
    launch<1>(ctv, iv, invv, wv, tv, o, ns, nqk, c, wqk, st);
  } else if (cb <= 2) {
    launch<2>(ctv, iv, invv, wv, tv, o, ns, nqk, c, wqk, st);
  } else if (cb <= 4) {
    launch<4>(ctv, iv, invv, wv, tv, o, ns, nqk, c, wqk, st);
  } else if (cb <= 8) {
    launch<8>(ctv, iv, invv, wv, tv, o, ns, nqk, c, wqk, st);
  } else {
    launch<16>(ctv, iv, invv, wv, tv, o, ns, nqk, c, wqk, st);
  }
  return static_cast<int>(cudaGetLastError());
}
