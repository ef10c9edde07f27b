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
// are the flat rows [qw0 + qthr, qw0 + wqk) (cut at nqk). The windows are
// sized from mean density with slack: a contribution outside every window
// of its tile is dropped, as in the reference; the windows are the
// reference's, bit for bit, and are not widened.
//
// Owner-resolved rows. Every flat row p has one candidate owner, the
// sorted position pos = inv[idx[p]], in one tile pos >> 7. The thresholds
// only remove the overlaps of windows walked in ascending start, so p
// lies in some thresholded window of that tile exactly when it lies in
// some [qw0, min(qw0 + wqk, nqk)) of it (a CPU test holds the two equal).
// So one coalesced pass over the flat rows reads each idx word, each inv
// entry it points at and each ct row once, tests the 9 windows of the
// owner's tile (36 bytes, cached) and adds the row into its owner or
// drops it. The TPU kernel's one-hot matmul over whole windows, and the
// previous design here (each 128-row tile scanning the ~84,000 flat rows
// of its windows, ~40x the rows it owns, one dependent idx -> inv load
// each), are gone.
//
// Deterministic sums without a fixed order: exact fixed point. Float
// atomics would add a row's terms in an order that changes from launch to
// launch, and with it the bits. Here the terms are integers, whose sum
// does not depend on the order:
//   1. abs_max: one pass over ct for m = max |ct| (integer atomicMax on
//      the f32 bits, which order like the values for |v|);
//   2. owner_add: q = round(ct * 2^k) as int64, red.add into (ns, c)
//      int64 sums, with k = 61 - L - e, where m < 2^(e + 1) and
//      nqk < 2^L: a row sums at most nqk terms of magnitude at most
//      2^(62 - L), so no sum can overflow;
//   3. finalize: out = sum * 2^-k, rounded once to f32.
// Each term is off by at most 2^-(k + 1) = 2^(L + e - 62), which is
// m x 2^(L - 62) at most: 1.8e-12 x m at 5.84 million rows, so a row of T
// terms is within T x 1.8e-12 x m of the exact sum before the one f32
// rounding, where the f32 sum of the plain version is within ~T x 6e-8 x
// m: the bar of 1e-6 x max|exact| is met with orders of magnitude to
// spare. Every launch on the same inputs gives the same bits. A
// non-finite cotangent has no finite scale: then every output is NaN.
//
// What bounds it on the H100: bytes. The compulsory traffic is ct, idx,
// inv and the plan read once and out written once (~0.07 ms at 365,000 x
// 16 x 8 at 3.35 TB/s); this design reads ct twice (the max, then the
// sums) and adds 8-byte integer sums, which live in the 50 MB L2 and
// take one 64-bit reduction per kept element.

#include <cuda_runtime.h>

namespace {

constexpr int kTileShift = 7;    // 128 sorted support rows a tile (S_TILE)
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) abs_max_kernel(
    const float* __restrict__ ct, long long n, unsigned* __restrict__ bits) {
  unsigned m = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // float4 loads where ct is 16-byte aligned, else one word a thread
  const bool aligned = (reinterpret_cast<unsigned long long>(ct) & 15) == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const float4* ct4 = reinterpret_cast<const float4*>(ct);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n4; i += stride) {
    const float4 v = ct4[i];
    m = max(m, __float_as_uint(v.x) & 0x7fffffffu);
    m = max(m, __float_as_uint(v.y) & 0x7fffffffu);
    m = max(m, __float_as_uint(v.z) & 0x7fffffffu);
    m = max(m, __float_as_uint(v.w) & 0x7fffffffu);
  }
  for (long long i = 4 * n4 + blockIdx.x * static_cast<long long>(
                                             blockDim.x) + threadIdx.x;
       i < n; i += stride) {
    m = max(m, __float_as_uint(ct[i]) & 0x7fffffffu);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(bits, m);
}

// the fixed-point exponent k for max |ct| given by its f32 bits; false
// when there is no finite scale (a NaN or infinite cotangent)
__device__ __forceinline__ bool fixed_scale(unsigned bits, long long nqk,
                                            int* k) {
  if (bits >= 0x7f800000u) return false;
  const int L = 64 - __clzll(nqk);             // nqk < 2^L
  // e with m < 2^(e + 1); subnormals take the smallest normal's exponent,
  // which only lowers k and keeps the bound
  const int e = bits == 0 ? 0 : max(static_cast<int>(bits >> 23), 1) - 127;
  *k = 61 - L - e;
  return true;
}

template <int LPR>
__global__ void __launch_bounds__(kThreads) owner_add_kernel(
    const float* __restrict__ ct,     // (nqk, c) sorted-query flat rows
    const int* __restrict__ idx,      // (nqk,) support ids
    const int* __restrict__ inv,      // (ns,) sorted position of each id
    const int* __restrict__ qw0,      // (nt, 9) window starts
    const unsigned* __restrict__ bits,
    unsigned long long* __restrict__ acc,   // (ns, c) int64 sums
    int ns, long long nqk, int c, int wqk) {
  int k;
  if (!fixed_scale(*bits, nqk, &k)) return;
  const double scale = ldexp(1.0, k);
  const long long g =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long p = g / LPR;       // LPR lanes a flat row
  const int sub = static_cast<int>(g % LPR);
  if (p >= nqk) return;
  const int j = idx[p];
  if (j < 0 || j >= ns) return;
  const int pos = inv[j];
  if (pos < 0 || pos >= ns) return;
  const int* w = qw0 + static_cast<long long>(pos >> kTileShift) * 9;
  bool kept = false;
#pragma unroll
  for (int o = 0; o < 9; ++o) {
    const long long w0 = w[o];
    kept |= p >= w0 && p < w0 + wqk;   // p < nqk: the cut holds already
  }
  if (!kept) return;
  const float* row = ct + p * c;
  unsigned long long* dst = acc + static_cast<long long>(pos) * c;
  for (int ch = sub; ch < c; ch += LPR) {
    const long long q = __double2ll_rn(static_cast<double>(row[ch]) * scale);
    atomicAdd(dst + ch, static_cast<unsigned long long>(q));
  }
}

__global__ void __launch_bounds__(kThreads) finalize_kernel(
    const unsigned long long* __restrict__ acc,
    const unsigned* __restrict__ bits, float* __restrict__ out,
    long long n, long long nqk) {
  const long long i =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  int k;
  if (!fixed_scale(*bits, nqk, &k)) {
    out[i] = __int_as_float(0x7fffffff);
    return;
  }
  const long long s = static_cast<long long>(acc[i]);
  out[i] = static_cast<float>(static_cast<double>(s) * ldexp(1.0, -k));
}

template <int LPR>
void launch_add(const float* ct, const int* idx, const int* inv,
                const int* qw0, const unsigned* bits,
                unsigned long long* acc, int ns, long long nqk, int c,
                int wqk, cudaStream_t stream) {
  const long long threads = nqk * LPR;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  owner_add_kernel<LPR><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(ct, idx, inv, qw0, bits, acc, ns, nqk, c,
                                    wqk);
}

}  // namespace

// Plain C entry point, loaded with ctypes (ops/scatter_window.py). ``acc``
// is (ns, c) int64 and ``bits`` one 32-bit word of scratch, both
// allocated by the caller and overwritten here. Launches on ``stream``
// and does not synchronise. Returns cudaGetLastError() after the launches
// (0 on success), or cudaErrorInvalidValue for arguments the kernels do
// not take.
extern "C" int scatter_window_launch(
    const void* ct, const void* idx, const void* inv, const void* qw0,
    void* acc, void* bits, void* out, int ns, long long nqk, int c, int wqk,
    void* stream) {
  if (ns < 1 || nqk < 0 || c < 1 || wqk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* ctv = static_cast<const float*>(ct);
  const int* iv = static_cast<const int*>(idx);
  const int* invv = static_cast<const int*>(inv);
  const int* wv = static_cast<const int*>(qw0);
  auto* a = static_cast<unsigned long long*>(acc);
  auto* mb = static_cast<unsigned*>(bits);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_out = static_cast<long long>(ns) * c;
  cudaError_t err = cudaMemsetAsync(a, 0, sizeof(*a) * n_out, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(mb, 0, sizeof(*mb), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nqk > 0) {
    const long long n_ct = nqk * c;
    long long blocks = (n_ct / 4 + kThreads - 1) / kThreads;
    blocks = blocks < 1 ? 1 : (blocks > 132 * 16 ? 132 * 16 : blocks);
    abs_max_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        ctv, n_ct, mb);
    // lanes a flat row: the least power of two that holds c, at most 32
    if (c <= 1) {
      launch_add<1>(ctv, iv, invv, wv, mb, a, ns, nqk, c, wqk, st);
    } else if (c <= 2) {
      launch_add<2>(ctv, iv, invv, wv, mb, a, ns, nqk, c, wqk, st);
    } else if (c <= 4) {
      launch_add<4>(ctv, iv, invv, wv, mb, a, ns, nqk, c, wqk, st);
    } else if (c <= 8) {
      launch_add<8>(ctv, iv, invv, wv, mb, a, ns, nqk, c, wqk, st);
    } else if (c <= 16) {
      launch_add<16>(ctv, iv, invv, wv, mb, a, ns, nqk, c, wqk, st);
    } else {
      launch_add<32>(ctv, iv, invv, wv, mb, a, ns, nqk, c, wqk, st);
    }
  }
  finalize_kernel<<<static_cast<unsigned>((n_out + kThreads - 1) / kThreads),
                    kThreads, 0, st>>>(a, mb, o, n_out, nqk);
  return static_cast<int>(cudaGetLastError());
}
