// Cell-window KNN over clouds sorted by raster cell id, for Hopper (sm_90a).
//
// Replaces pointunet_tpu/ops/knn_pallas.py:knn_pallas_core and its kernel
// body _kernel_factory. Same function, same inputs and the same output row
// space: for every sorted query, the k nearest support rows among the 27
// cells around the query's cell, as indices into the sorted support, with
// a slot that found no neighbour filled by the first neighbour found (row
// 0 if there is none).
//
// The TPU kernel's workarounds are not carried over (128-lane-aligned
// window starts, cells carried as f32 values, the transposed (16, Ns)
// support, the two-board density split, the 13-bit packed key). Here one
// thread owns one sorted query. For each (dx, dy) whose column is inside
// the grid it reads the exact row span of the three z-adjacent cells from
// the cell prefix sums,
//     cell_start[id(cx+dx, cy+dy, max(cz-1, 0))]
//       .. cell_start[id(cx+dx, cy+dy, min(cz+1, r-1)) + 1],
// so no window is ever truncated, and keeps a sorted list of k (1 or 16)
// (d^2, row) pairs in registers. The 9 spans are visited in ascending row
// order and a candidate enters the list only when it is strictly nearer
// than the current k-th, so ties go to the lower row: the list is ordered
// by (d^2, row), exactly what a stable sort of the candidates by d^2
// gives (knn_cuda.knn_cell_window_plain).
//
// d^2 is dx*dx + dy*dy + dz*dz in that order with every product and sum
// rounded on its own (__fmul_rn / __fadd_rn forbid FMA contraction), which
// is how eager PyTorch evaluates the plain version; the two agree on every
// index.
//
// What bounds it on the H100: candidate-row reads, about 27 cells x points
// per cell per query, 12 bytes each, with a few flops per row and no
// tensor-core work: latency- and L2-bound, not bandwidth- or
// compute-bound. Adjacent sorted queries sit in the same or neighbouring
// cells, so the threads of a warp read the same spans and their loads hit
// L1/L2 instead of device memory. Shared-memory tiles of the windows and
// TMA are later work.

#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kThreads = 128;

template <int K>
__global__ void knn_cell_window_kernel(
    const float* __restrict__ sp,          // (ns, 3) sorted support
    const int* __restrict__ cell_start,    // (r^3 + 1,) prefix sums
    const float* __restrict__ qp,          // (nq, 3) sorted queries
    const int* __restrict__ qc,            // (nq, 3) query cells
    int* __restrict__ out,                 // (nq, K)
    int nq, int r) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;

  const float qx = qp[3 * q + 0];
  const float qy = qp[3 * q + 1];
  const float qz = qp[3 * q + 2];
  const int cx = qc[3 * q + 0];
  const int cy = qc[3 * q + 1];
  const int cz = qc[3 * q + 2];
  const int z0 = max(cz - 1, 0);
  const int z1 = min(cz + 1, r - 1);

  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = CUDART_INF_F;
    bi[t] = -1;
  }

  for (int dx = -1; dx <= 1; ++dx) {
    const int x = cx + dx;
    if (x < 0 || x >= r) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int y = cy + dy;
      if (y < 0 || y >= r || z0 > z1) continue;
      const int base = (x * r + y) * r;
      const int start = cell_start[base + z0];
      const int end = cell_start[base + z1 + 1];
      for (int row = start; row < end; ++row) {
        const float ex = __fsub_rn(qx, sp[3 * row + 0]);
        const float ey = __fsub_rn(qy, sp[3 * row + 1]);
        const float ez = __fsub_rn(qz, sp[3 * row + 2]);
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
            __fmul_rn(ez, ez));
        if (d < bd[K - 1]) {
          // insert after every entry <= d: walk down from the tail,
          // shifting entries greater than d one slot back
#pragma unroll
          for (int t = K - 1; t > 0; --t) {
            if (bd[t - 1] > d) {
              bd[t] = bd[t - 1];
              bi[t] = bi[t - 1];
            } else if (bd[t] > d) {
              bd[t] = d;
              bi[t] = row;
            }
          }
          if (bd[0] > d) {
            bd[0] = d;
            bi[0] = row;
          }
        }
      }
    }
  }

  const int first = bi[0] >= 0 ? bi[0] : 0;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    out[q * K + t] = bi[t] >= 0 ? bi[t] : first;
  }
}

template <int K>
void launch(const float* sp, const int* cell_start, const float* qp,
            const int* qc, int* out, int nq, int r, cudaStream_t stream) {
  const int blocks = (nq + kThreads - 1) / kThreads;
  knn_cell_window_kernel<K><<<blocks, kThreads, 0, stream>>>(
      sp, cell_start, qp, qc, out, nq, r);
}

}  // namespace

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
      launch<1>(s, cs, qv, qcv, o, nq, r, st);
      break;
    case 16:
      launch<16>(s, cs, qv, qcv, o, nq, r, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
