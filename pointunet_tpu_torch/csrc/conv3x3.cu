// SAME, stride-1 3x3x3 convolution of channels-first volumes, for Hopper
// (sm_90a).
//
// Replaces pointunet_tpu/ops/conv_pallas.py:conv3d_3x3_pallas (kernel body
// _kernel_factory) and its batched entry conv3d_3x3_pallas_batched. Same
// function:
//     out[b, o, z, y, x] = sum over (c, dz, dy, dx) of
//         x[b, c, z + dz - 1, y + dy - 1, x + dx - 1] * w[o, c, dz, dy, dx]
// with zeros outside the volume, products and sums in f32, the sum rounded
// once to the input's type (f32 or bf16). An optional bias is added after
// that rounding, in the input's type, as the reference's ``y + bias`` does.
//
// The layout is the port's: the (B, Cin, D, H, W) activation and the
// (Cout, Cin, 3, 3, 3) weight are read where they lie, nothing is permuted
// to channels-last, and SAME padding is a bounds test while the halo is
// staged. The TPU kernel's X padding to a multiple of 8, Cin padding to 128
// lanes, z/y block padding, double-buffered DMA ring and optimisation
// barrier are TPU artefacts and are not carried over.
//
// Design. One block owns one (b, z) output plane x TY rows x 32 columns x
// TC output channels. Per chunk of 8 input channels it stages the haloed
// input (3 x (TY + 2) x 34, as f32) and the chunk's 27 x TC weights in
// shared memory. Each warp owns 4 rows and RC output channels; each lane
// one column: it keeps the 4 x RC sums in registers, reads 6 input rows a
// (dz, dx) tap column (consecutive lanes, consecutive words: no bank
// conflicts) and the RC weights of a tap as one broadcast vector load, and
// does 4 x RC fused multiply-adds per weight vector. The sum runs over
// (channel, dz, dx, dy) in that order; the output is written once.
//
// What bounds it on the H100: operations. The attention stage's convs do
// 2 x 27 x Cin x Cout multiply-adds a voxel on 10^6-10^7 voxels, far above
// the card's ratio of operations to bytes, and this kernel runs them on
// the CUDA cores in f32 (67 TFLOP/s peak), not on the tensor cores (989
// TFLOP/s in bf16): the bound for bf16 input is 15x below what this design
// can reach. Tensor cores (wgmma on bf16 tiles staged by TMA) are the next
// step. f32 input must stay off TF32, so its bound is the CUDA cores' rate
// and this design is the right shape for it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32;      // output columns a block: one lane each
constexpr int kRY = 4;       // output rows a warp
constexpr int kWarps = 8;    // warps a block
constexpr int kCK = 8;       // input channels staged a chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// RC consecutive weights from shared memory, as vector loads where RC
// allows (the caller keeps the address aligned to the vector)
template <int RC>
__device__ __forceinline__ void load_w(const float* p, float (&wv)[RC]) {
  if constexpr (RC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < RC / 4; ++k) {
      const float4 q = reinterpret_cast<const float4*>(p)[k];
      wv[4 * k] = q.x;
      wv[4 * k + 1] = q.y;
      wv[4 * k + 2] = q.z;
      wv[4 * k + 3] = q.w;
    }
  } else if constexpr (RC == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    wv[0] = q.x;
    wv[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < RC; ++k) wv[k] = p[k];
  }
}

template <int RC, int NCG>
struct Tile {
  static constexpr int kNRG = kWarps / NCG;      // row groups a block
  static constexpr int kTY = kRY * kNRG;         // output rows a block
  static constexpr int kTC = RC * NCG;           // output channels a block
  static constexpr int kSY = kTY + 2;
  static constexpr int kSX = kTX + 2;
  static constexpr int kInCh = 3 * kSY * kSX;    // staged floats a channel
  static constexpr size_t kSmem =
      sizeof(float) * (kCK * kInCh + kCK * 27 * kTC);
};

template <typename T, int RC, int NCG>
__global__ void __launch_bounds__(kWarps * 32) conv3x3_kernel(
    const T* __restrict__ x,      // (B, Cin, D, H, W)
    const T* __restrict__ w,      // (Cout, Cin, 3, 3, 3)
    const T* __restrict__ bias,   // (Cout,) or null
    T* __restrict__ out,          // (B, Cout, D, H, W)
    int cin, int cout, int d, int h, int wd, int x_tiles) {
  using G = Tile<RC, NCG>;
  constexpr int SY = G::kSY;
  constexpr int SX = G::kSX;
  constexpr int TC = G::kTC;
  constexpr int IN_CH = G::kInCh;
  extern __shared__ __align__(16) float smem[];
  float* s_in = smem;                    // (kCK, 3, SY, SX)
  float* s_w = smem + kCK * IN_CH;       // (kCK, 27, TC)

  const int x0 = (blockIdx.x % x_tiles) * kTX;
  const int y0 = (blockIdx.x / x_tiles) * G::kTY;
  const int b = blockIdx.y / d;
  const int z = blockIdx.y % d;
  const int co0 = blockIdx.z * TC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = warp % G::kNRG;         // this warp's rows: rg * kRY + i
  const int cg = warp / G::kNRG;         // its channels: cg * RC + j

  const long long plane = static_cast<long long>(h) * wd;
  const long long vol = plane * d;
  const T* xb = x + static_cast<long long>(b) * cin * vol;

  float acc[kRY][RC];
#pragma unroll
  for (int i = 0; i < kRY; ++i) {
#pragma unroll
    for (int j = 0; j < RC; ++j) acc[i][j] = 0.0f;
  }

  for (int ci0 = 0; ci0 < cin; ci0 += kCK) {
    const int ckn = min(kCK, cin - ci0);
    // the haloed input of the chunk; zeros outside the volume
    for (int i = threadIdx.x; i < ckn * IN_CH; i += blockDim.x) {
      const int col = i % SX;
      int rest = i / SX;
      const int row = rest % SY;
      rest /= SY;
      const int dz = rest % 3;
      const int c = rest / 3;
      const int zz = z + dz - 1;
      const int yy = y0 + row - 1;
      const int xx = x0 + col - 1;
      float v = 0.0f;
      if (zz >= 0 && zz < d && yy >= 0 && yy < h && xx >= 0 && xx < wd) {
        v = to_f32(xb[static_cast<long long>(ci0 + c) * vol + zz * plane +
                      static_cast<long long>(yy) * wd + xx]);
      }
      s_in[i] = v;
    }
    // the chunk's weights, (channel, tap, output channel); zeros past Cout
    for (int i = threadIdx.x; i < ckn * 27 * TC; i += blockDim.x) {
      const int j = i % TC;
      const int tap = (i / TC) % 27;
      const int c = i / (27 * TC);
      const int co = co0 + j;
      s_w[i] = co < cout
                   ? to_f32(w[(static_cast<long long>(co) * cin + ci0 + c) *
                                  27 + tap])
                   : 0.0f;
    }
    __syncthreads();

    for (int c = 0; c < ckn; ++c) {
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* src =
              s_in + ((c * 3 + dz) * SY + rg * kRY) * SX + lane + dx;
          float v[kRY + 2];
#pragma unroll
          for (int r = 0; r < kRY + 2; ++r) v[r] = src[r * SX];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            float wv[RC];
            load_w<RC>(s_w + (c * 27 + dz * 9 + dy * 3 + dx) * TC + cg * RC,
                       wv);
#pragma unroll
            for (int i = 0; i < kRY; ++i) {
#pragma unroll
              for (int j = 0; j < RC; ++j) {
                acc[i][j] = fmaf(v[i + dy], wv[j], acc[i][j]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const int xx = x0 + lane;
  if (xx >= wd) return;
#pragma unroll
  for (int i = 0; i < kRY; ++i) {
    const int yy = y0 + rg * kRY + i;
    if (yy >= h) continue;
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int co = co0 + cg * RC + j;
      if (co >= cout) continue;
      T o = from_f32<T>(acc[i][j]);
      if (bias != nullptr) o = from_f32<T>(to_f32(o) + to_f32(bias[co]));
      out[(static_cast<long long>(b) * cout + co) * vol + z * plane +
          static_cast<long long>(yy) * wd + xx] = o;
    }
  }
}

template <typename T, int RC, int NCG>
int launch(const void* x, const void* w, const void* bias, void* out, int b,
           int cin, int cout, int d, int h, int wd, cudaStream_t stream) {
  using G = Tile<RC, NCG>;
  auto kernel = conv3x3_kernel<T, RC, NCG>;
  // every tile takes more than the 48 KB of static shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int x_tiles = (wd + kTX - 1) / kTX;
  const int y_tiles = (h + G::kTY - 1) / G::kTY;
  const dim3 grid(x_tiles * y_tiles, b * d, (cout + G::kTC - 1) / G::kTC);
  kernel<<<grid, kWarps * 32, G::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), cin, cout, d, h, wd,
      x_tiles);
  return static_cast<int>(cudaGetLastError());
}

// the tile shape by output width: RC channels a warp, NCG channel groups a
// block (the rest of the 8 warps stack rows)
template <typename T>
int dispatch(const void* x, const void* w, const void* bias, void* out, int b,
             int cin, int cout, int d, int h, int wd, cudaStream_t stream) {
  if (cout <= 2) {
    return launch<T, 2, 1>(x, w, bias, out, b, cin, cout, d, h, wd, stream);
  }
  if (cout <= 8) {
    return launch<T, 4, 2>(x, w, bias, out, b, cin, cout, d, h, wd, stream);
  }
  if (cout <= 16) {
    return launch<T, 8, 2>(x, w, bias, out, b, cin, cout, d, h, wd, stream);
  }
  return launch<T, 8, 4>(x, w, bias, out, b, cin, cout, d, h, wd, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes (ops/conv_cuda.py). ``dtype`` is
// 0 for f32 and 1 for bf16 (x, w, bias and out all of it); ``bias`` may be
// null. Launches on ``stream`` and does not synchronise. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int conv3x3_launch(const void* x, const void* w, const void* bias,
                              void* out, int b, int cin, int cout, int d,
                              int h, int wd, int dtype, void* stream) {
  if (b < 1 || cin < 1 || cout < 1 || d < 1 || h < 1 || wd < 1 ||
      static_cast<long long>(b) * d > 65535 || (cout + 1) / 2 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(x, w, bias, out, b, cin, cout, d, h, wd, st);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(x, w, bias, out, b, cin, cout, d, h, wd,
                                   st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
