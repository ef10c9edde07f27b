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
// to channels-last in device memory, and SAME padding is zero fill while
// the halo is staged. The TPU kernel's X padding to a multiple of 8, Cin
// padding to 128 lanes, z/y block padding, double-buffered DMA ring and
// optimisation barrier are TPU artefacts and are not carried over.
//
// What bounds it on the H100: operations. The attention stage's convs do
// 2 x 27 x Cin x Cout operations a voxel on 10^6-10^7 voxels, far above
// the card's ratio of operations to bytes (the head, 128 -> 2, is the one
// bound by bytes). Six designs, chosen by ops/conv_cuda.py:conv_path:
//
// Tensor cores, bf16 (Cin % 16 == 0, W even): conv3x3_tc_kernel, an
// implicit GEMM. M is the output voxels, N is Cout, K is 27 taps x Cin.
// One block owns one (b, z) plane x 16 rows x 32 columns (M = 512) x BN
// output channels (BN = Cout padded to 8, at most 64; grid.z takes the
// rest). A stage is 16 input channels of one input plane (dz): its haloed
// (18, 32 + 2 vec) tile comes in by cp.async (vec = 8, 4 or 2 elements a
// copy, as W's alignment allows; out-of-volume copies are zero fill) into
// a ring of 3 stages, with the 9 (dy, dx) taps' weights, which the
// wrapper packs once per call as (Cin / 16, 27, Cout padded to 8, 16)
// bf16, K-major, zero past Cout, and which land in shared memory as 8 x
// 16-byte core matrices. The dx = +-1 shifts break the 16-byte alignment
// that ldmatrix needs in an x-major tile, so each stage is first
// transposed in shared memory to voxel-major (18, 34) x 16 channels (32
// bytes a voxel, halves XOR-swizzled so that 8 consecutive voxels hit
// distinct banks): every tap is then an aligned voxel offset into that one
// tile. 4 warpgroups each own 128 voxels as two m64 tiles (for the head's
// BN = 8, 2 warpgroups own four); per tap each warp reads its 16 rows of
// each by ldmatrix into registers (two register sets, the next tap's
// loads overlapping this tap's products) and the warpgroup issues
// wgmma.mma_async m64nBNk16 (bf16 x bf16 -> f32) with A from those
// registers and B through an unswizzled shared-memory descriptor (LBO
// 128 bytes along K, SBO 256 along N), the f32 sums in registers. The sum
// is rounded once to bf16, the bias added in bf16, and the tile goes
// through shared memory so that the channels-first stores are vectors
// along x. No split-K and no
// atomics: two launches give the same bits. What holds it on the large
// convs is staging the operands into shared memory, not the products: a
// stage's 9 taps of weights (BN x 16 x 9) weigh as much as its input
// tile, and removing the products or the transpose from the loop barely
// changes its time; the warp-level mma.sync.m16n8k16 in place of wgmma
// ran at the same speed and gave the same bits. So a block owns 512
// output voxels, which halves the weight bytes staged a voxel against
// 256.
//
// Tensor cores, f32 (Cin % 8 == 0, W even): conv3x3_xf_kernel, the same
// implicit GEMM with split-TF32 (3xTF32) products. One TF32 product keeps
// 11 significant bits and misses the f32 bar; so each operand is split as
// hi = tf32(a) (cvt.rna: ties away from zero) and lo = tf32(a - hi), and
// each product is a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, ~2^-22
// relative, is dropped), all on the tensor cores. A first small kernel
// packs the weight and splits it into hi and lo once a call, laid out so
// that each stage's 9 taps x BN x 8 weights are one contiguous block of
// K-major 8 x 16-byte core matrices; A is split in registers as it is
// read. A stage is 8 input channels of one input plane: the raw (channel,
// row, x) tile by cp.async (4 or 2 floats a copy, zero fill outside the
// volume) into a 3-stage ring, and the hi and lo weight blocks by two
// bulk copies (cp.async.bulk) that one thread issues on the stage's
// mbarrier. The weights are 3/4 of a stage's bytes: staged by ~4.5
// cp.async a thread they held 128 -> 64 at 9.7 ms on an H100, as bulk
// copies 6.9 ms. No transpose: a lane's A elements
// (voxel g, g + 8; channel t, t + 4 of mma.m16n8k8's fragment) are scalar
// shared-memory reads at a one-float dx shift, and the channel stride (8
// mod 32 words) keeps a warp's 32 reads on 32 banks. A block owns 8 rows x
// 32 columns x BN = Cout rounded up to 8 (at most 64: grid.z takes the
// rest); each warpgroup issues wgmma.mma_async m64nBNk8 (tf32 x tf32 ->
// f32) with A from registers and B through a shared-memory descriptor.
// On an H100 the 64 -> 64 and 128 -> 64 window convs ran ~1.27x faster
// with N = 64 than with two N = 32 tiles, so BN = 64 takes one m64 tile a
// warpgroup (512 threads, 1 block an SM); N <= 16 (the head,
// the L0 blocks) takes two m64 tiles a warpgroup in 256-thread blocks, two
// an SM. The tensor cores' own f32 accumulation truncates: summed over all
// Cin x 27 / 8 steps into one register it reached ~1e-5 of max |out|, so
// each stage's 27 products start from zero and are added to the running
// sum with one round-to-nearest f32 add (~1e-6 then). The deep convs,
// with fewer output tiles than 2 an SM, split their Cin chunks into runs
// (ops/conv_cuda.py:conv_splits) summed into an f32 scratch that a second
// kernel adds in run order: deterministic, no atomics; the bias follows
// the sum. Every launch gives the same bits. The bound held to is 3 x
// operations / 495 TFLOP/s (dense TF32), not the CUDA cores' 67 TFLOP/s:
// this is the least time the card can take for f32-accurate products.
//
// Narrow Cout, bf16 (Cout <= 2, Cin % 16 == 0, Cin <= 256, W % 8 == 0:
// the head): conv3x3_nt_kernel. Bound by bytes (2 x 27 x 128 x 2
// operations a voxel against 256 bytes read). The wide design above
// stages each input plane three times, once a dz, pads N from 2 to 8 and
// runs 9 taps a stage, each a chain of ldmatrix, wgmma and wait: 4.4 ms
// for the serve ROI head on an H100. Here the taps go into N: one wgmma
// m64n56k16 a chunk and m64 tile multiplies every staged voxel by all 27
// taps x 2 output channels (54 of 56 columns used), A read once a stage
// straight from the cp.async tile by ldmatrix.trans (M runs over the
// staged tile as it lies, so there is no transpose), the whole weight in
// shared memory. After an input plane's chunks, its partials go through
// shared memory one dz group at a time and each output voxel of the three
// planes that read it sums its 9 (dy, dx) partials into f32 sums kept in
// registers; an output plane is rounded and stored once the plane below
// it is in. Each input byte is staged once a block (a 10 x 32 tile over a
// slab of planes; ops/conv_cuda.py:narrow_planes). What holds it on an
// H100 (probe_conv.py): ~1 us a stage (its cp.async issue, barrier and
// the partials' pass) against a byte bound of 0.5 ms for the ROI head,
// which takes 1.4. Measured slower on the way: wgmma m64n8k16 taps with
// A by ldmatrix from a transposed tile (2.7 ms; one m64n24 wgmma a tap
// into three planes' sums made ptxas serialise, A from shared memory
// re-read A each dz, slabs of 4 planes, deeper rings spilled), and this
// design with the transpose kept (1.7) or a 6-stage ring (no gain).
//
// Narrow Cout, f32 (Cout <= 8, Cin % 4 == 0, W even): conv3x3_nf_kernel,
// on the CUDA cores with f32 FMAs. 3xTF32 with N padded to 8 would do 12x
// the products the head needs; the CUDA cores do just its 2 x 27 x Cin x
// Cout. A block owns 10 / CO output planes (CO = Cout padded to 2, 4 or
// 8) x 40 rows x 32 columns, each warp 5 rows, each lane one column; a
// stage is 4 channels of one input plane (a 3-stage cp.async ring) and
// the whole weight stays in shared memory as (Cin, 27, CO) floats; each
// staged value feeds the 3 output planes that read it and each weight
// load (one broadcast vector) 5 x CO FMAs. Bound by bytes (0.25 ms for
// the segment window's head), held by issue (FMAs and shared-memory loads
// share the schedulers): ~1 ms on an H100.
//
// Deep convs, bf16 (Cin % 16 == 0, Cout > 8, W <= 64 and not a multiple of
// 32: the coarse levels whose rows the wide design's 32-column tiles do
// not fill): conv3x3_dp_kernel. Bound by operations, but the wide design
// leaves most of its M tile outside the volume there and its grid does
// not fill the card: at L4 (10 x 13 x 12) 40 blocks of 48 serial stages,
// 156 of each block's 512 M rows in the volume. (Where those tiles are
// full, W = 64 and 32, the wide design measured faster and keeps them.)
// Here a block owns yb rows of one plane at the whole width, M running
// over the padded, flattened rows m = y * (W + 2) + x (the two columns
// past W computed and dropped), ~85-95 % of the M tile in the volume; BN
// = Cout up to 128 (m64n128: each input tile staged once); Cin split into
// runs across blocks where the tiles give fewer blocks than SMs
// (ops/conv_cuda.py:tc_splits), the runs' f32 partials summed in run order
// by conv3x3_split_sum_bf16, rounded once to bf16, the bias added in bf16
// (the other designs' rounding; deterministic, no atomics). A and B both
// come from shared memory through descriptors (the voxel-major tile kept
// as two K-major halves, so that a tap is a shift of A's start), so that a
// stage's 9 taps issue at once and the next stage is transposed while
// they run; a 4-stage ring. What holds it: the weights staged a stage (9
// x BN x 16, re-read by every block) and the transpose; L3, L4 and the
// 128 -> 128 convs at (40, 52, 48) still lose to F.conv3d (PERF.md).
//
// CUDA cores (the init conv with Cin = 4, odd W): conv3x3_kernel.
// One block owns one (b, z) output plane x TY rows x 32 columns x TC
// output channels. Per chunk of 8 input channels it stages the haloed
// input (3 x (TY + 2) x 34, as f32) and the chunk's 27 x TC weights in
// shared memory. Each warp owns 4 rows and RC output channels; each lane
// one column: it keeps the 4 x RC sums in registers, reads 6 input rows a
// (dz, dx) tap column (consecutive lanes, consecutive words: no bank
// conflicts) and the RC weights of a tap as one broadcast vector load, and
// does 4 x RC fused multiply-adds per weight vector. The sum runs over
// (channel, dz, dx, dy) in that order; the output is written once.

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

// ---------------------------------------------------------------------------
// Tensor-core design (bf16)

constexpr int kTcTX = 32;             // output columns a block
constexpr int kTcTY = 16;             // output rows a block (M = 512)
constexpr int kTcM = kTcTX * kTcTY;
constexpr int kTcCK = 16;             // input channels a stage (one k16)
constexpr int kTcStages = 3;          // cp.async ring depth
constexpr int kTcRows = kTcTY + 2;    // staged rows (y halo)
constexpr int kTcCols = kTcTX + 2;    // transposed columns (x halo)
constexpr int kTcRawX = kTcTX + 16;   // raw row: 32 + 2 vec elements, vec <= 8
constexpr int kTcRawCh = kTcRows * kTcRawX;          // raw elements a channel
constexpr int kTcRaw = kTcCK * kTcRawCh;             // raw elements a stage
constexpr int kTcVox = kTcRows * kTcCols;            // transposed voxels
constexpr int kTcOutX = kTcM + 8;     // epilogue row (padded: no conflicts)

// A block is 4 warpgroups of 2 m64 tiles each, or, for the head's N = 8
// (whose staging, not its products, is the cost), 2 warpgroups of 4
template <int BN>
struct TcTile {
  static constexpr int kWG = BN == 8 ? 2 : 4;    // warpgroups
  static constexpr int kThreads = kWG * 128;
  static constexpr int kMSub = kTcM / kWG / 64;  // m64 tiles a warpgroup
  static constexpr int kW = 9 * BN * kTcCK;      // weight elements a stage
  static constexpr int kAcc = BN / 2;            // f32 sums a thread, m64
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) *
      (kTcStages * (kTcRaw + kW) + kTcVox * kTcCK);
  static_assert(BN % 8 == 0 && BN <= 64, "wgmma N");
  static_assert(kTcStages * kTcRaw >= BN * kTcOutX, "epilogue fits");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of ``bytes`` (4, 8 or 16); zero fill when ``fill`` is false
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool fill) {
  const unsigned n = fill ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                     "r"(smem_u32(dst)), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::
                     "r"(smem_u32(dst)), "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same with each 8 x 8 matrix transposed: lane l gives the address of
// a 16-byte row of matrix l / 8, which lands as a column
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// cp.async writes are made visible to the tensor cores' (async proxy)
// reads of shared memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// shared-memory matrix descriptor of a K-major, unswizzled B tile: 8 x 16
// byte core matrices, ``lbo`` bytes apart along K, ``sbo`` along N
__device__ __forceinline__ unsigned long long wgmma_desc(const void* p,
                                                         unsigned lbo,
                                                         unsigned sbo) {
  return static_cast<unsigned long long>((smem_u32(p) & 0x3ffff) >> 4) |
         (static_cast<unsigned long long>(lbo >> 4) << 16) |
         (static_cast<unsigned long long>(sbo >> 4) << 32);
}

// D (64 x N, f32, registers) += A (64 x 16 bf16, registers: each warp of
// the warpgroup its 16 rows, as mma.m16n8k16's A) x B (16 x N, bf16,
// shared memory through ``desc``)
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2],
                                           const unsigned (&a)[4],
                                           unsigned long long desc);

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[4],
                                              const unsigned (&a)[4],
                                              unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8],
                                              const unsigned (&a)[4],
                                              unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16],
                                              const unsigned (&a)[4],
                                              unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32],
                                              const unsigned (&a)[4],
                                              unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// D (64 x N, f32, registers) += A (64 x 16 bf16) x B (16 x N bf16), both
// from shared memory through descriptors (K-major, unswizzled)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2],
                                         unsigned long long da,
                                         unsigned long long db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32],
                                            unsigned long long da,
                                            unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64],
                                            unsigned long long da,
                                            unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 56, f32) = (scale_d ? D : 0) + A (64 x 16 bf16, registers, as
// wgmma_bf16's) x B (16 x 56 bf16, shared memory)
__device__ __forceinline__ void wgmma_rs56(float (&d)[28],
                                           const unsigned (&a)[4],
                                           unsigned long long db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27"
      "}, {%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// element offset of (row r, 8-element half h) in a tile of 16-element rows
// whose halves are swapped every 4 rows: ldmatrix's 8 row addresses (8
// consecutive rows, one half) then fall in 8 distinct 16-byte bank groups
__device__ __forceinline__ int swz(int r, int h) {
  return r * 16 + ((h ^ ((r >> 2) & 1)) << 3);
}

// element offset of (row n, 8-element half h) in a B tile of 8 x 16-byte
// core matrices, n-group major: core matrix (n / 8, h) at ((n / 8) * 2 + h)
// * 64 elements, so the K-adjacent one is 128 bytes on and the N-adjacent
// one 256 bytes (the descriptor's LBO and SBO)
__device__ __forceinline__ int b_core(int n, int h) {
  return (((n >> 3) * 2 + h) << 6) + ((n & 7) << 3);
}

// cp.async of 16 input channels c0 .. c0 + 15 x ``rows`` rows y0 - 1 ..
// of input plane zz x columns x0 - VEC .. x0 + cols + VEC - 1, as
// VEC-element vectors, into ``raw`` (channel stride ``rawch``, row stride
// ``rawx``); zero fill outside the volume
template <int VEC, int THREADS>
__device__ __forceinline__ void stage_tile(
    __nv_bfloat16* raw, const __nv_bfloat16* xb, int c0, int zz, int y0,
    int x0, int rows, int cols, int rawx, int rawch, int d, int h, int wd) {
  const bool zin = zz >= 0 && zz < d;
  const long long plane = static_cast<long long>(h) * wd;
  const int nq = cols / VEC + 2;                 // vectors a staged row
  for (int i = threadIdx.x; i < kTcCK * rows * nq; i += THREADS) {
    const int q = i % nq;
    const int r = (i / nq) % rows;
    const int c = i / (nq * rows);
    const int yy = y0 - 1 + r;
    const int xs = x0 - VEC + q * VEC;
    const bool in = zin && yy >= 0 && yy < h && xs >= 0 && xs < wd;
    const __nv_bfloat16* src =
        in ? xb + (static_cast<long long>(c0 + c) * d + zz) * plane +
                 static_cast<long long>(yy) * wd + xs
           : xb;
    cp_async<VEC * 2>(raw + c * rawch + r * rawx + q * VEC, src, in);
  }
}

// cp.async of the packed weights of chunk cc, input plane offset dz: its 9
// (dy, dx) taps x output channels n0 .. n0 + BN - 1 x 16, into ``ws`` in
// core-matrix order (b_core); zeros past the packed columns
template <int BN, int THREADS>
__device__ __forceinline__ void stage_weights(__nv_bfloat16* ws,
                                              const __nv_bfloat16* wp,
                                              int cc, int dz, int n0,
                                              int np) {
  const __nv_bfloat16* wsrc =
      wp + ((static_cast<long long>(cc) * 27 + dz * 9) * np + n0) * kTcCK;
  for (int i = threadIdx.x; i < 9 * BN * 2; i += THREADS) {
    const int hh = i & 1;
    const int n = (i >> 1) % BN;
    const int t9 = (i >> 1) / BN;
    const bool in = n0 + n < np;
    cp_async<16>(ws + t9 * BN * kTcCK + b_core(n, hh),
                 in ? wsrc + (static_cast<long long>(t9) * np + n) * kTcCK +
                          hh * 8
                    : wp,
                 in);
  }
}

// The raw (channel, row, x) tile of a stage as (voxel, 16 channels), halves
// swizzled (swz): voxel v = r * cols + col holds row r, raw column col - 1
// + VEC (so col 0 is x0 - 1). The dx = +-1 shifts break the 16-byte
// alignment that ldmatrix needs in an x-major tile; voxel-major, every tap
// is an aligned voxel offset.
template <int VEC, int THREADS>
__device__ __forceinline__ void transpose_tile(__nv_bfloat16* tv,
                                               const __nv_bfloat16* rs,
                                               int nvox, int cols, int rawx,
                                               int rawch) {
  for (int i = threadIdx.x; i < 2 * nvox; i += THREADS) {
    const int v = i % nvox;
    const int hh = i / nvox;
    const int r = v / cols;
    const int col = v % cols - 1 + VEC;
    const __nv_bfloat16* src = rs + hh * 8 * rawch + r * rawx + col;
    __align__(16) __nv_bfloat16 vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) vals[e] = src[e * rawch];
    *reinterpret_cast<uint4*>(tv + swz(v, hh)) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

// Issue the cp.async copies of stage s: input channels (s / 3) * 16 + 0..15
// of input plane z + s % 3 - 1, rows y0 - 1 .. y0 + 16, columns
// x0 - vec .. x0 + 31 + vec, and the weights of its 9 (dy, dx) taps for
// output channels n0 .. n0 + BN - 1.
template <int BN, int VEC, int THREADS>
__device__ __forceinline__ void tc_issue(
    __nv_bfloat16* raw, __nv_bfloat16* ws, const __nv_bfloat16* xb,
    const __nv_bfloat16* wp, int s, int z, int y0, int x0, int n0, int np,
    int d, int h, int wd) {
  stage_tile<VEC, THREADS>(raw, xb, (s / 3) * kTcCK, z + s % 3 - 1, y0, x0,
                           kTcRows, kTcTX, kTcRawX, kTcRawCh, d, h, wd);
  stage_weights<BN, THREADS>(ws, wp, s / 3, s % 3, n0, np);
}

template <int BN, int VEC>
__global__ void __launch_bounds__(TcTile<BN>::kThreads, BN == 8 ? 2 : 1)
    conv3x3_tc_kernel(
    const __nv_bfloat16* __restrict__ x,      // (B, Cin, D, H, W)
    const __nv_bfloat16* __restrict__ wp,     // (Cin / 16, 27, np, 16)
    const __nv_bfloat16* __restrict__ bias,   // (Cout,) or null
    __nv_bfloat16* __restrict__ out,          // (B, Cout, D, H, W)
    int cin, int cout, int np, int d, int h, int wd, int x_tiles) {
  using G = TcTile<BN>;
  constexpr int ACC = G::kAcc;
  constexpr int MSUB = G::kMSub;
  constexpr int THREADS = G::kThreads;
  extern __shared__ __align__(128) __nv_bfloat16 tc_smem[];
  __nv_bfloat16* raw = tc_smem;                          // (stages, kTcRaw)
  __nv_bfloat16* ws = raw + kTcStages * kTcRaw;          // (stages, kW)
  __nv_bfloat16* tv = ws + kTcStages * G::kW;            // (kTcVox, 16)

  const int x0 = (blockIdx.x % x_tiles) * kTcTX;
  const int y0 = (blockIdx.x / x_tiles) * kTcTY;
  const int b = blockIdx.y / d;
  const int z = blockIdx.y % d;
  const int n0 = blockIdx.z * BN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // warpgroup warp / 4 owns M rows [64 MSUB (warp / 4), + 64 MSUB) as
  // MSUB m64 tiles; each warp gives the wgmma its 16 rows of each
  const int m_warp = (warp >> 2) * (MSUB * 64) + (warp & 3) * 16;
  const long long plane = static_cast<long long>(h) * wd;
  const __nv_bfloat16* xb = x + static_cast<long long>(b) * cin * d * plane;

  float acc[MSUB][ACC];
#pragma unroll
  for (int i = 0; i < MSUB; ++i) {
#pragma unroll
    for (int e = 0; e < ACC; ++e) acc[i][e] = 0.0f;
  }

  const int n_stages = (cin / kTcCK) * 3;
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < n_stages) {
      tc_issue<BN, VEC, THREADS>(raw + s * kTcRaw, ws + s * G::kW, xb, wp,
                                 s, z, y0, x0, n0, np, d, h, wd);
    }
    cp_async_commit();
  }

  // this lane's ldmatrix row of an A tile: voxel m_warp + (lane & 15) + 64 i
  // and channel half lane >> 4
  const int a_m = m_warp + (lane & 15);
  const int a_h = lane >> 4;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kTcStages - 2>();
    fence_proxy_async();
    __syncthreads();     // stage s landed; stage s - 1 fully consumed
    const int sn = s + kTcStages - 1;
    if (sn < n_stages) {
      const int slot = sn % kTcStages;
      tc_issue<BN, VEC, THREADS>(raw + slot * kTcRaw, ws + slot * G::kW,
                                 xb, wp, sn, z, y0, x0, n0, np, d, h, wd);
    }
    cp_async_commit();

    transpose_tile<VEC, THREADS>(tv, raw + (s % kTcStages) * kTcRaw, kTcVox,
                                 kTcCols, kTcRawX, kTcRawCh);
    __syncthreads();

    // 9 (dy, dx) taps: A fragments by ldmatrix into one of two register
    // sets while the other set's wgmmas run
    const __nv_bfloat16* wst = ws + (s % kTcStages) * G::kW;
    unsigned af[2][MSUB][4];
    auto load_a = [&](int t9, unsigned (&dst)[MSUB][4]) {
      const int dy = t9 / 3;
      const int dx = t9 % 3;
#pragma unroll
      for (int i = 0; i < MSUB; ++i) {
        const int m = a_m + i * 64;
        const int v = ((m / kTcTX) + dy) * kTcCols + (m % kTcTX) + dx;
        ldmatrix_x4(dst[i], tv + swz(v, a_h));
      }
    };
    load_a(0, af[0]);
#pragma unroll
    for (int t9 = 0; t9 < 9; ++t9) {
      const unsigned long long desc =
          wgmma_desc(wst + t9 * BN * kTcCK, 128, 256);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < MSUB; ++i) {
        wgmma_bf16<BN>(acc[i], af[t9 & 1][i], desc);
      }
      wgmma_commit();
      if (t9 + 1 < 9) {
        wgmma_wait<1>();         // the other register set is free again
        load_a(t9 + 1, af[(t9 + 1) & 1]);
      }
    }
    wgmma_wait<0>();             // the weights of this stage are read
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: round to bf16, add the bias in bf16, (n, m) tile in shared
  // memory, then vector stores along x
  __nv_bfloat16* so = tc_smem;                           // (BN, kTcOutX)
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < MSUB; ++i) {
#pragma unroll
    for (int e = 0; e < ACC; ++e) {
      const int m = m_warp + i * 64 + g + ((e >> 1) & 1) * 8;
      const int n = (e >> 2) * 8 + 2 * t + (e & 1);
      __nv_bfloat16 o = __float2bfloat16_rn(acc[i][e]);
      if (bias != nullptr && n0 + n < cout) {
        o = __float2bfloat16_rn(__bfloat162float(o) +
                                __bfloat162float(bias[n0 + n]));
      }
      so[n * kTcOutX + m] = o;
    }
  }
  __syncthreads();
  constexpr int kQ = kTcTX / VEC;
  const long long vol = plane * d;
  for (int i = threadIdx.x; i < BN * kTcTY * kQ; i += THREADS) {
    const int q = i % kQ;
    const int r = (i / kQ) % kTcTY;
    const int n = i / (kQ * kTcTY);
    const int yy = y0 + r;
    const int xx = x0 + q * VEC;
    if (n0 + n >= cout || yy >= h || xx >= wd) continue;
    const __nv_bfloat16* src = so + n * kTcOutX + r * kTcTX + q * VEC;
    __nv_bfloat16* dst = out + (static_cast<long long>(b) * cout + n0 + n) *
                                   vol +
                         z * plane + static_cast<long long>(yy) * wd + xx;
    if constexpr (VEC == 8) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else if constexpr (VEC == 4) {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    } else {
      *reinterpret_cast<unsigned*>(dst) =
          *reinterpret_cast<const unsigned*>(src);
    }
  }
}

template <int BN, int VEC>
int launch_tc(const void* x, const void* wp, const void* bias, void* out,
              int b, int cin, int cout, int np, int d, int h, int wd,
              cudaStream_t stream) {
  using G = TcTile<BN>;
  auto kernel = conv3x3_tc_kernel<BN, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int x_tiles = (wd + kTcTX - 1) / kTcTX;
  const int y_tiles = (h + kTcTY - 1) / kTcTY;
  const dim3 grid(x_tiles * y_tiles, b * d, (np + BN - 1) / BN);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), cin, cout, np, d, h, wd, x_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int dispatch_tc(const void* x, const void* wp, const void* bias, void* out,
                int b, int cin, int cout, int np, int d, int h, int wd,
                cudaStream_t stream) {
  if (np <= 8) {
    return launch_tc<8, VEC>(x, wp, bias, out, b, cin, cout, np, d, h, wd,
                             stream);
  }
  if (np <= 16) {
    return launch_tc<16, VEC>(x, wp, bias, out, b, cin, cout, np, d, h, wd,
                              stream);
  }
  if (np <= 32) {
    return launch_tc<32, VEC>(x, wp, bias, out, b, cin, cout, np, d, h, wd,
                              stream);
  }
  return launch_tc<64, VEC>(x, wp, bias, out, b, cin, cout, np, d, h, wd,
                            stream);
}

// ---------------------------------------------------------------------------
// Narrow-Cout design, bf16 (Cout <= 2: the head)

// (the design is in the note at the top) A block owns a 10 x 32 output
// tile over a slab of ``nz`` output planes; M runs over the staged tile
// as it lies, 12 rows x 48 columns (x0 - 8 .. x0 + 39: whole 8-element
// vectors; 576 voxels, 9 m64 tiles, 3 warpgroups of 3), so that 8
// consecutive voxels of one channel are one 16-byte ldmatrix.trans row
// (the channel stride is padded so that 8 channels' rows fall on
// distinct banks).
constexpr int kNtWG = 3;                        // warpgroups a block
constexpr int kNtThreads = kNtWG * 128;
constexpr int kNtMT = 3;                        // m64 tiles a warpgroup
constexpr int kNtTY = 10;                       // output rows a block
constexpr int kNtRows = kNtTY + 2;              // staged rows (y halo)
constexpr int kNtCols = kTcTX + 16;             // staged columns: 48
constexpr int kNtRawCh = kNtRows * kNtCols + 8; // raw elements a channel
constexpr int kNtRaw = kTcCK * kNtRawCh;        // raw elements a stage
constexpr int kNtVox = kNtRows * kNtCols;       // the staged tile's voxels
constexpr int kNtStages = 4;                    // cp.async ring depth
constexpr int kNtN = 56;                        // 27 taps x 2, padded
constexpr int kNtB = kNtN * kTcCK;              // weight elements a chunk
constexpr int kNtPs = 19;                       // a partial row: 18 + pad
constexpr int kNtOut = (kNtTY * kTcTX + kNtThreads - 1) / kNtThreads;
static_assert(kNtWG * kNtMT * 64 == kNtVox, "M is the staged tile");

__global__ void __launch_bounds__(kNtThreads, 1) conv3x3_nt_kernel(
    const __nv_bfloat16* __restrict__ x,      // (B, Cin, D, H, W)
    const __nv_bfloat16* __restrict__ wp,     // (Cin / 16, 27, 8, 16)
    const __nv_bfloat16* __restrict__ bias,   // (Cout,) or null
    __nv_bfloat16* __restrict__ out,          // (B, Cout, D, H, W)
    int cin, int cout, int d, int h, int wd, int x_tiles, int nz) {
  extern __shared__ __align__(128) __nv_bfloat16 nt_smem[];
  const int chunks = cin / kTcCK;
  __nv_bfloat16* wres = nt_smem;                       // (chunks, kNtB)
  __nv_bfloat16* raw = wres + chunks * kNtB;           // (stages, kNtRaw)
  float* ps = reinterpret_cast<float*>(raw + kNtStages * kNtRaw);  // (576, 19)

  const int x0 = (blockIdx.x % x_tiles) * kTcTX;
  const int y0 = (blockIdx.x / x_tiles) * kNtTY;
  const int slabs = (d + nz - 1) / nz;
  const int b = blockIdx.y / slabs;
  const int z0 = (blockIdx.y % slabs) * nz;            // output planes
  const int z1 = min(d, z0 + nz);                      // z0 .. z1 - 1
  const int p0 = max(z0 - 1, 0);                       // input planes
  const int p1 = min(z1 + 1, d);                       // p0 .. p1 - 1
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m_warp = (warp >> 2) * (kNtMT * 64) + (warp & 3) * 16;
  const long long plane = static_cast<long long>(h) * wd;
  const __nv_bfloat16* xb =
      x + static_cast<long long>(b) * cin * d * plane;

  // the whole weight as one 16 x 56 B tile a chunk, resident (one commit
  // group ahead of the ring's): column tap * 2 + o is w[o, c, tap]
  for (int i = threadIdx.x; i < chunks * kNtN * 2; i += kNtThreads) {
    const int hh = i & 1;
    const int n = (i >> 1) % kNtN;
    const int cc = (i >> 1) / kNtN;
    const int tap = n >> 1;
    const int o = n & 1;
    const bool in = tap < 27 && o < cout;
    cp_async<16>(wres + cc * kNtB + b_core(n, hh),
                 in ? wp + ((static_cast<long long>(cc) * 27 + tap) * 8 +
                            o) * kTcCK + hh * 8
                    : wp,
                 in);
  }
  cp_async_commit();

  // stage s: chunk s % chunks of input plane p0 + s / chunks
  const int n_stages = (p1 - p0) * chunks;
  auto issue = [&](int s) {
    stage_tile<8, kNtThreads>(raw + (s % kNtStages) * kNtRaw, xb,
                              (s % chunks) * kTcCK, p0 + s / chunks, y0, x0,
                              kNtRows, kTcTX, kNtCols, kNtRawCh, d, h, wd);
  };
#pragma unroll
  for (int s = 0; s < kNtStages - 1; ++s) {
    if (s < n_stages) issue(s);
    cp_async_commit();
  }

  float acc[kNtMT][kNtN / 2];       // this plane's partials, wgmma's
#pragma unroll
  for (int i = 0; i < kNtMT; ++i) {
#pragma unroll
    for (int e = 0; e < kNtN / 2; ++e) acc[i][e] = 0.0f;
  }
  // the sums of the output planes p - 1, p, p + 1 (r = 0, 1, 2) of this
  // thread's voxels q = threadIdx.x + j * kNtThreads (y = q / 32, x = q %
  // 32) and both output channels
  float sum[3][kNtOut][2];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int j = 0; j < kNtOut; ++j) sum[r][j][0] = sum[r][j][1] = 0.0f;
  }
  auto store = [&](int r, int zo) {
#pragma unroll
    for (int j = 0; j < kNtOut; ++j) {
      const int q = threadIdx.x + j * kNtThreads;
      const int yy = y0 + q / kTcTX;
      const int xx = x0 + q % kTcTX;
      if (q >= kNtTY * kTcTX || yy >= h || xx >= wd) continue;
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        if (o >= cout) continue;
        __nv_bfloat16 v = __float2bfloat16_rn(sum[r][j][o]);
        if (bias != nullptr) {
          v = __float2bfloat16_rn(__bfloat162float(v) +
                                  __bfloat162float(bias[o]));
        }
        out[((static_cast<long long>(b) * cout + o) * d + zo) * plane +
            static_cast<long long>(yy) * wd + xx] = v;
      }
    }
  };
  // this lane's ldmatrix.trans row: channel (lane / 16) * 8 + lane % 8,
  // voxels v .. v + 7 with v = m_warp + 64 i + (lane / 8 % 2) * 8
  const int a_c = (lane >> 4) * 8 + (lane & 7);
  const int a_v = m_warp + ((lane >> 3) & 1) * 8;
  const int g = lane >> 2;
  const int t = lane & 3;

  unsigned afs[2][kNtMT][4];
  int s = 0;
  for (int p = p0; p < p1; ++p) {
    for (int cc = 0; cc < chunks; ++cc, ++s) {
      cp_async_wait<kNtStages - 2>();
      fence_proxy_async();
      __syncthreads();   // stage s (and the weights) landed; s - 1 consumed
      if (s + kNtStages - 1 < n_stages) issue(s + kNtStages - 1);
      cp_async_commit();
      // A into one of two register sets, chosen by the chunk's parity in
      // two static branches (an asm operand from a runtime-indexed set
      // would be a copy that the next stage overwrites while the wgmma
      // still reads it): the other set's wgmmas (stage s - 1) may still
      // run
      const __nv_bfloat16* rs = raw + (s % kNtStages) * kNtRaw +
                                a_c * kNtRawCh;
      const unsigned long long db =
          wgmma_desc(wres + cc * kNtB, 128, 256);
      auto products = [&](unsigned (&af)[kNtMT][4]) {
#pragma unroll
        for (int i = 0; i < kNtMT; ++i) {
          ldmatrix_x4_trans(af[i], rs + a_v + i * 64);
        }
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < kNtMT; ++i) {
          wgmma_rs56(acc[i], af[i], db, cc > 0);   // a plane starts at 0
        }
        wgmma_commit();
      };
      if (cc & 1) {
        products(afs[1]);
      } else {
        products(afs[0]);
      }
      wgmma_wait<1>();           // stage s - 1's products are done
    }
    wgmma_wait<0>();

    // input plane p's partials into the output planes p + 1 - dz
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      const int zo = p + 1 - dz;
      if (zo < z0 || zo >= z1) continue;          // the same in every thread
#pragma unroll
      for (int i = 0; i < kNtMT; ++i) {
#pragma unroll
        for (int e = 0; e < kNtN / 2; ++e) {
          const int n = (e >> 2) * 8 + 2 * t + (e & 1) - dz * 18;
          const int m = m_warp + i * 64 + g + ((e >> 1) & 1) * 8;
          if (n >= 0 && n < 18) ps[m * kNtPs + n] = acc[i][e];
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kNtOut; ++j) {
        const int q = threadIdx.x + j * kNtThreads;
        if (q >= kNtTY * kTcTX) continue;
        // output (y, x) reads staged voxel (y + dy, x + 7 + dx)
        const float* pq =
            ps + ((q / kTcTX) * kNtCols + q % kTcTX + 7) * kNtPs;
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          float v = 0.0f;
#pragma unroll
          for (int t9 = 0; t9 < 9; ++t9) {
            v += pq[((t9 / 3) * kNtCols + t9 % 3) * kNtPs + t9 * 2 + o];
          }
          sum[2 - dz][j][o] += v;
        }
      }
      __syncthreads();
    }
    if (p - 1 >= z0 && p - 1 < z1) store(0, p - 1);   // complete
#pragma unroll
    for (int j = 0; j < kNtOut; ++j) {
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        sum[0][j][o] = sum[1][j][o];
        sum[1][j][o] = sum[2][j][o];
        sum[2][j][o] = 0.0f;
      }
    }
  }
  cp_async_wait<0>();
  if (p1 - 1 >= z0 && p1 - 1 < z1) store(0, p1 - 1);  // no input below it
}

int launch_nt(const void* x, const void* wp, const void* bias, void* out,
              int b, int cin, int cout, int d, int h, int wd, int nz,
              cudaStream_t stream) {
  auto kernel = conv3x3_nt_kernel;
  const size_t smem =
      sizeof(__nv_bfloat16) * (static_cast<size_t>(cin / kTcCK) * kNtB +
                               kNtStages * kNtRaw) +
      sizeof(float) * kNtVox * kNtPs;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int x_tiles = (wd + kTcTX - 1) / kTcTX;
  const int y_tiles = (h + kNtTY - 1) / kNtTY;
  const dim3 grid(x_tiles * y_tiles, b * ((d + nz - 1) / nz));
  kernel<<<grid, kNtThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), cin, cout, d, h, wd, x_tiles, nz);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Deep-conv design, bf16 (W <= 64: the coarse levels)

constexpr int kDpStages = 4;          // cp.async ring depth

// The raw (channel, row, x) tile of a stage as two K-major halves of
// (voxel, 8 channels), the layout wgmma reads A from shared memory in:
// voxel v = r * cols + col holds row r, raw column col - 1 + VEC (so col 0
// is x0 - 1); half h of voxel v at (h * nvox_a + v) * 8. Eight consecutive
// voxels of a half are one 8 x 16-byte core matrix, so a tap's shift is a
// shift of the descriptor's start.
template <int VEC, int THREADS>
__device__ __forceinline__ void transpose_kmajor(__nv_bfloat16* tv,
                                                 const __nv_bfloat16* rs,
                                                 int nvox, int nvox_a,
                                                 int cols, int rawx,
                                                 int rawch) {
  for (int i = threadIdx.x; i < 2 * nvox; i += THREADS) {
    const int v = i % nvox;
    const int hh = i / nvox;
    const int r = v / cols;
    const int col = v % cols - 1 + VEC;
    const __nv_bfloat16* src = rs + hh * 8 * rawch + r * rawx + col;
    __align__(16) __nv_bfloat16 vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) vals[e] = src[e * rawch];
    *reinterpret_cast<uint4*>(tv + (hh * nvox_a + v) * 8) =
        *reinterpret_cast<const uint4*>(vals);
  }
}


// A block owns one (b, z) plane x ``yb`` rows x the whole width x BN
// output channels x one run of Cin chunks. M runs over the padded,
// flattened rows of that box: m = y * (W + 2) + x, x < W valid, the two
// columns past W computed and dropped; WG warpgroups own MT m64 tiles
// each. BN = 128 takes one m64 tile a warpgroup (64 f32 sums a thread).
template <int BN, int WG, int MT>
struct DpTile {
  static constexpr int kThreads = WG * 128;
  static constexpr int kM = WG * MT * 64;
  static constexpr int kW = 9 * BN * kTcCK;      // weight elements a stage
  static constexpr int kAcc = BN / 2;
  static_assert(BN % 8 == 0 && BN <= 128, "wgmma N");
};

// raw elements a stage of the deep design (rounded to 128 bytes), and the
// voxels of its transposed tile: the box's (yb + 2) x (W + 2), or as many
// as its M rows read, whichever is more (rounded to 8)
__host__ __device__ __forceinline__ int dp_raw(int yb, int rawx) {
  return (kTcCK * (yb + 2) * rawx + 63) / 64 * 64;
}

__host__ __device__ __forceinline__ int dp_vox(int yb, int wd, int m) {
  const int px = wd + 2;
  return (max((yb + 2) * px, m + 2 * px + 2) + 7) / 8 * 8;
}

template <int BN, int WG, int MT, int VEC>
__global__ void __launch_bounds__(WG * 128, 1) conv3x3_dp_kernel(
    const __nv_bfloat16* __restrict__ x,      // (B, Cin, D, H, W)
    const __nv_bfloat16* __restrict__ wp,     // (Cin / 16, 27, np, 16)
    const __nv_bfloat16* __restrict__ bias,   // (Cout,) or null
    __nv_bfloat16* __restrict__ out,          // (B, Cout, D, H, W)
    float* __restrict__ partial,              // (splits, B, Cout, D, H, W)
    int cin, int cout, int np, int d, int h, int wd, int yb, int n_tiles,
    int chunks_per_split, int split_sums) {
  using G = DpTile<BN, WG, MT>;
  constexpr int ACC = G::kAcc;
  constexpr int THREADS = G::kThreads;
  extern __shared__ __align__(128) __nv_bfloat16 dp_smem[];
  const int px = wd + 2;
  const int rows = yb + 2;
  const int rawx = wd + 2 * VEC;
  const int rawch = rows * rawx;
  const int raw_stage = dp_raw(yb, rawx);
  const int nvox_a = dp_vox(yb, wd, G::kM);
  __nv_bfloat16* ws = dp_smem;                          // (stages, kW)
  __nv_bfloat16* raw = ws + kDpStages * G::kW;          // (stages, raw)
  __nv_bfloat16* tv = raw + kDpStages * raw_stage;      // (2, 2, nvox_a, 8)

  const int y0 = blockIdx.x * yb;
  const int b = blockIdx.y / d;
  const int z = blockIdx.y % d;
  const int nt = blockIdx.z % n_tiles;
  const int n0 = nt * BN;
  const int split = blockIdx.z / n_tiles;
  const int c_begin = split * chunks_per_split;
  const int n_chunks = min(cin / kTcCK - c_begin, chunks_per_split);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wg_m = (warp >> 2) * (MT * 64);             // warpgroup's rows
  const int y_n = min(yb, h - y0);                      // rows of this box
  const long long plane = static_cast<long long>(h) * wd;
  const long long vol = plane * d;
  const __nv_bfloat16* xb = x + static_cast<long long>(b) * cin * vol;

  // stage s: chunk c_begin + s / 3 of input plane z + s % 3 - 1
  const int n_stages = n_chunks * 3;
  auto issue = [&](int s) {
    const int slot = s % kDpStages;
    stage_tile<VEC, THREADS>(raw + slot * raw_stage, xb,
                             (c_begin + s / 3) * kTcCK, z + s % 3 - 1, y0, 0,
                             rows, wd, rawx, rawch, d, h, wd);
    stage_weights<BN, THREADS>(ws + slot * G::kW, wp, c_begin + s / 3, s % 3,
                               n0, np);
  };
  auto transpose = [&](int s) {
    transpose_kmajor<VEC, THREADS>(tv + (s & 1) * 2 * nvox_a * 8,
                                   raw + (s % kDpStages) * raw_stage,
                                   rows * px, nvox_a, px, rawx, rawch);
  };
#pragma unroll
  for (int s = 0; s < kDpStages - 1; ++s) {
    if (s < n_stages) issue(s);
    cp_async_commit();
  }
  cp_async_wait<kDpStages - 2>();
  __syncthreads();                       // stage 0 landed
  transpose(0);
  fence_proxy_async();
  __syncthreads();

  float acc[MT][ACC];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < ACC; ++e) acc[i][e] = 0.0f;
  }

  for (int s = 0; s < n_stages; ++s) {
    const __nv_bfloat16* wst = ws + (s % kDpStages) * G::kW;
    const __nv_bfloat16* ta = tv + (s & 1) * 2 * nvox_a * 8;
    wgmma_fence();
#pragma unroll
    for (int t9 = 0; t9 < 9; ++t9) {
      const int off = (t9 / 3) * px + t9 % 3;
      const unsigned long long db =
          wgmma_desc(wst + t9 * BN * kTcCK, 128, 256);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        wgmma_ss<BN>(acc[i],
                     wgmma_desc(ta + (wg_m + i * 64 + off) * 8, nvox_a * 16,
                                128),
                     db);
      }
    }
    wgmma_commit();
    if (s + 1 < n_stages) {              // the next stage, while they run
      cp_async_wait<kDpStages - 3>();
      __syncthreads();                   // stage s + 1 landed everywhere
      if (s + kDpStages - 1 < n_stages) issue(s + kDpStages - 1);
      cp_async_commit();
      transpose(s + 1);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    __syncthreads();
  }
  cp_async_wait<0>();

  // epilogue: each sum where it lies; a split's runs as f32 partials, else
  // rounded to bf16 with the bias added in bf16
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m_warp = wg_m + (warp & 3) * 16;
  const long long nb = static_cast<long long>(gridDim.y / d) * cout;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < ACC; ++e) {
      const int m = m_warp + i * 64 + g + ((e >> 1) & 1) * 8;
      const int n = n0 + (e >> 2) * 8 + 2 * t + (e & 1);
      const int yy = m / px;
      const int xx = m % px;
      if (n >= cout || xx >= wd || yy >= y_n) continue;
      const long long at = (static_cast<long long>(b) * cout + n) * vol +
                           z * plane + static_cast<long long>(y0 + yy) * wd +
                           xx;
      if (split_sums) {
        partial[split * nb * vol + at] = acc[i][e];
      } else {
        __nv_bfloat16 o = __float2bfloat16_rn(acc[i][e]);
        if (bias != nullptr) {
          o = __float2bfloat16_rn(__bfloat162float(o) +
                                  __bfloat162float(bias[n]));
        }
        out[at] = o;
      }
    }
  }
}

// out[i] = the sum of the ``splits`` f32 partials in split order, rounded
// once to bf16, then the bias added in bf16
__global__ void conv3x3_split_sum_bf16(const float* __restrict__ partial,
                                       const __nv_bfloat16* __restrict__ bias,
                                       __nv_bfloat16* __restrict__ out,
                                       long long n, int splits, int cout,
                                       long long vol) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = partial[i];
    for (int k = 1; k < splits; ++k) s += partial[k * n + i];
    __nv_bfloat16 o = __float2bfloat16_rn(s);
    if (bias != nullptr) {
      o = __float2bfloat16_rn(__bfloat162float(o) +
                              __bfloat162float(bias[(i / vol) % cout]));
    }
    out[i] = o;
  }
}

template <int BN, int WG, int MT, int VEC>
int launch_dp(const void* x, const void* wp, const void* bias, void* out,
              void* partial, int b, int cin, int cout, int np, int d, int h,
              int wd, int yb, int splits, cudaStream_t stream) {
  using G = DpTile<BN, WG, MT>;
  const int px = wd + 2;
  if ((yb - 1) * px + wd > G::kM) {   // the box's rows must fit the M tile
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(__nv_bfloat16) *
      (static_cast<size_t>(kDpStages) * (G::kW + dp_raw(yb, wd + 2 * VEC)) +
       static_cast<size_t>(dp_vox(yb, wd, G::kM)) * 2 * kTcCK);
  auto kernel = conv3x3_dp_kernel<BN, WG, MT, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (np + BN - 1) / BN;
  const int chunks = cin / kTcCK;
  const int per = (chunks + splits - 1) / splits;
  const dim3 grid((h + yb - 1) / yb, b * d, n_tiles * splits);
  kernel<<<grid, G::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(partial), cin,
      cout, np, d, h, wd, yb, n_tiles, per, splits > 1 ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(b) * cout * d * h * wd;
  const long long blocks = (n + 255) / 256;
  conv3x3_split_sum_bf16<<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                           256, 0, stream>>>(
      static_cast<const float*>(partial),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), n, splits, cout,
      static_cast<long long>(d) * h * wd);
  return static_cast<int>(cudaGetLastError());
}

// N up to 64 (the L2 blocks) with two m64 tiles a warpgroup (M = 512);
// above, N = 128 with one (M = 256), Cout = 256 in two column tiles
template <int VEC>
int dispatch_dp(const void* x, const void* wp, const void* bias, void* out,
                void* partial, int b, int cin, int cout, int np, int d,
                int h, int wd, int yb, int splits, cudaStream_t stream) {
  if (np <= 64) {
    return launch_dp<64, 4, 2, VEC>(x, wp, bias, out, partial, b, cin, cout,
                                    np, d, h, wd, yb, splits, stream);
  }
  return launch_dp<128, 4, 1, VEC>(x, wp, bias, out, partial, b, cin, cout,
                                   np, d, h, wd, yb, splits, stream);
}

// ---------------------------------------------------------------------------
// Tensor-core design (f32, split TF32)

constexpr int kXfCK = 8;              // input channels a stage (one k8)
constexpr int kXfStages = 3;          // cp.async ring depth
constexpr int kXfTY = 8;              // output rows a block
constexpr int kXfRawX = kTcTX + 8;    // raw row: 32 + 2 vec floats, vec <= 4

// A block owns TY output rows x 32 columns x BN output channels (Cout
// past BN takes more column tiles, grid.z). Each warpgroup owns MT m64
// tiles of two rows each. A staged channel is (TY + 2) rows x 40 floats,
// padded to 8 mod 32 words, so that a warp's A fragment (4 channels x 8
// voxels) hits 32 distinct banks.
template <int BN, int TY, int MT>
struct XfTile {
  static constexpr int kThreads = TY / (2 * MT) * 128;  // warpgroups x 128
  static constexpr int kMinBlocks = kThreads <= 256 ? 2 : 1;
  static constexpr int kRows = TY + 2;                  // staged rows
  static constexpr int kRawCh = ((kRows * kXfRawX + 23) / 32) * 32 + 8;
  static constexpr int kRaw = kXfCK * kRawCh;           // raw floats a stage
  static constexpr int kW = 9 * BN * kXfCK;             // hi (or lo) floats
  static constexpr size_t kSmem =
      sizeof(float) * kXfStages * (kRaw + 2 * kW);
  static_assert(BN % 8 == 0 && BN <= 64 && TY % (2 * MT) == 0, "tile");
  static_assert(kRawCh >= kRows * kXfRawX && kRawCh % 32 == 8, "stride");
};

// f32 -> (hi, lo) TF32 operands: hi = v rounded to TF32 (ties away from
// zero), lo = the rest rounded the same way; hi + lo = v within 2^-22 |v|
__device__ __forceinline__ void split_tf32(float v, unsigned& hi,
                                           unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// D (64 x N, f32, registers) += A (64 x 8 tf32, registers: each warp of
// the warpgroup its 16 rows, as mma.m16n8k8's A) x B (8 x N tf32, shared
// memory through ``desc``, K-major)
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const unsigned (&a)[4],
                                           unsigned long long desc);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4],
                                              const unsigned (&a)[4],
                                              unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8],
                                               const unsigned (&a)[4],
                                               unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16],
                                               const unsigned (&a)[4],
                                               unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const unsigned (&a)[4],
                                               unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// float offset of (row n, 4-float half h) in a K-major tf32 B tile of 8 x
// 16-byte core matrices, n-group major: core matrix (n / 8, h) at ((n / 8)
// * 2 + h) * 32 floats, so the K-adjacent one is 128 bytes on and the
// N-adjacent one 256 bytes (the descriptor's LBO and SBO)
__device__ __forceinline__ int bw_core(int n, int h) {
  return (((n >> 3) * 2 + h) << 5) + ((n & 7) << 2);
}

// mbarrier and bulk-copy helpers: one thread asks for a stage's weights
// as two contiguous bulk copies whose bytes complete the stage's barrier
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Issue the copies of a stage (chunk cc, input plane z + dz - 1): by all
// threads, cp.async of 8 channels x rows y0 - 1 .. y0 + TY x columns x0 -
// vec .. x0 + 31 + vec (zero fill outside the volume); by thread 0, the
// stage's hi and lo weights (9 taps x BN x 8, already in core-matrix
// order, one contiguous block each) as two bulk copies on ``bar``
template <int BN, int TY, int MT, int VEC>
__device__ __forceinline__ void xf_issue(float* raw, float* wsh, float* wsl,
                                         unsigned long long* bar,
                                         const float* xb, const float* wh,
                                         const float* wl, int cc, int dz,
                                         int z, int y0, int x0, int nt,
                                         int n_tiles, int d, int h, int wd) {
  using G = XfTile<BN, TY, MT>;
  const int zz = z + dz - 1;
  const bool zin = zz >= 0 && zz < d;
  const long long plane = static_cast<long long>(h) * wd;
  constexpr int kQ = kTcTX / VEC + 2;            // vectors a staged row
  for (int i = threadIdx.x; i < kXfCK * G::kRows * kQ; i += G::kThreads) {
    const int q = i % kQ;
    const int r = (i / kQ) % G::kRows;
    const int c = i / (kQ * G::kRows);
    const int yy = y0 - 1 + r;
    const int xs = x0 - VEC + q * VEC;
    const bool in = zin && yy >= 0 && yy < h && xs >= 0 && xs < wd;
    const float* src =
        in ? xb + (static_cast<long long>(cc * kXfCK + c) * d + zz) * plane +
                 static_cast<long long>(yy) * wd + xs
           : xb;
    cp_async<VEC * 4>(raw + c * G::kRawCh + r * kXfRawX + q * VEC, src, in);
  }
  if (threadIdx.x == 0) {
    const long long w0 =
        ((static_cast<long long>(cc) * 3 + dz) * n_tiles + nt) * G::kW;
    mbar_expect_tx(bar, 2 * G::kW * sizeof(float));
    bulk_copy(wsh, wh + w0, G::kW * sizeof(float), bar);
    bulk_copy(wsl, wl + w0, G::kW * sizeof(float), bar);
  }
}

template <int BN, int TY, int MT, int VEC>
__global__ void __launch_bounds__(XfTile<BN, TY, MT>::kThreads,
                                  XfTile<BN, TY, MT>::kMinBlocks)
    conv3x3_xf_kernel(
    const float* __restrict__ x,      // (B, Cin, D, H, W)
    const float* __restrict__ wh,     // TF32 hi weights, conv3x3_xf_pack
    const float* __restrict__ wl,     // the same, TF32 lo
    const float* __restrict__ bias,   // (Cout,) or null
    float* __restrict__ out,          // (B, Cout, D, H, W), or the
                                      // (splits, B, Cout, D, H, W) partials
    int cin, int cout, int d, int h, int wd, int x_tiles, int n_tiles,
    int chunks_per_split, int split_sums) {
  using G = XfTile<BN, TY, MT>;
  constexpr int ACC = BN / 2;                 // f32 sums a thread, m64
  constexpr int WSZ = G::kW;
  extern __shared__ __align__(128) float xf_smem[];
  float* raw = xf_smem;                                 // (stages, kRaw)
  float* wsh = raw + kXfStages * G::kRaw;               // (stages, WSZ)
  float* wsl = wsh + kXfStages * WSZ;                   // (stages, WSZ)

  const int x0 = (blockIdx.x % x_tiles) * kTcTX;
  const int y0 = (blockIdx.x / x_tiles) * TY;
  const int b = blockIdx.y / d;
  const int z = blockIdx.y % d;
  const int nt = blockIdx.z % n_tiles;
  const int n0 = nt * BN;
  const int split = blockIdx.z / n_tiles;
  const int c_begin = split * chunks_per_split;
  const int n_chunks = min(cin / kXfCK - c_begin, chunks_per_split);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  __shared__ __align__(8) unsigned long long wbar[kXfStages];
  if (threadIdx.x == 0) {
    for (int k = 0; k < kXfStages; ++k) mbar_init(&wbar[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // warpgroup warp / 4 owns rows 2 MT (warp / 4) .. + 2 MT - 1 as MT m64
  // tiles of two rows; warp w of it gives each tile its 16 rows: row
  // (w / 2), columns 16 (w % 2) + 0 .. 15
  const int row_w = 2 * MT * (warp >> 2) + ((warp & 3) >> 1);
  const int col_w = 16 * (warp & 1);
  const long long plane = static_cast<long long>(h) * wd;
  const long long vol = plane * d;
  const float* xb = x + static_cast<long long>(b) * cin * vol;

  float acc[MT][ACC];
  float part[MT][ACC];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < ACC; ++e) acc[i][e] = 0.0f;
  }

  const int n_stages = n_chunks * 3;
#pragma unroll
  for (int s = 0; s < kXfStages - 1; ++s) {
    if (s < n_stages) {
      xf_issue<BN, TY, MT, VEC>(raw + s * G::kRaw, wsh + s * WSZ,
                                wsl + s * WSZ, &wbar[s], xb, wh, wl,
                                c_begin + s / 3, s % 3, z, y0, x0, nt,
                                n_tiles, d, h, wd);
    }
    cp_async_commit();
  }

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kXfStages - 2>();
    fence_proxy_async();
    __syncthreads();     // stage s landed; stage s - 1 fully consumed
    const int sn = s + kXfStages - 1;
    if (sn < n_stages) {
      const int slot = sn % kXfStages;
      xf_issue<BN, TY, MT, VEC>(raw + slot * G::kRaw, wsh + slot * WSZ,
                                wsl + slot * WSZ, &wbar[slot], xb, wh, wl,
                                c_begin + sn / 3, sn % 3, z, y0, x0, nt,
                                n_tiles, d, h, wd);
    }
    cp_async_commit();

    const int slot = s % kXfStages;
    mbar_wait(&wbar[slot], (s / kXfStages) & 1);   // the weights landed
    const float* rs = raw + slot * G::kRaw + t * G::kRawCh +
                      row_w * kXfRawX + col_w + g + VEC - 1;
    // A fragments of a tap, split in registers: two sets (the next tap's
    // loads overlap this tap's products) of (m64 tile, hi / lo, 4)
    unsigned af[2][MT][2][4];
    auto load_a = [&](int t9, unsigned (&dst)[MT][2][4]) {
      const float* pa = rs + (t9 / 3) * kXfRawX + t9 % 3;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* q = pa + 2 * i * kXfRawX;
        split_tf32(q[0], dst[i][0][0], dst[i][1][0]);
        split_tf32(q[8], dst[i][0][1], dst[i][1][1]);
        split_tf32(q[4 * G::kRawCh], dst[i][0][2], dst[i][1][2]);
        split_tf32(q[4 * G::kRawCh + 8], dst[i][0][3], dst[i][1][3]);
      }
    };
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int e = 0; e < ACC; ++e) part[i][e] = 0.0f;
    }
    load_a(0, af[0]);
#pragma unroll
    for (int t9 = 0; t9 < 9; ++t9) {
      const unsigned long long dh =
          wgmma_desc(wsh + slot * WSZ + t9 * BN * kXfCK, 128, 256);
      const unsigned long long dl =
          wgmma_desc(wsl + slot * WSZ + t9 * BN * kXfCK, 128, 256);
      wgmma_fence();
      // the stage's products from zero (then one round-to-nearest add):
      // the small ones first, a_lo b_lo dropped
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        wgmma_tf32<BN>(part[i], af[t9 & 1][i][1], dh);
        wgmma_tf32<BN>(part[i], af[t9 & 1][i][0], dl);
        wgmma_tf32<BN>(part[i], af[t9 & 1][i][0], dh);
      }
      wgmma_commit();
      if (t9 + 1 < 9) {
        wgmma_wait<1>();         // the other register set is free again
        load_a(t9 + 1, af[(t9 + 1) & 1]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int e = 0; e < ACC; ++e) acc[i][e] += part[i][e];
    }
  }
  cp_async_wait<0>();

  float* dst = out;
  if (split_sums) {
    dst += static_cast<long long>(split) * (gridDim.y / d) * cout * vol;
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int yy = y0 + row_w + 2 * i;
    if (yy >= h) continue;
#pragma unroll
    for (int e = 0; e < ACC; ++e) {
      const int xx = x0 + col_w + g + ((e >> 1) & 1) * 8;
      const int co = n0 + (e >> 2) * 8 + 2 * t + (e & 1);
      if (co >= cout || xx >= wd) continue;
      float o = acc[i][e];
      if (!split_sums && bias != nullptr) o = o + bias[co];
      dst[(static_cast<long long>(b) * cout + co) * vol + z * plane +
          static_cast<long long>(yy) * wd + xx] = o;
    }
  }
}

// The f32 design's B operand, once a call: w (Cout, Cin, 3, 3, 3) split
// into its TF32 hi and lo parts, each laid out as (Cin / 8, 3 dz, column
// tile, 9 (dy, dx) taps, BN x 8) with the BN x 8 block in core-matrix
// order (bw_core), so that a stage's weights are one contiguous block;
// zeros for output channels >= Cout
template <int BN>
__global__ void conv3x3_xf_pack(const float* __restrict__ w,
                                float* __restrict__ wh,
                                float* __restrict__ wl, int cin, int cout,
                                int n_tiles) {
  const long long n = static_cast<long long>(cin) * 27 * n_tiles * BN;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int e = static_cast<int>(i % (BN * kXfCK));   // in the block
    const long long blk = i / (BN * kXfCK);
    const int t9 = static_cast<int>(blk % 9);
    const int nt = static_cast<int>((blk / 9) % n_tiles);
    const int dz = static_cast<int>((blk / (9 * n_tiles)) % 3);
    const int cc = static_cast<int>(blk / (27 * n_tiles));
    const int core = e >> 5;                 // (n / 8) * 2 + k / 4
    const int n_in = ((core >> 1) << 3) + ((e & 31) >> 2);
    const int k = ((core & 1) << 2) + (e & 3);
    const int o = nt * BN + n_in;
    const int c = cc * kXfCK + k;
    const float v =
        o < cout ? w[(static_cast<long long>(o) * cin + c) * 27 + dz * 9 + t9]
                 : 0.0f;
    unsigned hi, lo;
    split_tf32(v, hi, lo);
    wh[i] = __uint_as_float(hi);
    wl[i] = __uint_as_float(lo);
  }
}

// out[i] = sum of the ``splits`` partials in split order, then the bias
__global__ void conv3x3_split_sum(const float* __restrict__ partial,
                                  const float* __restrict__ bias,
                                  float* __restrict__ out, long long n,
                                  int splits, int cout, long long vol) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = partial[i];
    for (int k = 1; k < splits; ++k) s += partial[k * n + i];
    if (bias != nullptr) s = s + bias[(i / vol) % cout];
    out[i] = s;
  }
}

template <int BN, int MT, int VEC>
int launch_xf(const float* x, const float* w, float* wsplit,
              const float* bias, float* out, float* partial, int b, int cin,
              int cout, int np, int d, int h, int wd, int splits,
              cudaStream_t stream) {
  using G = XfTile<BN, kXfTY, MT>;
  const int n_tiles = (np + BN - 1) / BN;
  const long long nw = static_cast<long long>(cin) * 27 * n_tiles * BN;
  float* wh = wsplit;
  float* wl = wsplit + nw;
  conv3x3_xf_pack<BN><<<static_cast<int>((nw + 255) / 256), 256, 0,
                        stream>>>(w, wh, wl, cin, cout, n_tiles);
  auto kernel = conv3x3_xf_kernel<BN, kXfTY, MT, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int x_tiles = (wd + kTcTX - 1) / kTcTX;
  const int y_tiles = (h + kXfTY - 1) / kXfTY;
  const int chunks = cin / kXfCK;
  const int per = (chunks + splits - 1) / splits;
  const dim3 grid(x_tiles * y_tiles, b * d, n_tiles * splits);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(
      x, wh, wl, bias, splits > 1 ? partial : out, cin, cout, d, h, wd,
      x_tiles, n_tiles, per, splits > 1 ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long vol = static_cast<long long>(d) * h * wd;
  const long long n = static_cast<long long>(b) * cout * vol;
  const long long blocks = (n + 255) / 256;
  conv3x3_split_sum<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256,
                      0, stream>>>(partial, bias, out, n, splits, cout, vol);
  return static_cast<int>(cudaGetLastError());
}

// N = 8 or 16 (the head, the L0 blocks) with two m64 tiles a
// warpgroup, two 256-thread blocks an SM; N = 32 or 64 with one, one
// 512-thread block an SM (the N = 64 products run at the higher rate)
template <int VEC>
int dispatch_xf(const float* x, const float* w, float* wsplit,
                const float* bias, float* out, float* partial, int b,
                int cin, int cout, int np, int d, int h, int wd, int splits,
                cudaStream_t stream) {
  if (np <= 8) {
    return launch_xf<8, 2, VEC>(x, w, wsplit, bias, out, partial, b, cin,
                                cout, np, d, h, wd, splits, stream);
  }
  if (np <= 16) {
    return launch_xf<16, 2, VEC>(x, w, wsplit, bias, out, partial, b, cin,
                                 cout, np, d, h, wd, splits, stream);
  }
  if (np <= 32) {
    return launch_xf<32, 1, VEC>(x, w, wsplit, bias, out, partial, b, cin,
                                 cout, np, d, h, wd, splits, stream);
  }
  return launch_xf<64, 1, VEC>(x, w, wsplit, bias, out, partial, b, cin,
                               cout, np, d, h, wd, splits, stream);
}

// ---------------------------------------------------------------------------
// Narrow-Cout design, f32 (Cout <= 8: the head), on the CUDA cores

constexpr int kNfRY = 5;                        // output rows a warp
constexpr int kNfWarps = 8;
constexpr int kNfThreads = kNfWarps * 32;
constexpr int kNfTY = kNfRY * kNfWarps;         // output rows a block
constexpr int kNfRows = kNfTY + 2;              // staged rows (y halo)
constexpr int kNfCK = 4;                        // input channels a stage
constexpr int kNfRawCh = kNfRows * kXfRawX;     // raw floats a channel
constexpr int kNfRaw = kNfCK * kNfRawCh;        // raw floats a stage

// cp.async of ``nc`` f32 input channels c0 .. x ``rows`` rows y0 - 1 .. of
// input plane zz x columns x0 - VEC .. x0 + 31 + VEC, as VEC-float vectors,
// into ``raw`` (channel stride ``rawch``, row stride kXfRawX); zero fill
// outside the volume
template <int VEC, int THREADS>
__device__ __forceinline__ void stage_tile_f32(float* raw, const float* xb,
                                               int c0, int nc, int zz,
                                               int y0, int x0, int rows,
                                               int rawch, int d, int h,
                                               int wd) {
  const bool zin = zz >= 0 && zz < d;
  const long long plane = static_cast<long long>(h) * wd;
  constexpr int kQ = kTcTX / VEC + 2;            // vectors a staged row
  for (int i = threadIdx.x; i < nc * rows * kQ; i += THREADS) {
    const int q = i % kQ;
    const int r = (i / kQ) % rows;
    const int c = i / (kQ * rows);
    const int yy = y0 - 1 + r;
    const int xs = x0 - VEC + q * VEC;
    const bool in = zin && yy >= 0 && yy < h && xs >= 0 && xs < wd;
    const float* src =
        in ? xb + (static_cast<long long>(c0 + c) * d + zz) * plane +
                 static_cast<long long>(yy) * wd + xs
           : xb;
    cp_async<VEC * 4>(raw + c * rawch + r * kXfRawX + q * VEC, src, in);
  }
}

// One block owns a slab of 10 / CO output planes x 40 rows x 32 columns x
// all CO (Cout padded to 2, 4 or 8) output channels; each warp 5 rows,
// each lane one column. A stage is 4 channels of one input plane; the
// block marches over Cin chunks, and within each over the slab's input
// planes, each staged value feeding the up to 3 output planes that read it
// (dz = 2, 1, 0). The slab's sums stay in registers to the end.
template <int CO, int VEC>
__global__ void __launch_bounds__(kNfThreads, 2) conv3x3_nf_kernel(
    const float* __restrict__ x,      // (B, Cin, D, H, W)
    const float* __restrict__ w,      // (Cout, Cin, 3, 3, 3)
    const float* __restrict__ bias,   // (Cout,) or null
    float* __restrict__ out,          // (B, Cout, D, H, W)
    int cin, int cout, int d, int h, int wd, int x_tiles) {
  constexpr int NZ = 10 / CO;                   // output planes a block
  constexpr int kPlanes = NZ + 2;
  extern __shared__ __align__(16) float nf_smem[];
  float* s_w = nf_smem;                         // (Cin, 27, CO)
  float* raw = s_w + cin * 27 * CO;             // (stages, kNfRaw)

  const int x0 = (blockIdx.x % x_tiles) * kTcTX;
  const int y0 = (blockIdx.x / x_tiles) * kNfTY;
  const int slabs = (d + NZ - 1) / NZ;
  const int b = blockIdx.y / slabs;
  const int z0 = (blockIdx.y % slabs) * NZ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* xb =
      x + static_cast<long long>(b) * cin * d * static_cast<long long>(h) *
              wd;

  // the whole weight, (channel, tap, output channel), resident; zeros
  // past Cout
  for (int i = threadIdx.x; i < cin * 27 * CO; i += kNfThreads) {
    const int o = i % CO;
    const int ct = i / CO;
    s_w[i] = o < cout
                 ? w[(static_cast<long long>(o) * cin + ct / 27) * 27 +
                     ct % 27]
                 : 0.0f;
  }

  // stage s: chunk s / kPlanes of input plane z0 - 1 + s % kPlanes
  const int chunks = cin / kNfCK;
  const int n_stages = chunks * kPlanes;
  auto issue = [&](int s) {
    stage_tile_f32<VEC, kNfThreads>(raw + (s % kXfStages) * kNfRaw, xb,
                                    (s / kPlanes) * kNfCK, kNfCK,
                                    z0 - 1 + s % kPlanes, y0, x0, kNfRows,
                                    kNfRawCh, d, h, wd);
  };
#pragma unroll
  for (int s = 0; s < kXfStages - 1; ++s) {
    issue(s);
    cp_async_commit();
  }

  float acc[NZ][kNfRY][CO];
#pragma unroll
  for (int j = 0; j < NZ; ++j) {
#pragma unroll
    for (int i = 0; i < kNfRY; ++i) {
#pragma unroll
      for (int o = 0; o < CO; ++o) acc[j][i][o] = 0.0f;
    }
  }

  for (int cc = 0; cc < chunks; ++cc) {
#pragma unroll
    for (int pi = 0; pi < kPlanes; ++pi) {
      const int s = cc * kPlanes + pi;
      cp_async_wait<kXfStages - 2>();
      __syncthreads();   // stage s landed; stage s - 1 fully consumed
      if (s + kXfStages - 1 < n_stages) issue(s + kXfStages - 1);
      cp_async_commit();
      const float* rs = raw + (s % kXfStages) * kNfRaw +
                        warp * kNfRY * kXfRawX + lane + VEC - 1;
#pragma unroll
      for (int c = 0; c < kNfCK; ++c) {
        const float* wc = s_w + (cc * kNfCK + c) * 27 * CO;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float v[kNfRY + 2];
#pragma unroll
          for (int r = 0; r < kNfRY + 2; ++r) {
            v[r] = rs[c * kNfRawCh + r * kXfRawX + dx];
          }
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dz = 0; dz < 3; ++dz) {
              const int j = pi - dz;            // the output plane fed
              if (j < 0 || j >= NZ) continue;   // static
              float wv[CO];
              load_w<CO>(wc + (dz * 9 + dy * 3 + dx) * CO, wv);
#pragma unroll
              for (int i = 0; i < kNfRY; ++i) {
#pragma unroll
                for (int o = 0; o < CO; ++o) {
                  acc[j][i][o] = fmaf(v[i + dy], wv[o], acc[j][i][o]);
                }
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const int xx = x0 + lane;
  const int yr = y0 + warp * kNfRY;
  if (xx >= wd) return;
  const long long plane = static_cast<long long>(h) * wd;
#pragma unroll
  for (int j = 0; j < NZ; ++j) {
    if (z0 + j >= d) continue;
#pragma unroll
    for (int i = 0; i < kNfRY; ++i) {
      if (yr + i >= h) continue;
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        if (o >= cout) continue;
        float v = acc[j][i][o];
        if (bias != nullptr) v = v + bias[o];
        out[((static_cast<long long>(b) * cout + o) * d + z0 + j) * plane +
            static_cast<long long>(yr + i) * wd + xx] = v;
      }
    }
  }
}

template <int CO, int VEC>
int launch_nf(const float* x, const float* w, const float* bias, float* out,
              int b, int cin, int cout, int d, int h, int wd,
              cudaStream_t stream) {
  auto kernel = conv3x3_nf_kernel<CO, VEC>;
  const size_t smem = sizeof(float) * (static_cast<size_t>(cin) * 27 * CO +
                                       kXfStages * kNfRaw);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int x_tiles = (wd + kTcTX - 1) / kTcTX;
  const int y_tiles = (h + kNfTY - 1) / kNfTY;
  const int nz = 10 / CO;
  const dim3 grid(x_tiles * y_tiles, b * ((d + nz - 1) / nz));
  kernel<<<grid, kNfThreads, smem, stream>>>(x, w, bias, out, cin, cout, d,
                                             h, wd, x_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int dispatch_nf(const float* x, const float* w, const float* bias,
                float* out, int b, int cin, int cout, int d, int h, int wd,
                cudaStream_t stream) {
  if (cout <= 2) {
    return launch_nf<2, VEC>(x, w, bias, out, b, cin, cout, d, h, wd,
                             stream);
  }
  if (cout <= 4) {
    return launch_nf<4, VEC>(x, w, bias, out, b, cin, cout, d, h, wd,
                             stream);
  }
  return launch_nf<8, VEC>(x, w, bias, out, b, cin, cout, d, h, wd, stream);
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

// Plain C entry point of the tensor-core design, loaded with ctypes
// (ops/conv_cuda.py). bf16 x (B, Cin, D, H, W), the packed weight ``wp``
// (Cin / 16, 27, np, 16) with wp[c / 16, dz * 9 + dy * 3 + dx, o, c % 16]
// = w[o, c, dz, dy, dx] and zeros for o >= Cout (np = Cout rounded up to
// 8), bias (Cout,) or null, out (B, Cout, D, H, W). Takes Cin % 16 == 0
// and even W. Launches on ``stream`` and does not synchronise. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int conv3x3_tc_launch(const void* x, const void* wp,
                                 const void* bias, void* out, int b, int cin,
                                 int cout, int np, int d, int h, int wd,
                                 void* stream) {
  if (b < 1 || cin < 16 || cin % 16 != 0 || cout < 1 || np % 8 != 0 ||
      np < cout || np > cout + 7 || d < 1 || h < 1 || wd < 2 || wd % 2 != 0 ||
      static_cast<long long>(b) * d > 65535 || (np + 63) / 64 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // elements a copy: the widest vector that W and the alignment of x and
  // out allow (rows, planes and channels then start on a vector)
  if (reinterpret_cast<unsigned long long>(wp) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned long long align = reinterpret_cast<unsigned long long>(x) |
                                   reinterpret_cast<unsigned long long>(out);
  if (wd % 8 == 0 && align % 16 == 0) {
    return dispatch_tc<8>(x, wp, bias, out, b, cin, cout, np, d, h, wd, st);
  }
  if (wd % 4 == 0 && align % 8 == 0) {
    return dispatch_tc<4>(x, wp, bias, out, b, cin, cout, np, d, h, wd, st);
  }
  if (align % 4 == 0) {
    return dispatch_tc<2>(x, wp, bias, out, b, cin, cout, np, d, h, wd, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Plain C entry point of the f32 tensor-core design (split TF32), loaded
// with ctypes (ops/conv_cuda.py). f32 x (B, Cin, D, H, W), w (Cout, Cin,
// 3, 3, 3), bias (Cout,) or null, out (B, Cout, D, H, W); ``wsplit`` is
// scratch of 2 x Cin x 27 x Np floats, 16-byte aligned, where a first
// small kernel packs w split into its TF32 hi (first half) and lo parts
// (conv3x3_xf_pack; Np = np rounded up to a multiple of the column tile
// BN, which is np itself up to 32 and 64 above; np = Cout rounded up to 8).
// Takes Cin % 8 == 0 and even W. ``splits`` > 1 splits the Cin chunks into
// that many contiguous runs, each block summing one run into ``partial``
// (splits, B, Cout, D, H, W) f32, and a last kernel sums the runs in order
// into out; with splits == 1 ``partial`` is not read. Launches on
// ``stream`` and does not synchronise. Returns cudaGetLastError() after
// the launches (0 on success), or cudaErrorInvalidValue for arguments the
// kernels do not take.
extern "C" int conv3x3_xf_launch(const void* x, const void* w, void* wsplit,
                                 const void* bias, void* out, void* partial,
                                 int b, int cin, int cout, int np, int d,
                                 int h, int wd, int splits, void* stream) {
  const int chunks = cin / kXfCK;
  if (b < 1 || cin < kXfCK || cin % kXfCK != 0 || cout < 1 || np % 8 != 0 ||
      np < cout || np > cout + 7 || d < 1 || h < 1 || wd < 2 ||
      wd % 2 != 0 || static_cast<long long>(b) * d > 65535 || splits < 1 ||
      splits > chunks ||
      (splits - 1) * ((chunks + splits - 1) / splits) >= chunks ||
      (splits > 1 && partial == nullptr) ||
      static_cast<long long>((np + 7) / 8) * splits > 65535 ||
      reinterpret_cast<unsigned long long>(wsplit) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xv = static_cast<const float*>(x);
  const float* wv = static_cast<const float*>(w);
  float* sv = static_cast<float*>(wsplit);
  const float* bv = static_cast<const float*>(bias);
  float* ov = static_cast<float*>(out);
  float* pv = static_cast<float*>(partial);
  // floats a copy: 4 where W and x's alignment allow, else 2
  const unsigned long long align = reinterpret_cast<unsigned long long>(x);
  if (wd % 4 == 0 && align % 16 == 0) {
    return dispatch_xf<4>(xv, wv, sv, bv, ov, pv, b, cin, cout, np, d, h,
                          wd, splits, st);
  }
  if (align % 8 == 0) {
    return dispatch_xf<2>(xv, wv, sv, bv, ov, pv, b, cin, cout, np, d, h,
                          wd, splits, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Plain C entry point of the narrow-Cout design in bf16, loaded with
// ctypes (ops/conv_cuda.py). bf16 x (B, Cin, D, H, W), starting 16-byte
// aligned, the packed weight ``wp`` of conv3x3_tc_launch with np = 8,
// bias (Cout,) or null, out (B, Cout, D, H, W); each block owns ``nz``
// output planes of one (b, 10 x 32) tile column
// (ops/conv_cuda.py:narrow_planes). Takes Cout <= 2, Cin % 16 == 0 with
// Cin <= 256 (the weight stays in shared memory beside the ring) and W %
// 8 == 0. Launches on ``stream`` and does not synchronise. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int conv3x3_nw_launch(const void* x, const void* wp,
                                 const void* bias, void* out, int b, int cin,
                                 int cout, int d, int h, int wd, int nz,
                                 void* stream) {
  if (b < 1 || cin < kTcCK || cin % kTcCK != 0 || cin > 256 || cout < 1 ||
      cout > 2 || d < 1 || h < 1 || wd < 8 || wd % 8 != 0 || nz < 1 ||
      static_cast<long long>(b) * ((d + nz - 1) / nz) > 65535 ||
      reinterpret_cast<unsigned long long>(x) % 16 != 0 ||
      reinterpret_cast<unsigned long long>(wp) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_nt(x, wp, bias, out, b, cin, cout, d, h, wd, nz,
                   static_cast<cudaStream_t>(stream));
}

// Plain C entry point of the narrow-Cout design in f32 (CUDA cores),
// loaded with ctypes (ops/conv_cuda.py). f32 x (B, Cin, D, H, W), w (Cout,
// Cin, 3, 3, 3), bias (Cout,) or null, out (B, Cout, D, H, W); each block
// owns 10 / CO output planes of one (b, 40 x 32) tile column. Takes Cout <=
// 8, Cin % 4 == 0 (the weight, Cin x 27 x Cout padded to 2, 4 or 8 floats,
// stays in shared memory beside the ring) and even W. Launches on
// ``stream`` and does not synchronise. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int conv3x3_nf_launch(const void* x, const void* w,
                                 const void* bias, void* out, int b, int cin,
                                 int cout, int d, int h, int wd,
                                 void* stream) {
  if (b < 1 || cin < kNfCK || cin % kNfCK != 0 || cout < 1 || cout > 8 ||
      d < 1 || h < 1 || wd < 2 || wd % 2 != 0 ||
      static_cast<long long>(b) * d > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xv = static_cast<const float*>(x);
  const float* wv = static_cast<const float*>(w);
  const float* bv = static_cast<const float*>(bias);
  float* ov = static_cast<float*>(out);
  const unsigned long long align = reinterpret_cast<unsigned long long>(x);
  if (wd % 4 == 0 && align % 16 == 0) {
    return dispatch_nf<4>(xv, wv, bv, ov, b, cin, cout, d, h, wd, st);
  }
  if (align % 8 == 0) {
    return dispatch_nf<2>(xv, wv, bv, ov, b, cin, cout, d, h, wd, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Plain C entry point of the deep-conv design (bf16), loaded with ctypes
// (ops/conv_cuda.py). x, the packed weight ``wp``, bias and out as for
// conv3x3_tc_launch; each block owns ``yb`` rows of one (b, z) plane at
// its whole width (ops/conv_cuda.py:deep_tile). ``splits`` > 1 splits the
// Cin chunks into that many contiguous runs, each block summing one run
// into ``partial`` (splits, B, Cout, D, H, W) f32, and a last kernel sums
// the runs in order, rounds once to bf16 and adds the bias in bf16; with
// splits == 1 ``partial`` is not read. Takes Cin % 16 == 0 and even W
// whose padded rows fit the M tile. Launches on ``stream`` and does not
// synchronise. Returns cudaGetLastError() after the launches (0 on
// success), or cudaErrorInvalidValue for arguments the kernels do not
// take.
extern "C" int conv3x3_dp_launch(const void* x, const void* wp,
                                 const void* bias, void* out, void* partial,
                                 int b, int cin, int cout, int np, int d,
                                 int h, int wd, int yb, int splits,
                                 void* stream) {
  const int chunks = cin / kTcCK;
  if (b < 1 || cin < kTcCK || cin % kTcCK != 0 || cout < 1 ||
      np % 8 != 0 || np < cout || np > cout + 7 || d < 1 || h < 1 ||
      wd < 2 || wd % 2 != 0 || yb < 1 || yb > h ||
      static_cast<long long>(b) * d > 65535 || splits < 1 ||
      splits > chunks ||
      (splits - 1) * ((chunks + splits - 1) / splits) >= chunks ||
      (splits > 1 && partial == nullptr) ||
      static_cast<long long>((np + 63) / 64) * splits > 65535 ||
      reinterpret_cast<unsigned long long>(wp) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long align = reinterpret_cast<unsigned long long>(x);
  if (wd % 8 == 0 && align % 16 == 0) {
    return dispatch_dp<8>(x, wp, bias, out, partial, b, cin, cout, np, d, h,
                          wd, yb, splits, st);
  }
  if (wd % 4 == 0 && align % 8 == 0) {
    return dispatch_dp<4>(x, wp, bias, out, partial, b, cin, cout, np, d, h,
                          wd, yb, splits, st);
  }
  if (align % 4 == 0) {
    return dispatch_dp<2>(x, wp, bias, out, partial, b, cin, cout, np, d, h,
                          wd, yb, splits, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
