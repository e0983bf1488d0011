// Tensor-core filterbank: the "bf16x2w" class (K1, the shipped default) and
// the "f32x2" class (K5 at "f32x2") on the exact bf16 hi/lo weight pair, and
// the "bf16" class (K5 at "bf16") on the bf16 weights.
//
// Replaces the TPU kernel body btle_tpu/wideband/fused.py:373 _kernel with
// the "im2col" inner at compute_dtype "bf16x2w", "f32x2" and "bf16" (there
// also its "im2colp" and "dots" inners, and the bf16 im2col of
// tools/dev_roll_experiment.py:60). All compute the 40-channel baseband
// before the demod tail,
//   y[o, k] = sum_{s < width} sum_{i < 40} G[s][o, i] * X[i, k + s]
// for o < 80 (rows 0..39 = y_i bins, 40..79 = y_q bins) and k < Ky, as a sum
// of exact bf16 x bf16 products in f32:
//   bf16x2w: G = Ghi + Glo, X the bf16 frames, two products per term (hi*x,
//            lo*x);
//   f32x2:   G = Ghi + Glo, X = xhi + xlo, the exact bf16 split of the f32
//            frames, four products per term (each weight fragment meets
//            both);
//   bf16:    G = bf16(G), X the bf16 frames, one product per term.
//
// GEMM orientation: y^T (Ky x kN) = A (Ky x K) . B (K x kN), K = 40 * shifts.
//   A, the frames: staged time-major in shared memory, Ft[col][i] (one
//     80-byte row of 40 bf16 per column), so row k of the im2col operand is
//     the contiguous span Ft[k .. k + shifts - 1][0..39]: A[k][kk] =
//     Ft_flat[k * 40 + kk], a Toeplitz matrix never materialised. ldmatrix
//     takes the m16n8k16 A fragments straight from it: row addresses are
//     16-byte aligned (80 * k + 2 * kk, kk a multiple of 8) and eight
//     consecutive rows lie 20 words apart, on eight distinct bank quads.
//     The frame prep (wideband/fused.py frontend_operands) writes the
//     frames time-major, (J, 40) bf16, or (2, J, 40) [xhi; xlo] at f32x2,
//     so each CTA's tile is one contiguous span copied with cp.async.
//   B, the weights: a (K_pad, kN) bf16 table of convert.py with zero rows up
//     to a multiple of 64 — kB = 2 halves, kN = 160 (hilo_weights):
//     B[s*40 + i][o] = Ghi[s][o, i], B[s*40 + i][80 + o] = Glo[s][o, i]; kB =
//     1, kN = 80 (bf16_weights): B[s*40 + i][o] = bf16(G[s][o, i]). K-slabs
//     of 64 rows stream through a 4-stage cp.async ring (rows padded to kN +
//     8 bf16: 21 or 11 x 16 bytes, odd, so ldmatrix.trans reads them without
//     conflicts).
//   The CTA has two warp groups (wn = 0, 1) of kWarpsM warps; each warp owns
//   64 columns of y x 80 GEMM columns: 4 x 10 m16n8k16 tiles, 160 f32
//   accumulators a thread. With two B halves, group wn takes half wn (hi or
//   lo) over every K row; with one, the groups split each 64-row K stage
//   (group wn its k16 steps 2 wn and 2 wn + 1), so each sums half the terms.
//   At f32x2 each B fragment feeds the xhi and the xlo MMA into one
//   accumulator.
//   Epilogue: group 0 stores its sums to shared memory, group 1 adds its own
//   (y = acc_hi + acc_lo, or the two split-K partial sums), and all threads
//   store y (80, Ky) f32 row-major in coalesced rows, masked at the ragged
//   Ky edge; frame rows past J are zero-filled by the copy (cp.async
//   src-size 0).
//
// Bound on the H100: operations. The pair is 2 x 2 x 80 x 40 x 65 FLOP per
// column, ~110 GFLOP per 131k-column bench block: 0.111 ms at the 989
// TFLOP/s bf16 tensor-core rate (f32x2: twice that, 0.223 ms; bf16: half,
// 0.056 ms); the bytes (~10.6 MB of frames in, ~42 MB of y out) take ~16 us.
// Weight traffic: every CTA sweeps all of B (2624 x 160 bf16 = 840 KB at
// 1280 taps, 420 KB at bf16) from L2. The column tile is 256 (8 warps, 1
// CTA per SM) wherever that still gives one CTA per SM: 518 CTAs and ~435
// MB of L2 reads per bench block, half of what 128-column tiles cost.
// Occupancy: the caller picks the tile (warps_m, 64 columns each: 4, 2 or
// 1) as the widest whose grid fills every SM; at the CLI's 8192-sample
// blocks (~9668 columns) that is 64 columns, 152 CTAs of 2 warps, where
// the 128-column CUDA-core kernel launched 76 CTAs for 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIn = 40;            // frame rows per column (20 I + 20 Q)
constexpr int kOut = 80;           // y rows
constexpr int kWarpM = 64;         // y columns per warp
constexpr int kMT = kWarpM / 16;   // m16 tiles per warp
constexpr int kNT = kOut / 8;      // n8 tiles per warp (one half of N)
constexpr int kKS = 64;            // K rows per pipeline stage (4 k16 steps)
constexpr int kStages = 4;

// the B table of kB halves: GEMM N (hi columns 0..79, lo 80..159) and the
// shared row of a B stage (168 or 88 bf16)
template <int kB>
struct BLayout {
  static constexpr int kN = kB * kOut;
  static constexpr int kBRow = kN + 8;
  static constexpr int kStageElems = kKS * kBRow;
  static constexpr int kRingBytes = kStages * kStageElems * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b, one m16n8k16 bf16 MMA with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kA frame operands (1: bf16x2w and bf16, 2: f32x2 [xhi; xlo]), kB B halves
// (2: the hi/lo pair, 1: bf16); 2 * kWarpsM warps, warp w computing columns
// (w % kWarpsM) * 64 .. + 63 of the tile against the hi (w < kWarpsM) or the
// lo half of B, or with one half against k16 steps 2 (w / kWarpsM) and
// 2 (w / kWarpsM) + 1 of each stage.
template <int kA, int kB, int kWarpsM>
__device__ __forceinline__ void hilo_body(
    const __nv_bfloat16* __restrict__ frames,
    const __nv_bfloat16* __restrict__ b, float* __restrict__ y, long long j,
    long long ky, int k_pad) {
  constexpr int kN = BLayout<kB>::kN;
  constexpr int kBRow = BLayout<kB>::kBRow;
  constexpr int kStageElems = BLayout<kB>::kStageElems;
  constexpr int kSteps = kKS / 16 / (3 - kB);   // k16 steps a warp takes
  constexpr int kBM = kWarpsM * kWarpM;
  constexpr int kThreads = 2 * kWarpsM * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* fs = bs + kStages * kStageElems;    // [kA][f_rows][kIn]
  const int f_rows = kBM + (k_pad + kIn - 1) / kIn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp / kWarpsM, wm = warp % kWarpsM;
  const long long k0 = (long long)blockIdx.x * kBM;
  const int n_stages = k_pad / kKS;

  // the frame tiles: rows k0 .. k0 + f_rows - 1, 5 x 16 bytes each
  for (int a = 0; a < kA; ++a) {
    const __nv_bfloat16* src = frames + (long long)a * j * kIn;
    __nv_bfloat16* dst = fs + a * f_rows * kIn;
    for (int c = tid; c < f_rows * 5; c += kThreads) {
      const bool in = k0 + c / 5 < j;
      cp_async16(dst + c * 8, in ? src + k0 * kIn + c * 8 : src, in ? 16 : 0);
    }
  }
  auto load_stage = [&](int st) {
    if (st < n_stages) {
      const __nv_bfloat16* src = b + (long long)st * kKS * kN;
      __nv_bfloat16* dst = bs + (st % kStages) * kStageElems;
      for (int c = tid; c < kKS * (kN / 8); c += kThreads) {
        const int r = c / (kN / 8), q = c % (kN / 8);
        cp_async16(dst + r * kBRow + q * 8, src + r * kN + q * 8, 16);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) load_stage(st);

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  // ldmatrix lane addresses: matrix lane / 8, row lane % 8 of it
  const int a_row = wm * kWarpM + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = (kB == 2 ? wn * kOut : 0) + (lane >> 4) * 8;
  const uint32_t fs_lane = smem_u32(fs) + 2 * (a_row * kIn + a_col);
  const uint32_t bs_lane = smem_u32(bs) + 2 * (b_row * kBRow + b_col);

  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();              // stage st landed; stage st - 1 consumed
    load_stage(st + kStages - 1);
    const uint32_t bst = bs_lane + (st % kStages) * kStageElems * 2;
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
      const int ks = kB == 2 ? step : wn * kSteps + step;
      const int kk = st * kKS + ks * 16;
      uint32_t af[kA][kMT][4];
#pragma unroll
      for (int a = 0; a < kA; ++a)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          ldmatrix_x4(af[a][mt],
                      fs_lane + 2 * (a * f_rows * kIn + mt * 16 * kIn + kk));
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, bst + 2 * (ks * 16 * kBRow + np * 16));
#pragma unroll
        for (int a = 0; a < kA; ++a)
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(acc[mt][2 * np], af[a][mt], bf[0], bf[1]);
            mma_bf16(acc[mt][2 * np + 1], af[a][mt], bf[2], bf[3]);
          }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                // the ring is free: stage y over it

  constexpr int kYS = kBM + 4;    // = 4 mod 32: conflict-free fragment stores
  float* ys = reinterpret_cast<float*>(smem);        // [kOut][kYS]
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (wn == half) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = wm * kWarpM + mt * 16 + g + (e >> 1) * 8;
            const int o = nt * 8 + 2 * q + (e & 1);
            float& d = ys[o * kYS + m];
            d = half ? d + acc[mt][nt][e] : acc[mt][nt][e];
          }
    }
    __syncthreads();
  }
  for (int idx = tid; idx < kOut * kBM; idx += kThreads) {
    const int o = idx / kBM, m = idx % kBM;
    if (k0 + m < ky) y[o * ky + k0 + m] = ys[o * kYS + m];
  }
}

template <int kWarpsM>
__global__ void __launch_bounds__(2 * kWarpsM * 32, 1)
    filterbank_bf16x2w_kernel(const __nv_bfloat16* __restrict__ frames,
                              const __nv_bfloat16* __restrict__ b,
                              float* __restrict__ y, long long j, long long ky,
                              int k_pad) {
  hilo_body<1, 2, kWarpsM>(frames, b, y, j, ky, k_pad);
}

template <int kWarpsM>
__global__ void __launch_bounds__(2 * kWarpsM * 32, 1)
    filterbank_im2col_f32x2_kernel(const __nv_bfloat16* __restrict__ frames,
                                   const __nv_bfloat16* __restrict__ b,
                                   float* __restrict__ y, long long j,
                                   long long ky, int k_pad) {
  hilo_body<2, 2, kWarpsM>(frames, b, y, j, ky, k_pad);
}

template <int kWarpsM>
__global__ void __launch_bounds__(2 * kWarpsM * 32, 1)
    filterbank_im2col_bf16_kernel(const __nv_bfloat16* __restrict__ frames,
                                  const __nv_bfloat16* __restrict__ b,
                                  float* __restrict__ y, long long j,
                                  long long ky, int k_pad) {
  hilo_body<1, 1, kWarpsM>(frames, b, y, j, ky, k_pad);
}

using Kernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, float*,
                        long long, long long, int);

// The dynamic shared-memory limit set per kernel instance and device so
// far: a launch raises it (cudaFuncSetAttribute) only when it needs more.
constexpr int kMaxDevices = 64;
int g_smem_limit[3][3][kMaxDevices];

// kInst: 0 bf16x2w, 1 f32x2, 2 bf16
template <int kA, int kB, int kInst>
int launch(Kernel k1, Kernel k2, Kernel k4, const void* frames, const void* b,
           void* y, long long j, int ky, int k_pad, int warps_m,
           void* stream) {
  if (k_pad <= 0 || k_pad % kKS) return (int)cudaErrorInvalidValue;
  const int slot = warps_m == 1 ? 0 : warps_m == 2 ? 1 : warps_m == 4 ? 2 : -1;
  if (slot < 0) return (int)cudaErrorInvalidValue;
  if (ky <= 0) return 0;
  Kernel kernel = slot == 0 ? k1 : slot == 1 ? k2 : k4;
  const int bm = warps_m * kWarpM;
  const int frame_bytes = kA * (bm + (k_pad + kIn - 1) / kIn) * kIn * 2;
  const int y_bytes = kOut * (bm + 4) * 4;
  int smem = BLayout<kB>::kRingBytes + frame_bytes;
  if (y_bytes > smem) smem = y_bytes;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int* limit = g_smem_limit[kInst][slot];
  if (dev >= kMaxDevices || smem > limit[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) limit[dev] = smem;
  }
  const unsigned blocks = (unsigned)((ky + bm - 1) / bm);
  kernel<<<blocks, 2 * warps_m * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)frames, (const __nv_bfloat16*)b, (float*)y, j, ky,
      k_pad);
  return (int)cudaGetLastError();
}

}  // namespace

// frames (J, 40) bf16 time-major; b (k_pad, 160) bf16; y (80, ky) f32
extern "C" int btle_filterbank_bf16x2w(const void* frames, const void* b,
                                       void* y, long long j, int ky, int k_pad,
                                       int warps_m, void* stream) {
  return launch<1, 2, 0>(filterbank_bf16x2w_kernel<1>, filterbank_bf16x2w_kernel<2>,
                   filterbank_bf16x2w_kernel<4>, frames, b, y, j, ky, k_pad,
                   warps_m, stream);
}

// frames (2, J, 40) bf16 time-major [xhi; xlo]; b and y as above
extern "C" int btle_filterbank_im2col_f32x2(const void* frames, const void* b,
                                            void* y, long long j, int ky,
                                            int k_pad, int warps_m,
                                            void* stream) {
  return launch<2, 2, 1>(filterbank_im2col_f32x2_kernel<1>,
                         filterbank_im2col_f32x2_kernel<2>,
                         filterbank_im2col_f32x2_kernel<4>, frames, b, y, j, ky,
                         k_pad, warps_m, stream);
}

// frames (J, 40) bf16 time-major; b (k_pad, 80) bf16; y (80, ky) f32
extern "C" int btle_filterbank_im2col_bf16(const void* frames, const void* b,
                                           void* y, long long j, int ky,
                                           int k_pad, int warps_m,
                                           void* stream) {
  return launch<1, 1, 2>(filterbank_im2col_bf16_kernel<1>,
                         filterbank_im2col_bf16_kernel<2>,
                         filterbank_im2col_bf16_kernel<4>, frames, b, y, j, ky,
                         k_pad, warps_m, stream);
}
