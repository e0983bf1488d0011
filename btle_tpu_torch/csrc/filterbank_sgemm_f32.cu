// DFT-folded polyphase filterbank in true FP32 on the CUDA cores: K5 at
// "f32" (inners "im2col", "im2colp" and "dots").
//
// Replaces the TPU kernel body btle_tpu/wideband/fused.py:373 _kernel at
// compute_dtype "f32" with the im2col, im2colp or dots inner (and the f32
// im2col probe of tools/dev_roll_experiment.py:60). It computes the
// 40-channel baseband before the demod tail,
//   y[o, k] = sum_{i < 40} sum_{s < width} W[s][o, i] * F[i, k + s]
// for o < 80 (rows 0..39 = y_i bins, 40..79 = y_q bins) and k < Ky, one
// fmaf per term in float32: no TF32, no tensor cores, no bf16 split (the
// TPU's HIGHEST precision; the hi/lo split is the "f32x2" class).
// Operands: the (40, J) f32 frames, zero past J, and the (40, S, 80) f32
// table of convert.sgemm_weights, T[i][s][o] = W[s][o, i] (S >= width):
// for one input row i, the weights of every shift lie contiguous, o
// fastest.
//
// Bound on the H100: operations. 2 x 80 x 40 x 65 FLOP per column, 55
// GFLOP per 131k-column bench block: 0.82 ms at the 67 TFLOP/s FP32 rate;
// the bytes (21 MB of frames in, 42 MB of y out) take ~19 us.
//
// Design: an SGEMM-style register tile with a sliding frame window.
// - A CTA owns all 80 rows of 32 x kWarps columns (256 at bench
//   geometry; the caller narrows to 128 or 64 where the grid would leave
//   SMs idle). Warp w owns columns 32w .. 32w + 31; lane l owns the 5 rows
//   l % 16 + 16r (r < 5) and the 16 consecutive columns 16 (l / 16) + c.
// - The contraction runs input row by input row: stage i holds T[i] (the
//   width x 80 weights, 16-byte cp.async copies) and frame row i over the
//   tile and its width - 1 column halo (4-byte copies: J is any length),
//   in a 3-slot ring, two stages in flight while one is computed, one CTA
//   barrier per stage.
// - Per shift s a lane loads its 5 weights T[i][s][o] (16 distinct words
//   a warp: one wavefront each) and one new frame value: its 16 values
//   F[i, k + s .. k + s + 15] slide through a register ring, unrolled over
//   whole turns so every index is a constant. 80 FMAs per 6 shared-memory
//   wavefronts a warp, where the first version's 5 x 8 tile had 40 per 13
//   loads; the weight stream, 832 KB per CTA from L2, is halved against
//   128-column tiles.
// - Registers: 80 accumulators, 16 window values, 5 weights;
//   __launch_bounds__(256, 2) keeps two CTAs (16 warps) per SM; the ring is
//   3 x (width x 80 + tile + width - 1) floats, 66 KB at width 65.
// - Summation order: for each output, i outer and s inner, one running
//   float32 sum of 2600 terms; the twin sums per im2col chunk of shifts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIn = 40;               // frame rows
constexpr int kOut = 80;              // y rows
constexpr int kRT = 5;                // rows per lane
constexpr int kCT = 16;               // consecutive columns per lane
constexpr int kRG = kOut / kRT;       // 16 row groups: lanes l % 16
constexpr int kWarpN = 32;            // columns per warp: 2 lane halves x 16
constexpr int kStages = 3;
static_assert(32 / kRG * kCT == kWarpN, "a warp's lanes tile 80 x 32");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}

// 4 bytes global -> shared; src_bytes 0 writes zero and reads nothing
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

// Floats of one ring slot: the width x 80 weights, then the frame row
// over the tile and its halo, rounded to 16 bytes.
__host__ __device__ __forceinline__ int slot_floats(int width, int tile) {
  return width * kOut + (tile + width - 1 + 3) / 4 * 4;
}

// 16 resident warps a SM at every tile width: at most 128 registers
template <int kWarps>
__global__ void __launch_bounds__(32 * kWarps, 16 / kWarps)
    filterbank_im2col_f32_kernel(const float* __restrict__ frames,
                                 const float* __restrict__ wt,
                                 float* __restrict__ y, long long j,
                                 long long ky, int s_tab, int width) {
  constexpr int kThreads = 32 * kWarps;
  constexpr int kTile = kWarpN * kWarps;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long k0 = (long long)blockIdx.x * kTile;
  const int slot = slot_floats(width, kTile);
  const int f_cols = kTile + width - 1;
  const int w_chunks = width * kOut / 4;

  auto load_stage = [&](int i) {
    if (i < kIn) {
      float* ws = smem + (i % kStages) * slot;
      const float* wsrc = wt + (long long)i * s_tab * kOut;
      for (int c = tid; c < w_chunks; c += kThreads)
        cp_async16(ws + 4 * c, wsrc + 4 * c);
      float* fs = ws + width * kOut;
      const float* fsrc = frames + (long long)i * j;
      for (int x = tid; x < f_cols; x += kThreads) {
        const bool in = k0 + x < j;
        cp_async4(fs + x, in ? fsrc + k0 + x : fsrc, in ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  load_stage(0);
  load_stage(1);

  const int rg = lane % kRG;
  const int cb = warp * kWarpN + (lane / kRG) * kCT;   // first column in the tile
  float acc[kRT][kCT];
#pragma unroll
  for (int r = 0; r < kRT; ++r)
#pragma unroll
    for (int c = 0; c < kCT; ++c) acc[r][c] = 0.0f;

  for (int i = 0; i < kIn; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();            // stage i landed; stage i - 1 consumed
    load_stage(i + kStages - 1);
    const float* ws = smem + (i % kStages) * slot + rg;
    const float* fs = smem + (i % kStages) * slot + width * kOut + cb;
    // win[(s + c) % 16] = F[i, k + s + c]: 15 values before shift 0, one
    // new value per shift
    float win[kCT];
#pragma unroll
    for (int c = 0; c < kCT - 1; ++c) win[c] = fs[c];
    for (int s0 = 0; s0 < width; s0 += kCT) {
#pragma unroll
      for (int ss = 0; ss < kCT; ++ss) {
        const int s = s0 + ss;
        if (s >= width) break;
        win[(ss + kCT - 1) % kCT] = fs[s + kCT - 1];
        float w[kRT];
#pragma unroll
        for (int r = 0; r < kRT; ++r) w[r] = ws[s * kOut + kRG * r];
#pragma unroll
        for (int r = 0; r < kRT; ++r)
#pragma unroll
          for (int c = 0; c < kCT; ++c)
            acc[r][c] = fmaf(w[r], win[(ss + c) % kCT], acc[r][c]);
      }
    }
  }
  cp_async_wait<0>();

  const long long k = k0 + cb;
  const bool vec = (ky & 3) == 0 && k + kCT <= ky;
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    float* dst = y + (long long)(rg + kRG * r) * ky + k;
    if (vec) {
#pragma unroll
      for (int c = 0; c < kCT; c += 4)
        *reinterpret_cast<float4*>(dst + c) =
            make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < kCT; ++c)
        if (k + c < ky) dst[c] = acc[r][c];
    }
  }
}

using Kernel = void (*)(const float*, const float*, float*, long long, long long,
                        int, int);

Kernel pick(int warps) {
  switch (warps) {
    case 2: return filterbank_im2col_f32_kernel<2>;
    case 4: return filterbank_im2col_f32_kernel<4>;
    case 8: return filterbank_im2col_f32_kernel<8>;
    default: return nullptr;
  }
}

int smem_bytes(int width, int warps) {
  return (int)sizeof(float) * kStages * slot_floats(width, kWarpN * warps);
}

// The dynamic shared-memory limit set per instance (2, 4, 8 warps) and
// device so far: a launch raises it only when it needs more.
constexpr int kMaxDevices = 64;
int g_smem_limit[3][kMaxDevices];

cudaError_t ensure_smem(int warps, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int* limit = g_smem_limit[warps == 2 ? 0 : warps == 4 ? 1 : 2];
  if (dev < kMaxDevices && smem <= limit[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(pick(warps), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && dev < kMaxDevices) limit[dev] = smem;
  return err;
}

}  // namespace

// frames (40, J) f32; wt (40, s_tab, 80) f32 (convert.sgemm_weights); y
// (80, ky) f32; warps 2, 4 or 8 (64, 128 or 256 columns per CTA)
extern "C" int btle_filterbank_im2col_f32(const void* frames, const void* wt,
                                          void* y, long long j, int ky, int s_tab,
                                          int width, int warps, void* stream) {
  if (pick(warps) == nullptr || width < 1 || s_tab < width || j < 1)
    return (int)cudaErrorInvalidValue;
  if (ky <= 0) return 0;
  const int smem = smem_bytes(width, warps);
  cudaError_t err = ensure_smem(warps, smem);
  if (err != cudaSuccess) return (int)err;
  const int tile = kWarpN * warps;
  const unsigned blocks = (unsigned)((ky + tile - 1) / tile);
  pick(warps)<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)frames, (const float*)wt, (float*)y, j, ky, s_tab, width);
  return (int)cudaGetLastError();
}

// The launch shape for (ky, width, warps): info[0] dynamic shared memory
// (bytes), [1] resident CTAs per SM, [2] CTAs in the grid, [3] threads per
// CTA, [4] columns per CTA.
extern "C" int btle_filterbank_im2col_f32_plan(int ky, int width, int warps,
                                               int* info) {
  if (pick(warps) == nullptr || width < 1) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(width, warps);
  cudaError_t err = ensure_smem(warps, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pick(warps),
                                                      32 * warps, smem);
  if (err != cudaSuccess) return (int)err;
  const int tile = kWarpN * warps;
  info[0] = smem;
  info[1] = per_sm;
  info[2] = (ky + tile - 1) / tile;
  info[3] = 32 * warps;
  info[4] = tile;
  return 0;
}
