// DFT-folded polyphase filterbank, bf16 frames x exact bf16 hi/lo weights.
//
// Replaces the TPU kernel body btle_tpu/wideband/fused.py:_kernel with
// inner "im2col" at compute_dtype "bf16x2w" (the shipped default mode).
// It computes the 40-channel baseband before the demod tail:
//   y[o, k] = sum_{s < width} sum_{i < 40} (Whi + Wlo)[s][o, i] * F[i, k + s]
// for o < 80 (rows 0..39 = y_i bins, 40..79 = y_q bins) and k < Ky, where
// F is the (40, J) bf16 frame array (20 I + 20 Q decimated rows, zero past
// J) and W[s][o, i] = gk[s / chunk][o (+80 for lo)][(s % chunk) * 40 + i]
// are the (n_chunks, 160, chunk*40) stacked hi/lo weights of
// _g_chunks_hilo. hi + lo (~17 significant bits) is exact in f32, so the
// kernel forms w = hi + lo once per staged weight and accumulates w * x
// with one f32 FMA per term, which rounds acc + w*x once. The TPU instead
// adds the exact products hi*x and lo*x (8 x 8 mantissa bits each) to its
// f32 sum separately, rounding twice per term; so the two differ in
// rounding, not only in the order of the sums, by a few f32 ulps of y.
//
// Bound on the H100: operations. The hi/lo pair is ~110 GFLOP per 131k
// bench block (2 x 2 x 80 x 40 x 65 per output column), ~0.11 ms at the
// 989 TFLOP/s bf16 tensor-core rate; the bytes (~10.6 MB of bf16 frames in,
// ~42 MB of y out) take ~16 us. This first kernel runs on the CUDA cores
// (f32 FMA), so it sits well above that bound.
// Design: one block per 128-column tile of y, all 80 rows. The frame tile
// (40 x (128 + width - 1)) is staged once in shared memory as f32; the
// weights stream from L2 (832 KB, L2-resident) in chunks of 5 shifts into
// shared memory; each thread accumulates a 5-row x 8-column register tile
// with conflict-free shared-memory reads (rows and columns interleaved by
// 16 across threads). Tensor cores (mma/wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIn = 40;       // frame rows
constexpr int kOut = 80;      // y rows
constexpr int kTileN = 128;   // y columns per block
constexpr int kThreads = 256;
constexpr int kGroups = 16;   // row / column interleave
constexpr int kRowsPT = kOut / kGroups;     // 5
constexpr int kColsPT = kTileN / kGroups;   // 8
constexpr int kShiftChunk = 5;

// The dynamic shared-memory limit set per device so far: the entry point
// raises it through the driver only when a launch needs more.
constexpr int kMaxDevices = 64;
int g_smem_limit[kMaxDevices];

__global__ void __launch_bounds__(kThreads) filterbank_bf16x2w_kernel(
    const __nv_bfloat16* __restrict__ frames,
    const __nv_bfloat16* __restrict__ gk, float* __restrict__ y, long long j,
    long long ky, int n_chunks, int chunk, int width) {
  extern __shared__ float smem[];
  const int fsw = kTileN + width - 1;          // frame tile width
  float* fs = smem;                            // [kIn][fsw]
  float* ws = smem + kIn * fsw;                // [kShiftChunk][kOut][kIn]
  const int tid = threadIdx.x;
  const long long k0 = (long long)blockIdx.x * kTileN;

  for (int idx = tid; idx < kIn * fsw; idx += kThreads) {
    const int i = idx / fsw, c = idx % fsw;
    const long long col = k0 + c;
    fs[idx] = col < j ? __bfloat162float(frames[(long long)i * j + col]) : 0.0f;
  }

  const int cg = tid % kGroups, rg = tid / kGroups;
  float acc[kRowsPT][kColsPT];
#pragma unroll
  for (int r = 0; r < kRowsPT; ++r)
#pragma unroll
    for (int c = 0; c < kColsPT; ++c) acc[r][c] = 0.0f;

  const long long row_stride = (long long)chunk * kIn;       // gk row length
  const long long chunk_stride = 2LL * kOut * row_stride;    // 160 rows
  for (int s0 = 0; s0 < width; s0 += kShiftChunk) {
    __syncthreads();   // previous chunk's weights consumed (and fs staged)
    for (int idx = tid; idx < kShiftChunk * kOut * kIn; idx += kThreads) {
      const int ds = idx / (kOut * kIn), rem = idx % (kOut * kIn);
      const int o = rem / kIn, i = rem % kIn;
      const int s = s0 + ds;
      float w = 0.0f;
      if (s < width) {
        const long long base = (s / chunk) * chunk_stride + (s % chunk) * kIn + i;
        w = __bfloat162float(gk[base + o * row_stride]) +
            __bfloat162float(gk[base + (o + kOut) * row_stride]);
      }
      ws[idx] = w;
    }
    __syncthreads();
    const int n_s = min(kShiftChunk, width - s0);
    for (int ds = 0; ds < n_s; ++ds) {
      const float* wsd = ws + ds * kOut * kIn;
      const float* fsd = fs + s0 + ds;
      for (int i = 0; i < kIn; ++i) {
        float wv[kRowsPT], xv[kColsPT];
#pragma unroll
        for (int r = 0; r < kRowsPT; ++r) wv[r] = wsd[(rg + kGroups * r) * kIn + i];
#pragma unroll
        for (int c = 0; c < kColsPT; ++c) xv[c] = fsd[i * fsw + cg + kGroups * c];
#pragma unroll
        for (int r = 0; r < kRowsPT; ++r)
#pragma unroll
          for (int c = 0; c < kColsPT; ++c) acc[r][c] = fmaf(wv[r], xv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPT; ++r)
#pragma unroll
    for (int c = 0; c < kColsPT; ++c) {
      const long long col = k0 + cg + kGroups * c;
      if (col < ky) y[(long long)(rg + kGroups * r) * ky + col] = acc[r][c];
    }
}

}  // namespace

extern "C" int btle_filterbank_bf16x2w(const void* frames, const void* gk,
                                       void* y, long long j, int ky,
                                       int n_chunks, int chunk, int width,
                                       void* stream) {
  const int smem = (int)(sizeof(float) *
      ((size_t)kIn * (kTileN + width - 1) + (size_t)kShiftChunk * kOut * kIn));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || smem > g_smem_limit[dev]) {
    err = cudaFuncSetAttribute(filterbank_bf16x2w_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) g_smem_limit[dev] = smem;
  }
  const unsigned blocks = (unsigned)((ky + kTileN - 1) / kTileN);
  filterbank_bf16x2w_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)frames, (const __nv_bfloat16*)gk, (float*)y, j, ky,
      n_chunks, chunk, width);
  return (int)cudaGetLastError();
}
