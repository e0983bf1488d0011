// DFT-folded polyphase filterbank in the "bf16" numerics class of the
// im2col form.
//
// Replaces the TPU kernel body btle_tpu/wideband/fused.py:_kernel at
// compute_dtype "bf16" (inners "im2col", "im2colp", "dots"); "f32" with
// those inners runs filterbank_sgemm_f32.cu, and the hi/lo classes
// "bf16x2w" and "f32x2" run on the tensor cores, filterbank_hilo_mma.cu.
// The inners are Mosaic schedules of one function; every one of the class
// runs this kernel. It computes the 40-channel baseband before the demod
// tail:
//   y[o, k] = sum_{s < width} sum_{i < 40} W[s][o, i] * F[i, k + s]
// for o < 80 (rows 0..39 = y_i bins, 40..79 = y_q bins) and k < Ky, with W
// = _g_chunks rounded to bf16, (n_chunks, 80, chunk*40), and F the (40, J)
// bf16 frames (filterbank_im2col_bf16). It stages W and F as f32 values
// and applies one fmaf per term.
//
// Bound on the H100: operations. 2 x 80 x 40 x 65 FLOP per output column,
// ~55 GFLOP per 131k bench block: ~0.056 ms at the 989 TFLOP/s bf16
// tensor-core rate; the bytes (frames in, ~42 MB of y out) take ~16 us.
// This first kernel runs on the CUDA cores (f32 FMA): one block per
// 128-column tile of y, all 80 rows; the frame tile (40 x (128 + width -
// 1)) staged once in shared memory as f32, the weights streamed from L2 in
// chunks of 5 shifts into shared memory, each thread accumulating a 5-row
// x 8-column register tile with conflict-free shared-memory reads. The
// tensor-core version is later work.

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

// The dynamic shared-memory limit set per device so far: a launch raises
// it (cudaFuncSetAttribute) only when it needs more.
constexpr int kMaxDevices = 64;
int g_smem_limit[kMaxDevices];

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ void filterbank_body(
    float* smem, const T* __restrict__ frames, const T* __restrict__ gk,
    float* __restrict__ y, long long j, long long ky, int chunk, int width) {
  const int fsw = kTileN + width - 1;          // frame tile width
  float* fs = smem;                            // [kIn][fsw]
  float* ws = smem + kIn * fsw;                // [kShiftChunk][kOut][kIn]
  const int tid = threadIdx.x;
  const long long k0 = (long long)blockIdx.x * kTileN;

  for (int idx = tid; idx < kIn * fsw; idx += kThreads) {
    const int i = idx / fsw, c = idx % fsw;
    const long long col = k0 + c;
    fs[idx] = col < j ? to_f32(frames[(long long)i * j + col]) : 0.0f;
  }

  const int cg = tid % kGroups, rg = tid / kGroups;
  float acc[kRowsPT][kColsPT];
#pragma unroll
  for (int r = 0; r < kRowsPT; ++r)
#pragma unroll
    for (int c = 0; c < kColsPT; ++c) acc[r][c] = 0.0f;

  const long long row_stride = (long long)chunk * kIn;       // gk row length
  const long long chunk_stride = (long long)kOut * row_stride;
  for (int s0 = 0; s0 < width; s0 += kShiftChunk) {
    __syncthreads();   // previous chunk's weights consumed (and fs staged)
    for (int idx = tid; idx < kShiftChunk * kOut * kIn; idx += kThreads) {
      const int ds = idx / (kOut * kIn), rem = idx % (kOut * kIn);
      const int o = rem / kIn, i = rem % kIn;
      const int s = s0 + ds;
      float w = 0.0f;
      if (s < width) {
        const long long base =
            (s / chunk) * chunk_stride + (long long)(s % chunk) * kIn + i;
        w = to_f32(gk[base + o * row_stride]);
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

__global__ void __launch_bounds__(kThreads) filterbank_im2col_bf16_kernel(
    const __nv_bfloat16* __restrict__ frames,
    const __nv_bfloat16* __restrict__ gk, float* __restrict__ y, long long j,
    long long ky, int chunk, int width) {
  extern __shared__ float smem[];
  filterbank_body<__nv_bfloat16>(smem, frames, gk, y, j, ky, chunk, width);
}

template <typename T>
int launch(void (*kernel)(const T*, const T*, float*, long long, long long,
                          int, int),
           int* smem_limit, const void* frames, const void* gk, void* y,
           long long j, int ky, int chunk, int width, void* stream) {
  const int smem = (int)(sizeof(float) *
      ((size_t)kIn * (kTileN + width - 1) + (size_t)kShiftChunk * kOut * kIn));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || smem > smem_limit[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) smem_limit[dev] = smem;
  }
  const unsigned blocks = (unsigned)((ky + kTileN - 1) / kTileN);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)frames, (const T*)gk, (float*)y, j, ky, chunk, width);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int btle_filterbank_im2col_bf16(const void* frames, const void* gk,
                                           void* y, long long j, int ky,
                                           int chunk, int width, void* stream) {
  return launch<__nv_bfloat16>(filterbank_im2col_bf16_kernel, g_smem_limit,
                               frames, gk, y, j, ky, chunk, width, stream);
}
