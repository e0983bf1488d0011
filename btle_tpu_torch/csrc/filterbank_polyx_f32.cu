// Exact-f32 true-polyphase filterbank ("polyx": stacked pre-shifted frames).
//
// Replaces the TPU kernel body btle_tpu/wideband/fused.py:_kernel_polyx
// (tables from _polyx_tables), the compute_dtype "f32" parity mode. Per
// output column k < Ky:
//   acc[r, k] = sum_{j < n_slices} F4[r, k + stack*j] * kcoefx[r, j]  (r < rows)
//   y[o, k]   = sum_{r < rows} w4x[o, r] * acc[r, k]                  (o < 80)
// where F4 is the (rows = stack*40, J) f32 array of permuted, pre-shifted
// frame rows (zero-padded by the caller to cover every read) and w4x is the
// 40-point DFT (with the row permutation) over the stacked accumulator.
// Everything is true FP32 on the CUDA cores: no TF32, no tensor-core pass —
// a reduced-precision pass would ghost strong bursts into other channels.
//
// Bound on the H100: operations, narrowly. Per 131k bench block the
// stacked FMAs are ~0.7 GFLOP and the DFT ~1.7 GFLOP: ~36 us at 67 TFLOP/s
// FP32; the bytes (~42 MB of stacked frames read, ~42 MB of y written) take
// ~25 us at 3.35 TB/s.
// Design: one block per 128-column tile. Phase 1 forms the tile's
// (rows x 128) accumulator in shared memory (threads walk consecutive
// columns, so the 33 strided frame reads per entry hit L1); phase 2 is the
// 80 x rows DFT product from shared memory with a 5-row x 8-column register
// tile per thread, rows and columns interleaved by 16 across threads for
// conflict-free shared-memory reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOut = 80;
constexpr int kTileN = 128;
constexpr int kThreads = 256;
constexpr int kGroups = 16;
constexpr int kRowsPT = kOut / kGroups;     // 5
constexpr int kColsPT = kTileN / kGroups;   // 8

// The dynamic shared-memory limit set per device so far: the entry point
// raises it through the driver only when a launch needs more.
constexpr int kMaxDevices = 64;
int g_smem_limit[kMaxDevices];

__global__ void __launch_bounds__(kThreads) filterbank_polyx_f32_kernel(
    const float* __restrict__ f4, const float* __restrict__ kcoefx,
    const float* __restrict__ w4x, float* __restrict__ y, long long j,
    long long ky, int rows, int n_slices, int stack) {
  extern __shared__ float smem[];
  float* acc_s = smem;                          // [rows][kTileN]
  float* w_s = acc_s + rows * kTileN;           // [kOut][rows]
  float* kc_s = w_s + kOut * rows;              // [rows][n_slices]
  const int tid = threadIdx.x;
  const long long k0 = (long long)blockIdx.x * kTileN;

  for (int idx = tid; idx < kOut * rows; idx += kThreads) w_s[idx] = w4x[idx];
  for (int idx = tid; idx < rows * n_slices; idx += kThreads) kc_s[idx] = kcoefx[idx];
  __syncthreads();

  for (int idx = tid; idx < rows * kTileN; idx += kThreads) {
    const int r = idx / kTileN, c = idx % kTileN;
    const long long col = k0 + c;
    float a = 0.0f;
    if (col < ky) {
      const float* src = f4 + (long long)r * j + col;
      const float* kc = kc_s + r * n_slices;
      for (int s = 0; s < n_slices; ++s) a = fmaf(src[(long long)stack * s], kc[s], a);
    }
    acc_s[idx] = a;
  }
  __syncthreads();

  const int cg = tid % kGroups, rg = tid / kGroups;
  float acc[kRowsPT][kColsPT];
#pragma unroll
  for (int a = 0; a < kRowsPT; ++a)
#pragma unroll
    for (int c = 0; c < kColsPT; ++c) acc[a][c] = 0.0f;
  for (int r = 0; r < rows; ++r) {
    float wv[kRowsPT], xv[kColsPT];
#pragma unroll
    for (int a = 0; a < kRowsPT; ++a) wv[a] = w_s[(rg + kGroups * a) * rows + r];
#pragma unroll
    for (int c = 0; c < kColsPT; ++c) xv[c] = acc_s[r * kTileN + cg + kGroups * c];
#pragma unroll
    for (int a = 0; a < kRowsPT; ++a)
#pragma unroll
      for (int c = 0; c < kColsPT; ++c) acc[a][c] = fmaf(wv[a], xv[c], acc[a][c]);
  }
#pragma unroll
  for (int a = 0; a < kRowsPT; ++a)
#pragma unroll
    for (int c = 0; c < kColsPT; ++c) {
      const long long col = k0 + cg + kGroups * c;
      if (col < ky) y[(long long)(rg + kGroups * a) * ky + col] = acc[a][c];
    }
}

}  // namespace

extern "C" int btle_filterbank_polyx_f32(const void* f4, const void* kcoefx,
                                         const void* w4x, void* y, long long j,
                                         int ky, int rows, int n_slices,
                                         int stack, void* stream) {
  const int smem = (int)(sizeof(float) *
      ((size_t)rows * kTileN + (size_t)kOut * rows + (size_t)rows * n_slices));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || smem > g_smem_limit[dev]) {
    err = cudaFuncSetAttribute(filterbank_polyx_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) g_smem_limit[dev] = smem;
  }
  const unsigned blocks = (unsigned)((ky + kTileN - 1) / kTileN);
  filterbank_polyx_f32_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)f4, (const float*)kcoefx, (const float*)w4x, (float*)y, j,
      ky, rows, n_slices, stack);
  return (int)cudaGetLastError();
}
