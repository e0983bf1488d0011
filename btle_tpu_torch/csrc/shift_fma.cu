// Shifted per-row FMAs over stacked frame rows, folded to 40 channels.
//
// Replaces the TPU probe kernel of tools/dev_rollscale.py (make_kernel :43,
// body :46, call :75), which asks how the cost of N unaligned lane slices
// scales when R frame rows are stacked (K3's POLYX_STACK question):
//   a[r, k]   = sum_{j < N} f[r, k + step*j] * kc[r, j]        (r < R)
//   out[c, k] = fold(a)[c, k],  k < n_cols
// where fold is the tool's pairwise halving a[:h] + a[h:2h] down to 40
// rows (R = 40, 80 or 160: out[c] sums rows c + 40q). FP32 on the CUDA
// cores, no TF32; each row's products are summed in j order with one FMA
// each (the tool multiplies and adds, in groups of GRP), so the result
// differs from the tool's order by a few float32 ulps of the sums.
//
// Bound on the H100: bytes and operations come close. At R = 40, N = 65
// and a 131072-column block it reads 21 MB of frames and writes 21 MB:
// ~13 us at 3.35 TB/s; its 0.34 G FMAs take ~10 us at 67 TFLOP/s. At
// R = 160 the frames are 85 MB, ~32 us.
// Design: one block per 128-column tile. The (R, 128 + step*(N-1)) frame
// tile and the (R, N) coefficients are staged in shared memory (at most
// 175 KB at R = 160); each thread owns one column and every other output
// row, forms the R/40 row sums of an output in registers and folds them
// there. Consecutive threads read consecutive words: no bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOut = 40;
constexpr int kTileN = 128;
constexpr int kThreads = 256;
constexpr int kRowSplit = kThreads / kTileN;   // 2 output rows in flight

constexpr int kMaxDevices = 64;
int g_smem_limit[kMaxDevices];

template <int Q>   // R / 40 rows fold into each output row
__global__ void __launch_bounds__(kThreads) shift_fma_kernel(
    const float* __restrict__ f, const float* __restrict__ kc,
    float* __restrict__ out, long long ld_f, long long n_cols, int n, int step) {
  extern __shared__ float smem[];
  constexpr int rows = Q * kOut;
  const int width = kTileN + step * (n - 1);
  float* f_s = smem;                          // [rows][width]
  float* kc_s = f_s + rows * width;           // [rows][n]
  const int tid = threadIdx.x;
  const long long k0 = (long long)blockIdx.x * kTileN;

  for (int idx = tid; idx < rows * width; idx += kThreads) {
    const int r = idx / width, cc = idx % width;
    const long long col = k0 + cc;
    f_s[idx] = col < ld_f ? f[(long long)r * ld_f + col] : 0.0f;
  }
  for (int idx = tid; idx < rows * n; idx += kThreads) kc_s[idx] = kc[idx];
  __syncthreads();

  const int col = tid % kTileN;
  const long long k = k0 + col;
  if (k >= n_cols) return;
  for (int c = tid / kTileN; c < kOut; c += kRowSplit) {
    float p[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = c + kOut * q;
      const float* src = f_s + r * width + col;
      const float* cf = kc_s + r * n;
      float a = 0.0f;
      for (int j = 0; j < n; ++j) a = fmaf(src[step * j], cf[j], a);
      p[q] = a;
    }
    // the tool's fold: rows [0, h) += rows [h, 2h), h halving to 40
#pragma unroll
    for (int h = Q / 2; h >= 1; h /= 2)
#pragma unroll
      for (int q = 0; q < h; ++q) p[q] = p[q] + p[q + h];
    out[(long long)c * n_cols + k] = p[0];
  }
}

template <int Q>
cudaError_t launch(const void* f, const void* kc, void* out, long long ld_f,
                   long long n_cols, int n, int step, cudaStream_t stream) {
  const int width = kTileN + step * (n - 1);
  const int smem = (int)(sizeof(float) * ((size_t)Q * kOut * (width + n)));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // the limit is per kernel instance: key it by Q as well as the device
  const int slot = dev * 3 + (Q == 1 ? 0 : Q == 2 ? 1 : 2);
  if (slot >= kMaxDevices || smem > g_smem_limit[slot]) {
    err = cudaFuncSetAttribute(shift_fma_kernel<Q>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (slot < kMaxDevices) g_smem_limit[slot] = smem;
  }
  const unsigned blocks = (unsigned)((n_cols + kTileN - 1) / kTileN);
  shift_fma_kernel<Q><<<blocks, kThreads, smem, stream>>>(
      (const float*)f, (const float*)kc, (float*)out, ld_f, n_cols, n, step);
  return cudaGetLastError();
}

}  // namespace

extern "C" int btle_shift_fma(const void* f, const void* kc, void* out, int rows,
                              long long ld_f, long long n_cols, int n, int step,
                              void* stream) {
  if (n < 1 || step < 1 || n_cols < 1 || ld_f < n_cols + (long long)step * (n - 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (rows) {
    case kOut: return (int)launch<1>(f, kc, out, ld_f, n_cols, n, step, st);
    case 2 * kOut: return (int)launch<2>(f, kc, out, ld_f, n_cols, n, step, st);
    case 4 * kOut: return (int)launch<4>(f, kc, out, ld_f, n_cols, n, step, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
