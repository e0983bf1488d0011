// Access-address correlation on its own, and the strided-roll row stack.
//
// Replaces the TPU probe kernels of tools/dev_aagrp_repro.py (corr_kernel
// :90 and roll_kernel :103, call :118), the AA-only variant of
// tools/dev_aagrp_bisect.py (run_aa_only :227, call :265) and the AA
// variants of tools/dev_roll_experiment.py (_aa_kernel :130, call :197).
// On the TPU each manufactures the 32 shifted copies of the decision
// lattice with strided pltpu.roll ops over a broadcast and reduces them
// with a block-diagonal matmul (AA_GRP shifts per roll group), or with 32
// shifted FMAs. On Hopper there is no roll to amortise: a thread reads
// its 32 taps straight out of shared memory.
//
// btle_aa_corr, per row c and column t < n_out:
//   acc[c, t] = sum_{j < 32} w[c, j] * s[c, t + sps*j]
//   hit[c, t] = acc[c, t] == n_mask
// with s either float32 values or int8 decisions mapped to +1 (> 0) and
// -1 in the kernel. The taps are summed in groups of GRP (a partial sum
// per group, then added): the TPU's per-roll-group matmul accumulation.
// With +-1/0 operands every partial sum is a small integer, so the result
// is exact whatever the grouping or order.
//
// btle_shift_stack, the rolled stack itself, with its wrap-around:
//   x[r*rows + c, t] = s[c, (t + k0 + sps*(grp-1-r)) mod nbp],  t < nbp.
//
// Bound on the H100: bytes. At the probes' largest size (40 rows of a
// 131072-column block) the correlation reads 21 MB of lattice and writes
// 21 MB of acc and 5 MB of hits, ~14 us at 3.35 TB/s; its 32 FMAs per
// output are ~0.34 GFLOP, ~5 us at 67 TFLOP/s FP32.
// Design: one block per (row, 256-column tile); the tile and its
// 31*sps halo are staged once in shared memory (consecutive threads read
// consecutive words: no bank conflicts), the row's 32 weights too, and
// each thread forms one output with its taps unrolled. The stack is a
// plain gather, one thread per output element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 32;
constexpr int kTile = 256;      // output columns per block (= threads)
constexpr int kMaxSps = 8;
constexpr int kSpan = kTile + (kTaps - 1) * kMaxSps;

__device__ __forceinline__ float lattice_value(float v) { return v; }
__device__ __forceinline__ float lattice_value(int8_t v) {
  return v > 0 ? 1.0f : -1.0f;
}

template <typename T, int GRP>
__global__ void __launch_bounds__(kTile) aa_corr_kernel(
    const T* __restrict__ s, const float* __restrict__ w,
    float* __restrict__ acc_out, int8_t* __restrict__ hit_out,
    long long ld_s, long long n_out, int sps, float n_mask) {
  __shared__ float s_s[kSpan];
  __shared__ float w_s[kTaps];
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * kTile;
  const T* row = s + (long long)c * ld_s;
  const int span = kTile + (kTaps - 1) * sps;
  for (int k = tid; k < span; k += kTile) {
    const long long t = t0 + k;
    s_s[k] = t < ld_s ? lattice_value(row[t]) : 0.0f;
  }
  if (tid < kTaps) w_s[tid] = w[c * kTaps + tid];
  __syncthreads();

  const long long t = t0 + tid;
  if (t >= n_out) return;
  float acc = 0.0f;
#pragma unroll
  for (int g0 = 0; g0 < kTaps; g0 += GRP) {
    float part = 0.0f;
#pragma unroll
    for (int r = 0; r < GRP; ++r)
      part = fmaf(w_s[g0 + r], s_s[tid + sps * (g0 + r)], part);
    acc += part;
  }
  acc_out[(long long)c * n_out + t] = acc;
  hit_out[(long long)c * n_out + t] = acc == n_mask;
}

template <typename T>
cudaError_t launch_corr(const void* s, const void* w, void* acc, void* hit,
                        int rows, long long ld_s, long long n_out, int sps,
                        int grp, int n_mask, cudaStream_t stream) {
  dim3 grid((unsigned)((n_out + kTile - 1) / kTile), (unsigned)rows);
  const T* sp = (const T*)s;
  const float* wp = (const float*)w;
  float* ap = (float*)acc;
  int8_t* hp = (int8_t*)hit;
  const float nm = (float)n_mask;
  switch (grp) {
    case 1: aa_corr_kernel<T, 1><<<grid, kTile, 0, stream>>>(sp, wp, ap, hp, ld_s, n_out, sps, nm); break;
    case 2: aa_corr_kernel<T, 2><<<grid, kTile, 0, stream>>>(sp, wp, ap, hp, ld_s, n_out, sps, nm); break;
    case 4: aa_corr_kernel<T, 4><<<grid, kTile, 0, stream>>>(sp, wp, ap, hp, ld_s, n_out, sps, nm); break;
    case 8: aa_corr_kernel<T, 8><<<grid, kTile, 0, stream>>>(sp, wp, ap, hp, ld_s, n_out, sps, nm); break;
    case 16: aa_corr_kernel<T, 16><<<grid, kTile, 0, stream>>>(sp, wp, ap, hp, ld_s, n_out, sps, nm); break;
    case 32: aa_corr_kernel<T, 32><<<grid, kTile, 0, stream>>>(sp, wp, ap, hp, ld_s, n_out, sps, nm); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kTile) shift_stack_kernel(
    const float* __restrict__ s, float* __restrict__ x, int rows,
    long long nbp, int grp, int sps, long long k0) {
  const int out_row = blockIdx.y;             // r * rows + c
  const int r = out_row / rows, c = out_row % rows;
  const long long t = (long long)blockIdx.x * kTile + threadIdx.x;
  if (t >= nbp) return;
  const long long shift = k0 + (long long)sps * (grp - 1 - r);
  long long src = (t + shift) % nbp;
  if (src < 0) src += nbp;
  x[(long long)out_row * nbp + t] = s[(long long)c * nbp + src];
}

}  // namespace

extern "C" int btle_aa_corr(const void* s, const void* w, void* acc, void* hit,
                            int rows, long long ld_s, long long n_out, int sps,
                            int grp, int is_int8, int n_mask, void* stream) {
  if (sps < 1 || sps > kMaxSps || rows < 1 || n_out < 1 ||
      ld_s < n_out + (long long)(kTaps - 1) * sps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_int8 ? launch_corr<int8_t>(s, w, acc, hit, rows, ld_s, n_out,
                                             sps, grp, n_mask, st)
                       : launch_corr<float>(s, w, acc, hit, rows, ld_s, n_out,
                                            sps, grp, n_mask, st));
}

extern "C" int btle_shift_stack(const void* s, void* x, int rows, long long nbp,
                                int grp, int sps, long long k0, void* stream) {
  if (rows < 1 || grp < 1 || nbp < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((nbp + kTile - 1) / kTile), (unsigned)(grp * rows));
  shift_stack_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(
      (const float*)s, (float*)x, rows, nbp, grp, sps, k0);
  return (int)cudaGetLastError();
}
