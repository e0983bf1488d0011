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
// Bound on the H100: bytes. At R = 40, N = 65, step 2 and a 131072-column
// block it reads 21 MB of frames and writes 21 MB (~13 us at 3.35 TB/s);
// its 0.34 G FMAs take ~10 us at 67 TFLOP/s. At R = 160 (N = 17, step 8)
// the frames are 85 MB, ~32 us, for about the same FMAs.
//
// Design: shared-memory staging, one pipeline per warp.
// - A CTA owns 512 output columns; it stages rows of 512 + step*(N-1)
//   columns (the 128-column halo of the tool's configurations is 20% of
//   what is staged, against 50% for 128-column tiles).
// - The rows go through in stages of 8: stage (g, q) holds rows c + 40q
//   for the 8 output channels c of group g, one row per warp. A warp
//   stages and consumes only its own row, so its 3-slot ring of rows needs
//   cp.async.wait_group and __syncwarp, never a CTA barrier: loads of the
//   next two stages are in flight while the warp computes. The Q = R/40
//   stages of a group run back to back, and each thread folds its partial
//   sums in registers in the tool's order ((p0 + p2) + (p1 + p3) at Q = 4).
// - Copies: 16 bytes where the row stride ld_f and the base are 16-byte
//   aligned, 4 bytes otherwise (cp.async zero-fills columns past ld_f).
//   Each lane copies whole chunks of its warp's row: no integer division.
// - Lane l computes 16 consecutive columns. Its frame values slide through
//   a register ring of float4 chunks: per tap it loads step/4 new chunks
//   (one per two taps at step 2), so 16 FMAs cost step + 1/4 shared-memory
//   wavefronts a warp (the coefficients come as one float4 per 4 taps,
//   a broadcast). Shared rows are 16-column segments padded by 4 words:
//   the 8 lanes of a quarter-warp's 16-byte loads hit 8 distinct bank
//   quads.
// - Occupancy: ~90 KB of shared memory (3 x 8 rows of 800 words, plus kc)
//   and __launch_bounds__(256, 2): two CTAs, 16 warps, per SM at every R.
// A register-only design (frames through L1) was not taken: a lane's
// 16-column window needs 16 + 128 columns, read with a 64-byte lane
// stride, which costs L1 wavefronts per FMA that the padded shared rows
// avoid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOut = 40;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kU = 16;                     // consecutive columns per lane
constexpr int kTileN = 32 * kU;            // 512 output columns per CTA
constexpr int kPad = 4;                    // words after each 16-word segment
constexpr int kSeg = kU + kPad;
constexpr int kStages = 3;
constexpr int kGroups = kOut / kWarps;     // 5 groups of 8 channels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

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

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The shared word of column x of a staged row (16-word segments + pad).
__device__ __forceinline__ int seg_word(int x) { return x + (x / kU) * kPad; }

// One row's taps for this lane's 16 columns: acc[u] = sum_j
// row[lane*16 + u + step*j] * kc[j], j in order, one fmaf each. The
// frame values live in a ring of kNB float4 chunks; chunk m of the lane's
// window (columns 4m .. 4m + 3 past its first) sits in slot m % kNB, and
// the loop is unrolled over whole turns of the ring so every slot index is
// a constant.
template <int kStep>
__device__ __forceinline__ void row_taps(const float* __restrict__ row,
                                         const float* __restrict__ kcr, int n,
                                         int lane, float (&acc)[kU]) {
  constexpr int kNB = kU / 4 + (kStep % 4 ? 1 : 0);   // chunks live at once
  constexpr int kTurn = 4 * kNB / kStep;              // taps per ring turn
  constexpr int kUnroll = kTurn % 4 == 0 ? kTurn : (kTurn == 2 ? 4 : 4 * kTurn);
  constexpr int kPre = (kU - 1 - kStep) / 4 + 1;      // chunks before tap 0
  const float* base = row + lane * kSeg;
  float4 ring[kNB];
#pragma unroll
  for (int u = 0; u < kU; ++u) acc[u] = 0.0f;
#pragma unroll
  for (int m = 0; m < kPre; ++m)
    ring[m % kNB] = *reinterpret_cast<const float4*>(base + seg_word(4 * m));
  for (int j0 = 0; j0 < n; j0 += kUnroll) {
    const int m0 = kStep * j0 / 4;   // a multiple of kNB
    float4 k4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int jj = 0; jj < kUnroll; ++jj) {
      if (j0 + jj >= n) break;
      if (jj % 4 == 0) k4 = *reinterpret_cast<const float4*>(kcr + j0 + jj);
      const float kv = lane_of(k4, jj % 4);
      // the chunks tap jj needs that tap jj - 1 did not
#pragma unroll
      for (int m = (kStep * jj - kStep + kU - 1) / 4 + 1;
           m <= (kStep * jj + kU - 1) / 4; ++m)
        ring[m % kNB] =
            *reinterpret_cast<const float4*>(base + seg_word(4 * (m0 + m)));
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int x = kStep * jj + u;
        acc[u] = fmaf(lane_of(ring[(x / 4) % kNB], x % 4), kv, acc[u]);
      }
    }
  }
}

template <int Q, int kStep, bool kVec16>
__global__ void __launch_bounds__(kThreads, 2) shift_fma_kernel(
    const float* __restrict__ f, const float* __restrict__ kc,
    float* __restrict__ out, long long ld_f, long long n_cols, int n,
    int row_words, int kc_ld) {
  extern __shared__ __align__(16) float smem[];
  constexpr int rows = Q * kOut;
  constexpr int n_stages = kGroups * Q;
  float* ring = smem;                                   // [kStages][kWarps][row_words]
  float* kc_s = smem + kStages * kWarps * row_words;    // [rows][kc_ld], zero past n
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long k0 = (long long)blockIdx.x * kTileN;
  const int width = row_words / kSeg * kU;              // staged columns

  for (int r = warp; r < rows; r += kWarps)
    for (int j = lane; j < kc_ld; j += 32)
      kc_s[r * kc_ld + j] = j < n ? kc[(long long)r * n + j] : 0.0f;
  __syncthreads();

  // stage s = (group s / Q, fold position s % Q): this warp's row
  auto stage_row = [&](int s) {
    const int qq = s % Q;
    const int q = Q == 4 ? (qq == 1 ? 2 : qq == 2 ? 1 : qq) : qq;
    return (s / Q) * kWarps + warp + kOut * q;
  };
  auto load_stage = [&](int s) {
    if (s < n_stages) {
      const float* src = f + (long long)stage_row(s) * ld_f;
      float* dst = ring + ((s % kStages) * kWarps + warp) * row_words;
      if (kVec16) {
        for (int c = lane; c < width / 4; c += 32) {
          const long long col = k0 + 4 * c;
          const long long left = ld_f - col;
          const int bytes = left >= 4 ? 16 : left > 0 ? (int)left * 4 : 0;
          cp_async16(dst + seg_word(4 * c), bytes ? src + col : src, bytes);
        }
      } else {
        for (int x = lane; x < width; x += 32) {
          const long long col = k0 + x;
          const bool in = col < ld_f;
          cp_async4(dst + seg_word(x), in ? src + col : src, in ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
  load_stage(0);
  load_stage(1);

  const long long k = k0 + lane * kU;
  const bool vec_out = (n_cols & 3) == 0 && k + kU <= n_cols;
  float acc[kU], f0[kU], f1[kU];
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncwarp();                    // stage s landed; slot of s - 1 is free
    load_stage(s + kStages - 1);
    const int r = stage_row(s);
    row_taps<kStep>(ring + ((s % kStages) * kWarps + warp) * row_words,
                    kc_s + r * kc_ld, n, lane, acc);
    const int qq = s % Q;
    // the tool's fold: Q = 2: p0 + p1; Q = 4, rows taken in the order
    // 0, 2, 1, 3: (p0 + p2) + (p1 + p3)
    if (Q > 1 && qq != Q - 1) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (qq == 0) f0[u] = acc[u];
        else if (qq == 1) f0[u] = f0[u] + acc[u];
        else f1[u] = acc[u];
      }
      continue;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (Q == 2) acc[u] = f0[u] + acc[u];
      if (Q == 4) acc[u] = f0[u] + (f1[u] + acc[u]);
    }
    float* dst = out + (long long)(r % kOut) * n_cols + k;
    if (vec_out) {
#pragma unroll
      for (int u = 0; u < kU; u += 4)
        *reinterpret_cast<float4*>(dst + u) =
            make_float4(acc[u], acc[u + 1], acc[u + 2], acc[u + 3]);
    } else {
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (k + u < n_cols) dst[u] = acc[u];
    }
  }
  cp_async_wait<0>();
}

using Kernel = void (*)(const float*, const float*, float*, long long,
                        long long, int, int, int);

// The launch's shape: dynamic shared memory, the row stride of the ring
// and of the staged coefficients, in words.
struct Plan {
  int smem, row_words, kc_ld;
};

Plan plan(int rows, int n, int step) {
  const int width = kTileN + step * (n - 1);
  const int segs = (width + kU - 1) / kU;
  Plan p;
  p.row_words = segs * kSeg;
  p.kc_ld = (n + 3) / 4 * 4;
  p.smem = (int)(sizeof(float) *
                 ((size_t)kStages * kWarps * p.row_words + (size_t)rows * p.kc_ld));
  return p;
}

template <int Q, int kStep>
Kernel pick(bool vec16) {
  return vec16 ? shift_fma_kernel<Q, kStep, true> : shift_fma_kernel<Q, kStep, false>;
}

template <int Q>
Kernel pick_step(int step, bool vec16) {
  switch (step) {
    case 2: return pick<Q, 2>(vec16);
    case 4: return pick<Q, 4>(vec16);
    case 8: return pick<Q, 8>(vec16);
    default: return nullptr;
  }
}

Kernel pick_kernel(int rows, int step, bool vec16) {
  switch (rows) {
    case kOut: return pick_step<1>(step, vec16);
    case 2 * kOut: return pick_step<2>(step, vec16);
    case 4 * kOut: return pick_step<4>(step, vec16);
    default: return nullptr;
  }
}

// Every launch sets its instance's dynamic shared-memory limit: one CUDA
// runtime call, no synchronisation, and 18 instances need no cache.
cudaError_t ensure_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

bool valid(int rows, long long ld_f, long long n_cols, int n, int step) {
  return n >= 1 && n_cols >= 1 && ld_f >= n_cols + (long long)step * (n - 1) &&
         pick_kernel(rows, step, false) != nullptr;
}

}  // namespace

// f (rows, ld_f) f32, kc (rows, n) f32, out (40, n_cols) f32; rows 40, 80
// or 160, step 2, 4 or 8
extern "C" int btle_shift_fma(const void* f, const void* kc, void* out, int rows,
                              long long ld_f, long long n_cols, int n, int step,
                              void* stream) {
  if (!valid(rows, ld_f, n_cols, n, step)) return (int)cudaErrorInvalidValue;
  const bool vec16 = ld_f % 4 == 0 && ((uintptr_t)f & 15) == 0;
  Kernel kernel = pick_kernel(rows, step, vec16);
  const Plan p = plan(rows, n, step);
  cudaError_t err = ensure_smem(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n_cols + kTileN - 1) / kTileN);
  kernel<<<blocks, kThreads, p.smem, (cudaStream_t)stream>>>(
      (const float*)f, (const float*)kc, (float*)out, ld_f, n_cols, n,
      p.row_words, p.kc_ld);
  return (int)cudaGetLastError();
}

// The launch shape for (rows, n, step, n_cols, 16-byte copies): info[0]
// dynamic shared memory (bytes), [1] resident CTAs per SM, [2] CTAs in the
// grid, [3] threads per CTA, [4] output columns per CTA.
extern "C" int btle_shift_fma_plan(int rows, int n, int step, long long n_cols,
                                   int vec16, int* info) {
  if (!valid(rows, n_cols + (long long)step * (n - 1), n_cols, n, step))
    return (int)cudaErrorInvalidValue;
  Kernel kernel = pick_kernel(rows, step, vec16 != 0);
  const Plan p = plan(rows, n, step);
  cudaError_t err = ensure_smem(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, p.smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = p.smem;
  info[1] = per_sm;
  info[2] = (int)((n_cols + kTileN - 1) / kTileN);
  info[3] = kThreads;
  info[4] = kTileN;
  return 0;
}
