// Exact-f32 true-polyphase filterbank ("polyx": stacked pre-shifted frames).
//
// Replaces the TPU kernel body btle_tpu/wideband/fused.py:_kernel_polyx
// (tables from _polyx_tables), the compute_dtype "f32" parity mode. Per
// output column k < Ky:
//   acc[r, k] = sum_{j < n_slices} F4[r, k + stack*j] * kcoefx[r, j]  (r < 80)
//   y[o, k]   = sum_{r < 80} w4x[o, r] * acc[r, k]                   (o < 80)
// where F4 is the (80, J) f32 array of permuted, pre-shifted frame rows
// (read as zero past J) and w4x is the 40-point DFT (with the row
// permutation) over the stacked accumulator. Everything is true FP32 on the
// CUDA cores (fmaf): no TF32, no tensor-core pass — a reduced-precision pass
// would ghost strong bursts into other channels.
//
// Bound on the H100: operations, narrowly. Per 131k bench block the
// stacked FMAs are ~0.7 GFLOP and the DFT ~1.7 GFLOP: ~36 us at 67 TFLOP/s
// FP32; the bytes (~42 MB of stacked frames read, ~42 MB of y written) take
// ~25 us at 3.35 TB/s.
//
// Design: a persistent SGEMM whose B operand (the stacked accumulator) is
// formed on chip, eight rows at a time.
// - A CTA of 32 x kWarps threads owns column tiles of kTile = 32 x kWarps
//   columns (256 at bench geometry; the caller narrows to 128 or 64 where
//   the grid would leave SMs idle) and walks tiles blockIdx.x, + gridDim.x,
//   ... Each tile is 10 chunks of 8 stacked rows; the CTA's chunks form
//   one sequence across its tiles, so the next tile's first copies overlap
//   this tile's last FMAs and its epilogue.
// - Staging: a chunk's frame window F4[8 rows, k0 : k0 + kTile +
//   stack*(n_slices-1)] goes to shared memory with cp.async (4-byte
//   copies, zero past J) through a 3-slot ring, two chunks in flight (a
//   deeper ring measured no faster). The row stride is 2 mod 32 words, so
//   phase 1's 8-byte reads are conflict-free. w4x (transposed) and kcoefx
//   arrive by cp.async with the first chunk and stay for the CTA's life:
//   loads that each wait for a round trip to memory cost as much as a tile.
// - Phase 1, a register sliding window: thread (row tid % 8, run tid / 8)
//   forms acc for 8 consecutive columns. Slice j needs frame columns
//   stack*j .. stack*j + 7 of its run, so each slice loads `stack` new
//   values (one 8-byte read at stack 2) for 8 FMAs, and a turn of 8 /
//   stack slices one or two float4 reads of taps; the ring index is a
//   constant in the unrolled turn. The 8 x kTile chunk of acc goes to a
//   double-buffered shared tile (rows padded by 4 words).
// - Phase 2, the 80 x 8 DFT slab as a register-tiled SGEMM: lane l owns
//   the 5 output rows l % 16 + 16a and 16 consecutive columns (the FP32
//   SGEMM filterbank's layout), 80 accumulators live for the whole tile;
//   per stacked row 5 broadcast weight reads and 4 16-byte acc reads feed
//   80 FMAs.
// - Software pipeline: iteration i runs phase 1 of chunk i and phase 2 of
//   chunk i - 1 behind one barrier (two, phase after phase, measured a few
//   percent slower), so each warp mixes phase 1's shared-memory reads with
//   phase 2's FMAs.
// - The epilogue: each warp stages its 80 x 32 strip of y 16 rows at a
//   time in its own stage, so a warp store writes four whole 128-byte
//   rows. Stored straight from the register tile (16 bytes to each of 16
//   rows per instruction) the y writes took longer than all the FMAs.
// - Registers: 80 accumulators + 8 + 8 in phase 1 or + 16 + 5 in phase 2;
//   __launch_bounds__(threads, 16 / kWarps) keeps 16 warps per SM (at most
//   128 registers). Shared memory at 256 columns and 33 slices: 106 KB,
//   two CTAs per SM.
// - Summation order: acc over j ascending (one fmaf chain per entry), y
//   over r ascending; the twin multiplies and adds separately and sums y
//   as one matmul, so the two agree to rounding (1e-5 of max |y|).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 80;                // stacked rows (stack x 40, or the probe's 80)
constexpr int kOut = 80;
constexpr int kChunkRows = 8;
constexpr int kChunks = kRows / kChunkRows;   // 10
constexpr int kRT = 5;                   // output rows per lane
constexpr int kCT = 16;                  // consecutive columns per lane
constexpr int kRG = kOut / kRT;          // 16 row groups: lanes l % 16
constexpr int kRun = 8;                  // phase 1: columns per thread
constexpr int kStages = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 4 bytes global -> shared; src_bytes 0 writes zero and reads nothing
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Frame columns a tile reads, and their shared-memory row stride (2 mod 32
// words, at least the window)
__host__ __device__ __forceinline__ int window_cols(int tile, int n_slices, int stack) {
  return tile + stack * (n_slices - 1);
}
__host__ __device__ __forceinline__ int frame_stride(int wf) {
  return (wf - 2 + 31) / 32 * 32 + 2;
}

// Taps per kcoefx row in shared memory: whole float4 turns of 8 slices,
// plus 4 so the 8 rows of a chunk fall in distinct banks
__host__ __device__ __forceinline__ int kc_ld(int n_slices) {
  return (n_slices + 7) / 8 * 8 + 4;
}

// The epilogue's per-warp y stage: 16 rows x 32 columns, rows padded to 36
constexpr int kStageLd = 36;
constexpr int kWarpStage = kRG * kStageLd;

// Shared-memory layout in floats: w4x transposed [80 r][80 o]; kcoefx
// [80][kc_ld], zero past n_slices; acc [2][8][tile + 4]; one y stage per
// warp [warps][16][36]; the frame ring [kStages][8][stride]
__host__ __device__ __forceinline__ int acc_offset(int n_slices) {
  return kRows * kOut + kRows * kc_ld(n_slices);
}
__host__ __device__ __forceinline__ int stage_offset(int tile, int n_slices) {
  return acc_offset(n_slices) + 2 * kChunkRows * (tile + 4);
}
__host__ __device__ __forceinline__ int ring_offset(int tile, int n_slices) {
  return stage_offset(tile, n_slices) + tile / 32 * kWarpStage;
}

// Phase 1 for one (row, run): a[c] = sum_j src[stack*j + c] * kc[j], c < 8.
// win[x % 8] holds src[x]; a turn of 8 / stack slices returns the ring to
// its start, so every index below is a constant. The turn's taps come in
// float4 reads (kc is 16-byte aligned and zero past n_slices).
template <int kStack>
__device__ __forceinline__ void slice_sums(const float* __restrict__ src,
                                           const float* __restrict__ kc, int n_slices,
                                           float (&a)[kRun]) {
  constexpr int kTurn = kRun / kStack;
  float win[kRun];
#pragma unroll
  for (int x = 0; x < kRun - kStack; ++x) win[x] = src[x];
#pragma unroll
  for (int c = 0; c < kRun; ++c) a[c] = 0.0f;
  for (int j0 = 0; j0 < n_slices; j0 += kTurn) {
    float kq[kTurn];
#pragma unroll
    for (int q = 0; q < kTurn; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(kc + j0 + q);
      kq[q] = v.x;
      kq[q + 1] = v.y;
      kq[q + 2] = v.z;
      kq[q + 3] = v.w;
    }
#pragma unroll
    for (int jj = 0; jj < kTurn; ++jj) {
      const int j = j0 + jj;
      if (j >= n_slices) break;
      if (kStack == 2) {
        const float2 v = *reinterpret_cast<const float2*>(src + 2 * j + 6);
        win[(2 * jj + 6) % kRun] = v.x;
        win[(2 * jj + 7) % kRun] = v.y;
      } else {
        win[(jj + 7) % kRun] = src[j + 7];
      }
#pragma unroll
      for (int c = 0; c < kRun; ++c) a[c] = fmaf(win[(kStack * jj + c) % kRun], kq[jj], a[c]);
    }
  }
}

template <int kStack, int kWarps>
__global__ void __launch_bounds__(32 * kWarps, 16 / kWarps)
    filterbank_polyx_f32_kernel(const float* __restrict__ f4,
                                const float* __restrict__ kcoefx,
                                const float* __restrict__ w4x, float* __restrict__ y,
                                long long j, long long ky, int n_slices, int n_tiles) {
  constexpr int kThreads = 32 * kWarps;
  constexpr int kTile = 32 * kWarps;
  constexpr int kAccLd = kTile + 4;
  static_assert(kChunkRows * kTile / kRun == kThreads, "one run of 8 per thread");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wf = window_cols(kTile, n_slices, kStack);
  const int stride = frame_stride(wf);
  const int kcl = kc_ld(n_slices);
  float* w_s = smem;
  float* kc_s = smem + kRows * kOut;
  float* acc_s = smem + acc_offset(n_slices);
  float* stage = smem + stage_offset(kTile, n_slices) + warp * kWarpStage;
  float* ring = smem + ring_offset(kTile, n_slices);
  // this CTA's tiles: blockIdx.x + i * gridDim.x
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int n_chunks = my_tiles * kChunks;

  // w4x (transposed) and the taps arrive with the first chunk's copies
  for (int idx = tid; idx < kRows * kOut; idx += kThreads) {
    const int o = idx / kRows, r = idx - o * kRows;
    cp_async4(w_s + r * kOut + o, w4x + idx, 4);
  }
  for (int idx = tid; idx < kRows * kcl; idx += kThreads) {
    const int r = idx / kcl, s = idx - r * kcl;
    const bool in = s < n_slices;
    cp_async4(kc_s + idx, in ? kcoefx + r * n_slices + s : kcoefx, in ? 4 : 0);
  }

  auto load_chunk = [&](int g) {
    if (g < n_chunks) {
      const long long k0 =
          ((long long)blockIdx.x + (long long)(g / kChunks) * gridDim.x) * kTile;
      const int r0 = (g % kChunks) * kChunkRows;
      float* fs = ring + (g % kStages) * kChunkRows * stride;
#pragma unroll
      for (int r = 0; r < kChunkRows; ++r) {
        const float* src = f4 + (long long)(r0 + r) * j;
        for (int x = tid; x < wf; x += kThreads) {
          const bool in = k0 + x < j;
          cp_async4(fs + r * stride + x, in ? src + k0 + x : src, in ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
  for (int g = 0; g < kStages - 1; ++g) load_chunk(g);

  const int rg = lane % kRG;
  const int cb = warp * 32 + (lane / kRG) * kCT;   // first column of the lane in the tile
  const int p_row = tid % kChunkRows, p_run = tid / kChunkRows;
  float acc[kRT][kCT];
#pragma unroll
  for (int a = 0; a < kRT; ++a)
#pragma unroll
    for (int c = 0; c < kCT; ++c) acc[a][c] = 0.0f;

  // Iteration i forms chunk i's acc (phase 1) and folds chunk i - 1's into
  // y (phase 2): one barrier a chunk, and each warp's instruction stream
  // mixes phase 1's shared-memory reads with phase 2's FMAs.
  for (int i = 0; i <= n_chunks; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();    // chunk i landed; chunk i - 1's acc is written, chunk i - 2's read
    load_chunk(i + kStages - 1);

    if (i < n_chunks) {  // phase 1: 8 stacked rows of acc over the tile
      const float* src = ring + (i % kStages) * kChunkRows * stride + p_row * stride +
                         kRun * p_run;
      float a[kRun];
      slice_sums<kStack>(src, kc_s + ((i % kChunks) * kChunkRows + p_row) * kcl, n_slices,
                         a);
      float4* dst = reinterpret_cast<float4*>(acc_s + (i & 1) * kChunkRows * kAccLd +
                                              p_row * kAccLd + kRun * p_run);
      dst[0] = make_float4(a[0], a[1], a[2], a[3]);
      dst[1] = make_float4(a[4], a[5], a[6], a[7]);
    }
    if (i == 0) continue;

    // phase 2: y += w4x[:, 8 rows] . acc[8 rows, tile] for chunk g = i - 1
    const int g = i - 1, chunk = g % kChunks;
    const float* ws = w_s + chunk * kChunkRows * kOut + rg;
    const float* xs = acc_s + (g & 1) * kChunkRows * kAccLd + cb;
#pragma unroll
    for (int r = 0; r < kChunkRows; ++r) {
      float w[kRT], x[kCT];
#pragma unroll
      for (int a = 0; a < kRT; ++a) w[a] = ws[r * kOut + kRG * a];
#pragma unroll
      for (int c = 0; c < kCT; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(xs + r * kAccLd + c);
        x[c] = v.x;
        x[c + 1] = v.y;
        x[c + 2] = v.z;
        x[c + 3] = v.w;
      }
#pragma unroll
      for (int a = 0; a < kRT; ++a)
#pragma unroll
        for (int c = 0; c < kCT; ++c) acc[a][c] = fmaf(w[a], x[c], acc[a][c]);
    }

    if (chunk == kChunks - 1) {  // the tile's last chunk: store y, start anew
      // Each warp writes its 80 x 32 strip of y 16 rows at a time through its
      // own stage, so a warp store writes four whole 128-byte rows instead
      // of 16 bytes to each of 16 rows.
      const long long k0 =
          ((long long)blockIdx.x + (long long)(g / kChunks) * gridDim.x) * kTile + warp * 32;
      const int s_row = lane / 8, s_col = 4 * (lane % 8);
      const bool vec = (ky & 3) == 0 && k0 + s_col + 4 <= ky;
#pragma unroll
      for (int a = 0; a < kRT; ++a) {
#pragma unroll
        for (int c = 0; c < kCT; c += 4)
          *reinterpret_cast<float4*>(stage + rg * kStageLd + (lane / kRG) * kCT + c) =
              make_float4(acc[a][c], acc[a][c + 1], acc[a][c + 2], acc[a][c + 3]);
#pragma unroll
        for (int c = 0; c < kCT; ++c) acc[a][c] = 0.0f;
        __syncwarp();
#pragma unroll
        for (int q = 0; q < kRG / 4; ++q) {
          const int row = 4 * q + s_row;
          const float4 v = *reinterpret_cast<const float4*>(stage + row * kStageLd + s_col);
          float* dst = y + (long long)(row + kRG * a) * ky + k0 + s_col;
          if (vec) {
            *reinterpret_cast<float4*>(dst) = v;
          } else {
            const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (k0 + s_col + c < ky) dst[c] = e[c];
          }
        }
        __syncwarp();
      }
    }
  }
  cp_async_wait<0>();
}

using Kernel = void (*)(const float*, const float*, const float*, float*, long long,
                        long long, int, int);

// instance index: stack 1 or 2 x 2, 4 or 8 warps
int instance(int stack, int warps) {
  if (stack != 1 && stack != 2) return -1;
  const int w = warps == 2 ? 0 : warps == 4 ? 1 : warps == 8 ? 2 : -1;
  return w < 0 ? -1 : (stack - 1) * 3 + w;
}

Kernel pick(int inst) {
  switch (inst) {
    case 0: return filterbank_polyx_f32_kernel<1, 2>;
    case 1: return filterbank_polyx_f32_kernel<1, 4>;
    case 2: return filterbank_polyx_f32_kernel<1, 8>;
    case 3: return filterbank_polyx_f32_kernel<2, 2>;
    case 4: return filterbank_polyx_f32_kernel<2, 4>;
    case 5: return filterbank_polyx_f32_kernel<2, 8>;
    default: return nullptr;
  }
}

int smem_bytes(int n_slices, int stack, int warps) {
  const int tile = 32 * warps;
  const int stride = frame_stride(window_cols(tile, n_slices, stack));
  return (int)sizeof(float) * (ring_offset(tile, n_slices) + kStages * kChunkRows * stride);
}

// Per instance and device: the dynamic shared-memory limit set so far, and
// the resident CTAs per SM and SM count at the shared-memory size last asked
constexpr int kMaxDevices = 64;
struct Shape {
  int smem_limit, smem, per_sm, sms;
};
Shape g_shape[6][kMaxDevices];

// Raises the instance's shared-memory limit if needed and returns its
// launch shape at `smem` bytes (resident CTAs per SM, SMs)
cudaError_t launch_shape(int inst, int smem, Shape* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Shape local = {0, 0, 0, 0};
  Shape& s = dev < kMaxDevices ? g_shape[inst][dev] : local;
  if (s.smem == smem && s.per_sm > 0) {
    *out = s;
    return cudaSuccess;
  }
  if (smem > s.smem_limit) {
    err = cudaFuncSetAttribute(pick(inst), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    s.smem_limit = smem;
  }
  const int warps = 2 << (inst % 3);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, pick(inst), 32 * warps, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (s.per_sm < 1) return cudaErrorInvalidConfiguration;
  s.smem = smem;
  *out = s;
  return cudaSuccess;
}

}  // namespace

// f4 (80, J) f32 stacked frames; kcoefx (80, n_slices); w4x (80, 80); y
// (80, ky); stack 1 or 2; warps 2, 4 or 8 (64, 128 or 256 columns per tile)
extern "C" int btle_filterbank_polyx_f32(const void* f4, const void* kcoefx,
                                         const void* w4x, void* y, long long j,
                                         int ky, int rows, int n_slices,
                                         int stack, int warps, void* stream) {
  const int inst = instance(stack, warps);
  if (inst < 0 || rows != kRows || n_slices < 1 || j < 1)
    return (int)cudaErrorInvalidValue;
  if (ky <= 0) return 0;
  const int smem = smem_bytes(n_slices, stack, warps);
  Shape s;
  cudaError_t err = launch_shape(inst, smem, &s);
  if (err != cudaSuccess) return (int)err;
  const int tile = 32 * warps;
  const int n_tiles = (ky + tile - 1) / tile;
  const int grid = n_tiles < s.per_sm * s.sms ? n_tiles : s.per_sm * s.sms;
  pick(inst)<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)f4, (const float*)kcoefx, (const float*)w4x, (float*)y, j, ky,
      n_slices, n_tiles);
  return (int)cudaGetLastError();
}

// The launch shape for (ky, n_slices, stack, warps): info[0] dynamic shared
// memory (bytes), [1] resident CTAs per SM, [2] CTAs in the (persistent)
// grid, [3] threads per CTA, [4] columns per tile.
extern "C" int btle_filterbank_polyx_f32_plan(int ky, int n_slices, int stack,
                                              int warps, int* info) {
  const int inst = instance(stack, warps);
  if (inst < 0 || n_slices < 1) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(n_slices, stack, warps);
  Shape s;
  cudaError_t err = launch_shape(inst, smem, &s);
  if (err != cudaSuccess) return (int)err;
  const int tile = 32 * warps;
  const int n_tiles = (ky + tile - 1) / tile;
  info[0] = smem;
  info[1] = s.per_sm;
  info[2] = n_tiles < s.per_sm * s.sms ? n_tiles : s.per_sm * s.sms;
  info[3] = 32 * warps;
  info[4] = tile;
  return 0;
}
