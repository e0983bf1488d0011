// Access-address correlation on its own, and the strided-roll row stack.
//
// Replaces the TPU probe kernels of tools/dev_aagrp_repro.py (corr_kernel
// :90 and roll_kernel :103, call :118), the AA-only variant of
// tools/dev_aagrp_bisect.py (run_aa_only :227, call :265) and the AA
// variants of tools/dev_roll_experiment.py (_aa_kernel :130, call :197).
// On the TPU each manufactures the 32 shifted copies of the decision
// lattice with strided pltpu.roll ops over a broadcast and reduces them
// with a block-diagonal matmul (AA_GRP shifts per roll group), or with 32
// shifted FMAs. On Hopper there is no roll to amortise: each lattice value
// is staged once and reused from registers.
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
// A copy: bit for bit with its twin (grp <= 64, nbp < 2^30).
//
// Bound on the H100: bytes. At the probes' largest size (40 rows of a
// 131072-column block) the correlation reads 21 MB of lattice and writes
// 21 MB of acc and 5 MB of hits, ~14 us at 3.35 TB/s; its 32 FMAs per
// output are ~0.34 GFLOP, ~5 us at 67 TFLOP/s FP32.
// Design, two tilings picked from the grid:
// * Wide (sps 1, 2, 4 or 8, and enough tiles to give every SM two CTAs, as
//   K11's 40 x 131072): persistent CTAs walk (row, tile) pairs, 2048
//   columns a tile (4096 at sps 8), so the 31*sps halo read again is a
//   small share; sps is a template argument, so every index of the tile
//   is a compile-time offset from the thread's base.
//   1. Each thread loads its share of the next tile (four values per load:
//      16 bytes of float or 4 of int8) into registers while the current
//      tile is computed and written, so loads overlap the arithmetic and
//      the stores; the staged tile goes to shared memory split by sps
//      phase: row p holds s[t0 + p + sps*m], one pad word after every U.
//   2. A thread owns U = 16 consecutive outputs of one phase (m = U*k ..
//      U*k + U - 1). Their 32 taps are the U + 31 consecutive values of
//      that phase row from m = U*k: the thread reads each once into a
//      register and applies it to every output it feeds, with the 32
//      weights in registers. Every index is a compile-time offset; the pad
//      puts a warp's 32 threads (U + 1 words apart) on 32 banks.
//   3. The outputs go back to the phase rows, and the CTA writes the tile
//      in column order: acc as float4 and four hits as one 32-bit word a
//      thread, so each warp writes whole 128-byte lines.
// * Narrow (fewer tiles, as the K8 and K9 probes' 40 x 2048): the grid is
//   latency-bound, so the tile is the shortest chain: 256 columns, one
//   output per thread from the tile staged in column order, stored
//   directly.
// The stack is a copy bound by its bytes (K9's 8 x 40 x 2176: 2.8 MB
// written, 0.35 MB read, ~0.9 us at 3.35 TB/s, about the launch floor), so
// its cost is instructions and the launch: no 64-bit modulo per element
// (each row group's shift is reduced mod nbp once, on the host, and an
// element's source wraps by one conditional subtract), 16-byte loads and
// stores, and a grid of at most one wave (see shift_stack_kernel).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 32;
constexpr int kMaxSps = 8;
constexpr int kWideU = 16;         // outputs per thread on wide tiles
constexpr int kNarrowThreads = 256;
constexpr int kNarrowSpan = kNarrowThreads + (kTaps - 1) * kMaxSps;
constexpr int kStackThreads = 256;
constexpr int kStackU = 4;          // 16-byte groups a stack thread stores
constexpr int kMaxStackGroups = 64;  // row groups (shifts) a stack takes
constexpr int kMaxDevices = 64;
constexpr int kNumGroups = 6;      // groupings 1, 2, 4, 8, 16, 32

__device__ __forceinline__ float lattice_value(float v) { return v; }
__device__ __forceinline__ float lattice_value(int8_t v) {
  return v > 0 ? 1.0f : -1.0f;
}

// four consecutive lattice values: one 16-byte (float) or 4-byte (int8) load
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load4(const int8_t* p, float v[4]) {
  const char4 a = __ldg(reinterpret_cast<const char4*>(p));
  v[0] = lattice_value((int8_t)a.x);
  v[1] = lattice_value((int8_t)a.y);
  v[2] = lattice_value((int8_t)a.z);
  v[3] = lattice_value((int8_t)a.w);
}

// The wide tile at sps SPS: WPP warps per phase, so a CTA has 32*SPS*WPP
// threads (128 or 256) and covers M_TILE = 32*WPP*U positions of each
// phase, COLS = SPS*M_TILE columns, from SPAN lattice values; a phase row
// holds M_TILE + 31 values plus one pad word per U, its stride LD_ROW
// shifted by 32/SPS words so the phases of one staged load fall in
// different banks; the row's 32 weights follow the phase rows. BATCH
// 4-value loads a thread cover the span.
__host__ __device__ constexpr int wide_threads(int sps) {
  return 32 * sps * (sps >= 4 ? 1 : 4 / sps);
}

template <int SPS>
struct Wide {
  static constexpr int U = kWideU;
  static constexpr int THREADS = wide_threads(SPS);
  static constexpr int WPP = THREADS / (32 * SPS);
  static constexpr int M_TILE = 32 * WPP * U;
  static constexpr int COLS = SPS * M_TILE;
  static constexpr int SPAN = COLS + (kTaps - 1) * SPS;
  static constexpr int LAST = M_TILE + kTaps - 2;          // the last staged m
  static constexpr int LD_ROW = (LAST + LAST / U + 1 + 31) / 32 * 32 + 32 / SPS;
  static constexpr int WORDS = SPS * LD_ROW + kTaps;       // shared floats
  static constexpr int BATCH = (SPAN + 4 * THREADS - 1) / (4 * THREADS);
  // the staged value of column t0 + x: phase x % SPS, position x / SPS
  static __device__ __forceinline__ int slot(int x) {
    const int m = x / SPS;
    return (x % SPS) * LD_ROW + m + m / U;
  }
};

// U outputs from the U + 31 values of a window: value i at win[i + i/U]
// (a phase row, one pad word per U) or, for U = 1, at win[stride*i]; tap j
// of output u is value u + j, the taps summed in groups of GRP.
template <int GRP, int U>
__device__ __forceinline__ void taps(const float* win, int stride, const float wr[kTaps],
                                     float acc[U]) {
  float part[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = part[u] = 0.0f;
#pragma unroll
  for (int i = 0; i < U + kTaps - 1; ++i) {
    const float v = win[U == 1 ? stride * i : i + i / U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = i - u;                        // the tap value i is to output u
      if (j < 0 || j >= kTaps) continue;
      part[u] = fmaf(wr[j], v, j % GRP == 0 ? 0.0f : part[u]);
      if (j % GRP == GRP - 1) acc[u] += part[u];
    }
  }
}

// SPS = 0: the narrow tile (any sps, one 256-column tile a CTA on a
// (tiles, rows) grid); SPS = 1, 2, 4, 8: the wide tile, persistent CTAs
// over tiles = tiles_per_row * rows
template <typename T, int GRP, int SPS>
__global__ void __launch_bounds__(SPS == 0 ? kNarrowThreads : wide_threads(SPS))
aa_corr_kernel(const T* __restrict__ s, const float* __restrict__ w,
               float* __restrict__ acc_out, int8_t* __restrict__ hit_out,
               long long ld_s, long long n_out, int sps, int tiles_per_row, int tiles,
               float n_mask) {
  const int tid = threadIdx.x;
  if constexpr (SPS == 0) {
    __shared__ float s_n[kNarrowSpan];
    __shared__ float w_n[kTaps];
    const int c = blockIdx.y;
    const long long t0 = (long long)blockIdx.x * kNarrowThreads;
    const T* row = s + (long long)c * ld_s;
    const int span = kNarrowThreads + (kTaps - 1) * sps;
    for (int k = tid; k < span; k += kNarrowThreads) {
      const long long t = t0 + k;
      s_n[k] = t < ld_s ? lattice_value(row[t]) : 0.0f;
    }
    if (tid < kTaps) w_n[tid] = w[c * kTaps + tid];
    __syncthreads();
    const long long t = t0 + tid;
    if (t >= n_out) return;
    float wr[kTaps], acc[1];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) wr[j] = w_n[j];
    taps<GRP, 1>(s_n + tid, sps, wr, acc);        // taps s_n[tid + sps*j]
    acc_out[(long long)c * n_out + t] = acc[0];
    hit_out[(long long)c * n_out + t] = acc[0] == n_mask;
  } else {
    using G = Wide<SPS>;
    constexpr int U = G::U;
    __shared__ float s_s[G::WORDS];
    float* w_s = s_s + SPS * G::LD_ROW;
    const bool vec = (ld_s & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(s) & (4 * sizeof(T) - 1)) == 0;
    float v[G::BATCH][4], wv = 0.0f;
    // issue the loads of `tile` (zero past ld_s: only outputs past n_out
    // read them)
    auto fetch = [&](int tile) {
      const int c = tile / tiles_per_row;
      const long long t0 = (long long)(tile - c * tiles_per_row) * G::COLS;
      const T* row = s + (long long)c * ld_s;
#pragma unroll
      for (int b = 0; b < G::BATCH; ++b) {
        const int x = 4 * tid + 4 * G::THREADS * b;
        const long long t = t0 + x;
        if (vec && x < G::SPAN && t + 4 <= ld_s) {
          load4(row + t, v[b]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[b][e] = x + e < G::SPAN && t + e < ld_s ? lattice_value(row[t + e]) : 0.0f;
        }
      }
      if (tid < kTaps) wv = __ldg(w + c * kTaps + tid);
    };

    const int warp = tid >> 5, lane = tid & 31;
    const int p = warp % SPS;
    const int k = (warp / SPS) * 32 + lane;
    float* mine = s_s + p * G::LD_ROW + (U + 1) * k;
    const bool acc_al = (n_out & 3) == 0 && (reinterpret_cast<uintptr_t>(acc_out) & 15) == 0;
    const bool hit_al = (n_out & 3) == 0 && (reinterpret_cast<uintptr_t>(hit_out) & 3) == 0;
    int tile = blockIdx.x;
    if (tile < tiles) fetch(tile);
    for (; tile < tiles; tile += gridDim.x) {
      const int c = tile / tiles_per_row;
      const long long t0 = (long long)(tile - c * tiles_per_row) * G::COLS;
      // 1. stage the fetched tile, then fetch the next
#pragma unroll
      for (int b = 0; b < G::BATCH; ++b) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * tid + 4 * G::THREADS * b + e;
          if (x < G::SPAN) s_s[G::slot(x)] = v[b][e];
        }
      }
      if (tid < kTaps) w_s[tid] = wv;
      __syncthreads();
      if (tile + (int)gridDim.x < tiles) fetch(tile + gridDim.x);

      // 2. U outputs of phase p from U + 31 consecutive values of its row
      float wr[kTaps], acc[U];
#pragma unroll
      for (int j = 0; j < kTaps; ++j) wr[j] = w_s[j];
      taps<GRP, U>(mine, 1, wr, acc);
      __syncthreads();                            // every window has been read
#pragma unroll
      for (int u = 0; u < U; ++u) mine[u] = acc[u];  // position U*k + u
      __syncthreads();

      // 3. the tile in column order, four columns a thread
      float* arow = acc_out + (long long)c * n_out;
      int8_t* hrow = hit_out + (long long)c * n_out;
#pragma unroll
      for (int r = 0; r < G::COLS / (4 * G::THREADS); ++r) {
        const int x = 4 * tid + 4 * G::THREADS * r;
        const long long t = t0 + x;
        if (t >= n_out) break;
        float a[4];
        uint32_t hits = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = s_s[G::slot(x + e)];
          hits |= (uint32_t)(a[e] == n_mask) << (8 * e);
        }
        if (t + 4 <= n_out && acc_al) {
          *reinterpret_cast<float4*>(arow + t) = make_float4(a[0], a[1], a[2], a[3]);
        } else {
          for (int e = 0; e < 4 && t + e < n_out; ++e) arow[t + e] = a[e];
        }
        if (t + 4 <= n_out && hit_al) {
          *reinterpret_cast<uint32_t*>(hrow + t) = hits;
        } else {
          for (int e = 0; e < 4 && t + e < n_out; ++e) hrow[t + e] = (int8_t)(hits >> (8 * e));
        }
      }
      __syncthreads();                            // before the next tile is staged
    }
  }
}

template <typename T>
using CorrKernel = void (*)(const T*, const float*, float*, int8_t*, long long,
                            long long, int, int, int, float);

template <typename T, int SPS>
CorrKernel<T> pick_grp(int grp) {
  switch (grp) {
    case 1: return aa_corr_kernel<T, 1, SPS>;
    case 2: return aa_corr_kernel<T, 2, SPS>;
    case 4: return aa_corr_kernel<T, 4, SPS>;
    case 8: return aa_corr_kernel<T, 8, SPS>;
    case 16: return aa_corr_kernel<T, 16, SPS>;
    case 32: return aa_corr_kernel<T, 32, SPS>;
    default: return nullptr;
  }
}

// the wide instance at sps (1, 2, 4 or 8), or the narrow one at sps 0
template <typename T>
CorrKernel<T> pick(int grp, int sps) {
  switch (sps) {
    case 0: return pick_grp<T, 0>(grp);
    case 1: return pick_grp<T, 1>(grp);
    case 2: return pick_grp<T, 2>(grp);
    case 4: return pick_grp<T, 4>(grp);
    case 8: return pick_grp<T, 8>(grp);
    default: return nullptr;
  }
}

int group_index(int grp) {
  for (int g = 0; g < kNumGroups; ++g)
    if (grp == 1 << g) return g;
  return -1;
}

// The launch of one call: the wide tile where sps allows and its tiles give
// every SM two CTAs, a persistent grid of at most the CTAs the card holds
// at once; else the narrow tile, one CTA per (tile, row).
struct Plan {
  int wide_sps;          // the wide instance's sps, 0 for the narrow tile
  int threads, cols, tiles_per_row, tiles, per_sm;
  dim3 grid;
};

// per device: the SM count, and per instance (lattice type, grouping, tile:
// wide at sps 1, 2, 4, 8 or narrow) the resident CTAs an SM takes
struct DeviceInfo {
  int sms;
  int per_sm[2][kNumGroups][5];
  int stack_per_sm;
};
DeviceInfo g_info[kMaxDevices];

template <typename T>
cudaError_t make_plan(int rows, long long n_out, int sps, int grp, Plan* p) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  DeviceInfo local = {};
  DeviceInfo& info = dev < kMaxDevices ? g_info[dev] : local;
  if (info.sms == 0) {
    err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  p->wide_sps = 0;
  if ((sps & (sps - 1)) == 0) {
    p->threads = wide_threads(sps);
    p->cols = p->threads / sps * kWideU * sps;
    p->tiles_per_row = (int)((n_out + p->cols - 1) / p->cols);
    if ((long long)rows * p->tiles_per_row >= 2LL * info.sms) p->wide_sps = sps;
  }
  if (p->wide_sps == 0) {
    p->threads = p->cols = kNarrowThreads;
    p->tiles_per_row = (int)((n_out + kNarrowThreads - 1) / kNarrowThreads);
  }
  p->tiles = p->tiles_per_row * rows;
  int& per_sm = info.per_sm[sizeof(T) == 1][group_index(grp)]
                           [p->wide_sps ? __builtin_ctz(p->wide_sps) : 4];
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pick<T>(grp, p->wide_sps),
                                                        p->threads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  p->per_sm = per_sm;
  if (p->wide_sps == 0) {
    p->grid = dim3(p->tiles_per_row, rows);
  } else {
    const int cap = per_sm * info.sms;
    p->grid = dim3(p->tiles < cap ? p->tiles : cap);
  }
  return cudaSuccess;
}

// rows on the narrow grid's y; tiles counted in 32-bit ints
bool valid(int rows, long long n_out, int sps, int grp) {
  return sps >= 1 && sps <= kMaxSps && rows >= 1 && rows <= 65535 && n_out >= 1 &&
         (n_out / kNarrowThreads + 1) * rows < (1LL << 31) && group_index(grp) >= 0;
}

template <typename T>
cudaError_t launch_corr(const void* s, const void* w, void* acc, void* hit,
                        int rows, long long ld_s, long long n_out, int sps,
                        int grp, int n_mask, cudaStream_t stream) {
  Plan p;
  cudaError_t err = make_plan<T>(rows, n_out, sps, grp, &p);
  if (err != cudaSuccess) return err;
  pick<T>(grp, p.wide_sps)<<<p.grid, p.threads, 0, stream>>>(
      (const T*)s, (const float*)w, (float*)acc, (int8_t*)hit, ld_s, n_out, sps,
      p.tiles_per_row, p.tiles, (float)n_mask);
  return cudaGetLastError();
}

// The stack: items are (output row, segment of seg_groups 16-byte groups);
// a thread takes up to kStackU groups of a segment, kStackThreads apart, so a
// warp stores whole lines. The row's shift, reduced mod nbp on the host,
// is a kernel parameter; each group's source column wraps by one
// conditional subtract (t + shift < 2*nbp). Groups start at the row's
// first 16-byte-aligned column a0; the head [0, a0) and the tail past the
// last whole group (at most three columns each) are stored scalarly. A
// group whose source is aligned and does not cross the seam is one float4
// load, else four scalar loads. The shifts are a __grid_constant__
// parameter, so indexing them by r reads the parameter bank, no local copy.
struct StackShifts {
  int v[kMaxStackGroups];   // shift of row group r, in [0, nbp)
};

__global__ void __launch_bounds__(kStackThreads) shift_stack_kernel(
    const float* __restrict__ s, float* __restrict__ x, int rows, int nbp,
    int segs, int seg_groups, int items, const __grid_constant__ StackShifts sh) {
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int row = item / segs, seg = item - row * segs;  // CTA-uniform
    const int r = row / rows, c = row - r * rows;
    const int shift = sh.v[r];
    float* __restrict__ xr = x + (long long)row * nbp;
    const float* __restrict__ sr = s + (long long)c * nbp;
    const int a0 = min((int)((0u - (unsigned)((uintptr_t)xr >> 2)) & 3u), nbp);
    const int groups = (nbp - a0) >> 2;
    if (seg == 0 && threadIdx.x < 8) {    // the head and the tail
      const int t = threadIdx.x < 4 ? threadIdx.x : a0 + 4 * groups + threadIdx.x - 4;
      if (threadIdx.x < 4 ? t < a0 : t < nbp) {
        int src = t + shift;
        if (src >= nbp) src -= nbp;
        xr[t] = sr[src];
      }
    }
    const int g_lo = seg * seg_groups;
    const int g_hi = min(groups, g_lo + seg_groups);
    float4 v[kStackU];
#pragma unroll
    for (int u = 0; u < kStackU; ++u) {
      const int g = g_lo + threadIdx.x + u * kStackThreads;
      if (g < g_hi) {
        int src = a0 + 4 * g + shift;
        if (src >= nbp) src -= nbp;
        const float* p = sr + src;
        if (src + 3 < nbp && ((uintptr_t)p & 15) == 0) {
          v[u] = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          float e[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            int k = src + j;
            if (k >= nbp) k -= nbp;
            e[j] = __ldg(sr + k);
          }
          v[u] = make_float4(e[0], e[1], e[2], e[3]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStackU; ++u) {
      const int g = g_lo + threadIdx.x + u * kStackThreads;
      if (g < g_hi) *reinterpret_cast<float4*>(xr + a0 + 4 * g) = v[u];
    }
  }
}

struct StackPlan {
  int segs, seg_groups, items, per_sm, grid;
};

bool stack_valid(int rows, long long nbp, int grp) {
  return rows >= 1 && grp >= 1 && grp <= kMaxStackGroups && nbp >= 1 &&
         nbp < (1LL << 30) && (long long)grp * rows * (nbp / 4 + 1) < (1LL << 31);
}

// Segments of at most kStackThreads * kStackU groups, split evenly over the
// row; the grid is one wave (the CTAs the card holds at once) or the items,
// whichever is fewer.
cudaError_t make_stack_plan(int rows, int nbp, int grp, StackPlan* p) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  DeviceInfo local = {};
  DeviceInfo& info = dev < kMaxDevices ? g_info[dev] : local;
  if (info.sms == 0) {
    err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (info.stack_per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info.stack_per_sm, shift_stack_kernel,
                                                        kStackThreads, 0);
    if (err != cudaSuccess) return err;
    if (info.stack_per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  const int max_groups = nbp / 4 > 0 ? nbp / 4 : 1;
  const int per_seg = kStackThreads * kStackU;
  p->segs = (max_groups + per_seg - 1) / per_seg;
  p->seg_groups = (max_groups + p->segs - 1) / p->segs;
  p->items = grp * rows * p->segs;
  p->per_sm = info.stack_per_sm;
  const int cap = info.stack_per_sm * info.sms;
  p->grid = p->items < cap ? p->items : cap;
  return cudaSuccess;
}

}  // namespace

extern "C" int btle_aa_corr(const void* s, const void* w, void* acc, void* hit,
                            int rows, long long ld_s, long long n_out, int sps,
                            int grp, int is_int8, int n_mask, void* stream) {
  if (!valid(rows, n_out, sps, grp) || ld_s < n_out + (long long)(kTaps - 1) * sps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_int8 ? launch_corr<int8_t>(s, w, acc, hit, rows, ld_s, n_out,
                                             sps, grp, n_mask, st)
                       : launch_corr<float>(s, w, acc, hit, rows, ld_s, n_out,
                                            sps, grp, n_mask, st));
}

// The launch shape for (rows, n_out, sps, grp, int8 lattice): info[0]
// dynamic shared memory (bytes: none, the tiles' is static), [1] resident
// CTAs per SM, [2] CTAs in the grid, [3] threads per CTA, [4] output
// columns per tile.
extern "C" int btle_aa_corr_plan(int rows, long long n_out, int sps, int grp,
                                 int is_int8, int* info) {
  if (!valid(rows, n_out, sps, grp)) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = is_int8 ? make_plan<int8_t>(rows, n_out, sps, grp, &p)
                                  : make_plan<float>(rows, n_out, sps, grp, &p);
  if (err != cudaSuccess) return (int)err;
  info[0] = 0;
  info[1] = p.per_sm;
  info[2] = (int)(p.grid.x * p.grid.y);
  info[3] = p.threads;
  info[4] = p.cols;
  return 0;
}

extern "C" int btle_shift_stack(const void* s, void* x, int rows, long long nbp,
                                int grp, int sps, long long k0, void* stream) {
  if (!stack_valid(rows, nbp, grp)) return (int)cudaErrorInvalidValue;
  StackPlan p;
  const cudaError_t err = make_stack_plan(rows, (int)nbp, grp, &p);
  if (err != cudaSuccess) return (int)err;
  StackShifts sh;
  for (int r = 0; r < grp; ++r) {
    const long long k = (k0 + (long long)sps * (grp - 1 - r)) % nbp;
    sh.v[r] = (int)(k < 0 ? k + nbp : k);
  }
  shift_stack_kernel<<<p.grid, kStackThreads, 0, (cudaStream_t)stream>>>(
      (const float*)s, (float*)x, rows, (int)nbp, p.segs, p.seg_groups, p.items, sh);
  return (int)cudaGetLastError();
}

// The stack's launch shape for (rows, nbp, grp): info[0] dynamic shared
// memory (none), [1] resident CTAs per SM, [2] CTAs in the grid, [3]
// threads per CTA, [4] output columns per segment.
extern "C" int btle_shift_stack_plan(int rows, long long nbp, int grp, int* info) {
  if (!stack_valid(rows, nbp, grp)) return (int)cudaErrorInvalidValue;
  StackPlan p;
  const cudaError_t err = make_stack_plan(rows, (int)nbp, grp, &p);
  if (err != cudaSuccess) return (int)err;
  info[0] = 0;
  info[1] = p.per_sm;
  info[2] = p.grid;
  info[3] = kStackThreads;
  info[4] = 4 * p.seg_groups;
  return 0;
}
