// Demod tail of the fused wideband front end: decisions, AA hits, RSSI.
//
// Replaces the TPU kernel body btle_tpu/wideband/fused.py:_demod_tail (with
// the _aa_w4 block-diagonal AA weights), shared there by every filterbank
// inner. From the 80-row channel baseband y (rows 0..39 = y_i of bins
// 0..39, rows 40..79 = y_q) it writes, per channel m:
//   bits[m, n] = d > 0 (d < 0 on odd bins when lag is odd: the (-1)^(mk)
//                half-band sign the filterbank never applied),
//                d = y_i[n] y_q[n+lag] - y_i[n+lag] y_q[n],      n < n_bits
//   hit[m, n]  = every masked access-address bit j matches bits[n + j*sps]
//   mag[m, n]  = mean of |y_i| + |y_q| over [n, n + 32*sps),     n < n_hit
//
// Bound on the H100: bytes. Per 131k bench block it reads y (~42 MB) and
// writes bits, hit and mag (~5 + 5 + 21 MB): ~74 MB, ~22 us at 3.35 TB/s;
// its few operations per position are far below the FP32 rate.
//
// Design: one CTA per (channel, 2048-position tile), so the halo it reads
// again (31*sps + lag or 32*sps - 1 columns) is ~6% of the tile.
//   1. The tile's y_i and y_q spans are staged once in shared memory, with
//      16-byte loads where the rows allow; the channel's AA word and care
//      mask are two warp ballots (bit j from lane j), in registers.
//   2. Each decision is formed once from shared memory (d with __fmul_rn /
//      __fsub_rn, so nvcc cannot contract it into an FMA and decisions agree
//      with the plain PyTorch twin bit for bit, ties included), and each
//      |y_i| + |y_q| value once; four a thread with 16-byte reads when the
//      lag is a multiple of 4 (LE 1M at sps 4 and 8).
//   3. The decisions are packed by warp ballots into 32-bit words per sps
//      phase: bit t of phase p's word w is decision sps*(32w + t) + p. The
//      32-tap window of position k is then 32 consecutive bits of phase
//      k % sps from bit k / sps: one funnel shift of two words, and the AA
//      test is the exact integer one ((word ^ aa) & care == 0, the
//      "acc == n_mask" of the TPU kernel).
//   4. The RSSI window sum is the same balanced pairwise tree as the TPU
//      kernel's doubling loop (log2(32*sps) levels, ping-ponged between two
//      shared buffers, one barrier a level, 16-byte reads from span 4 on),
//      so mag is bit-identical to the twin.
//   5. Each thread writes four consecutive positions: bits and hit as one
//      32-bit store each, mag as one float4, where the rows are aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 40;
constexpr int kAaBits = 32;
constexpr int kMaxSps = 8;
constexpr int kTile = 2048;       // positions per CTA
constexpr int kThreads = 256;
// phase words: sps * (ceil((kTile / sps + 31) / 32) + 1) <= 80 for sps <= 8
constexpr int kMaxWords = 128;

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// staged y columns per row: decisions read up to bits_len - 1 + lag, the
// RSSI windows up to kTile + 32*sps - 2
__host__ __device__ __forceinline__ int span_len(int sps, int lag) {
  const int d = kTile + (kAaBits - 1) * sps + lag;
  const int w = kTile + kAaBits * sps - 1;
  return round4(d > w ? d : w);
}

__host__ __device__ __forceinline__ int smem_bytes(int sps, int lag) {
  const int bits_len = kTile + (kAaBits - 1) * sps;
  const int w_len = kTile + kAaBits * sps - 1;
  return (2 * span_len(sps, lag) + round4(w_len)) * 4 + kMaxWords * 4 +
         round4(bits_len);
}

// four bytes (byte i = position n + i) to p[0..3], the first ``left``
__device__ __forceinline__ void store_bytes4(uint8_t* p, uint32_t v,
                                             long long left, bool aligned) {
  if (aligned && left >= 4) {
    *reinterpret_cast<uint32_t*>(p) = v;
  } else {
    for (int i = 0; i < 4 && i < left; ++i) p[i] = (uint8_t)(v >> (8 * i));
  }
}

__global__ void __launch_bounds__(kThreads) demod_tail_kernel(
    const float* __restrict__ y, const int8_t* __restrict__ aa_rows,
    const int8_t* __restrict__ aa_mask, int8_t* __restrict__ bits_out,
    uint8_t* __restrict__ hit_out, float* __restrict__ mag_out, long long ky,
    long long n_bits, long long n_hit, int sps, int lag) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sps_log2 = __ffs(sps) - 1;
  const int win = kAaBits * sps;
  const int span = span_len(sps, lag);
  const int bits_len = kTile + (kAaBits - 1) * sps;   // decisions the hits read
  const int w_len = kTile + win - 1;                  // values the windows read
  float* yi_s = reinterpret_cast<float*>(smem);
  float* yq_s = yi_s + span;
  float* w_s = yq_s + span;
  uint32_t* words_s = reinterpret_cast<uint32_t*>(w_s + round4(w_len));
  uint8_t* bits_s = reinterpret_cast<uint8_t*>(words_s + kMaxWords);

  const int m = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n0 = (long long)blockIdx.x * kTile;
  const float* yi = y + (long long)m * ky;
  const float* yq = y + (long long)(kChannels + m) * ky;

  // 1. the tile's y spans, zero past Ky
  if ((ky & 3) == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0) {
    for (int c = tid; c < span / 4; c += kThreads) {
      const long long n = n0 + 4 * c;
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
      if (n < ky) {          // Ky % 4 == 0: the whole float4 lies inside
        a = __ldg(reinterpret_cast<const float4*>(yi + n));
        b = __ldg(reinterpret_cast<const float4*>(yq + n));
      }
      reinterpret_cast<float4*>(yi_s)[c] = a;
      reinterpret_cast<float4*>(yq_s)[c] = b;
    }
  } else {
    for (int k = tid; k < span; k += kThreads) {
      const long long n = n0 + k;
      yi_s[k] = n < ky ? __ldg(yi + n) : 0.0f;
      yq_s[k] = n < ky ? __ldg(yq + n) : 0.0f;
    }
  }
  // the channel's AA word and care mask: bit j from lane j
  const unsigned aa = __ballot_sync(~0u, aa_rows[m * kAaBits + lane] & 1);
  const unsigned care = __ballot_sync(~0u, aa_mask[lane] != 0);
  __syncthreads();

  // 2. decisions (zero past n_bits) and |y_i| + |y_q|
  const bool flip = (lag & 1) && (m & 1);
  auto decide = [&](int k, float yi0, float yq0, float yil, float yql) {
    const float d = __fsub_rn(__fmul_rn(yi0, yql), __fmul_rn(yil, yq0));
    return k < bits_len && n0 + k < n_bits && (flip ? d < 0.0f : d > 0.0f);
  };
  if ((lag & 3) == 0) {
    // four positions a thread: every span read is a 16-byte one
    for (int k = 4 * tid; k < round4(w_len); k += 4 * kThreads) {
      const float4 a = *reinterpret_cast<const float4*>(yi_s + k);
      const float4 b = *reinterpret_cast<const float4*>(yq_s + k);
      *reinterpret_cast<float4*>(w_s + k) = make_float4(
          __fadd_rn(fabsf(a.x), fabsf(b.x)), __fadd_rn(fabsf(a.y), fabsf(b.y)),
          __fadd_rn(fabsf(a.z), fabsf(b.z)), __fadd_rn(fabsf(a.w), fabsf(b.w)));
      if (k < round4(bits_len)) {
        const float4 c = *reinterpret_cast<const float4*>(yi_s + k + lag);
        const float4 e = *reinterpret_cast<const float4*>(yq_s + k + lag);
        *reinterpret_cast<uint32_t*>(bits_s + k) =
            (uint32_t)decide(k, a.x, b.x, c.x, e.x) |
            (uint32_t)decide(k + 1, a.y, b.y, c.y, e.y) << 8 |
            (uint32_t)decide(k + 2, a.z, b.z, c.z, e.z) << 16 |
            (uint32_t)decide(k + 3, a.w, b.w, c.w, e.w) << 24;
      }
    }
  } else {
    // one position a thread per pass: lanes on consecutive words
    for (int k = tid; k < round4(bits_len); k += kThreads)
      bits_s[k] = k < bits_len &&
                  decide(k, yi_s[k], yq_s[k], yi_s[k + lag], yq_s[k + lag]);
    for (int k = tid; k < w_len; k += kThreads)
      w_s[k] = __fadd_rn(fabsf(yi_s[k]), fabsf(yq_s[k]));
  }
  __syncthreads();

  // 3. phase words (the tree's first barrier publishes them)
  const int n_t = kTile / sps + kAaBits - 1;          // decisions per phase
  const int n_words = (n_t + 31) / 32 + 1;            // + the shift's high word
  for (int id = warp; id < sps * n_words; id += kThreads / 32) {
    const int p = id / n_words, t = 32 * (id % n_words) + lane;
    const unsigned word = __ballot_sync(~0u, t < n_t && bits_s[sps * t + p]);
    if (lane == 0) words_s[id] = word;
  }

  // 4. window sums: after the level of span s, src[k] holds the sum of the
  // 2s values from k (the staged y_i buffer is free now); from s = 4 on,
  // four sums a thread with 16-byte reads and writes (the few sums past
  // ``live`` that this computes are never read)
  float* src = w_s;
  float* dst = yi_s;
  for (int s = 1; s < win; s *= 2) {
    const int live = w_len - 2 * s + 1;
    if (s < 4) {
      for (int k = tid; k < live; k += kThreads)
        dst[k] = __fadd_rn(src[k], src[k + s]);
    } else {
      for (int k = 4 * tid; k < live; k += 4 * kThreads) {
        const float4 a = *reinterpret_cast<const float4*>(src + k);
        const float4 b = *reinterpret_cast<const float4*>(src + k + s);
        *reinterpret_cast<float4*>(dst + k) =
            make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                        __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
      }
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }

  // 5. outputs, four consecutive positions a thread
  const float scale = 1.0f / (float)win;
  const bool bits_al = (n_bits & 3) == 0 &&
                       (reinterpret_cast<uintptr_t>(bits_out) & 3) == 0;
  const bool hit_al = (n_hit & 3) == 0 &&
                      (reinterpret_cast<uintptr_t>(hit_out) & 3) == 0;
  const bool mag_al = (n_hit & 3) == 0 &&
                      (reinterpret_cast<uintptr_t>(mag_out) & 15) == 0;
  for (int k = 4 * tid; k < kTile; k += 4 * kThreads) {
    const long long n = n0 + k;
    if (n >= n_bits) break;
    store_bytes4(reinterpret_cast<uint8_t*>(bits_out) + m * n_bits + n,
                 *reinterpret_cast<const uint32_t*>(bits_s + k), n_bits - n,
                 bits_al);
    if (n >= n_hit) continue;
    uint32_t hits = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = k + i;
      const int q = kk >> sps_log2;
      const uint32_t* wp = words_s + (kk & (sps - 1)) * n_words + (q >> 5);
      const unsigned word = __funnelshift_r(wp[0], wp[1], q & 31);
      hits |= (uint32_t)(((word ^ aa) & care) == 0u) << (8 * i);
    }
    store_bytes4(hit_out + m * n_hit + n, hits, n_hit - n, hit_al);
    const float4 s4 = *reinterpret_cast<const float4*>(src + k);
    const float4 mg = make_float4(__fmul_rn(s4.x, scale), __fmul_rn(s4.y, scale),
                                  __fmul_rn(s4.z, scale), __fmul_rn(s4.w, scale));
    float* out = mag_out + m * n_hit + n;
    if (mag_al && n_hit - n >= 4) {
      *reinterpret_cast<float4*>(out) = mg;
    } else {
      const float v[4] = {mg.x, mg.y, mg.z, mg.w};
      for (int i = 0; i < 4 && i < n_hit - n; ++i) out[i] = v[i];
    }
  }
}

// The dynamic shared-memory limit set per device so far: a launch raises
// it (cudaFuncSetAttribute) only when it needs more than the default.
constexpr int kMaxDevices = 64;
int g_smem_limit[kMaxDevices];

}  // namespace

extern "C" int btle_demod_tail(const void* y, const void* aa_rows,
                               const void* aa_mask, void* bits, void* hit,
                               void* mag, long long ky, long long n_bits,
                               long long n_hit, int sps, int lag,
                               void* stream) {
  if (sps < 1 || sps > kMaxSps || (sps & (sps - 1)) || lag < 0)
    return (int)cudaErrorInvalidValue;
  if (n_bits <= 0) return 0;
  const int smem = smem_bytes(sps, lag);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices || smem > g_smem_limit[dev]) {
      err = cudaFuncSetAttribute(demod_tail_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < kMaxDevices) g_smem_limit[dev] = smem;
    }
  }
  dim3 grid((unsigned)((n_bits + kTile - 1) / kTile), kChannels);
  demod_tail_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)y, (const int8_t*)aa_rows, (const int8_t*)aa_mask,
      (int8_t*)bits, (uint8_t*)hit, (float*)mag, ky, n_bits, n_hit, sps, lag);
  return (int)cudaGetLastError();
}
