// Narrowband scan: phase-difference decisions and the 32-tap access-address
// correlation over (C, N) IQ rows.
//
// Replaces the TPU kernel btle_tpu/phy/pallas_scan.py:_kernel (launched by
// scan_block_fused), with the numerics of the JAX main path it stands in
// for (rx/pipeline.py:scan_block): for every row c
//   d[n]      = i[n] q[n+lag] - i[n+lag] q[n]                  n < n_bits
//   bits[c,n] = d[n] > 0                                       (int8)
//   hit[c,n]  = every masked AA bit j matches bits[c, n + j*sps], n < n_hit
// with n_bits = N - lag and n_hit = n_bits - 31*sps. Integer IQ (int16) uses
// exact int32 products (|d| < 2^31 for any int16 input); float32 IQ uses
// __fmul_rn / __fsub_rn so nvcc cannot contract the products into an FMA.
// Bits and hits then equal the plain PyTorch twin exactly. The Pallas
// kernel casts int16 to f32, where two products past 2^24 can round equal;
// the port keeps the exact integer answer of the JAX main path.
//
// Bound on the H100: bytes, and at narrowband block sizes launch latency.
// A 131072 + 1473-sample int16 block reads 0.53 MB and writes 0.27 MB of
// bits and 0.27 MB of hits: ~0.3 us at 3.35 TB/s, below a launch. The
// wideband rescan's 40 float rows of a bench block move ~53 MB, ~16 us.
// Design: one CTA of 128 threads per (row, tile of kTile = 512 positions):
// a narrowband block gives every SM two CTAs, 40 rows give many small CTAs
// resident at once. A tile is one load round trip and one barrier:
//   1. The decisions are formed straight from the IQ rows into warp
//      ballots, one 32-bit word per (sps phase, 32 decisions): bit t of
//      phase p's word w is decision sps*(32w + t) + p (K2's layout,
//      csrc/demod_tail.cu). Each lane first loads the four samples of
//      each of its decisions into registers, so all the tile's loads are
//      in flight at once; neighbouring lanes' samples share L1 lines. The
//      row's AA word and care mask are two more ballots (bit j from lane
//      j).
//   2. After one barrier each thread takes four consecutive positions k:
//      bits[k] is bit k / sps of phase k % sps, and the 32-tap window of k
//      is the 32 bits of that phase from bit k / sps, a funnel shift of two
//      words; the hit is ((window ^ aa) & care) == 0, an exact integer
//      compare. Bits and hits go out as one 32-bit word each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAaBits = 32;
constexpr int kTile = 512;      // output positions per CTA
constexpr int kThreads = 128;   // four positions a thread
constexpr int kWarps = kThreads / 32;
// phase words a warp loads the decisions of up front: every word for sps
// <= 8 but 5 and 7 (sps * words_per_phase(sps) <= 24), the rest from
// direct loads
constexpr int kMaxIt = 24 / kWarps;
constexpr int kMaxShared = 48 * 1024;

template <typename T>
__device__ __forceinline__ bool decide(T i0, T q0, T i1, T q1);

template <>
__device__ __forceinline__ bool decide<int16_t>(int16_t i0, int16_t q0,
                                                int16_t i1, int16_t q1) {
  const int d = (int)i0 * (int)q1 - (int)i1 * (int)q0;
  return d > 0;
}

template <>
__device__ __forceinline__ bool decide<float>(float i0, float q0, float i1,
                                              float q1) {
  return __fsub_rn(__fmul_rn(i0, q1), __fmul_rn(i1, q0)) > 0.0f;
}

// phase words per phase: a window reads words q/32 and q/32 + 1 of its
// phase, q <= (kTile - 1) / sps
__host__ __device__ __forceinline__ int words_per_phase(int sps) {
  return ((kTile - 1) / sps >> 5) + 2;
}

// four bytes (byte e = position n + e) to p[0..3], the first ``left``
__device__ __forceinline__ void store_bytes4(uint8_t* p, uint32_t v, long long left,
                                             bool aligned) {
  if (aligned && left >= 4) {
    *reinterpret_cast<uint32_t*>(p) = v;
  } else {
    for (int e = 0; e < 4 && e < left; ++e) p[e] = (uint8_t)(v >> (8 * e));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) scan_block_kernel(
    const T* __restrict__ iq_i, const T* __restrict__ iq_q,
    const int8_t* __restrict__ aa_rows, const int8_t* __restrict__ aa_mask,
    int8_t* __restrict__ bits_out, uint8_t* __restrict__ hit_out,
    long long n, long long n_bits, long long n_hit, int sps, int lag) {
  extern __shared__ uint32_t words_s[];
  const int n_words = words_per_phase(sps);
  const int total = sps * n_words;                   // ballots a tile
  const int bits_len = kTile + (kAaBits - 1) * sps;  // decisions its windows read
  const int c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n0 = (long long)blockIdx.x * kTile;
  const long long left = n_bits - n0;                // decisions of this row from n0
  const T* ri = iq_i + (long long)c * n + n0;
  const T* rq = iq_q + (long long)c * n + n0;

  // 1. phase words (zero past n_bits): ballot it of this warp is word
  // id = warp + kWarps*it, phase id / n_words; its lane's decision kk
  const unsigned aa = __ballot_sync(~0u, aa_rows[c * kAaBits + lane] & 1);
  const unsigned care = __ballot_sync(~0u, aa_mask[lane] != 0);
  T a0[kMaxIt], b0[kMaxIt], a1[kMaxIt], b1[kMaxIt];
  bool ok[kMaxIt];
#pragma unroll
  for (int it = 0; it < kMaxIt; ++it) {
    const int id = warp + kWarps * it;
    const int p = id / n_words;
    const int kk = sps * (32 * (id - p * n_words) + lane) + p;
    ok[it] = id < total && kk < bits_len && kk < left;
    a0[it] = b0[it] = a1[it] = b1[it] = T(0);
    if (ok[it]) {
      a0[it] = ri[kk];
      b0[it] = rq[kk];
      a1[it] = ri[kk + lag];
      b1[it] = rq[kk + lag];
    }
  }
#pragma unroll
  for (int it = 0; it < kMaxIt; ++it) {
    const int id = warp + kWarps * it;
    if (id < total) {
      const unsigned word =
          __ballot_sync(~0u, ok[it] && decide<T>(a0[it], b0[it], a1[it], b1[it]));
      if (lane == 0) words_s[id] = word;
    }
  }
  for (int id = warp + kWarps * kMaxIt; id < total; id += kWarps) {
    const int p = id / n_words;
    const int kk = sps * (32 * (id - p * n_words) + lane) + p;
    const bool b = kk < bits_len && kk < left &&
                   decide<T>(ri[kk], rq[kk], ri[kk + lag], rq[kk + lag]);
    const unsigned word = __ballot_sync(~0u, b);
    if (lane == 0) words_s[id] = word;
  }
  __syncthreads();

  // 2. bits and hits, four consecutive positions a thread
  const int k = 4 * tid;
  if (k >= left) return;
  const int shift = (sps & (sps - 1)) == 0 ? __ffs(sps) - 1 : -1;
  uint32_t bits = 0, hits = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int kk = k + e;
    const int q = shift >= 0 ? kk >> shift : kk / sps;
    const uint32_t* wp = words_s + (kk - q * sps) * n_words + (q >> 5);
    const uint32_t lo = wp[0], hi = wp[1];
    bits |= ((lo >> (q & 31)) & 1u) << (8 * e);
    hits |= (uint32_t)(((__funnelshift_r(lo, hi, q & 31) ^ aa) & care) == 0u) << (8 * e);
  }
  uint8_t* rb = reinterpret_cast<uint8_t*>(bits_out) + (long long)c * n_bits;
  store_bytes4(rb + n0 + k, bits, left - k, (reinterpret_cast<uintptr_t>(rb) & 3) == 0);
  if (n0 + k < n_hit) {
    uint8_t* rh = hit_out + (long long)c * n_hit;
    store_bytes4(rh + n0 + k, hits, n_hit - n0 - k, (reinterpret_cast<uintptr_t>(rh) & 3) == 0);
  }
}

bool valid(int rows, long long n, int sps, int lag) {
  const long long n_hit = n - lag - (long long)(kAaBits - 1) * sps;
  return sps >= 1 && lag >= 1 && rows >= 1 && rows <= 65535 && n_hit >= 0 &&
         sps <= kMaxShared / 8 && 4 * sps * words_per_phase(sps) <= kMaxShared;
}

template <typename T>
int launch(const void* i, const void* q, const void* aa_rows,
           const void* aa_mask, void* bits, void* hit, int rows, long long n,
           int sps, int lag, cudaStream_t stream) {
  if (!valid(rows, n, sps, lag)) return (int)cudaErrorInvalidValue;
  const long long n_bits = n - lag;
  const long long n_hit = n_bits - (long long)(kAaBits - 1) * sps;
  if (n_bits == 0) return (int)cudaSuccess;
  dim3 grid((unsigned)((n_bits + kTile - 1) / kTile), (unsigned)rows);
  scan_block_kernel<T><<<grid, kThreads, 4 * sps * words_per_phase(sps), stream>>>(
      (const T*)i, (const T*)q, (const int8_t*)aa_rows,
      (const int8_t*)aa_mask, (int8_t*)bits, (uint8_t*)hit, n, n_bits, n_hit,
      sps, lag);
  return (int)cudaGetLastError();
}

template <typename T>
int plan(int rows, long long n, int sps, int lag, int* info) {
  if (!valid(rows, n, sps, lag)) return (int)cudaErrorInvalidValue;
  const int smem = 4 * sps * words_per_phase(sps);
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, scan_block_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = smem;
  info[1] = per_sm;
  info[2] = (int)((n - lag + kTile - 1) / kTile) * rows;
  info[3] = kThreads;
  info[4] = kTile;
  return 0;
}

}  // namespace

// is_float: 0 = int16 IQ, 1 = float32 IQ. i, q (rows, n); aa_rows (rows, 32)
// int8; aa_mask (32,) int8; bits (rows, n - lag) int8; hit
// (rows, n - lag - 31*sps) bool.
extern "C" int btle_scan_block(const void* i, const void* q,
                               const void* aa_rows, const void* aa_mask,
                               void* bits, void* hit, int rows, long long n,
                               int sps, int lag, int is_float, void* stream) {
  if (is_float)
    return launch<float>(i, q, aa_rows, aa_mask, bits, hit, rows, n, sps, lag,
                         (cudaStream_t)stream);
  return launch<int16_t>(i, q, aa_rows, aa_mask, bits, hit, rows, n, sps, lag,
                         (cudaStream_t)stream);
}

// The launch shape for (rows, n, sps, lag, float IQ): info[0] dynamic
// shared memory (bytes), [1] resident CTAs per SM, [2] CTAs in the grid,
// [3] threads per CTA, [4] positions per CTA.
extern "C" int btle_scan_block_plan(int rows, long long n, int sps, int lag,
                                    int is_float, int* info) {
  return is_float ? plan<float>(rows, n, sps, lag, info)
                  : plan<int16_t>(rows, n, sps, lag, info);
}
