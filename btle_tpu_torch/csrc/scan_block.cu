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
// bits and 0.27 MB of hits: ~0.3 us at 3.35 TB/s, below a launch.
// Design: one block per (row, tile of kTile output positions). The tile's
// i and q plus a halo of 31*sps + lag samples are staged in shared memory
// (each sample read from device memory once per tile), the decisions are
// written as bytes to shared memory and to bits, and each thread gathers
// the 32 decisions of a position at stride sps into one 32-bit word: the
// hit test is ((word ^ aa) & mask) == 0, an exact integer compare (K2's).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAaBits = 32;
constexpr int kTile = 1024;     // output positions per block
constexpr int kThreads = 256;
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

template <typename T>
__global__ void __launch_bounds__(kThreads) scan_block_kernel(
    const T* __restrict__ iq_i, const T* __restrict__ iq_q,
    const int8_t* __restrict__ aa_rows, const int8_t* __restrict__ aa_mask,
    int8_t* __restrict__ bits_out, uint8_t* __restrict__ hit_out,
    long long n, long long n_bits, long long n_hit, int sps, int lag) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int span = (kAaBits - 1) * sps;
  const int bits_len = kTile + span;          // decisions this tile needs
  const int iq_len = bits_len + lag;          // samples behind them
  T* i_s = reinterpret_cast<T*>(smem);
  T* q_s = i_s + iq_len;
  uint8_t* b_s = reinterpret_cast<uint8_t*>(q_s + iq_len);

  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * kTile;
  const T* ri = iq_i + (long long)c * n;
  const T* rq = iq_q + (long long)c * n;

  for (int k = tid; k < iq_len; k += kThreads) {
    const long long s = n0 + k;
    i_s[k] = s < n ? ri[s] : T(0);
    q_s[k] = s < n ? rq[s] : T(0);
  }
  __syncthreads();

  int8_t* rb = bits_out + (long long)c * n_bits;
  for (int k = tid; k < bits_len; k += kThreads) {
    const bool b = decide<T>(i_s[k], q_s[k], i_s[k + lag], q_s[k + lag]);
    b_s[k] = b;
    if (k < kTile && n0 + k < n_bits) rb[n0 + k] = (int8_t)b;
  }

  unsigned aa = 0, mask = 0;
#pragma unroll
  for (int j = 0; j < kAaBits; ++j) {
    aa |= (unsigned)(aa_rows[c * kAaBits + j] & 1) << j;
    mask |= (unsigned)(aa_mask[j] != 0) << j;
  }
  __syncthreads();

  uint8_t* rh = hit_out + (long long)c * n_hit;
  for (int k = tid; k < kTile; k += kThreads) {
    if (n0 + k >= n_hit) break;
    unsigned word = 0;
#pragma unroll
    for (int j = 0; j < kAaBits; ++j)
      word |= (unsigned)b_s[k + j * sps] << j;
    rh[n0 + k] = ((word ^ aa) & mask) == 0u;
  }
}

template <typename T>
int launch(const void* i, const void* q, const void* aa_rows,
           const void* aa_mask, void* bits, void* hit, int rows, long long n,
           int sps, int lag, cudaStream_t stream) {
  const long long n_bits = n - lag;
  const long long n_hit = n_bits - (long long)(kAaBits - 1) * sps;
  const long long bits_len = kTile + (long long)(kAaBits - 1) * sps;
  const size_t smem = (size_t)(bits_len + lag) * 2 * sizeof(T) + bits_len;
  if (sps < 1 || lag < 1 || rows < 1 || rows > 65535 || n_hit < 0 ||
      smem > (size_t)kMaxShared)
    return (int)cudaErrorInvalidValue;
  if (n_bits == 0) return (int)cudaSuccess;
  dim3 grid((unsigned)((n_bits + kTile - 1) / kTile), (unsigned)rows);
  scan_block_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)i, (const T*)q, (const int8_t*)aa_rows,
      (const int8_t*)aa_mask, (int8_t*)bits, (uint8_t*)hit, n, n_bits, n_hit,
      sps, lag);
  return (int)cudaGetLastError();
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
