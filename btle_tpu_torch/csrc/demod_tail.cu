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
// Design: one block per (channel, 256-position tile). The tile's decisions
// and |y_i|+|y_q| values are computed once into shared memory (each y value
// is read once per tile plus a 31*sps / 32*sps halo); the AA test is an
// exact integer one (XOR against the channel's AA word under the care
// mask, the "acc == n_mask" of the TPU kernel); the RSSI window sum is the
// same balanced pairwise tree as the TPU kernel's doubling loop, so mag is
// bit-identical to the plain PyTorch twin. d is computed with __fmul_rn /
// __fsub_rn so nvcc cannot contract it into an FMA: decisions then agree
// with the twin bit for bit, ties included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 40;
constexpr int kAaBits = 32;
constexpr int kTile = 256;      // positions per block (= threads)
constexpr int kMaxSps = 8;
constexpr int kBitsLen = kTile + (kAaBits - 1) * kMaxSps;
constexpr int kMagLen = kTile + kAaBits * kMaxSps - 1;

__global__ void __launch_bounds__(kTile) demod_tail_kernel(
    const float* __restrict__ y, const int8_t* __restrict__ aa_rows,
    const int8_t* __restrict__ aa_mask, int8_t* __restrict__ bits_out,
    uint8_t* __restrict__ hit_out, float* __restrict__ mag_out, long long ky,
    long long n_bits, long long n_hit, int sps, int lag) {
  __shared__ uint8_t bits_s[kBitsLen];
  __shared__ float w_s[kMagLen];
  const int m = blockIdx.y;
  const int tid = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * kTile;
  const float* yi = y + (long long)m * ky;
  const float* yq = y + (long long)(kChannels + m) * ky;
  const bool flip = (lag & 1) && (m & 1);
  const int win = kAaBits * sps;
  const int bits_len = kTile + (kAaBits - 1) * sps;
  const int mag_len = kTile + win - 1;

  for (int k = tid; k < bits_len; k += kTile) {
    const long long n = n0 + k;
    uint8_t b = 0;
    if (n < n_bits) {
      const float d = __fsub_rn(__fmul_rn(yi[n], yq[n + lag]),
                                __fmul_rn(yi[n + lag], yq[n]));
      b = flip ? (d < 0.0f) : (d > 0.0f);
      if (k < kTile) bits_out[(long long)m * n_bits + n] = (int8_t)b;
    }
    bits_s[k] = b;
  }
  for (int k = tid; k < mag_len; k += kTile) {
    const long long n = n0 + k;
    w_s[k] = n < ky ? __fadd_rn(fabsf(yi[n]), fabsf(yq[n])) : 0.0f;
  }
  __syncthreads();

  // window sums as a balanced pairwise tree: after the level of span s,
  // w_s[k] holds the sum of the 2s values starting at k
  for (int span = 1; span < win; span *= 2) {
    float v0 = 0.0f, v1 = 0.0f;
    const int live = mag_len - 2 * span + 1;   // entries valid after this level
    const int k1 = tid + kTile;
    if (tid < live) v0 = __fadd_rn(w_s[tid], w_s[tid + span]);
    if (k1 < live) v1 = __fadd_rn(w_s[k1], w_s[k1 + span]);
    __syncthreads();
    if (tid < live) w_s[tid] = v0;
    if (k1 < live) w_s[k1] = v1;
    __syncthreads();
  }

  const long long n = n0 + tid;
  if (n < n_hit) {
    unsigned aa = 0, mask = 0, word = 0;
    for (int j = 0; j < kAaBits; ++j) {
      aa |= (unsigned)(aa_rows[m * kAaBits + j] & 1) << j;
      mask |= (unsigned)(aa_mask[j] != 0) << j;
      word |= (unsigned)bits_s[tid + j * sps] << j;
    }
    hit_out[(long long)m * n_hit + n] = ((word ^ aa) & mask) == 0u;
    mag_out[(long long)m * n_hit + n] = __fmul_rn(w_s[tid], 1.0f / (float)win);
  }
}

}  // namespace

extern "C" int btle_demod_tail(const void* y, const void* aa_rows,
                               const void* aa_mask, void* bits, void* hit,
                               void* mag, long long ky, long long n_bits,
                               long long n_hit, int sps, int lag,
                               void* stream) {
  if (sps < 1 || sps > kMaxSps) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n_bits + kTile - 1) / kTile), kChannels);
  demod_tail_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(
      (const float*)y, (const int8_t*)aa_rows, (const int8_t*)aa_mask,
      (int8_t*)bits, (uint8_t*)hit, (float*)mag, ky, n_bits, n_hit, sps, lag);
  return (int)cudaGetLastError();
}
