// Candidate decode: window gather, dewhitening, byte packing, CRC24 verdict.
//
// Replaces the TPU kernel btle_tpu/rx/pallas_decode.py:_kernel (launched by
// decode_candidates_pallas). For every (channel, slot) candidate at lattice
// position pos it takes the 336 bits at pos + 32*sps + k*sps, XORs the
// channel's whitening row, packs 42 LSB-first bytes, reads the payload
// length (6 bits on advertising channels, 5 on data channels) and compares
// the CRC24 state after header + payload with the three bytes that follow. Past the lattice end
// the window reads, by clamp_tail:
//   0  zero, with pos clamped to [0, Kb-1] — the Pallas kernel's semantics
//      (the fused wideband scan);
//   1  the lattice's last bit, every index clamped to [0, Kb-1] — the XLA
//      decode's gathers (rx/pipeline.py:_decode_candidate), which every
//      dense block decode (narrowband stream_decode, wideband rescan) runs.
//
// Bound on the H100: neither bytes nor operations. At bench geometry the
// kernel reads ~0.2 MB of window bits and writes ~0.1 MB (40 x 16 x 42 int32)
// — well under a microsecond at 3.35 TB/s — so launch latency sets its time.
// Design: one thread per candidate, everything in registers. The TPU
// kernel's GF(2) CRC matmul (an MXU device) becomes the exact bitwise
// reflected LFSR of the table update (btle_rx.c:1211-1222), eight shift/xor
// steps per byte; only the CRC state at the selected length is kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAaBits = 32;
constexpr int kPduBytes = 42;            // header + max payload + CRC
constexpr int kPduBits = kPduBytes * 8;  // 336
constexpr unsigned kPolyReflected = 0xDA6000u;

// kClampTail is a template parameter so the zero-padding instantiation
// carries no per-bit branch on the mode.
template <bool kClampTail>
__global__ void decode_candidates_kernel(
    const int8_t* __restrict__ bits, const int* __restrict__ pos,
    const int8_t* __restrict__ whiten, const int* __restrict__ crc_inits,
    const uint8_t* __restrict__ adv, int* __restrict__ out_bytes,
    int* __restrict__ out_plen, uint8_t* __restrict__ out_match,
    uint8_t* __restrict__ out_lenok, int n_ch, long long kb, int n_slots,
    int sps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_ch * n_slots) return;
  const int m = t / n_slots;
  long long p = pos[t];
  if (!kClampTail) p = p < 0 ? 0 : (p > kb - 1 ? kb - 1 : p);
  const int8_t* row = bits + (long long)m * kb;
  const int8_t* wrow = whiten + (long long)m * kPduBits;
  const bool is_adv = adv[m] != 0;
  const long long start = p + (long long)kAaBits * sps;

  unsigned crc = (unsigned)crc_inits[m] & 0xFFFFFFu;
  int plen = 0, plen_c = 0;
  unsigned crc_state = 0, crc_rcv = 0;
  int* my_bytes = out_bytes + (long long)t * kPduBytes;
  for (int b = 0; b < kPduBytes; ++b) {
    int v = 0;
    for (int k = 0; k < 8; ++k) {
      long long idx = start + (long long)(8 * b + k) * sps;
      int raw;
      if (kClampTail) {
        idx = idx < 0 ? 0 : (idx > kb - 1 ? kb - 1 : idx);
        raw = (int)row[idx];
      } else {
        raw = idx < kb ? (int)row[idx] : 0;
      }
      v |= ((raw ^ (int)wrow[8 * b + k]) & 1) << k;
    }
    my_bytes[b] = v;
    if (b == 1) {
      plen = is_adv ? (v & 63) : (v & 31);
      plen_c = plen > 37 ? 37 : plen;
    }
    crc ^= (unsigned)v;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      crc = (crc & 1u) ? ((crc >> 1) ^ kPolyReflected) : (crc >> 1);
    if (b >= 1 && b == plen_c + 1) crc_state = crc;
    if (b >= 2) {
      if (b == plen_c + 2) crc_rcv |= (unsigned)v;
      if (b == plen_c + 3) crc_rcv |= (unsigned)v << 8;
      if (b == plen_c + 4) crc_rcv |= (unsigned)v << 16;
    }
  }
  out_plen[t] = plen;
  out_match[t] = crc_state == crc_rcv ? 1 : 0;
  out_lenok[t] = is_adv ? (plen >= 6 && plen <= 37) : (plen <= 31);
}

}  // namespace

extern "C" int btle_decode_candidates(
    const void* bits, const void* pos, const void* whiten,
    const void* crc_inits, const void* adv, void* out_bytes, void* out_plen,
    void* out_match, void* out_lenok, int n_ch, long long kb, int n_slots,
    int sps, int clamp_tail, void* stream) {
  const int n = n_ch * n_slots;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  auto kernel = clamp_tail ? decode_candidates_kernel<true>
                           : decode_candidates_kernel<false>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)bits, (const int*)pos, (const int8_t*)whiten,
      (const int*)crc_inits, (const uint8_t*)adv, (int*)out_bytes,
      (int*)out_plen, (uint8_t*)out_match, (uint8_t*)out_lenok, n_ch, kb,
      n_slots, sps);
  return (int)cudaGetLastError();
}
