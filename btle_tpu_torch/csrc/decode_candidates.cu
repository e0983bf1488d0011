// Candidate decode: window gather, dewhitening, byte packing, CRC24 verdict.
//
// Replaces the TPU kernel btle_tpu/rx/pallas_decode.py:_kernel (launched by
// decode_candidates_pallas). For every (channel, slot) candidate at lattice
// position pos it takes the 336 bits at pos + 32*sps + k*sps, XORs the
// channel's whitening row, packs 42 LSB-first bytes, reads the payload
// length (6 bits on advertising channels, 5 on data channels) and compares
// the CRC24 state after header + payload with the three bytes that follow.
// Past the lattice end the window reads, by clamp_tail:
//   0  zero, with pos clamped to [0, Kb-1] — the Pallas kernel's semantics
//      (the fused wideband scan);
//   1  the lattice's last bit, every index clamped to [0, Kb-1] — the XLA
//      decode's gathers (rx/pipeline.py:_decode_candidate), which every
//      dense block decode (narrowband stream_decode, wideband rescan) runs.
//
// Bound on the H100: bytes, far below a launch. At bench geometry the
// kernel reads ~0.2 MB of window bits and writes ~0.1 MB (40 x 16 x 42
// int32): well under a microsecond at 3.35 TB/s. What a one-thread-per-
// candidate schedule pays instead is a serial chain of 336 strided byte
// loads per thread on a handful of SMs (640 candidates are 5 CTAs).
//
// Design: one warp per candidate, four candidates per CTA (640 candidates
// are 160 CTAs, 16 on the narrowband path's 1 x 16).
// - Window bits by ballot: in step w (11 steps) lane l reads window bit
//   32w + l. The 32 addresses are sps bytes apart, one contiguous span
//   per warp load, and all 11 loads are issued before the first ballot.
//   Each bit is XORed with the whitening bit (a coalesced 32-byte row
//   read) and __ballot_sync packs the step into one 32-bit word, bit l =
//   window bit 32w + l: word w holds bytes 4w .. 4w + 3, LSB-first.
// - Lane w < 11 keeps word w; byte b is a shuffle from lane b / 4 and a
//   shift. Lane l stores bytes l and l + 32: the 42 int32 of a candidate
//   are two coalesced stores.
// - The CRC is the reflected table update of btle_rx.c:1211-1222, one
//   lookup per byte in a 256-entry table the CTA builds in its prologue
//   (8 LFSR steps per entry, two entries per thread). Every lane walks the
//   same header + payload bytes (the lookups broadcast); the state after
//   byte plen_c + 1 is compared with bytes plen_c + 2 .. plen_c + 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAaBits = 32;
constexpr int kPduBytes = 42;            // header + max payload + CRC
constexpr int kPduBits = kPduBytes * 8;  // 336
constexpr int kWords = (kPduBits + 31) / 32;   // 11 ballot words
constexpr int kWarps = 4;                // candidates per CTA
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kPolyReflected = 0xDA6000u;

// kClampTail is a template parameter so the zero-padding instantiation
// carries no per-bit branch on the mode.
template <bool kClampTail>
__global__ void __launch_bounds__(32 * kWarps) decode_candidates_kernel(
    const int8_t* __restrict__ bits, const int* __restrict__ pos,
    const int8_t* __restrict__ whiten, const int* __restrict__ crc_inits,
    const uint8_t* __restrict__ adv, int* __restrict__ out_bytes,
    int* __restrict__ out_plen, uint8_t* __restrict__ out_match,
    uint8_t* __restrict__ out_lenok, int n_ch, long long kb, int n_slots,
    int sps) {
  __shared__ unsigned table[256];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int b = tid; b < 256; b += 32 * kWarps) {
    unsigned c = (unsigned)b;
#pragma unroll
    for (int k = 0; k < 8; ++k) c = (c & 1u) ? ((c >> 1) ^ kPolyReflected) : (c >> 1);
    table[b] = c;
  }
  __syncthreads();

  const int t = blockIdx.x * kWarps + (tid >> 5);
  if (t >= n_ch * n_slots) return;       // whole warps leave together
  const int m = t / n_slots;
  long long p = pos[t];
  if (!kClampTail) p = p < 0 ? 0 : (p > kb - 1 ? kb - 1 : p);
  const int8_t* row = bits + (long long)m * kb;
  const int8_t* wrow = whiten + (long long)m * kPduBits;
  const long long start = p + (long long)kAaBits * sps;

  int raw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int i = 32 * w + lane;
    raw[w] = 0;
    if (i < kPduBits) {
      long long idx = start + (long long)i * sps;
      if (kClampTail) {
        idx = idx < 0 ? 0 : (idx > kb - 1 ? kb - 1 : idx);
        raw[w] = (int)row[idx] ^ (int)wrow[i];
      } else {
        raw[w] = (idx < kb ? (int)row[idx] : 0) ^ (int)wrow[i];
      }
    }
  }
  unsigned mine = 0;                     // lane w < 11: word w
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const unsigned word = __ballot_sync(kFull, raw[w] & 1);
    if (lane == w) mine = word;
  }
  auto byte_at = [&](int b) -> unsigned {
    return (__shfl_sync(kFull, mine, b >> 2) >> ((b & 3) * 8)) & 0xFFu;
  };

  const unsigned lo = byte_at(lane);
  const unsigned hi = byte_at(lane + 32 < kPduBytes ? lane + 32 : 0);
  int* my_bytes = out_bytes + (long long)t * kPduBytes;
  my_bytes[lane] = (int)lo;
  if (lane + 32 < kPduBytes) my_bytes[lane + 32] = (int)hi;

  const bool is_adv = adv[m] != 0;
  const int hdr = (int)byte_at(1);
  const int plen = is_adv ? (hdr & 63) : (hdr & 31);
  const int plen_c = plen > 37 ? 37 : plen;
  unsigned crc = (unsigned)crc_inits[m] & 0xFFFFFFu;
  for (int b = 0; b <= plen_c + 1; ++b)
    crc = table[(crc ^ byte_at(b)) & 0xFFu] ^ (crc >> 8);
  const unsigned rcv = byte_at(plen_c + 2) | (byte_at(plen_c + 3) << 8) |
                       (byte_at(plen_c + 4) << 16);
  if (lane == 0) {
    out_plen[t] = plen;
    out_match[t] = crc == rcv ? 1 : 0;
    out_lenok[t] = is_adv ? (plen >= 6 && plen <= 37) : (plen <= 31);
  }
}

// An empty kernel: the launch floor the candidate decode is measured
// against (a profiler's device time of one launch that does nothing).
__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int btle_decode_candidates(
    const void* bits, const void* pos, const void* whiten,
    const void* crc_inits, const void* adv, void* out_bytes, void* out_plen,
    void* out_match, void* out_lenok, int n_ch, long long kb, int n_slots,
    int sps, int clamp_tail, void* stream) {
  const int n = n_ch * n_slots;
  const int blocks = (n + kWarps - 1) / kWarps;
  auto kernel = clamp_tail ? decode_candidates_kernel<true>
                           : decode_candidates_kernel<false>;
  kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const int8_t*)bits, (const int*)pos, (const int8_t*)whiten,
      (const int*)crc_inits, (const uint8_t*)adv, (int*)out_bytes,
      (int*)out_plen, (uint8_t*)out_match, (uint8_t*)out_lenok, n_ch, kb,
      n_slots, sps);
  return (int)cudaGetLastError();
}

extern "C" int btle_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The launch shape for n_ch x n_slots candidates: info[0] shared memory
// (bytes, the CRC table), [1] resident CTAs per SM, [2] CTAs in the grid,
// [3] threads per CTA, [4] candidates per CTA.
extern "C" int btle_decode_candidates_plan(int n_ch, int n_slots, int* info) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decode_candidates_kernel<false>, 32 * kWarps, 0);
  if (err != cudaSuccess) return (int)err;
  info[0] = (int)(256 * sizeof(unsigned));
  info[1] = per_sm;
  info[2] = (n_ch * n_slots + kWarps - 1) / kWarps;
  info[3] = 32 * kWarps;
  info[4] = kWarps;
  return 0;
}
