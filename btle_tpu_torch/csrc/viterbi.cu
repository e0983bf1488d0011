// V1: the radix-2 soft-decision Viterbi of the LE Coded PHY (rate 1/2, K=4,
// 8 states), a batch of trellises in one launch.
//
// Replaces no Pallas kernel: the JAX function btle_tpu/phy/viterbi.py:138
// viterbi_decode_r2 is a lax.scan that XLA runs as a loop on the device,
// vmapped over candidates. PyTorch has no device loop, so the 182
// add-compare-select iterations and the 182 traceback steps of a 364-step
// trellis would be ~1000 host-driven launches; here they are one kernel.
//
// What it computes, per trellis b (inputs la, lb: (B, n) float32, n even):
//   pm = {0, -1e30 x 7}; for each iteration t (two trellis steps), for each
//   next state ns, over its four predecessors j (pred[ns][j], signs
//   A1 B1 A2 B2 of the four branch symbols):
//     c_j = pm[pred[ns][j]] + (((A1*la[2t] + B1*lb[2t]) + A2*la[2t+1])
//                              + B2*lb[2t+1])
//   and the FIRST maximal j wins (jnp.argmax's tie rule). The +-1 products
//   are exact; the adds run in the JAX package's order with __fadd_rn, so
//   no contraction or reassociation moves a rounding. Traceback from state
//   0: iteration t emits (x1, x2) = ((s >> 1) & 1, s & 1) and steps to the
//   winning predecessor. Outputs: bits (B, n) int8, pm_end = pm[0] (B,).
//
// Bound on the H100: neither bytes nor operations. A 364-step trellis
// moves 3280 bytes (2 x 364 float32 in, 364 int8 + one float32 out) and
// does ~9 k operations; at B = 160 that is 0.16 us of HBM traffic. The
// binding cost is the dependency chain: 182 add-compare-select steps,
// each waiting on the last step's metrics, then 182 traceback steps, each
// waiting on the last state.
//
// Design: one warp per trellis, four warps a CTA (B = 160 is 40 CTAs, one
// wave). The warp first stages its trellis's soft inputs in shared memory
// (coalesced, 23 loads a lane, all in flight at once), so the chain never
// waits on device memory. Lane l plays next state l & 7 (lanes 8..31
// repeat lanes 0..7, so every shuffle is full-warp): it keeps its metric
// in a register, reads its four predecessors' metrics with __shfl_sync,
// and keeps its four branch-sign rows in registers. Each iteration lanes
// 0..7 store the winning predecessor STATE (not j) as one byte, so the
// eight bytes of an iteration form one 64-bit word. Lane 0 then walks the
// traceback: the word of iteration t does not depend on the state, so its
// load issues ahead, and the chain per step is one shift and one mask.
// The bits go to shared memory and leave as coalesced byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 8;
constexpr int kPreds = 4;
constexpr int kMaxWarps = 4;                 // trellises per CTA
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kStaticSmemLimit = 48 * 1024;

// shared bytes of one warp: la and lb (2 n float32), one winner byte per
// (iteration, state) (4 n), the decoded bits (n); 16-byte aligned
__host__ __device__ inline size_t warp_smem_bytes(int n) {
  return ((size_t)13 * n + 15) & ~(size_t)15;
}

__global__ void __launch_bounds__(32 * kMaxWarps) viterbi_r2_kernel(
    const float* __restrict__ la, const float* __restrict__ lb,
    const int* __restrict__ pred, const float* __restrict__ signs,
    int8_t* __restrict__ bits, float* __restrict__ pm_end, int n_trellis,
    int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= n_trellis) return;                // the whole warp leaves
  const int n_iter = n >> 1;
  unsigned char* base = smem + (size_t)warp * warp_smem_bytes(n);
  float* s_la = reinterpret_cast<float*>(base);
  float* s_lb = s_la + n;
  uint8_t* s_win = reinterpret_cast<uint8_t*>(s_lb + n);   // 8n/2 bytes
  int8_t* s_bits = reinterpret_cast<int8_t*>(s_win + (size_t)kStates * n_iter);

  const float* g_la = la + (size_t)b * n;
  const float* g_lb = lb + (size_t)b * n;
  for (int k = lane; k < n; k += 32) {
    s_la[k] = g_la[k];
    s_lb[k] = g_lb[k];
  }

  const int ns = lane & (kStates - 1);
  int p[kPreds];
  float a1[kPreds], b1[kPreds], a2[kPreds], b2[kPreds];
#pragma unroll
  for (int j = 0; j < kPreds; ++j) {
    p[j] = pred[ns * kPreds + j];
    const float* s = signs + (ns * kPreds + j) * 4;
    a1[j] = s[0];
    b1[j] = s[1];
    a2[j] = s[2];
    b2[j] = s[3];
  }
  __syncwarp();

  float pm = ns == 0 ? 0.0f : -1e30f;
#pragma unroll 2
  for (int t = 0; t < n_iter; ++t) {
    const float la0 = s_la[2 * t], la1 = s_la[2 * t + 1];
    const float lb0 = s_lb[2 * t], lb1 = s_lb[2 * t + 1];
    float c[kPreds];
#pragma unroll
    for (int j = 0; j < kPreds; ++j) {
      const float bm = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(a1[j], la0), __fmul_rn(b1[j], lb0)),
                    __fmul_rn(a2[j], la1)),
          __fmul_rn(b2[j], lb1));
      c[j] = __fadd_rn(__shfl_sync(kFull, pm, p[j]), bm);
    }
    float best = c[0];
    int win = p[0];
#pragma unroll
    for (int j = 1; j < kPreds; ++j) {
      if (c[j] > best) {
        best = c[j];
        win = p[j];
      }
    }
    pm = best;
    if (lane < kStates) s_win[t * kStates + lane] = (uint8_t)win;
  }
  __syncwarp();

  if (lane == 0) {
    pm_end[b] = pm;
    const unsigned long long* words =
        reinterpret_cast<const unsigned long long*>(s_win);
    unsigned state = 0;
#pragma unroll 4
    for (int t = n_iter - 1; t >= 0; --t) {
      const unsigned long long w = words[t];
      s_bits[2 * t] = (int8_t)((state >> 1) & 1);
      s_bits[2 * t + 1] = (int8_t)(state & 1);
      state = (unsigned)(w >> (8 * state)) & 0xffu;
    }
  }
  __syncwarp();
  int8_t* g_bits = bits + (size_t)b * n;
  for (int k = lane; k < n; k += 32) g_bits[k] = s_bits[k];
}

// warps a CTA for trellises of n steps: four while their shared memory
// fits the static 48 KB, fewer above
int warps_for(int n) {
  int w = kMaxWarps;
  while (w > 1 && (size_t)w * warp_smem_bytes(n) > kStaticSmemLimit) --w;
  return w;
}

}  // namespace

extern "C" int btle_viterbi_r2(const void* la, const void* lb,
                               const void* pred, const void* signs,
                               void* bits, void* pm_end, int n_trellis,
                               int n, void* stream) {
  if (n <= 0 || (n & 1) || n_trellis <= 0) return (int)cudaErrorInvalidValue;
  const int warps = warps_for(n);
  const size_t smem = (size_t)warps * warp_smem_bytes(n);
  if (smem > kStaticSmemLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_r2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_trellis + warps - 1) / warps;
  viterbi_r2_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)la, (const float*)lb, (const int*)pred,
      (const float*)signs, (int8_t*)bits, (float*)pm_end, n_trellis, n);
  return (int)cudaGetLastError();
}

// The launch shape for n_trellis trellises of n steps: info[0] shared
// memory (bytes a CTA), [1] resident CTAs per SM, [2] CTAs in the grid,
// [3] threads per CTA, [4] trellises per CTA.
extern "C" int btle_viterbi_r2_plan(int n_trellis, int n, int* info) {
  const int warps = warps_for(n);
  const size_t smem = (size_t)warps * warp_smem_bytes(n);
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, viterbi_r2_kernel, 32 * warps, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = (int)smem;
  info[1] = per_sm;
  info[2] = (n_trellis + warps - 1) / warps;
  info[3] = 32 * warps;
  info[4] = warps;
  return 0;
}
