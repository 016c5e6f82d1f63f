// Shared by the attention kernels (v5_attention.cu, window_attention.cu,
// table_attention.cu):
// warp and block reduction helpers, the cross-block second passes, the
// bfloat16 rounding points, and the dispatch on the row width and on the
// h table's element type. Everything sits in an anonymous namespace, so
// each source gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;       // warps per block; one dst node per warp
constexpr int kMaxHeads = 8;    // the wrapper refuses more heads
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCapThreads = 256;  // threads of the cap reduction

// The flags word every attention C entry takes: where the JAX package's
// bfloat16 modes round (ops/cuda/rounding.py Rounding names the same
// points). kBf16Table: h is a bfloat16 table (cast once by the wrapper;
// the logits and every product read its rows). The others round float32
// values in registers: kRoundRows the gathered float32 row after its
// logits are taken, kRoundAcc each edge's [weighted h | ex] before the
// float32 sums of the forward, kRoundPayload a destination's g, inv and
// d(den) in the backward (after d(den) is taken from g), kRoundDh the
// d(h) rows, kRoundDraw d(raw) in d(a_src), kRoundDsdst d(raw) in
// d(s_dst). Every sum stays float32.
constexpr int kRoundRows = 1;
constexpr int kRoundAcc = 2;
constexpr int kRoundPayload = 4;
constexpr int kRoundDh = 8;
constexpr int kRoundDraw = 16;
constexpr int kRoundDsdst = 32;
constexpr int kBf16Table = 64;

// x rounded to the nearest bfloat16, ties to even (as XLA's convert and
// torch's .to(torch.bfloat16)), as a float; never truncated
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float round_if(float x, bool on) {
  return on ? round_bf16(x) : x;
}

// one element of an h table, float32 or bfloat16
__device__ __forceinline__ float load_h(const float* p) { return *p; }
__device__ __forceinline__ float load_h(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// f(h as the table's element type): the C entries take h as void*. A
// library holds the kernels of one element type (bfloat16 where it is
// built with -DGAT_BF16_TABLE, ops/cuda/build.py) and refuses the other.
template <typename F>
int with_table(const void* h, int flags, F&& f) {
#ifdef GAT_BF16_TABLE
  if (!(flags & kBf16Table)) return (int)cudaErrorInvalidValue;
  return f(static_cast<const __nv_bfloat16*>(h));
#else
  if (flags & kBf16Table) return (int)cudaErrorInvalidValue;
  return f(static_cast<const float*>(h));
#endif
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: float addition commutes, so every lane ends bitwise equal
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The source half of head k's raw logit, h[src] . a_src[:, k]: lane l
// holds features l, l+32, ... of the sender's row in hv, sa is a_src
// transposed, (nh, d_feat), in shared memory. Every kernel that needs a raw
// logit (forward, cap pass, backward) takes it from here, so they all get
// the same bits for the same edge: the 2-phase argmax edge then has
// raw - cap == 0 exactly, where LeakyReLU's slope-at-0 convention decides
// its gradient. WITH_Q: the backward's second dot in the same pass over
// the lane's features, q = h[src] . g[dst] over head k's features (head
// and gv are not read otherwise), of the row rounded to bfloat16 where
// round_q (kRoundRows: the logit reads the float32 row, q the rounded one).
template <int C, bool WITH_Q>
__device__ __forceinline__ float head_dot(const float (&hv)[C],
                                          const bool (&live)[C],
                                          const int (&head)[C],
                                          const float* sa, int k, int d_feat,
                                          int lane, const float (&gv)[C],
                                          float& q, bool round_q = false) {
  float p = 0.f, r = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (!live[c]) continue;
    p += hv[c] * sa[k * d_feat + lane + 32 * c];
    if (WITH_Q && head[c] == k) r += round_if(hv[c], round_q) * gv[c];
  }
  if (WITH_Q) q = warp_sum(r);
  return warp_sum(p);
}

// LeakyReLU as the 2-phase kernels apply it: the slope at x <= 0
__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

// The kernel modes. Forward: kSweep1 accumulates the unnormalised parts
// with exp(slope * raw') and tracks the cap as it goes; kCap only tracks the
// cap and its argmax code; kTwoPhase takes the cap from device memory and
// writes the normalised output with exp(leaky(raw - cap)).
// Backward: kNorm (the sweep-1 op's normalised epilogue, eps' read from
// device memory), kParts (raw cotangents of the parts), kTwoPhase (the
// 2-phase op: the full LeakyReLU, the plain eps, and a d(cap) output).
enum class Fwd { kSweep1, kCap, kTwoPhase };
enum class Bwd { kNorm, kParts, kTwoPhase };

__device__ __forceinline__ float select_head(const float (&v)[kMaxHeads],
                                             int k) {
  float out = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxHeads; ++i)
    if (i == k) out = v[i];
  return out;
}

// (m, c) <- the larger value; on a tie, the lower (edge, head) code
__device__ __forceinline__ void take_max(float& m, int& c, float v, int vc) {
  if (v > m || (v == m && vc < c)) {
    m = v;
    c = vc;
  }
}

// Global (max, lowest code) over the per-block partials: one block, a
// strided scan then a shared-memory tree. max and min-code are exact, so
// the result does not depend on the order of the comparisons.
__global__ void __launch_bounds__(kCapThreads)
cap_reduce_kernel(const float* __restrict__ blk_max,
                  const int* __restrict__ blk_code, int nblk,
                  float* __restrict__ cap, int* __restrict__ code) {
  __shared__ float sm[kCapThreads];
  __shared__ int sc[kCapThreads];
  const int t = threadIdx.x;
  float m = -INFINITY;
  int c = INT_MAX;
  for (int b = t; b < nblk; b += kCapThreads)
    take_max(m, c, blk_max[b], blk_code[b]);
  sm[t] = m;
  sc[t] = c;
  __syncthreads();
  for (int s = kCapThreads / 2; s > 0; s >>= 1) {
    if (t < s) take_max(sm[t], sc[t], sm[t + s], sc[t + s]);
    __syncthreads();
  }
  if (t == 0) {
    *cap = sm[0];
    *code = sc[0];
  }
}

// out[i] = sum over blocks b (in order) of part[b, i]
__global__ void sum_partials_kernel(const float* __restrict__ part, int nblk,
                                    int len, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += part[(size_t)b * len + i];
  out[i] = s;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// LAUNCH(C) with C = the features per lane that cover c_need = ceil(D / 32)
#define ROWS_DISPATCH(LAUNCH) \
  if (c_need <= 1) { LAUNCH(1); }   \
  else if (c_need <= 2) { LAUNCH(2); } \
  else if (c_need <= 4) { LAUNCH(4); } \
  else if (c_need <= 8) { LAUNCH(8); } \
  else if (c_need <= 16) { LAUNCH(16); } \
  else { LAUNCH(32); }
