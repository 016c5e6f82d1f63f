// Shared by the attention kernels (v5_attention.cu, window_attention.cu,
// table_attention.cu):
// warp and block reduction helpers, the cross-block second passes, and the
// dispatch on the row width. Everything sits in an anonymous namespace, so
// each source gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;       // warps per block; one dst node per warp
constexpr int kMaxHeads = 8;    // the wrapper refuses more heads
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCapThreads = 256;  // threads of the cap reduction

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: float addition commutes, so every lane ends bitwise equal
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

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
