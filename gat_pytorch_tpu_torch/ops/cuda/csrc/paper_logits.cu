// The GAT paper form's edge logits for Hopper (sm_90a): a forward by
// destination, and the elementwise part of the backward.
//
// Replaces no TPU kernel: the JAX package forms these logits in XLA (a
// gather of the two per-head score tables, LeakyReLU, a segment max and a
// second gather). On the card the same chain in torch took two
// index_selects, an add, leaky_relu, a scatter_reduce for the max, a
// third index_select and four elementwise kernels a layer, each over the
// (E, NH) logits.
//
// Contract (per edge e = (j -> i) of the dst-sorted edge list, head k;
// s_src, s_dst (n, NH) the per-head scores a_l . h_j and a_r . h_i;
// mask[e] the real edges):
//   z[e,k]      = s_src[j,k] + s_dst[i,k]
//   l[e,k]      = mask[e] ? (z > 0 ? z : z * slope) : -1e30
//   mx[i,k]     = max over i's edges of l; a max that is not finite
//                 (no edge, or a NaN or an infinity) reads 0
//   logits[e,k] = mask[e] ? l[e,k] - mx[i,k] : -1e30
// Edges outside every destination's run (before row_ptr[0], from
// row_ptr[n] on) get -1e30. Backward, given g = d(logits):
//   d_z[e,k]    = mask[e] ? (z > 0 ? g : g * slope) : 0
// the max taking no gradient (the softmax after it is invariant to it);
// the sums of d_z by sender and by destination into d(s_src) and d(s_dst)
// are the sorted segment sum's (segment_sum.cu), in the wrapper.
//
// Bits. Every step is one float32 operation rounded to nearest, in the
// order torch's chain takes them: the add, the multiply by the slope (a
// float32), the subtract; __fadd_rn, __fmul_rn and __fsub_rn keep nvcc from
// contracting the multiply and the subtract into one fma. The max is exact
// in any order (a NaN is kept, as torch's scatter_reduce amax keeps it), so
// the logits and d_z carry the bits of the torch chain, and d(s_src) and
// d(s_dst), summed by the same sorted segment sums, keep theirs.
//
// Design. The forward gives each destination one warp; its lanes hold
// (edge, head) pairs: lane l takes head l % P and edge slot l / P, P the
// heads rounded up to a power of two (32 / P edges a pass: 4 edges of 8
// heads). Sweep 1 reads each edge's sender, mask and s_src row (the (n,
// NH) tables stay in L2) and keeps a running max per lane, reduced over
// the slots by shuffles; sweep 2 reads them again (from L2) and writes
// the logits, each pass one contiguous run of 32 / P x NH floats. The
// edges outside the runs are written by a grid-stride tail of the same
// launch. The backward is a grid-stride map, one edge a thread, its NH
// cotangents loaded and d_z stored as float4 where NH is 4 or 8.
// No sum is formed here, so no atomics and the same bits on every launch.
//
// What bounds it on the H100: bytes. At ogbn-arxiv size (169,343 nodes,
// 2.5M edges, NH = 8) the forward writes 80 MB of logits and reads 10 MB
// of senders, about 0.03 ms at 3.35 TB/s; the backward reads 80 MB of g
// and 20 MB of indices and writes 80 MB, about 0.06 ms.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // warps a block
constexpr int kMaxHeads = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;   // a padding edge's logit (NEG_INF)
constexpr int kBwdBlocks = 132 * 8; // one wave of 256-thread blocks

// the larger of a and b, a NaN kept wherever one appears
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float leaky(float z, float slope) {
  return z > 0.f ? z : __fmul_rn(z, slope);
}

template <int P>
__global__ void __launch_bounds__(kWarps * 32)
paper_logits_fwd_kernel(const float* __restrict__ s_src,
                        const float* __restrict__ s_dst,
                        const int* __restrict__ senders,
                        const uint8_t* __restrict__ mask,
                        const int* __restrict__ row_ptr, int n, int e,
                        int nh, float slope, float* __restrict__ logits) {
  constexpr int kSlots = 32 / P;    // edges a pass
  const int lane = threadIdx.x & 31;
  const int k = lane % P, slot = lane / P;
  const bool head = k < nh;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i < n) {
    const int lo = row_ptr[i], hi = row_ptr[i + 1];
    const float sd = head ? s_dst[(size_t)i * nh + k] : 0.f;
    // l[e,k] of an edge of the run
    auto logit = [&](int ed) {
      return mask[ed] ? leaky(__fadd_rn(s_src[(size_t)senders[ed] * nh + k],
                                        sd),
                              slope)
                      : kNegInf;
    };
    float mx = -INFINITY;
    for (int b = lo; b < hi; b += kSlots) {
      const int ed = b + slot;
      if (head && ed < hi) mx = max_nan(mx, logit(ed));
    }
#pragma unroll
    for (int o = P; o < 32; o <<= 1)
      mx = max_nan(mx, __shfl_xor_sync(kFull, mx, o));
    if (!isfinite(mx)) mx = 0.f;
    for (int b = lo; b < hi; b += kSlots) {
      const int ed = b + slot;
      if (head && ed < hi)
        logits[(size_t)ed * nh + k] =
            mask[ed] ? __fsub_rn(logit(ed), mx) : kNegInf;
    }
  }
  // the edges of no destination's run: [0, row_ptr[0]) and [row_ptr[n], e)
  const int p0 = row_ptr[0], pn = row_ptr[n];
  const size_t outside = (size_t)(p0 + (e - pn)) * nh;
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < outside;
       t += (size_t)gridDim.x * blockDim.x) {
    const size_t pos = t / nh;
    const size_t ed = pos < (size_t)p0 ? pos : pn + (pos - p0);
    logits[ed * nh + t % nh] = kNegInf;
  }
}

template <int NH, int V>
__global__ void __launch_bounds__(256)
paper_logits_bwd_kernel(const float* __restrict__ g,
                        const float* __restrict__ s_src,
                        const float* __restrict__ s_dst,
                        const int* __restrict__ senders,
                        const int* __restrict__ receivers,
                        const uint8_t* __restrict__ mask, int e, float slope,
                        float* __restrict__ d_z) {
  static_assert(NH % V == 0, "a vector lies inside one edge's heads");
  for (int ed = blockIdx.x * blockDim.x + threadIdx.x; ed < e;
       ed += gridDim.x * blockDim.x) {
    const size_t row = (size_t)ed * NH;
    float gv[NH], out[NH];
#pragma unroll
    for (int k = 0; k < NH; k += V) {
      if constexpr (V == 4) {
        const float4 q = *reinterpret_cast<const float4*>(g + row + k);
        gv[k] = q.x, gv[k + 1] = q.y, gv[k + 2] = q.z, gv[k + 3] = q.w;
      } else {
        gv[k] = g[row + k];
      }
    }
    if (mask[ed]) {
      const size_t js = (size_t)senders[ed] * NH;
      const size_t is = (size_t)receivers[ed] * NH;
#pragma unroll
      for (int k = 0; k < NH; ++k) {
        const float z = __fadd_rn(s_src[js + k], s_dst[is + k]);
        out[k] = z > 0.f ? gv[k] : __fmul_rn(gv[k], slope);
      }
    } else {
#pragma unroll
      for (int k = 0; k < NH; ++k) out[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < NH; k += V) {
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(d_z + row + k) =
            make_float4(out[k], out[k + 1], out[k + 2], out[k + 3]);
      } else {
        d_z[row + k] = out[k];
      }
    }
  }
}

template <int NH>
int launch_bwd(bool vec4, const float* g, const float* s_src,
               const float* s_dst, const int* senders, const int* receivers,
               const uint8_t* mask, int e, float slope, float* d_z,
               cudaStream_t st) {
  int blocks = (e + 255) / 256;
  blocks = blocks < 1 ? 1 : (blocks > kBwdBlocks ? kBwdBlocks : blocks);
  if constexpr (NH % 4 == 0) {
    if (vec4) {
      paper_logits_bwd_kernel<NH, 4><<<blocks, 256, 0, st>>>(
          g, s_src, s_dst, senders, receivers, mask, e, slope, d_z);
      return (int)cudaGetLastError();
    }
  }
  paper_logits_bwd_kernel<NH, 1><<<blocks, 256, 0, st>>>(
      g, s_src, s_dst, senders, receivers, mask, e, slope, d_z);
  return (int)cudaGetLastError();
}

using BwdLaunch = int (*)(bool, const float*, const float*, const float*,
                         const int*, const int*, const uint8_t*, int, float,
                         float*, cudaStream_t);

}  // namespace

extern "C" {

// Forward: logits (e, nh). s_src, s_dst (n, nh); senders (e,) and mask (e,)
// (one byte an edge, nonzero on the real edges) of the dst-sorted edges;
// row_ptr (n + 1,) each destination's run.
int paper_logits_forward(const float* s_src, const float* s_dst,
                         const int* senders, const uint8_t* mask,
                         const int* row_ptr, int n, int e, int nh,
                         float slope, float* logits, void* stream) {
  if (n < 1 || e < 0 || nh < 1 || nh > kMaxHeads)
    return (int)cudaErrorInvalidValue;
  // the kernel for P lanes a head group: the heads rounded up to a power
  // of two
  auto kern = nh <= 1   ? paper_logits_fwd_kernel<1>
              : nh <= 2 ? paper_logits_fwd_kernel<2>
              : nh <= 4 ? paper_logits_fwd_kernel<4>
                        : paper_logits_fwd_kernel<8>;
  kern<<<(n + kWarps - 1) / kWarps, kWarps * 32, 0, (cudaStream_t)stream>>>(
      s_src, s_dst, senders, mask, row_ptr, n, e, nh, slope, logits);
  return (int)cudaGetLastError();
}

// Backward's elementwise part: d_z (e, nh) from g (e, nh), the forward's
// tables and edges, and receivers (e,). vec4: g and d_z are 16-byte
// aligned (taken where nh is 4 or 8).
int paper_logits_backward(const float* g, const float* s_src,
                          const float* s_dst, const int* senders,
                          const int* receivers, const uint8_t* mask, int e,
                          int nh, float slope, int vec4, float* d_z,
                          void* stream) {
  if (e < 0 || nh < 1 || nh > kMaxHeads) return (int)cudaErrorInvalidValue;
  static constexpr BwdLaunch kLaunch[kMaxHeads] = {
      launch_bwd<1>, launch_bwd<2>, launch_bwd<3>, launch_bwd<4>,
      launch_bwd<5>, launch_bwd<6>, launch_bwd<7>, launch_bwd<8>};
  return kLaunch[nh - 1](vec4 != 0, g, s_src, s_dst, senders, receivers,
                         mask, e, slope, d_z, (cudaStream_t)stream);
}

}  // extern "C"
