// v2 segment attention op for Hopper (sm_90a): forward and backward over a
// pre-gathered edge table, in the normalised and the partial (unnormalised)
// form.
//
// Replaces the TPU kernels
//   gat_pytorch_tpu/ops/pallas/segment_attention.py:_kernel
//     (launched by _forward for fused_segment_attention and, with
//     normalize=False, fused_segment_attention_partial)
//   gat_pytorch_tpu/ops/pallas/segment_attention_bwd.py:_kernel
//     (launched by backward_packed)
//
// Contract (per edge e with destination dst = receivers[e], head k,
// feature j; the logits come from the caller, masked to -1e30 on padding
// edges, whose exp is 0; edges e >= e_real are padding and not read):
//   ex[e,k]       = exp(logits[e,k])
//   den[dst,k]    = sum_e ex[e,k]                   (no dropout mask in den)
//   num[dst,kf+j] = sum_e ex[e,k] * drop[e,k] * h_src[e,kf+j]
// The partial form returns (num, den); the normalised form returns
//   out = num * inv, inv = den > 0 ? 1 / (den + eps) : 0.
// Every destination row in [0, n) is written, zeros where it has no edge:
// under edge sharding each shard's (num, den) are summed over the shards.
// Backward, a map over the edges with no reduction across them: each edge
// reads its destination's payload P = [g | inv | dden] and writes
//   d_h_src[e,kf+j] = ex[e,k] * drop[e,k] * inv[dst,k] * g[dst,kf+j]
//   d_logits[e,k]   = ex[e,k] * (hg[e,k] * inv[dst,k] * drop[e,k] + dden)
//   d_drop[e,k]     = hg[e,k] * ex[e,k] * inv[dst,k]
// with hg[e,k] = sum_j h_src[e,kf+j] * g[dst,kf+j]. Normalised:
// g = d(out), inv as above, dden = -inv * sum_j out * g over head k.
// Partial (segment_attention_bwd.backward_packed(normalize=False)):
// g = d(num), inv = 1, dden = d(den). Padding edges and edges whose
// receiver is no row of this call get zero cotangents.
//
// Design. The TPU kernel packs h_src, the logits, the mask and the
// receivers into one edge-major array (one DMA a block), reduces by
// destination with a one-hot MXU contraction over aligned-down edge
// blocks, and spreads a head's weight over its features with an expander
// matmul: all of it because Mosaic has no in-kernel random gather. Here
// the receivers are sorted, so the wrapper takes per-destination CSR
// offsets and one warp owns one destination: it walks that destination's
// edges in order, lane l holding features l, l+32, ... of the edge's
// contiguous h_src row, and adds m*ex*h and ex in float32 in a fixed
// order. No atomics, no shared memory, and two launches give the same
// bits. The backward keeps the same warp-per-destination walk so that the
// destination's payload row is read once into registers and reused for
// each of its edges; each edge's outputs are written by exactly one warp.
//
// What bounds it on the H100: bytes. The forward reads the (E, nh*f)
// h_src table once, the backward reads it and writes d(h_src) of the
// same size: at PPI's 1024-wide rows and 65,280 edges that is 267 MB a
// call, about 0.08 ms at 3.35 TB/s (the first kernel of the port whose
// byte bound is not negligible). The rows are read from device memory,
// not from L2 as the gathered tables of the other kernels are, so the
// forward starts the loads of an edge's whole row (C a lane) before it
// uses any of them: with each load consumed right after it started, the
// forward ran at a third of the backward's rate. A warp walks its
// destination's edges one after another, so narrow rows are bound by
// latency.
//
// The bfloat16 mode (flags, attention_common.cuh): the JAX package's
// GAT_TPU_KERNEL_DTYPE=bfloat16 rounds each edge's [m*ex*h | ex] to
// bfloat16 before the float32 sums of the forward (kRoundAcc). The
// backward has no such mode.

#include "attention_common.cuh"

namespace {

// x rounded to bfloat16 in the kRoundAcc mode (a template parameter, so
// that the float32 mode carries no rounding instruction in its loop)
template <bool ACC>
__device__ __forceinline__ float acc_term(float x) {
  return ACC ? round_bf16(x) : x;
}

template <int C, bool NORM, bool ACC>
__global__ void __launch_bounds__(kWarps * 32)
v2_fwd_kernel(const float* __restrict__ logits,
              const float* __restrict__ h_src,
              const float* __restrict__ drop,
              const int* __restrict__ row_ptr, int n, int e_real,
              int d_feat, int nh, int f, float eps,
              float* __restrict__ out, float* __restrict__ den) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int head[C];
  bool live[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = lane + 32 * c;
    live[c] = j < d_feat;
    head[c] = live[c] ? j / f : 0;
  }

  for (int d = blockIdx.x * kWarps + warp; d < n; d += gridDim.x * kWarps) {
    float dsum[kMaxHeads], acc[C];
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k) dsum[k] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;

    const int lo = row_ptr[d], hi = min(row_ptr[d + 1], e_real);
    for (int e = lo; e < hi; ++e) {
      // every load of the row starts before any is used: the row is read
      // from device memory once, so their latencies must overlap
      const float* hrow = h_src + (size_t)e * d_feat;
      float hv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) hv[c] = live[c] ? hrow[lane + 32 * c] : 0.f;
      float w[kMaxHeads];
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k) {
        w[k] = 0.f;
        if (k < nh) {
          const float ex = expf(logits[(size_t)e * nh + k]);
          dsum[k] += acc_term<ACC>(ex);
          w[k] = drop ? ex * drop[(size_t)e * nh + k] : ex;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (live[c]) acc[c] += acc_term<ACC>(select_head(w, head[c]) * hv[c]);
    }

    float inv[kMaxHeads];
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k)
      inv[k] = !NORM ? 1.f : (dsum[k] > 0.f ? 1.f / (dsum[k] + eps) : 0.f);
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (live[c])
        out[(size_t)d * d_feat + lane + 32 * c] =
            NORM ? acc[c] * select_head(inv, head[c]) : acc[c];
    if (lane < nh) den[(size_t)d * nh + lane] = select_head(dsum, lane);
  }
}

// pay: (n, nh) the forward's den (NORM) or d(den) (partial); out: the
// forward's output (NORM only, NULL otherwise); h_src and d_h_src hold
// e_h rows, e_real <= e_h <= e_total
template <int C, bool NORM>
__global__ void __launch_bounds__(kWarps * 32)
v2_bwd_kernel(const float* __restrict__ logits,
              const float* __restrict__ h_src,
              const float* __restrict__ drop,
              const int* __restrict__ row_ptr, int n, int e_real,
              int e_h, int e_total, int d_feat, int nh, int f, float eps,
              const float* __restrict__ g, const float* __restrict__ out,
              const float* __restrict__ pay, float* __restrict__ d_h_src,
              float* __restrict__ d_logits, float* __restrict__ d_drop) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int head[C];
  bool live[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = lane + 32 * c;
    live[c] = j < d_feat;
    head[c] = live[c] ? j / f : 0;
  }

  for (int d = blockIdx.x * kWarps + warp; d < n; d += gridDim.x * kWarps) {
    const int lo = row_ptr[d], hi = min(row_ptr[d + 1], e_real);
    if (lo >= hi) continue;  // warp-uniform: no edge, nothing to write
    float gv[C];
    float inv[kMaxHeads], dden[kMaxHeads];
#pragma unroll
    for (int c = 0; c < C; ++c)
      gv[c] = live[c] ? g[(size_t)d * d_feat + lane + 32 * c] : 0.f;
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k) {
      inv[k] = dden[k] = 0.f;
      if (k < nh) {  // nh is warp-uniform: every lane joins the shuffles
        const float pk = pay[(size_t)d * nh + k];
        if (NORM) {
          inv[k] = pk > 0.f ? 1.f / (pk + eps) : 0.f;
          float p = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (live[c] && head[c] == k)
              p += out[(size_t)d * d_feat + lane + 32 * c] * gv[c];
          dden[k] = -warp_sum(p) * inv[k];
        } else {
          inv[k] = 1.f;
          dden[k] = pk;
        }
      }
    }

    for (int e = lo; e < hi; ++e) {
      const float* hrow = h_src + (size_t)e * d_feat;
      float* dhrow = d_h_src + (size_t)e * d_feat;
      float hv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) hv[c] = live[c] ? hrow[lane + 32 * c] : 0.f;
      float coef[kMaxHeads];
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k) {
        coef[k] = 0.f;
        if (k < nh) {
          float q = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (live[c] && head[c] == k) q += hv[c] * gv[c];
          const float hg = warp_sum(q);
          const float ex = expf(logits[(size_t)e * nh + k]);
          const float m = drop ? drop[(size_t)e * nh + k] : 1.f;
          coef[k] = ex * m * inv[k];
          if (lane == k) {
            d_logits[(size_t)e * nh + k] = ex * (hg * inv[k] * m + dden[k]);
            if (d_drop) d_drop[(size_t)e * nh + k] = hg * ex * inv[k];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (live[c]) dhrow[lane + 32 * c] = select_head(coef, head[c]) * gv[c];
    }
  }

  // padding edges (e >= e_real) and edges whose receiver is no row of this
  // call (>= n, past row_ptr[n]) get zero cotangents, from all warps
  const int warps = gridDim.x * kWarps;
  for (int e = min(e_real, row_ptr[n]) + blockIdx.x * kWarps + warp;
       e < e_total; e += warps) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (live[c] && e < e_h)
        d_h_src[(size_t)e * d_feat + lane + 32 * c] = 0.f;
    if (lane < nh) {
      d_logits[(size_t)e * nh + lane] = 0.f;
      if (d_drop) d_drop[(size_t)e * nh + lane] = 0.f;
    }
  }
}

}  // namespace

extern "C" {

// Forward: (out (n, d_feat) normalised where normalize, else num; den
// (n, nh)). logits (E, nh), h_src (e_h >= e_real rows, d_feat; rows from
// e_real on are not read), drop (E, nh) or NULL,
// row_ptr (n + 1,) the offsets of each destination's run in the dst-sorted
// edge list, e_real the number of leading real edges; flags the bfloat16
// mode's word (kRoundAcc or 0).
int v2_forward(const float* logits, const float* h_src, const float* drop,
               const int* row_ptr, int n, int e_real, int d_feat, int nh,
               int f, float eps, int normalize, float* out, float* den,
               int nblk, int flags, void* stream) {
  if (d_feat < 1 || d_feat > 1024 || nh < 1 || nh > kMaxHeads || nblk < 1 ||
      (flags & ~kRoundAcc))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int c_need = (d_feat + 31) / 32;
  const bool acc = flags & kRoundAcc;
#define V2_FWD_MODE(CC, NORM, ACC)                                    \
  v2_fwd_kernel<CC, NORM, ACC><<<nblk, kWarps * 32, 0, st>>>(         \
      logits, h_src, drop, row_ptr, n, e_real, d_feat, nh, f, eps, out, \
      den);
#define V2_FWD(CC)                                   \
  if (normalize && acc) { V2_FWD_MODE(CC, true, true) } \
  else if (normalize) { V2_FWD_MODE(CC, true, false) }  \
  else if (acc) { V2_FWD_MODE(CC, false, true) }        \
  else { V2_FWD_MODE(CC, false, false) }
  ROWS_DISPATCH(V2_FWD)
#undef V2_FWD
#undef V2_FWD_MODE
  return (int)cudaGetLastError();
}

// Backward: d_h_src (e_h, d_feat), d_logits (E, nh), d_drop (E, nh) or
// NULL. Normalised: g = d(out), out the forward's output, pay its den.
// Partial: g = d(num), out NULL, pay = d(den).
int v2_backward(const float* logits, const float* h_src, const float* drop,
                const int* row_ptr, int n, int e_real, int e_h, int e_total,
                int d_feat, int nh, int f, float eps, int normalize,
                const float* g, const float* out, const float* pay,
                float* d_h_src, float* d_logits, float* d_drop, int nblk,
                void* stream) {
  if (d_feat < 1 || d_feat > 1024 || nh < 1 || nh > kMaxHeads || nblk < 1 ||
      e_real > e_h || e_h > e_total || (normalize && out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int c_need = (d_feat + 31) / 32;
#define V2_BWD(CC)                                                       \
  if (normalize)                                                         \
    v2_bwd_kernel<CC, true><<<nblk, kWarps * 32, 0, st>>>(               \
        logits, h_src, drop, row_ptr, n, e_real, e_h, e_total, d_feat,   \
        nh, f, eps, g, out, pay, d_h_src, d_logits, d_drop);             \
  else                                                                   \
    v2_bwd_kernel<CC, false><<<nblk, kWarps * 32, 0, st>>>(              \
        logits, h_src, drop, row_ptr, n, e_real, e_h, e_total, d_feat,   \
        nh, f, eps, g, out, pay, d_h_src, d_logits, d_drop);
  ROWS_DISPATCH(V2_BWD)
#undef V2_BWD
  return (int)cudaGetLastError();
}

}  // extern "C"
