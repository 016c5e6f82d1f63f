// v4 table attention op for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels
//   gat_pytorch_tpu/ops/pallas/segment_attention.py:_kernel_split
//     (launched by _forward_split for fused_segment_attention_table)
//   gat_pytorch_tpu/ops/pallas/segment_attention_bwd.py:_kernel_split
//     (launched by backward_split)
//
// Contract (per edge e = (src, dst), head k, feature j; the logits come
// from the caller, masked to -1e30 on padding edges, whose exp is 0; the
// real edges come first and edges e >= e_real are padding, not read):
//   ex[e,k]       = exp(logits[e,k])           for e < e_real, else 0
//   den[dst,k]    = sum_e ex[e,k]              (no dropout mask in den)
//   inv[dst,k]    = den > 0 ? 1 / (den + eps) : 0
//   out[dst,kf+j] = inv[dst,k] * sum_e ex[e,k] * drop[e,k] * h[src,kf+j]
// Backward, with g = d(out), hg[e,k] = sum_j h[src,kf+j] * g[dst,kf+j] and
// dden[dst,k] = -inv[dst,k] * sum_j out[dst,kf+j] * g[dst,kf+j]:
//   d_h_rows[e,kf+j] = ex[e,k] * drop[e,k] * inv[dst,k] * g[dst,kf+j]
//   d_logits[e,k]    = ex[e,k] * (hg[e,k] * inv[dst,k] * drop[e,k] + dden)
//   d_drop[e,k]      = hg[e,k] * ex[e,k] * inv[dst,k]
// The d(h) rows come out in dst order; segment_sum.cu sums them by sender.
// A destination without a real edge has den = 0: its output row and every
// cotangent of its edges are 0, also at eps = 0. The padding edges all hang
// on one sink node (thousands in a batch padded to its bucket): no warp
// walks them; the backward's warps share the zeroing of their cotangents.
//
// Design. The TPU kernels turn the row gather and the per-destination sums
// into one-hot matmuls over edge blocks, with an expander matrix to spread
// a head's weight over its features, because Mosaic has no in-kernel random
// gather. Here one warp owns one destination and walks its in-edges
// (dst-sorted CSR offsets) in order; lane l holds features l, l+32, ... of
// the gathered sender row, and every lane reads the edge's nh logits (one
// broadcast load each), so the forward needs no shuffle at all and the
// backward one warp reduction per head and edge (hg). Each output row is
// written by exactly one warp in a fixed order: no atomics, and the results
// are bitwise reproducible. The normalisation runs in the kernel, as it
// does in the TPU kernel's body.
//
// What bounds it on the H100: by bytes, the gathered h rows in the forward
// (E x nh*f x 4) and the d(h) rows written in the backward (the same
// again); at 1024-wide rows and tens of thousands of edges that is a few
// hundred MB, of the order of 0.1 ms at 3.35 TB/s. As written a warp walks
// its edges one after another, so narrow rows are bound by latency.
//
// The bfloat16 modes (the flags word, attention_common.cuh): the JAX
// package's GAT_TPU_H_DTYPE, a bfloat16 h table (kBf16Table: both kernels
// are instantiated for both element types; half the gathered bytes), and
// GAT_TPU_KERNEL_DTYPE, each edge's [weighted h | ex] rounded before the
// forward's float32 sums (kRoundAcc).

#include "attention_common.cuh"

namespace {

template <int C, typename T>
__global__ void __launch_bounds__(kWarps * 32)
table_fwd_kernel(const float* __restrict__ logits, const T* __restrict__ h,
                 const float* __restrict__ drop,
                 const int* __restrict__ senders,
                 const int* __restrict__ row_ptr, int n, int e_real,
                 int d_feat, int nh, int f, float eps, int flags,
                 float* __restrict__ out, float* __restrict__ den) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool r_acc = flags & kRoundAcc;
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
      const T* hrow = h + (size_t)senders[e] * d_feat;
      float w[kMaxHeads];
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k) {
        w[k] = 0.f;
        if (k < nh) {
          const float ex = expf(logits[(size_t)e * nh + k]);
          dsum[k] += round_if(ex, r_acc);
          w[k] = drop ? ex * drop[(size_t)e * nh + k] : ex;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (live[c])
          acc[c] += round_if(
              select_head(w, head[c]) * load_h(hrow + lane + 32 * c), r_acc);
    }

    float inv[kMaxHeads];
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k)
      inv[k] = dsum[k] > 0.f ? 1.f / (dsum[k] + eps) : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (live[c])
        out[(size_t)d * d_feat + lane + 32 * c] =
            acc[c] * select_head(inv, head[c]);
    if (lane < nh) den[(size_t)d * nh + lane] = select_head(dsum, lane);
  }
}

template <int C, typename T>
__global__ void __launch_bounds__(kWarps * 32)
table_bwd_kernel(const float* __restrict__ logits, const T* __restrict__ h,
                 const float* __restrict__ drop,
                 const int* __restrict__ senders,
                 const int* __restrict__ row_ptr, int n, int e_real,
                 int e_total, int d_feat, int nh, int f, float eps,
                 const float* __restrict__ g, const float* __restrict__ out,
                 const float* __restrict__ den, float* __restrict__ d_h_rows,
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
    float gv[C];
    float inv[kMaxHeads], dden[kMaxHeads];
#pragma unroll
    for (int c = 0; c < C; ++c)
      gv[c] = live[c] ? g[(size_t)d * d_feat + lane + 32 * c] : 0.f;
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k) {
      inv[k] = dden[k] = 0.f;
      if (k < nh) {  // nh is warp-uniform: every lane joins the shuffles
        const float dn = den[(size_t)d * nh + k];
        inv[k] = dn > 0.f ? 1.f / (dn + eps) : 0.f;
        float p = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (live[c] && head[c] == k)
            p += out[(size_t)d * d_feat + lane + 32 * c] * gv[c];
        dden[k] = -warp_sum(p) * inv[k];
      }
    }

    const int lo = row_ptr[d], hi = min(row_ptr[d + 1], e_real);
    for (int e = lo; e < hi; ++e) {
      const T* hrow = h + (size_t)senders[e] * d_feat;
      float* dhrow = d_h_rows + (size_t)e * d_feat;
      float hv[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        hv[c] = live[c] ? load_h(hrow + lane + 32 * c) : 0.f;
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
      if (live[c]) d_h_rows[(size_t)e * d_feat + lane + 32 * c] = 0.f;
    if (lane < nh) {
      d_logits[(size_t)e * nh + lane] = 0.f;
      if (d_drop) d_drop[(size_t)e * nh + lane] = 0.f;
    }
  }
}

template <typename T>
int launch_table_forward(const float* logits, const T* h, const float* drop,
                         const int* senders, const int* row_ptr, int n,
                         int e_real, int d_feat, int nh, int f, float eps,
                         float* out, float* den, int nblk, int flags,
                         cudaStream_t st) {
  const int c_need = (d_feat + 31) / 32;
#define TABLE_FWD(CC)                                                        \
  table_fwd_kernel<CC, T><<<nblk, kWarps * 32, 0, st>>>(                     \
      logits, h, drop, senders, row_ptr, n, e_real, d_feat, nh, f, eps,      \
      flags, out, den);
  ROWS_DISPATCH(TABLE_FWD)
#undef TABLE_FWD
  return (int)cudaGetLastError();
}

template <typename T>
int launch_table_backward(const float* logits, const T* h, const float* drop,
                          const int* senders, const int* row_ptr, int n,
                          int e_real, int e_total, int d_feat, int nh, int f,
                          float eps, const float* g, const float* out,
                          const float* den, float* d_h_rows, float* d_logits,
                          float* d_drop, int nblk, cudaStream_t st) {
  const int c_need = (d_feat + 31) / 32;
#define TABLE_BWD(CC)                                                     \
  table_bwd_kernel<CC, T><<<nblk, kWarps * 32, 0, st>>>(                  \
      logits, h, drop, senders, row_ptr, n, e_real, e_total, d_feat, nh, f, \
      eps, g, out, den, d_h_rows, d_logits, d_drop);
  ROWS_DISPATCH(TABLE_BWD)
#undef TABLE_BWD
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both entries: h is float32, or bfloat16 where flags has kBf16Table;
// flags is the bfloat16 mode's word (attention_common.cuh), 0 for float32.

// Forward: out (n, d_feat) normalised, den (n, nh). logits (E, nh), h
// (n_src, d_feat), drop (E, nh) or NULL, row_ptr (n + 1,) the offsets of
// each destination's run in the dst-sorted edge list, e_real the number of
// leading real edges.
int table_forward(const float* logits, const void* h, const float* drop,
                  const int* senders, const int* row_ptr, int n, int e_real,
                  int d_feat, int nh, int f, float eps, float* out,
                  float* den, int nblk, int flags, void* stream) {
  if (d_feat < 1 || d_feat > 1024 || nh < 1 || nh > kMaxHeads || nblk < 1)
    return (int)cudaErrorInvalidValue;
  return with_table(h, flags, [&](auto hp) {
    return launch_table_forward(logits, hp, drop, senders, row_ptr, n,
                                e_real, d_feat, nh, f, eps, out, den, nblk,
                                flags, (cudaStream_t)stream);
  });
}

// Backward: d_h_rows (E, d_feat) in dst order, d_logits (E, nh), d_drop
// (E, nh) or NULL.
int table_backward(const float* logits, const void* h, const float* drop,
                   const int* senders, const int* row_ptr, int n, int e_real,
                   int e_total, int d_feat, int nh, int f, float eps,
                   const float* g,
                   const float* out, const float* den, float* d_h_rows,
                   float* d_logits, float* d_drop, int nblk, int flags,
                   void* stream) {
  if (d_feat < 1 || d_feat > 1024 || nh < 1 || nh > kMaxHeads || nblk < 1)
    return (int)cudaErrorInvalidValue;
  return with_table(h, flags, [&](auto hp) {
    return launch_table_backward(logits, hp, drop, senders, row_ptr, n,
                                 e_real, e_total, d_feat, nh, f, eps, g, out,
                                 den, d_h_rows, d_logits, d_drop, nblk,
                                 (cudaStream_t)stream);
  });
}

}  // extern "C"
