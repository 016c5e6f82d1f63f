// v4 table attention op for Hopper (sm_90a): forward, and a backward that
// sums d(h) by sender.
//
// Replaces the TPU kernels
//   gat_pytorch_tpu/ops/pallas/segment_attention.py:_kernel_split
//     (launched by _forward_split for fused_segment_attention_table)
//   gat_pytorch_tpu/ops/pallas/segment_attention_bwd.py:_kernel_split
//     (launched by backward_split; its d(den) prologue is dden_kernel)
// and, for this op, the d(h) reduction that the JAX package runs after the
// backward (segment_attention.py:_dh_reduce, segment_sum.py:_kernel_rows_nt
// or _kernel_rows): the TPU kernel writes per-edge d(h) rows because Mosaic
// has no in-kernel gather or scatter; here the backward walks each sender's
// edges and writes its d(h) row once.
//
// Contract (per edge e = (src, dst), head k, feature j; the logits come
// from the caller, masked to -1e30 on padding edges, whose exp is 0; the
// real edges come first and edges e >= e_real are padding, not read):
//   ex[e,k]       = exp(logits[e,k])           for e < e_real, else 0
//   den[dst,k]    = sum_e ex[e,k]              (no dropout mask in den)
//   inv[dst,k]    = den > 0 ? 1 / (den + eps) : 0
//   out[dst,kf+j] = inv[dst,k] * sum_e ex[e,k] * drop[e,k] * h[src,kf+j]
// Backward, with g = d(out), hg[e,k] = sum_j h[src,kf+j] * g[dst,kf+j],
// dden[dst,k] = -inv[dst,k] * sum_j out[dst,kf+j] * g[dst,kf+j] (its own
// launch, attention_common.cuh dden_kernel) and coef[e,k] = ex[e,k] *
// drop[e,k] * inv[dst,k]:
//   d_h[s,kf+j]   = sum over s's edges e, in src_order, of coef[e,k] *
//                   g[dst,kf+j]
//   d_logits[e,k] = ex[e,k] * (hg[e,k] * inv[dst,k] * drop[e,k] + dden)
//   d_drop[e,k]   = hg[e,k] * ex[e,k] * inv[dst,k]
// A destination without a real edge has den = 0: its output row and every
// cotangent of its edges are 0, also at eps = 0; so are the cotangents of
// the padding edges and of edges whose receiver is no row of the call, and
// a sender without a real edge has a zero d(h) row.
//
// d(h)'s bits. Each d_h sum starts at 0 and adds, in ascending position of
// the sender's run of src_order, the product coef * g rounded to float32
// (__fmul_rn, then __fadd_rn: no contraction), +0 for an edge whose
// receiver is no row of the call: the products and the order of the
// per-edge rows that segment_sum.cu's d(h) reduction summed before, so the
// same bits. Both of its forms (row-major and GAT_TPU_DH_REDUCE_NT=0's
// feature-major) give those bits, so this op reads no knob on the card.
//
// Design. The TPU kernels turn the row gather and the per-destination sums
// into one-hot matmuls over edge blocks. Here a block of nh warps owns one
// destination (forward) or one sender (backward), and warp k owns head k:
// lane l holds the vectors b + V*(l + 32c) (c < C) of a row, b the vector
// that holds the head's first element, V = 4 where it divides f (16-byte
// float loads at 4x256), 2 where it divides the row (8-byte loads at 6x121,
// whose heads start mid-vector: the elements of a neighbouring head are
// kept out of the dot and the stores), else 1; C*V <= 8 at f <= 256. A
// warp needs only its head's terms, so it never selects a head per
// feature. The edges are taken 32 at a time:
// lane i loads edge i's index, logit and mask and computes its exp once;
// the warp hands them out by shuffles (no shared memory, no block barrier).
// Each lane then issues U edges' row loads (U = 32 / (C*V), at most 8)
// before it uses them. The forward adds w * h with fmaf in ascending edge
// order and sums den the same way (its body, attention_fwd_wide of
// attention_common.cuh, is the v5 op's and the v2 op's: only where a row
// and a weight come from differs); the backward reads the sender's own h row
// once, gathers g[dst] per edge, reduces the U edges' hg together
// (warp_sums: U - 1 + log2(32 / U) shuffles, not 5 U), and writes each
// real edge's d(logits) and d(drop) from the edge's own lane. Each output
// row has one writer in a fixed order: no atomics, the same bits on every
// launch.
//
// What bounds it on the H100: by bytes, the input tables read once and the
// outputs written once: about 0.01 ms a call at PPI's shapes. In practice
// the gathered rows (E_real x d floats: h in the forward, g in the
// backward, 240 MB at 1024-wide rows and 58,000 edges) come from L2, which
// holds the (N, d) tables, and the L2 read rate sets the floor.
//
// The bfloat16 modes (the flags word, attention_common.cuh): the JAX
// package's GAT_TPU_H_DTYPE, a bfloat16 h table (kBf16Table: every kernel
// that reads h is instantiated for both element types; half the gathered
// bytes of the forward; a gathered bfloat16 vector is widened where it is
// used, not where it is loaded, so that the U edges' loads stay in
// flight together), and GAT_TPU_KERNEL_DTYPE, each edge's
// [weighted h | ex] rounded before the forward's float32 sums (kRoundAcc).

#include "attention_common.cuh"

namespace {

// The vector helpers (Vec, load_vec, store_in, in_flight, warp_sums)
// are attention_common.cuh's.

// The forward: block d is destination d, warp k head k; the body is the
// v5 and v2 ops' (attention_common.cuh attention_fwd_wide), its rows
// gathered by sender and its weights from the given logits (Src::kLogits)
template <int V, int C, bool RACC, typename T>
__global__ void __launch_bounds__(kMaxHeads * 32)
table_fwd_kernel(const FwdArgs<T> a) {
  attention_fwd_wide<V, C, RACC, Src::kLogits>(a);
}

// the backward by sender: block s < n_src is sender s, warp k head k; the
// blocks past them zero the padding edges' d(logits) and d(drop)
template <int V, int C, typename T>
__global__ void __launch_bounds__(kMaxHeads * 32)
table_bwd_kernel(const float* __restrict__ logits, const T* __restrict__ h,
                 const float* __restrict__ drop,
                 const int* __restrict__ receivers,
                 const int* __restrict__ order,
                 const int* __restrict__ src_ptr, int n_src, int n,
                 int e_real, int e_total, int d_feat, int nh, int f,
                 float eps, const float* __restrict__ g,
                 const float* __restrict__ den,
                 const float* __restrict__ dden, float* __restrict__ d_h,
                 float* __restrict__ d_logits, float* __restrict__ d_drop) {
  if ((int)blockIdx.x >= n_src) {
    const size_t stride = (size_t)(gridDim.x - n_src) * blockDim.x;
    for (size_t i = (size_t)e_real * nh +
                    (size_t)(blockIdx.x - n_src) * blockDim.x + threadIdx.x;
         i < (size_t)e_total * nh; i += stride) {
      d_logits[i] = 0.f;
      if (d_drop) d_drop[i] = 0.f;
    }
    return;
  }
  constexpr int U = in_flight(C * V);
  constexpr bool kSplit = V == 2;  // vectors may straddle two heads
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  const int s = blockIdx.x;
  const int lo_k = k * f, hi_k = lo_k + f;
  const int col = lo_k - lo_k % V + V * lane;
  bool live[C], inh[C][V];  // inh: the element is head k's
#pragma unroll
  for (int c = 0; c < C; ++c) {
    live[c] = col + 32 * V * c < hi_k;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = col + 32 * V * c + v;
      inh[c][v] = j >= lo_k && j < hi_k;
    }
  }
  // the sender's own row, read once, 0 outside head k
  float hv[C][V], acc[C][V];
  const T* hrow = h + (size_t)s * d_feat + col;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    Vec<T, V> r;
    r.zero();
    if (live[c]) r.load(hrow + 32 * V * c);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      hv[c][v] = inh[c][v] ? r.e(v) : 0.f;
      acc[c][v] = 0.f;
    }
  }

  const int lo = src_ptr[s], hi = src_ptr[s + 1];
  for (int b = lo; b < hi; b += 32) {
    const int cnt = min(32, hi - b);
    // lane i: the edge at position b + i of the sender's run
    int e = 0, dst = 0;
    bool real = false, inside = false;
    float ex = 0.f, m = 1.f, inv = 0.f, dd = 0.f, coef = 0.f;
    if (lane < cnt) {
      e = order[b + lane];
      real = e < e_real;
      if (real) {
        dst = receivers[e];
        inside = dst < n;
        if (inside) {
          const size_t ek = (size_t)e * nh + k, dk = (size_t)dst * nh + k;
          ex = expf(logits[ek]);
          if (drop) m = drop[ek];
          const float dn = den[dk];
          inv = dn > 0.f ? 1.f / (dn + eps) : 0.f;
          dd = dden[dk];
          coef = ex * m * inv;
        }
      }
    }
    // bit i: edge b + i is real, or has its receiver in the call (i < cnt)
    const unsigned real_bits = __ballot_sync(kFull, real);
    const unsigned in_bits = __ballot_sync(kFull, inside);
    if (!real_bits) continue;  // padding edges only
    float hg_mine = 0.f;
    for (int i0 = 0; i0 < cnt; i0 += U) {  // i0 + u < 32: U divides 32
      float gv[U][C][V], cu[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u;
        const int du = __shfl_sync(kFull, dst, i);
        cu[u] = __shfl_sync(kFull, coef, i);
        const float* grow = g + (size_t)du * d_feat + col;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if ((in_bits >> i & 1) && live[c]) {
            load_vec<V>(grow + 32 * V * c, gv[u][c]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) gv[u][c][v] = 0.f;
          }
        }
      }
      // hg over head k's elements (kSplit: a vector may hold a
      // neighbour's, whose g is not read into the dot); 0 past cnt
      float q[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        q[u] = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int v = 0; v < V; ++v)
            q[u] = fmaf(hv[c][v], kSplit && !inh[c][v] ? 0.f : gv[u][c][v],
                        q[u]);
      }
      // lane i0 + u takes edge i0 + u's sum from lane u * (32 / U)
      const float hg = __shfl_sync(
          kFull, warp_sums<U>(q, lane), ((lane - i0) & (U - 1)) * (32 / U));
      if (lane >= i0 && lane < i0 + U) hg_mine = hg;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!(real_bits >> (i0 + u) & 1)) continue;
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[c][v] = __fadd_rn(acc[c][v], __fmul_rn(cu[u], gv[u][c][v]));
      }
    }
    if (real) {
      const size_t ek = (size_t)e * nh + k;
      d_logits[ek] = inside ? ex * (hg_mine * inv * m + dd) : 0.f;
      if (d_drop) d_drop[ek] = inside ? hg_mine * ex * inv : 0.f;
    }
  }

  float* dhrow = d_h + (size_t)s * d_feat + col;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (live[c])
      store_in<V>(dhrow + 32 * V * c, acc[c], col + 32 * V * c, lo_k, hi_k);
}

bool bad_shape(int d_feat, int nh, int f) {
  return d_feat < 1 || d_feat > 1024 || nh < 1 || nh > kMaxHeads ||
         nh * f != d_feat;
}

}  // namespace

extern "C" {

// Entries reading h: h is float32, or bfloat16 where flags has kBf16Table;
// flags is the bfloat16 mode's word (attention_common.cuh), 0 for float32.

// Forward: out (n, d_feat) normalised, den (n, nh). logits (E, nh), h
// (n_src, d_feat), drop (E, nh) or NULL, row_ptr (n + 1,) the offsets of
// each destination's run in the dst-sorted edge list, e_real the number of
// leading real edges.
int table_forward(const float* logits, const void* h, const float* drop,
                  const int* senders, const int* row_ptr, int n, int e_real,
                  int d_feat, int nh, int f, float eps, float* out,
                  float* den, int flags, void* stream) {
  if (bad_shape(d_feat, nh, f) || n < 1) return (int)cudaErrorInvalidValue;
  const bool racc = flags & kRoundAcc;
  return with_table(h, flags, [&](auto hp) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(hp)>>;
    return with_vec(f, d_feat, hp, out, out, [&](auto vc) {
      constexpr int V = decltype(vc)::value;
      return with_c<V>(f, [&](auto cc) {
        constexpr int C = decltype(cc)::value;
        auto kern = racc ? table_fwd_kernel<V, C, true, T>
                         : table_fwd_kernel<V, C, false, T>;
        const FwdArgs<T> a{hp,      nullptr, nullptr, drop,    senders,
                           nullptr, row_ptr, n,       e_real,  d_feat,
                           nh,      f,       32,      0.f,     eps,
                           flags,   false,   nullptr, out,     den,
                           nullptr, nullptr, logits,  true};
        kern<<<n, nh * 32, 0, (cudaStream_t)stream>>>(a);
        return (int)cudaGetLastError();
      });
    });
  });
}

// The backward's prelude: dden (n, nh) from g and out (n, d_feat) and den.
int table_dden(const float* g, const float* out, const float* den, int n,
               int d_feat, int nh, int f, float eps, float* dden,
               void* stream) {
  if (bad_shape(d_feat, nh, f) || n < 1) return (int)cudaErrorInvalidValue;
  return launch_dden(g, out, den, n, d_feat, nh, f, eps, dden,
                     (cudaStream_t)stream);
}

// The backward by sender: d_h (n_src, d_feat), d_logits and d_drop (E, nh),
// d_drop NULL where no mask is given. Sender s's edges are
// order[src_ptr[s]:src_ptr[s+1]], ascending by position; entries >= e_real
// are padding edges and are not read. g (n, d_feat), den and dden (n, nh);
// receivers (E,).
int table_backward(const float* logits, const void* h, const float* drop,
                   const int* receivers, const int* order,
                   const int* src_ptr, int n_src, int n, int e_real,
                   int e_total, int d_feat, int nh, int f, float eps,
                   const float* g, const float* den, const float* dden,
                   float* d_h, float* d_logits, float* d_drop, int flags,
                   void* stream) {
  if (bad_shape(d_feat, nh, f) || n < 1 || n_src < 1 || e_real > e_total)
    return (int)cudaErrorInvalidValue;
  const long pad = (long)(e_total - e_real) * nh;
  const long per = (long)nh * 32 * 8;  // elements a zeroing block a pass
  const int zero_blocks = (int)((pad + per - 1) / per < 64
                                    ? (pad + per - 1) / per : 64);
  return with_table(h, flags, [&](auto hp) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(hp)>>;
    return with_vec(f, d_feat, hp, g, d_h, [&](auto vc) {
      constexpr int V = decltype(vc)::value;
      return with_c<V>(f, [&](auto cc) {
        constexpr int C = decltype(cc)::value;
        table_bwd_kernel<V, C, T>
            <<<n_src + zero_blocks, nh * 32, 0, (cudaStream_t)stream>>>(
                logits, hp, drop, receivers, order, src_ptr, n_src, n,
                e_real, e_total, d_feat, nh, f, eps, g, den, dden, d_h,
                d_logits, d_drop);
        return (int)cudaGetLastError();
      });
    });
  });
}

}  // extern "C"
