// v5 whole-attention op for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels
//   gat_pytorch_tpu/ops/pallas/segment_attention.py:_kernel_v5_auto
//     (single-sweep "v10" mode, launched by _forward_v5_auto)
//   gat_pytorch_tpu/ops/pallas/segment_attention_bwd.py:_kernel_v5_bwd
//     (sweep1 mode, launched by backward_v5: normalize=True for the
//      normalised op, normalize=False for the sweep-1 parts op
//      v5_sweep1_parts, whose forward is the same _kernel_v5_auto)
//
// Contract (per edge e = (src, dst), head k, for e < e_real):
//   raw'[e,k] = h[src,:] . a_src[:,k] + s_dst'[dst,k]   (s_dst' is B-shifted)
//   ex[e,k]   = exp(slope * raw'[e,k])
//   num[dst, k*f+j] += ex[e,k] * drop[e,k] * h[src, k*f+j]
//   den[dst, k]     += ex[e,k]                 (no dropout mask in den)
//   cap' = max raw', code = lowest e*nh + k attaining it
// The normalising epilogue out = num / (den + eps*exp(slope*cap')) runs in
// torch. The backward recomputes ex from the same inputs and emits the
// per-edge d(h) rows in dst order, d(drop), d(s_dst) per dst and d(a_src).
// It has two modes (the template parameter NORM of v5_bwd_kernel):
//   normalised  takes the cotangent g of out with out, den and eps' and
//               derives inv = 1/(den + eps') and d(den) = -(g . out) * inv
//               per destination and head itself;
//   parts       takes the raw cotangents d(num) (n, d_feat) and d(den)
//               (n, nh) of the unnormalised parts, as a caller hands them
//               over that differentiates its own epilogue (the hybrid
//               layer sums the parts of two ops first): per edge
//               d(raw') = slope * ex * (m * (h[src] . d_num[dst])_k
//                                       + d_den[dst,k]),
//               d(h) row = d(raw') @ a_src^T + ex * m * d_num[dst],
//               d(drop) = ex * (h[src] . d_num[dst])_k.
// The h table may have more rows than n: senders index h, receivers the n
// destination rows (a caller whose destinations are a part of the nodes).
//
// Design. The TPU kernels gather rows with one-hot matmuls because Mosaic
// has no in-kernel random gather; Hopper has one. So one warp owns one
// destination node at a time and walks its in-edges (dst-sorted CSR
// offsets) in order: it loads the sender's h row (lane l holds features
// l, l+32, ...), contracts it with a_src (held in shared memory) through
// warp shuffles, and accumulates num/den in registers. Every output row
// is written by exactly one warp, so no atomics are needed and the sums
// run in a fixed order: the results are bitwise reproducible.
// Cross-block reductions (the cap and its argmax, d(a_src)) go through
// per-block partials over a fixed grid and a second, ordered pass.
//
// What bounds it on the H100: by bytes, the gathered h rows (E x nh*f x
// 4 bytes), a few MB at Cora size, about a microsecond at 3.35 TB/s. As
// written it is bound by latency instead: each warp walks its edges one
// after another, and every edge is a dependent chain (sender index, row
// gather, nh warp reductions). Splitting a destination's edges over more
// lanes, or more destinations per warp for narrow rows, is the next step
// (PERF.md). No wgmma or TMA: a row gather per edge is the access
// pattern, and the contraction with a_src is nh*f*nh multiply-adds per
// edge.

#include "attention_common.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
v5_fwd_kernel(const float* __restrict__ h, const float* __restrict__ a_src,
              const float* __restrict__ s_dst, const float* __restrict__ drop,
              const int* __restrict__ senders,
              const int* __restrict__ row_ptr, int n, int e_real,
              int d_feat, int nh, int f, float slope,
              float* __restrict__ num, float* __restrict__ den,
              float* __restrict__ blk_max, int* __restrict__ blk_code) {
  extern __shared__ float sa[];  // a_src transposed, (nh, d_feat)
  __shared__ float wmax[kWarps];
  __shared__ int wcode[kWarps];
  for (int i = threadIdx.x; i < d_feat * nh; i += blockDim.x)
    sa[(i % nh) * d_feat + i / nh] = a_src[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int head[C];
  bool live[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = lane + 32 * c;
    live[c] = j < d_feat;
    head[c] = live[c] ? j / f : 0;
  }
  float vmax = -INFINITY;
  int vcode = INT_MAX;

  for (int d = blockIdx.x * kWarps + warp; d < n; d += gridDim.x * kWarps) {
    float sd[kMaxHeads], dsum[kMaxHeads], acc[C];
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k) {
      sd[k] = k < nh ? s_dst[(size_t)d * nh + k] : 0.f;
      dsum[k] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;

    const int lo = row_ptr[d];
    const int hi = min(row_ptr[d + 1], e_real);  // padding edges add nothing
    for (int e = lo; e < hi; ++e) {
      const float* hrow = h + (size_t)senders[e] * d_feat;
      float hv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) hv[c] = live[c] ? hrow[lane + 32 * c] : 0.f;
      float ex[kMaxHeads];
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k) {
        ex[k] = 0.f;
        if (k < nh) {  // nh is warp-uniform: every lane joins the shuffles
          float p = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (live[c]) p += hv[c] * sa[k * d_feat + lane + 32 * c];
          const float raw = warp_sum(p) + sd[k];
          take_max(vmax, vcode, raw, e * nh + k);
          ex[k] = expf(slope * raw);
          dsum[k] += ex[k];
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!live[c]) continue;
        float w = select_head(ex, head[c]);
        if (drop) w *= drop[(size_t)e * nh + head[c]];
        acc[c] += w * hv[c];
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (live[c]) num[(size_t)d * d_feat + lane + 32 * c] = acc[c];
    if (lane < nh) den[(size_t)d * nh + lane] = select_head(dsum, lane);
  }

  if (lane == 0) {
    wmax[warp] = vmax;
    wcode[warp] = vcode;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = -INFINITY;
    int code = INT_MAX;
    for (int w = 0; w < kWarps; ++w) take_max(m, code, wmax[w], wcode[w]);
    blk_max[blockIdx.x] = m;
    blk_code[blockIdx.x] = code;
  }
}

// NORM: the normalised mode; else the parts mode, where `g` carries d(num),
// `den` carries d(den), and `out` and `epsp` are not read (NULL).
template <int C, bool NORM>
__global__ void __launch_bounds__(kWarps * 32)
v5_bwd_kernel(const float* __restrict__ h, const float* __restrict__ a_src,
              const float* __restrict__ s_dst, const float* __restrict__ drop,
              const int* __restrict__ senders,
              const int* __restrict__ row_ptr, int n, int e_real,
              int d_feat, int nh, int f, float slope,
              const float* __restrict__ g, const float* __restrict__ out,
              const float* __restrict__ den, const float* __restrict__ epsp,
              float* __restrict__ d_h_rows, float* __restrict__ d_drop,
              float* __restrict__ d_sdst, float* __restrict__ dasrc_part) {
  extern __shared__ float smem[];
  float* sa = smem;                  // a_src transposed, (nh, d_feat)
  float* sacc = smem + d_feat * nh;  // this block's d(a_src), (nh, d_feat)
  for (int i = threadIdx.x; i < d_feat * nh; i += blockDim.x) {
    sa[(i % nh) * d_feat + i / nh] = a_src[i];
    sacc[i] = 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int head[C];
  bool live[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = lane + 32 * c;
    live[c] = j < d_feat;
    head[c] = live[c] ? j / f : 0;
  }
  float da[C][kMaxHeads];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k) da[c][k] = 0.f;
  float eps_p = 0.f;
  if constexpr (NORM) eps_p = *epsp;

  for (int d = blockIdx.x * kWarps + warp; d < n; d += gridDim.x * kWarps) {
    float gv[C];
    float inv[kMaxHeads], dden[kMaxHeads], sd[kMaxHeads], sds[kMaxHeads];
#pragma unroll
    for (int c = 0; c < C; ++c)
      gv[c] = live[c] ? g[(size_t)d * d_feat + lane + 32 * c] : 0.f;
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k) {
      inv[k] = dden[k] = sd[k] = sds[k] = 0.f;
      if (k < nh) {
        const float dn = den[(size_t)d * nh + k];
        if constexpr (NORM) {
          inv[k] = dn > 0.f ? 1.f / (dn + eps_p) : 0.f;
          float p = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (live[c] && head[c] == k)
              p += out[(size_t)d * d_feat + lane + 32 * c] * gv[c];
          dden[k] = -warp_sum(p) * inv[k];
        } else {  // the caller's epilogue owns the quotient
          inv[k] = 1.f;
          dden[k] = dn;
        }
        sd[k] = s_dst[(size_t)d * nh + k];
      }
    }

    const int lo = row_ptr[d];
    const int hi = min(row_ptr[d + 1], e_real);  // padding edges: see below
    for (int e = lo; e < hi; ++e) {
      float* dhrow = d_h_rows + (size_t)e * d_feat;
      const float* hrow = h + (size_t)senders[e] * d_feat;
      float hv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) hv[c] = live[c] ? hrow[lane + 32 * c] : 0.f;
      float draw[kMaxHeads], coef[kMaxHeads];
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k) {
        draw[k] = coef[k] = 0.f;
        if (k < nh) {
          float p = 0.f, q = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (!live[c]) continue;
            p += hv[c] * sa[k * d_feat + lane + 32 * c];
            if (head[c] == k) q += hv[c] * gv[c];
          }
          const float raw = warp_sum(p) + sd[k];
          const float hg = warp_sum(q);
          const float ex = expf(slope * raw);
          const float m = drop ? drop[(size_t)e * nh + k] : 1.f;
          // d(raw') through the negative LeakyReLU branch (raw' <= cap')
          draw[k] = slope * ex * (hg * inv[k] * m + dden[k]);
          coef[k] = ex * m * inv[k];
          sds[k] += draw[k];
          if (d_drop && lane == k)
            d_drop[(size_t)e * nh + k] = hg * ex * inv[k];
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!live[c]) continue;
        const int j = lane + 32 * c;
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxHeads; ++k) {
          if (k < nh) {
            v += sa[k * d_feat + j] * draw[k];
            da[c][k] += hv[c] * draw[k];
          }
        }
        dhrow[j] = v + select_head(coef, head[c]) * gv[c];
      }
    }
    if (lane < nh) d_sdst[(size_t)d * nh + lane] = select_head(sds, lane);
  }

  // Padding edges (e >= e_real) get zero cotangents. They all hang on the
  // sink node, thousands of them in a batch padded to its bucket, so the
  // sink's warp must not walk them alone: all warps share them.
  for (int e = e_real + blockIdx.x * kWarps + warp; e < row_ptr[n];
       e += gridDim.x * kWarps) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (live[c]) d_h_rows[(size_t)e * d_feat + lane + 32 * c] = 0.f;
    if (d_drop && lane < nh) d_drop[(size_t)e * nh + lane] = 0.f;
  }

  // block sum of d(a_src): warps add in a fixed order (deterministic)
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!live[c]) continue;
#pragma unroll
        for (int k = 0; k < kMaxHeads; ++k)
          if (k < nh) sacc[k * d_feat + lane + 32 * c] += da[c][k];
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < d_feat * nh; i += blockDim.x)
    dasrc_part[(size_t)blockIdx.x * d_feat * nh + i] =
        sacc[(i % nh) * d_feat + i / nh];  // back to (d_feat, nh)
}

template <bool NORM>
int launch_v5_backward(const float* h, const float* a_src, const float* s_dst,
                       const float* drop, const int* senders,
                       const int* row_ptr, int n, int e_real, int d_feat,
                       int nh, int f, float slope, const float* g,
                       const float* out, const float* den, const float* epsp,
                       float* d_h_rows, float* d_drop, float* d_sdst,
                       float* dasrc_part, float* d_asrc, int nblk,
                       void* stream) {
  if (d_feat < 1 || d_feat > 1024 || nh < 1 || nh > kMaxHeads || nblk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = 2 * (size_t)d_feat * nh * sizeof(float);
  const int c_need = (d_feat + 31) / 32;
  cudaError_t err = cudaSuccess;
#define V5_BWD(CC)                                                          \
  err = set_smem(v5_bwd_kernel<CC, NORM>, smem);                            \
  if (err == cudaSuccess)                                                   \
    v5_bwd_kernel<CC, NORM><<<nblk, kWarps * 32, smem, st>>>(               \
        h, a_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat, nh, f,  \
        slope, g, out, den, epsp, d_h_rows, d_drop, d_sdst, dasrc_part);
  ROWS_DISPATCH(V5_BWD)
#undef V5_BWD
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = d_feat * nh;
  sum_partials_kernel<<<(len + 255) / 256, 256, 0, st>>>(dasrc_part, nblk,
                                                         len, d_asrc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward: num (n, d_feat), den (n, nh), cap (1,), code (1,).
// blk_max / blk_code are (nblk,) scratch. drop may be NULL.
int v5_forward(const float* h, const float* a_src, const float* s_dst,
               const float* drop, const int* senders, const int* row_ptr,
               int n, int e_real, int d_feat, int nh, int f, float slope,
               float* num, float* den, float* blk_max, int* blk_code,
               float* cap, int* code, int nblk, void* stream) {
  if (d_feat < 1 || d_feat > 1024 || nh < 1 || nh > kMaxHeads || nblk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)d_feat * nh * sizeof(float);
  const int c_need = (d_feat + 31) / 32;
  cudaError_t err = cudaSuccess;
#define V5_FWD(CC)                                                        \
  err = set_smem(v5_fwd_kernel<CC>, smem);                                \
  if (err == cudaSuccess)                                                 \
    v5_fwd_kernel<CC><<<nblk, kWarps * 32, smem, st>>>(                   \
        h, a_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat, nh, f, \
        slope, num, den, blk_max, blk_code);
  ROWS_DISPATCH(V5_FWD)
#undef V5_FWD
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cap_reduce_kernel<<<1, kCapThreads, 0, st>>>(blk_max, blk_code, nblk, cap,
                                               code);
  return (int)cudaGetLastError();
}

// Backward, normalised mode: d_h_rows (E, d_feat) in dst order, d_drop
// (E, nh) or NULL, d_sdst (n, nh), d_asrc (d_feat, nh); dasrc_part is
// (nblk, d_feat*nh) scratch. epsp points at eps' = eps*exp(slope*cap') on
// the device.
int v5_backward(const float* h, const float* a_src, const float* s_dst,
                const float* drop, const int* senders, const int* row_ptr,
                int n, int e_real, int d_feat, int nh, int f, float slope,
                const float* g, const float* out, const float* den,
                const float* epsp, float* d_h_rows, float* d_drop,
                float* d_sdst, float* dasrc_part, float* d_asrc, int nblk,
                void* stream) {
  return launch_v5_backward<true>(h, a_src, s_dst, drop, senders, row_ptr, n,
                                  e_real, d_feat, nh, f, slope, g, out, den,
                                  epsp, d_h_rows, d_drop, d_sdst, dasrc_part,
                                  d_asrc, nblk, stream);
}

// Backward, parts mode: the same outputs from the raw cotangents d_num
// (n, d_feat) and d_den (n, nh) of the unnormalised parts.
int v5_backward_parts(const float* h, const float* a_src, const float* s_dst,
                      const float* drop, const int* senders,
                      const int* row_ptr, int n, int e_real, int d_feat,
                      int nh, int f, float slope, const float* d_num,
                      const float* d_den, float* d_h_rows, float* d_drop,
                      float* d_sdst, float* dasrc_part, float* d_asrc,
                      int nblk, void* stream) {
  return launch_v5_backward<false>(h, a_src, s_dst, drop, senders, row_ptr, n,
                                   e_real, d_feat, nh, f, slope, d_num,
                                   nullptr, d_den, nullptr, d_h_rows, d_drop,
                                   d_sdst, dasrc_part, d_asrc, nblk, stream);
}

}  // extern "C"
