// v5 whole-attention op for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels
//   gat_pytorch_tpu/ops/pallas/segment_attention.py:_kernel_v5_auto
//     (single-sweep "v10" mode, launched by _forward_v5_auto; and its
//      merged 2-phase mode, served here by v5_cap then
//      v5_forward_two_phase)
//   gat_pytorch_tpu/ops/pallas/segment_attention.py:_kernel_v5_cap
//     (the cap pre-pass: v5_cap)
//   gat_pytorch_tpu/ops/pallas/segment_attention.py:_kernel_v5
//     (the explicit-cap normalised forward: v5_forward_two_phase)
//   gat_pytorch_tpu/ops/pallas/segment_attention_bwd.py:_kernel_v5_bwd
//     (sweep1 mode, launched by backward_v5: normalize=True for the
//      normalised op, normalize=False for the sweep-1 parts op
//      v5_sweep1_parts, whose forward is the same _kernel_v5_auto; and
//      its sweep1=False mode: v5_backward_two_phase)
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
// It has two modes besides the 2-phase one (the template parameter MODE
// of v5_bwd_kernel):
//   kNorm       takes the cotangent g of out with out, den and eps' and
//               derives inv = 1/(den + eps') and d(den) = -(g . out) * inv
//               per destination and head itself;
//   kParts      takes the raw cotangents d(num) (n, d_feat) and d(den)
//               (n, nh) of the unnormalised parts, as a caller hands them
//               over that differentiates its own epilogue (the hybrid
//               layer sums the parts of two ops first): per edge
//               d(raw') = slope * ex * (m * (h[src] . d_num[dst])_k
//                                       + d_den[dst,k]),
//               d(h) row = d(raw') @ a_src^T + ex * m * d_num[dst],
//               d(drop) = ex * (h[src] . d_num[dst])_k.
// The 2-phase form (the JAX package under GAT_TPU_V10=0 or
// GAT_TPU_V5_MERGED=0, and its explicit-cap fused_gat_table) takes the cap
// as an input, from device memory, and applies the full LeakyReLU:
//   v5_cap                cap = max raw, code = lowest e*nh + k (raw not
//                         shifted: the caller's s_dst as it is);
//   v5_forward_two_phase  ex = exp(leaky(raw - cap)), out = num / (den +
//                         eps) where den > 0, else 0 (the plain eps);
//   v5_backward_two_phase d(pre) = ex * (m * inv * (h[src] . g[dst])_k +
//                         d_den[dst,k]) times the slope where pre <= 0,
//                         d(raw) = d(pre), and besides the outputs above
//                         d(cap) = -sum d(raw) over edges and heads.
// Every mode computes raw with head_dot (attention_common.cuh): the cap
// kernel, the forward and the backward get the same bits for the same
// edge, so the argmax edge has pre == 0 exactly and takes the slope.
// The h table may have more rows than n: senders index h, receivers the n
// destination rows (a caller whose destinations are a part of the nodes).
// The bfloat16 modes (the flags word, attention_common.cuh) are the JAX
// package's GAT_TPU_KERNEL_DTYPE (kRoundAcc in the forwards: each edge's
// [weighted h | ex] rounded before the float32 sums), GAT_TPU_H_DTYPE (a
// bfloat16 h table, kBf16Table: the kernels are instantiated for both
// element types) and the v6 form of segment_attention_window.py, which the
// port runs on the 2-phase entries (kRoundRows | kRoundAcc forward,
// kRoundRows | kRoundDh | kRoundDraw backward).
//
// Design. The TPU kernels gather rows with one-hot matmuls because Mosaic
// has no in-kernel random gather; Hopper has one. So one warp owns one
// destination node at a time and walks its in-edges (dst-sorted CSR
// offsets) in order: it loads the sender's h row (lane l holds features
// l, l+32, ...), contracts it with a_src (held in shared memory) through
// warp shuffles, and accumulates num/den in registers. Every output row
// is written by exactly one warp, so no atomics are needed and the sums
// run in a fixed order: the results are bitwise reproducible.
// Cross-block reductions (the cap and its argmax, d(a_src), d(cap)) go
// through per-block partials over a fixed grid and a second, ordered pass.
// The TPU's merged 2-phase launch (grid 2T: cap tiles, then attention
// tiles, the cap carried in VMEM scratch) has no counterpart here: blocks
// do not run in order, so the cap is a launch of its own (cap kernel and
// its reduce) before the forward, in order on one stream, and reaches the
// forward through device memory with no host sync.
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

// MODE (attention_common.cuh): kSweep1 writes the unnormalised num/den and
// the per-block (max, code) partials; kCap only the partials (drop, num,
// den unused); kTwoPhase reads *cap and writes out = num/(den + eps) into
// `num` and den, no partials.
template <int C, Fwd MODE, typename T>
__global__ void __launch_bounds__(kWarps * 32)
v5_fwd_kernel(const T* __restrict__ h, const float* __restrict__ a_src,
              const float* __restrict__ s_dst, const float* __restrict__ drop,
              const int* __restrict__ senders,
              const int* __restrict__ row_ptr, int n, int e_real,
              int d_feat, int nh, int f, float slope, float eps, int flags,
              const float* __restrict__ cap_in, float* __restrict__ num,
              float* __restrict__ den, float* __restrict__ blk_max,
              int* __restrict__ blk_code) {
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
  float cap = 0.f;
  if constexpr (MODE == Fwd::kTwoPhase) cap = *cap_in;
  const bool r_rows = flags & kRoundRows, r_acc = flags & kRoundAcc;

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
      const T* hrow = h + (size_t)senders[e] * d_feat;
      float hv[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        hv[c] = live[c] ? load_h(hrow + lane + 32 * c) : 0.f;
      float ex[kMaxHeads];
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k) {
        ex[k] = 0.f;
        if (k < nh) {  // nh is warp-uniform: every lane joins the shuffles
          float unused;
          const float raw = head_dot<C, false>(hv, live, head, sa, k, d_feat,
                                               lane, hv, unused) + sd[k];
          if constexpr (MODE == Fwd::kTwoPhase) {
            ex[k] = expf(leaky(raw - cap, slope));
          } else {
            take_max(vmax, vcode, raw, e * nh + k);
            if constexpr (MODE == Fwd::kSweep1) ex[k] = expf(slope * raw);
          }
          dsum[k] += round_if(ex[k], r_acc);
        }
      }
      if constexpr (MODE != Fwd::kCap) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (!live[c]) continue;
          float w = select_head(ex, head[c]);
          if (drop) w *= drop[(size_t)e * nh + head[c]];
          acc[c] += round_if(w * round_if(hv[c], r_rows), r_acc);
        }
      }
    }
    if constexpr (MODE != Fwd::kCap) {
      float inv[kMaxHeads];
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k) {
        inv[k] = 1.f;
        if constexpr (MODE == Fwd::kTwoPhase)
          inv[k] = dsum[k] > 0.f ? 1.f / (dsum[k] + eps) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!live[c]) continue;
        float v = acc[c];
        if constexpr (MODE == Fwd::kTwoPhase) v *= select_head(inv, head[c]);
        num[(size_t)d * d_feat + lane + 32 * c] = v;
      }
      if (lane < nh) den[(size_t)d * nh + lane] = select_head(dsum, lane);
    }
  }

  if constexpr (MODE != Fwd::kTwoPhase) {
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
}

// MODE (attention_common.cuh): kNorm reads eps' at `epsp`; kParts takes
// d(num) in `g` and d(den) in `den` (out, epsp, cap unread); kTwoPhase
// reads the cap at `cap`, uses the plain `eps`, and writes each block's
// -sum d(raw) after its d(a_src) partial (a partial row of
// d_feat*nh + 1 floats).
template <int C, Bwd MODE, typename T>
__global__ void __launch_bounds__(kWarps * 32)
v5_bwd_kernel(const T* __restrict__ h, const float* __restrict__ a_src,
              const float* __restrict__ s_dst, const float* __restrict__ drop,
              const int* __restrict__ senders,
              const int* __restrict__ row_ptr, int n, int e_real,
              int d_feat, int nh, int f, float slope, float eps, int flags,
              const float* __restrict__ g, const float* __restrict__ out,
              const float* __restrict__ den, const float* __restrict__ epsp,
              const float* __restrict__ cap_in, float* __restrict__ d_h_rows,
              float* __restrict__ d_drop, float* __restrict__ d_sdst,
              float* __restrict__ dasrc_part) {
  constexpr bool kTwo = MODE == Bwd::kTwoPhase;
  extern __shared__ float smem[];
  float* sa = smem;                  // a_src transposed, (nh, d_feat)
  float* sacc = smem + d_feat * nh;  // this block's d(a_src), (nh, d_feat)
  __shared__ float wdcap[kWarps];
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
  float eps_p = 0.f, cap = 0.f, dcap = 0.f;
  if constexpr (MODE == Bwd::kNorm) eps_p = *epsp;
  if constexpr (kTwo) {
    eps_p = eps;
    cap = *cap_in;
  }
  const bool r_rows = flags & kRoundRows, r_pay = flags & kRoundPayload,
             r_dh = flags & kRoundDh, r_draw = flags & kRoundDraw,
             r_sds = flags & kRoundDsdst;

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
        if constexpr (MODE != Bwd::kParts) {
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
    if (r_pay) {  // the payload, rounded after d(den) is taken from it
#pragma unroll
      for (int c = 0; c < C; ++c) gv[c] = round_bf16(gv[c]);
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k) {
        inv[k] = round_bf16(inv[k]);
        dden[k] = round_bf16(dden[k]);
      }
    }

    const int lo = row_ptr[d];
    const int hi = min(row_ptr[d + 1], e_real);  // padding edges: see below
    for (int e = lo; e < hi; ++e) {
      float* dhrow = d_h_rows + (size_t)e * d_feat;
      const T* hrow = h + (size_t)senders[e] * d_feat;
      float hv[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        hv[c] = live[c] ? load_h(hrow + lane + 32 * c) : 0.f;
      float draw[kMaxHeads], coef[kMaxHeads];
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k) {
        draw[k] = coef[k] = 0.f;
        if (k < nh) {
          float hg;
          const float raw = head_dot<C, true>(hv, live, head, sa, k, d_feat,
                                              lane, gv, hg, r_rows) + sd[k];
          const float m = drop ? drop[(size_t)e * nh + k] : 1.f;
          float ex;
          if constexpr (kTwo) {
            const float pre = raw - cap;
            ex = expf(leaky(pre, slope));
            // the slope where pre <= 0: the argmax edge has pre == 0
            const float dlg = ex * (hg * inv[k] * m + dden[k]);
            draw[k] = pre > 0.f ? dlg : slope * dlg;
            dcap += draw[k];
          } else {
            ex = expf(slope * raw);
            // d(raw') through the negative LeakyReLU branch (raw' <= cap')
            draw[k] = slope * ex * (hg * inv[k] * m + dden[k]);
          }
          coef[k] = ex * m * inv[k];
          sds[k] += round_if(draw[k], r_sds);
          if (d_drop && lane == k)
            d_drop[(size_t)e * nh + k] = hg * ex * inv[k];
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!live[c]) continue;
        const int j = lane + 32 * c;
        const float hq = round_if(hv[c], r_rows);
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxHeads; ++k) {
          if (k < nh) {
            v += sa[k * d_feat + j] * draw[k];
            da[c][k] += hq * round_if(draw[k], r_draw);
          }
        }
        dhrow[j] = round_if(v + select_head(coef, head[c]) * gv[c], r_dh);
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

  // block sums of d(a_src) and d(cap): warps add in a fixed order
  // (deterministic); dcap is the same on every lane of a warp
  if (kTwo && lane == 0) wdcap[warp] = dcap;
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
  const int len = d_feat * nh, stride = len + (kTwo ? 1 : 0);
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    dasrc_part[(size_t)blockIdx.x * stride + i] =
        sacc[(i % nh) * d_feat + i / nh];  // back to (d_feat, nh)
  if (kTwo && threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wdcap[w];
    dasrc_part[(size_t)blockIdx.x * stride + len] = -s;
  }
}

int check_shape(int d_feat, int nh, int nblk) {
  return (d_feat < 1 || d_feat > 1024 || nh < 1 || nh > kMaxHeads || nblk < 1)
             ? (int)cudaErrorInvalidValue
             : (int)cudaSuccess;
}

// One forward launch in MODE, then (kSweep1, kCap) the cap reduce.
template <Fwd MODE, typename T>
int launch_v5_forward(const T* h, const float* a_src, const float* s_dst,
                      const float* drop, const int* senders,
                      const int* row_ptr, int n, int e_real, int d_feat,
                      int nh, int f, float slope, float eps,
                      const float* cap_in, float* num, float* den,
                      float* blk_max, int* blk_code, float* cap, int* code,
                      int nblk, int flags, void* stream) {
  int bad = check_shape(d_feat, nh, nblk);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)d_feat * nh * sizeof(float);
  const int c_need = (d_feat + 31) / 32;
  cudaError_t err = cudaSuccess;
#define V5_FWD(CC)                                                        \
  err = set_smem(v5_fwd_kernel<CC, MODE, T>, smem);                       \
  if (err == cudaSuccess)                                                 \
    v5_fwd_kernel<CC, MODE, T><<<nblk, kWarps * 32, smem, st>>>(          \
        h, a_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat, nh, f, \
        slope, eps, flags, cap_in, num, den, blk_max, blk_code);
  ROWS_DISPATCH(V5_FWD)
#undef V5_FWD
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess || MODE == Fwd::kTwoPhase) return (int)err;
  cap_reduce_kernel<<<1, kCapThreads, 0, st>>>(blk_max, blk_code, nblk, cap,
                                               code);
  return (int)cudaGetLastError();
}

template <Bwd MODE, typename T>
int launch_v5_backward(const T* h, const float* a_src, const float* s_dst,
                       const float* drop, const int* senders,
                       const int* row_ptr, int n, int e_real, int d_feat,
                       int nh, int f, float slope, float eps, const float* g,
                       const float* out, const float* den, const float* epsp,
                       const float* cap_in, float* d_h_rows, float* d_drop,
                       float* d_sdst, float* dasrc_part, float* d_asrc,
                       int nblk, int flags, void* stream) {
  int bad = check_shape(d_feat, nh, nblk);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = 2 * (size_t)d_feat * nh * sizeof(float);
  const int c_need = (d_feat + 31) / 32;
  cudaError_t err = cudaSuccess;
#define V5_BWD(CC)                                                          \
  err = set_smem(v5_bwd_kernel<CC, MODE, T>, smem);                         \
  if (err == cudaSuccess)                                                   \
    v5_bwd_kernel<CC, MODE, T><<<nblk, kWarps * 32, smem, st>>>(            \
        h, a_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat, nh, f,  \
        slope, eps, flags, g, out, den, epsp, cap_in, d_h_rows, d_drop,     \
        d_sdst, dasrc_part);
  ROWS_DISPATCH(V5_BWD)
#undef V5_BWD
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // d(a_src), and in the 2-phase mode d(cap) after it
  const int len = d_feat * nh + (MODE == Bwd::kTwoPhase ? 1 : 0);
  sum_partials_kernel<<<(len + 255) / 256, 256, 0, st>>>(dasrc_part, nblk,
                                                         len, d_asrc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry: h is float32, or bfloat16 where flags has kBf16Table; flags
// is the bfloat16 mode's word (attention_common.cuh), 0 for float32.

// Forward: num (n, d_feat), den (n, nh), cap (1,), code (1,).
// blk_max / blk_code are (nblk,) scratch. drop may be NULL.
int v5_forward(const void* h, const float* a_src, const float* s_dst,
               const float* drop, const int* senders, const int* row_ptr,
               int n, int e_real, int d_feat, int nh, int f, float slope,
               float* num, float* den, float* blk_max, int* blk_code,
               float* cap, int* code, int nblk, int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_v5_forward<Fwd::kSweep1>(
        hp, a_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat, nh, f,
        slope, 0.f, nullptr, num, den, blk_max, blk_code, cap, code, nblk,
        flags, stream);
  });
}

// The 2-phase cap pass: cap (1,) = max raw over the real edges and heads,
// code (1,) = its lowest e*nh + k; blk_max / blk_code are (nblk,) scratch.
int v5_cap(const void* h, const float* a_src, const float* s_dst,
           const int* senders, const int* row_ptr, int n, int e_real,
           int d_feat, int nh, int f, float* blk_max, int* blk_code,
           float* cap, int* code, int nblk, int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_v5_forward<Fwd::kCap>(
        hp, a_src, s_dst, nullptr, senders, row_ptr, n, e_real, d_feat, nh,
        f, 0.f, 0.f, nullptr, nullptr, nullptr, blk_max, blk_code, cap, code,
        nblk, flags, stream);
  });
}

// The 2-phase forward: out (n, d_feat) normalised, den (n, nh), from the
// cap at `cap` (device memory). drop may be NULL.
int v5_forward_two_phase(const void* h, const float* a_src,
                         const float* s_dst, const float* cap,
                         const float* drop, const int* senders,
                         const int* row_ptr, int n, int e_real, int d_feat,
                         int nh, int f, float eps, float slope, float* out,
                         float* den, int nblk, int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_v5_forward<Fwd::kTwoPhase>(
        hp, a_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat, nh, f,
        slope, eps, cap, out, den, nullptr, nullptr, nullptr, nullptr, nblk,
        flags, stream);
  });
}

// Backward, normalised mode: d_h_rows (E, d_feat) in dst order, d_drop
// (E, nh) or NULL, d_sdst (n, nh), d_asrc (d_feat, nh); dasrc_part is
// (nblk, d_feat*nh) scratch. epsp points at eps' = eps*exp(slope*cap') on
// the device.
int v5_backward(const void* h, const float* a_src, const float* s_dst,
                const float* drop, const int* senders, const int* row_ptr,
                int n, int e_real, int d_feat, int nh, int f, float slope,
                const float* g, const float* out, const float* den,
                const float* epsp, float* d_h_rows, float* d_drop,
                float* d_sdst, float* dasrc_part, float* d_asrc, int nblk,
                int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_v5_backward<Bwd::kNorm>(
        hp, a_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat, nh, f,
        slope, 0.f, g, out, den, epsp, nullptr, d_h_rows, d_drop, d_sdst,
        dasrc_part, d_asrc, nblk, flags, stream);
  });
}

// Backward, parts mode: the same outputs from the raw cotangents d_num
// (n, d_feat) and d_den (n, nh) of the unnormalised parts.
int v5_backward_parts(const void* h, const float* a_src, const float* s_dst,
                      const float* drop, const int* senders,
                      const int* row_ptr, int n, int e_real, int d_feat,
                      int nh, int f, float slope, const float* d_num,
                      const float* d_den, float* d_h_rows, float* d_drop,
                      float* d_sdst, float* dasrc_part, float* d_asrc,
                      int nblk, int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_v5_backward<Bwd::kParts>(
        hp, a_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat, nh, f,
        slope, 0.f, d_num, nullptr, d_den, nullptr, nullptr, d_h_rows,
        d_drop, d_sdst, dasrc_part, d_asrc, nblk, flags, stream);
  });
}

// Backward, 2-phase: the outputs of the normalised mode from g, out, den,
// the cap at `cap` and the plain eps; d_asrc_cap is (d_feat*nh + 1,):
// d(a_src) then d(cap). dasrc_part is (nblk, d_feat*nh + 1) scratch.
int v5_backward_two_phase(const void* h, const float* a_src,
                          const float* s_dst, const float* cap,
                          const float* drop, const int* senders,
                          const int* row_ptr, int n, int e_real, int d_feat,
                          int nh, int f, float eps, float slope,
                          const float* g, const float* out, const float* den,
                          float* d_h_rows, float* d_drop, float* d_sdst,
                          float* dasrc_part, float* d_asrc_cap, int nblk,
                          int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_v5_backward<Bwd::kTwoPhase>(
        hp, a_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat, nh, f,
        slope, eps, g, out, den, nullptr, cap, d_h_rows, d_drop, d_sdst,
        dasrc_part, d_asrc_cap, nblk, flags, stream);
  });
}

}  // extern "C"
