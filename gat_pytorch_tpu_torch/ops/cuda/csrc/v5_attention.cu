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
// Rows wider than 256 floats take the backward's wide form (kWideC): a
// per-lane d(a_src) accumulator there would not fit in registers, so the
// kernel writes each edge's d(raw) row and v5_dasrc_kernel takes d(a_src)
// by sender, h^T S with S the per-sender sums of those rows.
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

// Rows wider than 256 floats (C >= 16 features a lane: PPI's 1024 and 726)
// take the backward's wide form. There a per-lane d(a_src) accumulator,
// C x kMaxHeads floats, beside the row, g and the per-head terms, comes to
// 255 registers and spills: every edge a read-modify-write of local
// memory (cuobjdump -res-usage of the C = 32 instances built with it).
// At C <= 8 it is at most 64 floats and the narrow form keeps it, without
// local memory.
constexpr int kWideC = 16;

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
// The wide form (C >= kWideC): d(a_src) is not accumulated here. Each
// edge's d(raw) row, rounded as d(a_src) reads it (kRoundDraw), goes to
// draw_out (E, nh) instead, padding edges' 0, and v5_dasrc_kernel takes
// d(a_src) from it by sender; the block's partial row gets only its
// -sum d(raw) (kTwoPhase), at column d_feat*nh.
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
              float* __restrict__ dasrc_part, float* __restrict__ draw_out) {
  constexpr bool kTwo = MODE == Bwd::kTwoPhase;
  constexpr bool kWide = C >= kWideC;
  extern __shared__ float smem[];
  float* sa = smem;                  // a_src transposed, (nh, d_feat)
  float* sacc = smem + d_feat * nh;  // this block's d(a_src), (nh, d_feat)
  __shared__ float wdcap[kWarps];
  // the wide form's head terms, a row of kMaxHeads each a warp: inv,
  // d(den), s_dst, the sum for d(s_dst), an edge's d(raw) and its coef
  enum { kInv, kDden, kSd, kSds, kDraw, kCoef, kTerms };
  __shared__ float wheads[kWide ? kWarps * kTerms * kMaxHeads : 1];
  float* wh = wheads + (kWide ? (threadIdx.x >> 5) * kTerms * kMaxHeads : 0);
  // the wide form's a_src rows are 32 C floats, zero past d_feat: its dot
  // products run over every lane's C features with no test of each (a
  // feature past d_feat adds 0 * 0), which keeps the raw logit's sum the
  // same as head_dot's
  constexpr int kPad = 32 * C;
  if constexpr (kWide) {
    for (int i = threadIdx.x; i < nh * kPad; i += blockDim.x) {
      const int j = i % kPad;
      sa[i] = j < d_feat ? a_src[j * nh + i / kPad] : 0.f;
    }
  } else {
    for (int i = threadIdx.x; i < d_feat * nh; i += blockDim.x) {
      sa[(i % nh) * d_feat + i / nh] = a_src[i];
      sacc[i] = 0.f;
    }
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
  // d(a_src) over this warp's edges (narrow form only: kWide has none)
  float da[kWide ? 1 : C][kMaxHeads];
#pragma unroll
  for (int c = 0; c < (kWide ? 1 : C); ++c)
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
    if constexpr (kWide) {
      __syncwarp();  // the last destination's terms are read
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kMaxHeads; ++k) {
          wh[kInv * kMaxHeads + k] = inv[k];
          wh[kDden * kMaxHeads + k] = dden[k];
          wh[kSd * kMaxHeads + k] = sd[k];
          wh[kSds * kMaxHeads + k] = 0.f;
        }
      }
      __syncwarp();
    }

    const int lo = row_ptr[d];
    const int hi = min(row_ptr[d + 1], e_real);  // padding edges: see below
    // the wide form has the next edge's row in flight while this one is
    // reduced (the narrow form's registers hold d(a_src) instead)
    float hn[kWide ? C : 1];
    if constexpr (kWide) {
      if (lo < hi) {
        const T* nrow = h + (size_t)senders[lo] * d_feat;
#pragma unroll
        for (int c = 0; c < C; ++c)
          hn[c] = live[c] ? load_h(nrow + lane + 32 * c) : 0.f;
      }
    }
    for (int e = lo; e < hi; ++e) {
      float* dhrow = d_h_rows + (size_t)e * d_feat;
      float hv[C];
      if constexpr (kWide) {
#pragma unroll
        for (int c = 0; c < C; ++c) hv[c] = hn[c];
        if (e + 1 < hi) {
          const T* nrow = h + (size_t)senders[e + 1] * d_feat;
#pragma unroll
          for (int c = 0; c < C; ++c)
            hn[c] = live[c] ? load_h(nrow + lane + 32 * c) : 0.f;
        }
      } else {
        const T* hrow = h + (size_t)senders[e] * d_feat;
#pragma unroll
        for (int c = 0; c < C; ++c)
          hv[c] = live[c] ? load_h(hrow + lane + 32 * c) : 0.f;
      }
      if constexpr (kWide) {
        // The heads in a loop that is not unrolled, their terms in shared
        // memory: the loop body holds one head_dot of C = 16 or 32
        // features a lane, where the narrow form unrolls kMaxHeads of
        // them. The same arithmetic in the same order as the narrow form.
        float hq[C];  // the rows as q reads them
        if (r_rows) {
#pragma unroll
          for (int c = 0; c < C; ++c) hq[c] = round_bf16(hv[c]);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) hq[c] = hv[c];
        }
        // head k's terms from its two sums (q = h[src] . g over the head's
        // features, raw = the logit): d(raw), coef, d(drop), in order
        auto head_terms = [&](int k, float hg, float raw) {
          raw += wh[kSd * kMaxHeads + k];
          const float m = drop ? drop[(size_t)e * nh + k] : 1.f;
          const float ik = wh[kInv * kMaxHeads + k];
          const float dk = wh[kDden * kMaxHeads + k];
          float ex, dr;
          if constexpr (kTwo) {
            const float pre = raw - cap;
            ex = expf(leaky(pre, slope));
            const float dlg = ex * (hg * ik * m + dk);
            dr = pre > 0.f ? dlg : slope * dlg;
            dcap += dr;
          } else {
            ex = expf(slope * raw);
            dr = slope * ex * (hg * ik * m + dk);
          }
          if (lane == 0) {
            wh[kDraw * kMaxHeads + k] = dr;
            wh[kCoef * kMaxHeads + k] = ex * m * ik;
            wh[kSds * kMaxHeads + k] += round_if(dr, r_sds);
          }
          if (d_drop && lane == k) d_drop[(size_t)e * nh + k] = hg * ex * ik;
          if (lane == k) draw_out[(size_t)e * nh + k] = round_if(dr, r_draw);
        };
        // head_dot's two sums in its order for two heads at once (their
        // chains of adds interleave), every feature added (a dead one's
        // terms are 0), q's terms selected, not branched to
        int k = 0;
#pragma unroll 1
        for (; k + 1 < nh; k += 2) {
          float p0 = 0.f, r0 = 0.f, p1 = 0.f, r1 = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            p0 += hv[c] * sa[k * kPad + lane + 32 * c];
            p1 += hv[c] * sa[(k + 1) * kPad + lane + 32 * c];
            r0 = head[c] == k ? r0 + hq[c] * gv[c] : r0;
            r1 = head[c] == k + 1 ? r1 + hq[c] * gv[c] : r1;
          }
          const float q0 = warp_sum(r0), q1 = warp_sum(r1);
          const float raw0 = warp_sum(p0), raw1 = warp_sum(p1);
          head_terms(k, q0, raw0);
          head_terms(k + 1, q1, raw1);
        }
        if (k < nh) {
          float p0 = 0.f, r0 = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            p0 += hv[c] * sa[k * kPad + lane + 32 * c];
            r0 = head[c] == k ? r0 + hq[c] * gv[c] : r0;
          }
          const float q0 = warp_sum(r0);
          head_terms(k, q0, warp_sum(p0));
        }
        __syncwarp();
        float v[C];
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = 0.f;
#pragma unroll 1
        for (int k = 0; k < nh; ++k) {
          const float dk = wh[kDraw * kMaxHeads + k];
#pragma unroll
          for (int c = 0; c < C; ++c) v[c] += sa[k * kPad + lane + 32 * c] * dk;
        }
#pragma unroll
        for (int c = 0; c < C; ++c)
          v[c] += wh[kCoef * kMaxHeads + head[c]] * gv[c];
        if (r_dh) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (live[c]) dhrow[lane + 32 * c] = round_bf16(v[c]);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (live[c]) dhrow[lane + 32 * c] = v[c];
        }
        __syncwarp();  // this edge's terms are read
      } else {
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
    }
    if constexpr (kWide) {
      if (lane < nh)
        d_sdst[(size_t)d * nh + lane] = wh[kSds * kMaxHeads + lane];
    } else {
      if (lane < nh) d_sdst[(size_t)d * nh + lane] = select_head(sds, lane);
    }
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
    if (kWide && lane < nh) draw_out[(size_t)e * nh + lane] = 0.f;
  }

  // block sums of d(a_src) and d(cap): warps add in a fixed order
  // (deterministic); dcap is the same on every lane of a warp
  if (kTwo && lane == 0) wdcap[warp] = dcap;
  const int len = d_feat * nh, stride = len + (kTwo ? 1 : 0);
  if constexpr (kWide) {
    if constexpr (kTwo) {
      __syncthreads();
      if (threadIdx.x == 0) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += wdcap[w];
        dasrc_part[(size_t)blockIdx.x * stride + len] = -s;
      }
    }
  } else {
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
    for (int i = threadIdx.x; i < len; i += blockDim.x)
      dasrc_part[(size_t)blockIdx.x * stride + i] =
          sacc[(i % nh) * d_feat + i / nh];  // back to (d_feat, nh)
    if (kTwo && threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += wdcap[w];
      dasrc_part[(size_t)blockIdx.x * stride + len] = -s;
    }
  }
}

// d(a_src) of the wide backward, by sender: d(a_src)[j, k] =
// sum over senders s of round_if(h[s, j], kRoundRows) * S[s, k], where
// S[s, k] is the sum of draw[e, k] over s's real edges e in the order of
// src_order (src_ptr: the offsets of each sender's run). It is today's sum
// over edges of h[src_e, j] * draw[e, k] in another association: every
// edge's product is taken once per sender instead of once per edge.
// Block b takes the senders [b*per, (b+1)*per) and writes its partial
// (d_feat, nh) into row b of `part` (stride floats a row; the backward
// wrote column d_feat*nh of it in the 2-phase mode); the ordered
// sum_partials_kernel adds the rows. Per tile of senders, thread t sums
// sender t/nh's draw column t%nh into shared memory; then thread t adds
// h[s, j] * S[s, :] for its features j = t + 256 c, the h row read once a
// sender, coalesced. No atomics, a fixed order: two launches, same bits.
constexpr int kDasrcThreads = 256;

template <int CF, typename T>
__global__ void __launch_bounds__(kDasrcThreads)
v5_dasrc_kernel(const T* __restrict__ h, const float* __restrict__ draw,
                const int* __restrict__ src_order,
                const int* __restrict__ src_ptr, int n_src, int d_feat,
                int nh, int flags, float* __restrict__ part, int stride) {
  __shared__ float s_tile[kDasrcThreads];  // (senders of a tile, nh)
  const int t = threadIdx.x;
  const int tile = kDasrcThreads / nh;
  const int per = (n_src + gridDim.x - 1) / gridDim.x;
  const int s_lo = min(blockIdx.x * per, n_src);
  const int s_hi = min(s_lo + per, n_src);
  const bool r_rows = flags & kRoundRows;
  float acc[CF][kMaxHeads];
#pragma unroll
  for (int c = 0; c < CF; ++c)
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k) acc[c][k] = 0.f;
  for (int s0 = s_lo; s0 < s_hi; s0 += tile) {
    const int cnt = min(tile, s_hi - s0);
    if (t < cnt * nh) {
      const int s = s0 + t / nh, k = t % nh;
      const int a = src_ptr[s], b = src_ptr[s + 1];
      float sum = 0.f;
#pragma unroll 4
      for (int i = a; i < b; ++i) sum += draw[(size_t)src_order[i] * nh + k];
      s_tile[t] = sum;
    }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < cnt; ++q) {
      const T* hrow = h + (size_t)(s0 + q) * d_feat;
#pragma unroll
      for (int c = 0; c < CF; ++c) {
        const int j = t + kDasrcThreads * c;
        if (j < d_feat) {
          const float hq = round_if(load_h(hrow + j), r_rows);
#pragma unroll
          for (int k = 0; k < kMaxHeads; ++k)
            if (k < nh) acc[c][k] += hq * s_tile[q * nh + k];
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < CF; ++c) {
    const int j = t + kDasrcThreads * c;
    if (j >= d_feat) continue;
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k)
      if (k < nh)
        part[(size_t)blockIdx.x * stride + (size_t)j * nh + k] = acc[c][k];
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
                       float* draw, int nblk, int flags, void* stream) {
  int bad = check_shape(d_feat, nh, nblk);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const int c_need = (d_feat + 31) / 32;
  // the wide form (C >= kWideC in ROWS_DISPATCH) writes draw, and its
  // d(a_src) is v5_dasrc's
  const bool wide = c_need > kWideC / 2;
  if (wide != (draw != nullptr)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
#define V5_BWD(CC)                                                          \
  {                                                                         \
    const size_t smem =                                                     \
        (CC >= kWideC ? (size_t)32 * CC : 2 * (size_t)d_feat) * nh *        \
        sizeof(float);                                                      \
    err = set_smem(v5_bwd_kernel<CC, MODE, T>, smem);                       \
    if (err == cudaSuccess)                                                 \
      v5_bwd_kernel<CC, MODE, T><<<nblk, kWarps * 32, smem, st>>>(          \
          h, a_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat, nh,   \
          f, slope, eps, flags, g, out, den, epsp, cap_in, d_h_rows,        \
          d_drop, d_sdst, dasrc_part, draw);                                \
  }
  ROWS_DISPATCH(V5_BWD)
#undef V5_BWD
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess || wide) return (int)err;
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
// the device. The wide form (d_feat > 256) takes draw (E, nh) and writes
// each edge's d(raw) there in place of d_asrc, which v5_dasrc then
// computes from it (draw is NULL at d_feat <= 256).
int v5_backward(const void* h, const float* a_src, const float* s_dst,
                const float* drop, const int* senders, const int* row_ptr,
                int n, int e_real, int d_feat, int nh, int f, float slope,
                const float* g, const float* out, const float* den,
                const float* epsp, float* d_h_rows, float* d_drop,
                float* d_sdst, float* dasrc_part, float* d_asrc, float* draw,
                int nblk, int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_v5_backward<Bwd::kNorm>(
        hp, a_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat, nh, f,
        slope, 0.f, g, out, den, epsp, nullptr, d_h_rows, d_drop, d_sdst,
        dasrc_part, d_asrc, draw, nblk, flags, stream);
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
                      float* draw, int nblk, int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_v5_backward<Bwd::kParts>(
        hp, a_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat, nh, f,
        slope, 0.f, d_num, nullptr, d_den, nullptr, nullptr, d_h_rows,
        d_drop, d_sdst, dasrc_part, d_asrc, draw, nblk, flags, stream);
  });
}

// Backward, 2-phase: the outputs of the normalised mode from g, out, den,
// the cap at `cap` and the plain eps; d_asrc_cap is (d_feat*nh + 1,):
// d(a_src) then d(cap). dasrc_part is (nblk, d_feat*nh + 1) scratch. The
// wide form writes draw as v5_backward's, and each block's -sum d(raw) in
// the last column of dasrc_part, for v5_dasrc.
int v5_backward_two_phase(const void* h, const float* a_src,
                          const float* s_dst, const float* cap,
                          const float* drop, const int* senders,
                          const int* row_ptr, int n, int e_real, int d_feat,
                          int nh, int f, float eps, float slope,
                          const float* g, const float* out, const float* den,
                          float* d_h_rows, float* d_drop, float* d_sdst,
                          float* dasrc_part, float* d_asrc_cap, float* draw,
                          int nblk, int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_v5_backward<Bwd::kTwoPhase>(
        hp, a_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat, nh, f,
        slope, eps, g, out, den, nullptr, cap, d_h_rows, d_drop, d_sdst,
        dasrc_part, d_asrc_cap, draw, nblk, flags, stream);
  });
}

// d(a_src) of the wide backward from its draw (E, nh): by sender, over
// the real edges in src_order with the offsets src_ptr (n_src + 1,), into
// the columns [0, d_feat*nh) of the (nblk, stride) partial rows, then
// out (stride,) = their ordered sum (stride = d_feat*nh + 1 in the 2-phase
// mode: the backward's d(cap) column is summed with them).
int v5_dasrc(const void* h, const float* draw, const int* src_order,
             const int* src_ptr, int n_src, int d_feat, int nh, float* part,
             int stride, float* out, int nblk, int flags, void* stream) {
  if (check_shape(d_feat, nh, nblk) || n_src < 0 || stride < d_feat * nh)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return with_table(h, flags, [&](auto hp) {
#define V5_DASRC(CF)                                                        \
  v5_dasrc_kernel<CF><<<nblk, kDasrcThreads, 0, st>>>(                      \
      hp, draw, src_order, src_ptr, n_src, d_feat, nh, flags, part, stride)
    if (d_feat <= kDasrcThreads) V5_DASRC(1);
    else if (d_feat <= 2 * kDasrcThreads) V5_DASRC(2);
    else if (d_feat <= 3 * kDasrcThreads) V5_DASRC(3);
    else V5_DASRC(4);
#undef V5_DASRC
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_partials_kernel<<<(stride + 255) / 256, 256, 0, st>>>(part, nblk,
                                                              stride, out);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
