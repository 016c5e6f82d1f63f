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
//   raw'[e,k] = s_src[src,k] + s_dst'[dst,k]   (s_dst' is B-shifted)
//   ex[e,k]   = exp(slope * raw'[e,k])
//   num[dst, k*f+j] += ex[e,k] * drop[e,k] * h[src, k*f+j]
//   den[dst, k]     += ex[e,k]                 (no dropout mask in den)
//   cap' = max raw', code = lowest e*nh + k attaining it
// with s_src = h @ a_src the source-score table (n_src, nh), written once
// per op call by source_scores (attention_common.cuh, source_scores_kernel;
// the wrapper hands it to every entry). The normalising epilogue
// out = num / (den + eps*exp(slope*cap')) runs in torch. The backward
// takes ex from the same table and emits the per-edge d(h) rows in dst
// order, d(drop), d(s_dst) per dst and d(a_src).
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
// Every mode takes raw = s_src[src, k] + s_dst[dst, k] from the one table
// of its op call: the cap pass, the forward and the backward get the same
// bits for the same edge, so the argmax edge has pre == 0 exactly and
// takes the slope.
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
// has no in-kernel random gather; Hopper has one. The sender's half of
// every logit depends on the sender alone, so it is a pass of its own
// (source_scores, h read once) and no kernel recomputes it per edge.
// The forward (v5_fwd_kernel: attention_fwd_wide and attention_fwd_narrow
// of attention_common.cuh, shared with window_attention.cu) takes each
// (edge, head)'s exp once, in the lane that owns the pair, and hands the
// weights out by shuffles; a lane's vector of the row belongs to one head
// (no select of a head per feature), loads are 16- or 8-byte vectors with
// several edges' in flight, and lanes fit the row: at f >= 32 a block of
// nh warps a destination, warp k head k; below, one warp a destination
// split into teams of lanes sized to the row, each team on its own edges.
// The lane plan (vector width, vectors a lane, lanes a row) comes from the
// wrapper (v5_attention.lane_plan), which the CPU tests check. The cap pass
// (v5_cap) is a stream over the E x nh scores (cap_stream_kernel). The
// backward is owned by senders (v5_bwd_sender_kernel, the body
// attention_bwd_by_sender of attention_common.cuh, shared with the
// windowed op): a warp takes an item, a run of at most L slots of one
// sender (build.sender_items: L a function of the edge count and the
// grid, a longer run cut into several in slot order, so that no warp
// walks a hub alone), reads the sender's h row and walks the item's slots
// in batches, gathering g[dst] and reading each destination's d(den),
// taken once a destination by the kernel's first launch (its instance
// DDEN), and sums the item's coef * g terms, then its d(raw) sums @
// a_src^T (each slot's whole term where a bfloat16 mode rounds it), into
// its d(h) row; a cut run's items write partial d(h) rows,
// which the tail (bwd_tail_kernel) adds in item order. Every
// output row is written by exactly one warp, block or tail thread, so no
// atomics are needed and the sums run in a fixed order: the results are
// bitwise reproducible.
// Cross-block reductions (the cap and its argmax, d(a_src), d(cap)) go
// through per-block partials over a fixed grid and a second, ordered pass.
// The float32 library runs every row width by sender; the bfloat16-table
// library instantiates plans of up to 8 elements a lane only, so rows
// wider than 256 floats from a bfloat16 table take the backward's older
// wide form (kWideC, one warp a destination): a per-lane d(a_src)
// accumulator there would not fit in registers, so the kernel writes each
// edge's d(raw) row and v5_dasrc_kernel takes d(a_src) by sender, h^T S
// with S the per-sender sums of those rows, and row 3 (segment_sum.cu)
// sums its per-edge d(h) rows by sender.
// The TPU's merged 2-phase launch (grid 2T: cap tiles, then attention
// tiles, the cap carried in VMEM scratch) has no counterpart here: blocks
// do not run in order, so the cap is a launch of its own (cap stream and
// its reduce) before the forward, in order on one stream, and reaches the
// forward through device memory with no host sync.
//
// What bounds it on the H100: by bytes, the h table read once and the
// edge arrays, a few MB at Cora size, about a microsecond at 3.35 TB/s;
// the gathered rows (E x nh*f elements) come from L2. The forward is a
// chain of three dependent loads a batch of edges (position, sender and
// score, row) and a few shuffles; the score pass and the cap reduce are
// launches of their own, so at Cora's size the launches set the floor.
// No wgmma or TMA: a row gather per edge is the access pattern.

#include "attention_common.cuh"

namespace {

// Rows wider than 256 floats (C >= 16 features a lane: PPI's 1024 and 726)
// from a bfloat16 table take the backward's wide form, v5_bwd_kernel below:
// per-edge d(h) rows, then row 3 (segment_sum.cu) by sender, and d(a_src)
// by v5_dasrc_kernel. Every other backward runs by sender
// (v5_bwd_sender_kernel, attention_common.cuh attention_bwd_by_sender),
// which writes d(h) per node.
constexpr int kWideC = 16;

// The plans of the backward by sender: every row of up to 1024 floats (32
// elements a lane) in the float32 library; up to 256 floats (8 elements a
// lane) in the bfloat16-table library, which instantiates no wide plan
#ifdef GAT_BF16_TABLE
constexpr int kBwdLimit = 8, kBwdMaxC = 8;
#else
constexpr int kBwdLimit = 32, kBwdMaxC = 32;
#endif

// The forward in both its modes (FwdArgs.two_phase): attention_fwd_wide
// at f >= 32 (a block of nh warps a destination), attention_fwd_narrow
// below (one warp a destination, teams of lanes), over the dst-sorted
// edges (perm NULL).
template <bool WIDE, int V, int C, int U, bool RACC, typename T>
__global__ void __launch_bounds__(kWarps * 32)
v5_fwd_kernel(const FwdArgs<T> a) {
  if constexpr (WIDE) {
    attention_fwd_wide<V, C, RACC, Src::kScores>(a);  // U = in_flight(C*V)
  } else {
    attention_fwd_narrow<V, C, U, RACC, Src::kScores>(a);
  }
}

// The backward by sender, every mode, over the dst-sorted edges (a slot is
// an edge, src_order's real prefix the sender runs) in the items of
// build.sender_items: d(h) per node, no per-edge rows and no row 3 after
// it. Its instance DDEN (one a table type, the plan's parameters unread)
// is the first launch in the normalised and 2-phase modes
// (launch_bwd_by_sender): each destination's d(den) into a.dden.
template <int V, int C, int U, bool AL, typename T, bool DDEN = false>
__global__ void __launch_bounds__(kWarps * 32, (kBwdBlocks<V, C>))
v5_bwd_sender_kernel(const BwdArgs<T> a) {
  if constexpr (DDEN) {
    bwd_dden(a);
  } else {
    attention_bwd_by_sender<V, C, U, AL>(a);
  }
}

// The wide form (C >= kWideC features a lane). One warp walks a
// destination's edges in order, lane l holding features l, l+32, ... of
// the sender's row and of g[dst]; the next edge's sender and row are in
// flight while this one is reduced. MODE (attention_common.cuh): kNorm
// reads eps' at `epsp`; kParts takes d(num) in `g` and d(den) in `den`
// (out, epsp, cap unread); kTwoPhase reads the cap at `cap`, uses the
// plain `eps`, and writes each block's -sum d(raw) in column d_feat*nh of
// its partial row. d(a_src) is not accumulated here: a per-lane
// accumulator, C x kMaxHeads floats beside the row, g and the per-head
// terms, came to 255 registers and spilled. Each edge's d(raw) row,
// rounded as d(a_src) reads it (kRoundDraw), goes to draw_out (E, nh),
// padding edges' 0, and v5_dasrc_kernel takes d(a_src) from it by sender.
template <int C, Bwd MODE, typename T>
__global__ void __launch_bounds__(kWarps * 32)
v5_bwd_kernel(const T* __restrict__ h, const float* __restrict__ a_src,
              const float* __restrict__ s_src,
              const float* __restrict__ s_dst, const float* __restrict__ drop,
              const int* __restrict__ senders,
              const int* __restrict__ row_ptr, int n, int e_real,
              int d_feat, int nh, int f, float slope, float eps, int flags,
              const float* __restrict__ g, const float* __restrict__ out,
              const float* __restrict__ den, const float* __restrict__ epsp,
              const float* __restrict__ cap_in, float* __restrict__ d_h_rows,
              float* __restrict__ d_drop, float* __restrict__ d_sdst,
              float* __restrict__ dasrc_part, float* __restrict__ draw_out) {
  static_assert(C >= kWideC, "the wide form");
  constexpr bool kTwo = MODE == Bwd::kTwoPhase;
  extern __shared__ float smem[];
  float* sa = smem;  // a_src transposed, (nh, 32 C), zero past d_feat
  __shared__ float wdcap[kWarps];
  // the head terms, a row of kMaxHeads each a warp: inv, d(den), s_dst,
  // the sum for d(s_dst), an edge's d(raw) and its coef
  enum { kInv, kDden, kSd, kSds, kDraw, kCoef, kTerms };
  __shared__ float wheads[kWarps * kTerms * kMaxHeads];
  float* wh = wheads + (threadIdx.x >> 5) * kTerms * kMaxHeads;
  // the products d(raw) @ a_src^T run over every lane's C features with
  // no test of each (a feature past d_feat gets 0)
  constexpr int kPad = 32 * C;
  for (int i = threadIdx.x; i < nh * kPad; i += blockDim.x) {
    const int j = i % kPad;
    sa[i] = j < d_feat ? a_src[j * nh + i / kPad] : 0.f;
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
    float inv[kMaxHeads], dden[kMaxHeads], sd[kMaxHeads];
#pragma unroll
    for (int c = 0; c < C; ++c)
      gv[c] = live[c] ? g[(size_t)d * d_feat + lane + 32 * c] : 0.f;
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k) {
      inv[k] = dden[k] = sd[k] = 0.f;
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

    const int lo = row_ptr[d];
    const int hi = min(row_ptr[d + 1], e_real);  // padding edges: see below
    // the next edge's sender and row in flight while this one is reduced
    float hn[C];
    int sn = 0;
    auto fetch = [&](int e_) {
      sn = senders[e_];
      const T* nrow = h + (size_t)sn * d_feat;
#pragma unroll
      for (int c = 0; c < C; ++c)
        hn[c] = live[c] ? load_h(nrow + lane + 32 * c) : 0.f;
    };
    if (lo < hi) fetch(lo);
    for (int e = lo; e < hi; ++e) {
      float* dhrow = d_h_rows + (size_t)e * d_feat;
      float hv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) hv[c] = hn[c];
      const int src = sn;
      if (e + 1 < hi) fetch(e + 1);
      // The heads in a loop that is not unrolled, their terms in shared
      // memory: the loop body holds q's sum of C = 16 or 32 features a
      // lane.
      float hq[C];  // the rows as q reads them
      if (r_rows) {
#pragma unroll
        for (int c = 0; c < C; ++c) hq[c] = round_bf16(hv[c]);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) hq[c] = hv[c];
      }
      // head k's terms from q = h[src] . g over the head's features and
      // the logit from the score table: d(raw), coef, d(drop), in order
      auto head_terms = [&](int k, float hg) {
        const float raw =
            s_src[(size_t)src * nh + k] + wh[kSd * kMaxHeads + k];
        const float m = drop ? drop[(size_t)e * nh + k] : 1.f;
        const float ik = wh[kInv * kMaxHeads + k];
        const float dk = wh[kDden * kMaxHeads + k];
        float ex, dr;
        if constexpr (kTwo) {
          const float pre = raw - cap;
          ex = expf(leaky(pre, slope));
          // the slope where pre <= 0: the argmax edge has pre == 0
          const float dlg = ex * (hg * ik * m + dk);
          dr = pre > 0.f ? dlg : slope * dlg;
          dcap += dr;
        } else {
          ex = expf(slope * raw);
          // d(raw') through the negative LeakyReLU branch (raw' <= cap')
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
      // a warp sum over each head's features, two heads at once (their
      // chains of adds interleave), q's terms selected, not branched to
      int k = 0;
#pragma unroll 1
      for (; k + 1 < nh; k += 2) {
        float r0 = 0.f, r1 = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          r0 = head[c] == k ? r0 + hq[c] * gv[c] : r0;
          r1 = head[c] == k + 1 ? r1 + hq[c] * gv[c] : r1;
        }
        const float q0 = warp_sum(r0), q1 = warp_sum(r1);
        head_terms(k, q0);
        head_terms(k + 1, q1);
      }
      if (k < nh) {
        float r0 = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c)
          r0 = head[c] == k ? r0 + hq[c] * gv[c] : r0;
        head_terms(k, warp_sum(r0));
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
    }
    if (lane < nh)
      d_sdst[(size_t)d * nh + lane] = wh[kSds * kMaxHeads + lane];
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
    if (lane < nh) draw_out[(size_t)e * nh + lane] = 0.f;
  }

  // the block's -sum d(raw) (kTwoPhase): warps add in a fixed order
  // (deterministic); dcap is the same on every lane of a warp
  if constexpr (kTwo) {
    if (lane == 0) wdcap[warp] = dcap;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += wdcap[w];
      dasrc_part[(size_t)blockIdx.x * (d_feat * nh + 1) + d_feat * nh] = -s;
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

// One forward launch over the plan (wide, vec, per_lane, lanes, unroll),
// then, in the sweep-1 mode, the cap reduce.
template <typename T>
int launch_v5_forward(const T* h, const float* s_src, const float* s_dst,
                      const float* drop, const int* senders,
                      const int* row_ptr, int n, int e_real, int d_feat,
                      int nh, int f, float slope, float eps, bool two_phase,
                      const float* cap_in, float* num, float* den,
                      float* blk_max, int* blk_code, float* cap, int* code,
                      int wide, int vec, int per_lane, int lanes,
                      int unroll, int nblk, int flags, void* stream) {
  const FwdArgs<T> a{h,      s_src, s_dst, drop,      senders, nullptr,
                     row_ptr, n,     e_real, d_feat,  nh,      f,
                     lanes,   slope, eps,   flags,     two_phase, cap_in,
                     num,     den,   blk_max, blk_code};
  return launch_attention_fwd<true, 8>(
      a, wide, vec, per_lane, unroll, nblk, cap, code, (cudaStream_t)stream,
      [](auto w, auto v, auto c, auto u, auto r) {
        return &v5_fwd_kernel<decltype(w)::value != 0, decltype(v)::value,
                              decltype(c)::value, decltype(u)::value,
                              decltype(r)::value != 0, T>;
      });
}

// The wide form's launch (rows over 256 floats from a bfloat16 table); its
// d(a_src) is v5_dasrc's, from draw
template <Bwd MODE, typename T>
int launch_v5_backward(const T* h, const float* a_src, const float* s_src,
                       const float* s_dst,
                       const float* drop, const int* senders,
                       const int* row_ptr, int n, int e_real, int d_feat,
                       int nh, int f, float slope, float eps, const float* g,
                       const float* out, const float* den, const float* epsp,
                       const float* cap_in, float* d_h_rows, float* d_drop,
                       float* d_sdst, float* dasrc_part, float* draw,
                       int nblk, int flags, void* stream) {
  int bad = check_shape(d_feat, nh, nblk);
  if (bad) return bad;
  const int c_need = (d_feat + 31) / 32;
  if (c_need <= kWideC / 2 || draw == nullptr)
    return (int)cudaErrorInvalidValue;  // v5_backward_by_sender's rows
  auto launch = [&](auto kern, int cc) {
    const size_t smem = (size_t)32 * cc * nh * sizeof(float);
    cudaError_t err = set_smem(kern, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<nblk, kWarps * 32, smem, (cudaStream_t)stream>>>(
        h, a_src, s_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat,
        nh, f, slope, eps, flags, g, out, den, epsp, cap_in, d_h_rows,
        d_drop, d_sdst, dasrc_part, draw);
    return (int)cudaGetLastError();
  };
  return c_need <= 16 ? launch(v5_bwd_kernel<16, MODE, T>, 16)
                      : launch(v5_bwd_kernel<32, MODE, T>, 32);
}

}  // namespace

extern "C" {

// Every entry: h is float32, or bfloat16 where flags has kBf16Table; flags
// is the bfloat16 mode's word (attention_common.cuh), 0 for float32.

// The source-score table s_src (n_src, nh) = h @ a_src, float32, over
// the plan (vec, per_lane, lanes) of v5_attention.score_plan; a_src
// (d_feat, nh). The windowed op's wrappers call this entry too.
int source_scores(const void* h, const float* a_src, int n_src, int d_feat,
                  int nh, int vec, int per_lane, int lanes, float* s_src,
                  int nblk, int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_source_scores(hp, a_src, n_src, d_feat, nh, vec, per_lane,
                                lanes, s_src, nblk, (cudaStream_t)stream);
  });
}

// Every forward takes the lane plan (wide, vec, per_lane, lanes, unroll)
// of v5_attention.lane_plan and the source-score table s_src (n_src, nh).

// Forward: num (n, d_feat), den (n, nh), cap (1,), code (1,).
// blk_max / blk_code are (nblk,) scratch. drop may be NULL.
int v5_forward(const void* h, const float* s_src, const float* s_dst,
               const float* drop, const int* senders, const int* row_ptr,
               int n, int e_real, int d_feat, int nh, int f, float slope,
               float* num, float* den, float* blk_max, int* blk_code,
               float* cap, int* code, int wide, int vec, int per_lane,
               int lanes, int unroll, int nblk, int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_v5_forward(hp, s_src, s_dst, drop, senders, row_ptr, n,
                             e_real, d_feat, nh, f, slope, 0.f, false,
                             nullptr, num, den, blk_max, blk_code, cap, code,
                             wide, vec, per_lane, lanes, unroll, nblk, flags,
                             stream);
  });
}

// The 2-phase cap pass, a stream over the real edges' scores: cap (1,) =
// max of s_src[senders[e], k] + s_dst[receivers[e], k] over e < e_real and
// the heads, code (1,) = its lowest e*nh + k; blk_max / blk_code are
// (nblk,) scratch. No h row is read, so the entry takes no flags.
int v5_cap(const float* s_src, const float* s_dst, const int* senders,
           const int* receivers, int e_real, int nh, float* blk_max,
           int* blk_code, float* cap, int* code, int nblk, void* stream) {
  return launch_cap_stream(s_src, s_dst, senders, receivers, e_real, nh,
                           blk_max, blk_code, cap, code, nblk, stream);
}

// The 2-phase forward: out (n, d_feat) normalised, den (n, nh), from the
// cap at `cap` (device memory). drop may be NULL.
int v5_forward_two_phase(const void* h, const float* s_src,
                         const float* s_dst, const float* cap,
                         const float* drop, const int* senders,
                         const int* row_ptr, int n, int e_real, int d_feat,
                         int nh, int f, float eps, float slope, float* out,
                         float* den, int wide, int vec, int per_lane,
                         int lanes, int unroll, int nblk, int flags,
                         void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_v5_forward(hp, s_src, s_dst, drop, senders, row_ptr, n,
                             e_real, d_feat, nh, f, slope, eps, true, cap,
                             out, den, nullptr, nullptr, nullptr, nullptr,
                             wide, vec, per_lane, lanes, unroll, nblk, flags,
                             stream);
  });
}

// Backward by sender, mode 0 (normalised: g = d(out), out and den the
// forward's, eps' at epsp on the device), 1 (parts: g = d(num), den =
// d(den); out, epsp and cap unread) or 2 (2-phase: the cap at `cap`, the
// plain eps), at every row width of the float32 library and at rows of 256
// floats or fewer of the bfloat16-table library. d_h (n_src, d_feat) per
// node, d_drop (e_total, nh) or NULL, d_sdst (n, nh), d_asrc (d_feat, nh)
// and in mode 2 d(cap) after it. items: the item table of the sender runs
// (build.SenderItems.table, n_items items, n_split cut runs). Scratch: dsd
// (e_total, nh), dsum (n_items, nh), part (nblk, d_feat*nh [+ 1]), dh_part
// (the cut runs' partial rows, d_feat; NULL where n_split is 0), dden (n,
// nh; unread in mode 1). receivers (e_total,); src_order and src_ptr
// (n_src + 1,): the real edges' sender runs (build.sender_runs); row_ptr
// (n + 1,): the edges' offsets by destination; (vec, per_lane, lanes,
// unroll): v5_attention.row_plan. Three launches in modes 0 and 2 (each
// destination's d(den), the kernel by sender and the tail), two in mode 1.
int v5_backward_by_sender(const void* h, const float* a_src,
                          const float* s_src, const float* s_dst,
                          const float* drop, const int* receivers,
                          const int* src_order, const int* src_ptr,
                          const int* row_ptr, const int* items,
                          int n_items, int n_split, int n_src, int n,
                          int e_real, int e_total, int d_feat, int nh, int f,
                          int mode, float slope, float eps, const float* g,
                          const float* out, const float* den,
                          const float* epsp, const float* cap, float* d_h,
                          float* d_drop, float* d_sdst, float* d_asrc,
                          float* dsd, float* dsum, float* part,
                          float* dh_part, float* dden, int vec, int per_lane,
                          int lanes, int unroll, int nblk, int flags,
                          void* stream) {
  if (mode < 0 || mode > 2 || e_real > e_total)
    return (int)cudaErrorInvalidValue;
  return with_table(h, flags, [&](auto hp) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(hp)>>;
    BwdArgs<T> a{hp,       a_src,     s_src,   s_dst,   drop,
                 receivers, src_order, src_ptr, nullptr, row_ptr,
                 n_src,    n,         e_total, e_real,  d_feat,
                 nh,       f,         lanes,   (Bwd)mode, slope,
                 eps,      flags,     g,       out,     den,
                 epsp,     cap,       d_h,     d_drop,  dsd,
                 dsum,     part,      0};
    a.items = items;
    a.n_items = n_items;
    a.n_split = n_split;
    a.dh_part = dh_part;
    a.dden = dden;
    return launch_bwd_by_sender<kBwdLimit, kBwdMaxC>(
        a, d_sdst, d_asrc, vec, per_lane, unroll, nblk, (cudaStream_t)stream,
        [](auto v, auto c, auto u, auto al, auto dd) {
          return &v5_bwd_sender_kernel<decltype(v)::value, decltype(c)::value,
                                       decltype(u)::value,
                                       decltype(al)::value != 0, T,
                                       decltype(dd)::value != 0>;
        });
  });
}

// The wide form (rows over 256 floats from a bfloat16 table), three
// entries, one a mode: d_h_rows
// (E, d_feat) in dst order, d_drop (E, nh) or NULL, d_sdst (n, nh), and
// draw (E, nh), each edge's d(raw), from which v5_dasrc takes d(a_src).
// Normalised mode: g = d(out), out and den the forward's, epsp points at
// eps' = eps*exp(slope*cap') on the device; dasrc_part is (nblk,
// d_feat*nh) scratch for v5_dasrc.
int v5_backward(const void* h, const float* a_src, const float* s_src,
                const float* s_dst, const float* drop, const int* senders,
                const int* row_ptr,
                int n, int e_real, int d_feat, int nh, int f, float slope,
                const float* g, const float* out, const float* den,
                const float* epsp, float* d_h_rows, float* d_drop,
                float* d_sdst, float* dasrc_part, float* draw, int nblk,
                int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_v5_backward<Bwd::kNorm>(
        hp, a_src, s_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat,
        nh, f, slope, 0.f, g, out, den, epsp, nullptr, d_h_rows, d_drop,
        d_sdst, dasrc_part, draw, nblk, flags, stream);
  });
}

// Parts mode: the same outputs from the raw cotangents d_num (n, d_feat)
// and d_den (n, nh) of the unnormalised parts.
int v5_backward_parts(const void* h, const float* a_src,
                      const float* s_src, const float* s_dst,
                      const float* drop, const int* senders,
                      const int* row_ptr, int n, int e_real, int d_feat,
                      int nh, int f, float slope, const float* d_num,
                      const float* d_den, float* d_h_rows, float* d_drop,
                      float* d_sdst, float* dasrc_part, float* draw,
                      int nblk, int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_v5_backward<Bwd::kParts>(
        hp, a_src, s_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat,
        nh, f, slope, 0.f, d_num, nullptr, d_den, nullptr, nullptr,
        d_h_rows, d_drop, d_sdst, dasrc_part, draw, nblk, flags, stream);
  });
}

// 2-phase: the outputs of the normalised mode from g, out, den, the cap at
// `cap` and the plain eps; dasrc_part is (nblk, d_feat*nh + 1) scratch,
// each block's -sum d(raw) in its last column, for v5_dasrc.
int v5_backward_two_phase(const void* h, const float* a_src,
                          const float* s_src, const float* s_dst,
                          const float* cap, const float* drop,
                          const int* senders,
                          const int* row_ptr, int n, int e_real, int d_feat,
                          int nh, int f, float eps, float slope,
                          const float* g, const float* out, const float* den,
                          float* d_h_rows, float* d_drop, float* d_sdst,
                          float* dasrc_part, float* draw, int nblk,
                          int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_v5_backward<Bwd::kTwoPhase>(
        hp, a_src, s_src, s_dst, drop, senders, row_ptr, n, e_real, d_feat,
        nh, f, slope, eps, g, out, den, nullptr, cap, d_h_rows, d_drop,
        d_sdst, dasrc_part, draw, nblk, flags, stream);
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
