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
// takes ex from the same table and writes d(h) per node (summed by
// sender), d(drop), d(s_dst) per dst and d(a_src).
// It has two modes besides the 2-phase one (the mode argument of
// v5_backward_by_sender):
//   kNorm       takes the cotangent g of out with out, den and eps' and
//               derives inv = 1/(den + eps') and d(den) = -(g . out) * inv
//               per destination and head itself;
//   kParts      takes the raw cotangents d(num) (n, d_feat) and d(den)
//               (n, nh) of the unnormalised parts, as a caller hands them
//               over that differentiates its own epilogue (the hybrid
//               layer sums the parts of two ops first): per edge
//               d(raw') = slope * ex * (m * (h[src] . d_num[dst])_k
//                                       + d_den[dst,k]),
//               d(h) term = d(raw') @ a_src^T + ex * m * d_num[dst],
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
// Both libraries, the float32 one and the bfloat16-table one, run every
// row width by sender: at 16 or more elements a lane an item's sums and
// its sender's row live in shared memory as float32, whatever the table's
// element type.
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

// The plans of the backward by sender: every row of up to 1024 floats (32
// elements a lane), in both libraries
constexpr int kBwdLimit = 32, kBwdMaxC = 32;

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
// plain eps), at every row width. d_h (n_src, d_feat) per node, d_drop (e_total, nh) or NULL, d_sdst (n, nh), d_asrc (d_feat, nh)
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

}  // extern "C"
