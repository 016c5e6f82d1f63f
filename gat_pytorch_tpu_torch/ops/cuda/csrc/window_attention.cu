// Windowed whole-attention op over the block layout, for Hopper (sm_90a):
// forward and backward.
//
// Replaces the TPU kernels
//   gat_pytorch_tpu/ops/pallas/segment_attention_window.py:_kernel_v6
//     (block-layout "v7" form, single-sweep "v10" mode, float32
//      contractions; launched by _forward_v6 for fused_gat_window_v7)
//   gat_pytorch_tpu/ops/pallas/segment_attention_window.py:_kernel_v6_bwd
//     (the same form and mode, launched by backward_v6: normalize=True for
//      the normalised op, normalize=False for the sweep-1 parts op
//      v7_sweep1_parts, whose forward is the same _kernel_v6)
//   and both in their 2-phase (sweep1=False) mode, the v7 form under
//   GAT_TPU_V10=0: window_cap (the phase-0 cap sweep of _kernel_v6),
//   window_forward_two_phase (its phase 1) and window_backward's 2-phase
//   mode; and, for this op, the d(h) reduction that the JAX package runs
//   after the backward (segment_attention_window.py's per-slot d(h) rows,
//   segment_sum.py:_kernel_rows_nt): here the backward sums d(h) by sender.
//
// Contract. The edges live in layout slots: grouped per nb-row destination
// tile, sender-sorted within a tile, padded per block to eb slots; a pad
// slot has recv == -1 and contributes nothing. Per real slot s = (send,
// recv) and head k:
//   raw'[s,k] = s_src[send,k] + s_dst'[recv,k]  (s_dst' B-shifted)
//   ex[s,k]   = exp(slope * raw'[s,k])
//   num[recv, k*f+j] += ex[s,k] * drop[s,k] * h[send, k*f+j]
//   den[recv, k]     += ex[s,k]                (no dropout mask in den)
//   cap' = max raw', code = lowest s*nh + k attaining it
// with s_src = h @ a_src the source-score table (n, nh), written once per
// op call by the v5 library's source_scores entry (attention_common.cuh
// source_scores_kernel). drop is (E7, nh) in slot order. The normalising
// epilogue out = num / (den + eps*exp(slope*cap')) and the cap cotangent
// run in torch. The backward takes ex from the same table and emits d(h)
// per node, each sender's slots' terms summed (the TPU kernel's per-slot
// rows, which the JAX package reduces by sender after it, are never
// written), d(drop) per slot (0 on pad slots), d(s_dst) per destination
// and d(a_src). Its modes (Bwd, attention_common.cuh) are those of
// v5_attention.cu: the normalised mode takes g, out, den and eps' and
// derives inv and d(den) itself; the parts mode takes the raw cotangents
// d(num) and d(den) of the unnormalised parts from a caller that
// differentiates its own epilogue. The 2-phase entries are those of
// v5_attention.cu over the slots: window_cap (max raw, lowest slot*nh +
// k), window_forward_two_phase (exp(leaky(raw - cap)), out = num / (den +
// eps)), and the backward's 2-phase mode (the full LeakyReLU's derivative
// and d(cap) = -sum d(raw)); every mode takes raw from the one score table
// of its op call, so the argmax slot has raw - cap == 0 exactly.
// The bfloat16 payload mode (GAT_TPU_V6_DTYPE, the JAX package's default)
// comes in through the flags word (attention_common.cuh): a bfloat16 h
// table (kBf16Table) where the JAX kernel packs the window and takes the
// logits from the rounded rows, else the float32 rows rounded after the
// logits (kRoundRows: the table is taken from the float32 rows);
// kRoundAcc in the forwards; kRoundPayload, kRoundDh, kRoundDraw and
// kRoundDsdst in the backwards. The 2-phase d(cap) sums the float32
// d(raw), and the cap pass, a stream over the table, has no such mode.
//
// Design. The TPU kernel streams a window of the node table into VMEM per
// destination tile and gathers from it with one-hot matrix products, per
// eb-slot block against a wb-row slice, because Mosaic has no in-kernel
// row gather; `window`, `wb`, `base`, `tile_base` and `dmax` size those
// streams. Hopper gathers rows directly, so none of them reaches the
// kernels. What the kernels walk is the layout's slot order through two
// index arrays computed once with the layout: dst_perm lists the slots by
// destination (stable, so still sender-sorted within a row, pad slots
// last) and dst_ptr cuts it into per-row runs; pad slots are never
// visited: dst_ptr[n] is the count of real slots. The forward
// (window_fwd_kernel) is the v5 op's (attention_fwd_wide and
// attention_fwd_narrow of attention_common.cuh) over these runs: a batch's
// positions are read together, so dst_perm[i], then send[slot], the score
// and drop[slot, :] come as one batch of independent loads, not one
// dependent chain a slot; each (slot, head)'s exp is taken once and handed
// out by shuffles; a lane's vector belongs to one head, or is tested per
// element where a head starts mid-vector (Pubmed's 8 x 3); lanes are
// grouped to fit the row (at 8 x 8, teams of 16 lanes with float4 loads,
// two slots at once). The cap pass is the v5 op's stream over the real
// slots' scores (cap_stream_kernel).
//
// The backward is owned by senders (window_bwd_kernel, whose body,
// attention_bwd_by_sender of attention_common.cuh, the v5 op's backward
// shares over its dst-sorted edges): a warp takes an item, a run of at
// most L slots of a sender's run of src_perm (the real slots by sender;
// build.sender_items cuts a longer run into items whose partial d(h) rows
// the tail adds in item order), reads the sender's h row once and walks
// the item in batches, a lane a (slot, head) taking the slot's
// destination, payload, d(den) and exp once, teams of lanes sized to the
// row (the forward's) gathering g[dst] for a slot each; the per-head dots
// h . g of a team are reduced together (team_sums), and the slots' coef * g
// terms are added in ascending position of the run, from 0, so no (E7, d)
// rows are written or read back. d(den) = -inv * sum out * g, a
// destination's, is a launch of its own before the walk (bwd_dden);
// d(s_dst), each destination's slots' terms summed in dst_perm order, is
// the tail's (bwd_tail_kernel), which also adds the blocks' d(a_src) [|
// d(cap)] partial rows in row order. d(h)'s d(raw) @ a_src^T and d(a_src)
// = h^T S take S, each item's d(raw) summed over its slots: the products
// once an item (each slot's whole d(h) term where a bfloat16 mode rounds
// it). Every output row has one writer and a fixed order of sums: no
// atomics, bitwise reproducible; the cap with its argmax code, d(a_src)
// and d(cap) go through per-block partials over a fixed grid and an
// ordered second pass.
//
// What the layout can buy on this card is locality: the warps of the grid
// work on neighbouring rows at the same time, whose neighbours sit in a
// narrow id window after the RCM reorder, so the gathered rows hit in L2.
// While the whole table fits the 50 MB L2 (5 MB at Pubmed size) the order
// of the reads matters little (PERF.md).
//
// What bounds it on the H100: by bytes, the h table, the slot arrays, the
// dropout mask and the outputs, a few MB at Pubmed size (microseconds at
// 3.35 TB/s). Pubmed averages 5.5 real slots a destination (and a
// sender), so a row is one or two batches: three dependent loads
// (position, slot's sender or destination and its scores, row) and a few
// shuffles each, besides the launches of the score pass, the backward's
// tail and, in the 2-phase form, of the cap stream and its reduce.

#include "attention_common.cuh"

namespace {

// The forward in both its modes over the layout's per-destination runs
// (FwdArgs.perm = dst_perm): the kernel of v5_fwd_kernel
// (v5_attention.cu).
template <bool WIDE, int V, int C, int U, bool RACC, typename T>
__global__ void __launch_bounds__(kWarps * 32)
window_fwd_kernel(const FwdArgs<T> a) {
  if constexpr (WIDE) {
    attention_fwd_wide<V, C, RACC, Src::kScores>(a);  // U = in_flight(C*V)
  } else {
    attention_fwd_narrow<V, C, U, RACC, Src::kScores>(a);
  }
}

// The backward by sender over the layout's slots (attention_common.cuh,
// attention_bwd_by_sender, shared with the v5 op's v5_bwd_sender_kernel);
// its instance DDEN is the d(den) launch before it (bwd_dden)
template <int V, int C, int U, bool AL, typename T, bool DDEN = false>
__global__ void __launch_bounds__(kWarps * 32, (kBwdBlocks<V, C>))
window_bwd_kernel(const BwdArgs<T> a) {
  if constexpr (DDEN) {
    bwd_dden(a);
  } else {
    attention_bwd_by_sender<V, C, U, AL>(a);
  }
}

// The bfloat16-table library (-DGAT_BF16_TABLE) serves the packed window
// only, whose rows are nh*f <= 64 wide (a narrow plan of at most 4
// elements a lane in the forward; in the backward one vector a lane, or two
// single elements at 32 lanes), and has no 2-phase entries (the packed
// window is a single-sweep form).
#ifdef GAT_BF16_TABLE
constexpr bool kWindowWide = false;
constexpr int kWindowNarrow = 4;
constexpr int kBwdLimit = 4, kBwdMaxC = 2;
#else
constexpr bool kWindowWide = true;
constexpr int kWindowNarrow = 8;
constexpr int kBwdLimit = 32, kBwdMaxC = 32;
#endif

// One forward launch over the plan (wide, vec, per_lane, lanes, unroll),
// then, in the sweep-1 mode, the cap reduce.
template <typename T>
int launch_window_forward(const T* h, const float* s_src,
                          const float* s_dst, const float* drop,
                          const int* send, const int* dst_perm,
                          const int* dst_ptr, int n, int d_feat, int nh,
                          int f, float slope, float eps, bool two_phase,
                          const float* cap_in, float* num, float* den,
                          float* blk_max, int* blk_code, float* cap,
                          int* code, int wide, int vec, int per_lane,
                          int lanes, int unroll, int nblk, int flags,
                          void* stream) {
  const FwdArgs<T> a{h,       s_src, s_dst,   drop,    send,      dst_perm,
                     dst_ptr, n,     INT_MAX, d_feat,  nh,        f,
                     lanes,   slope, eps,     flags,   two_phase, cap_in,
                     num,     den,   blk_max, blk_code};
  return launch_attention_fwd<kWindowWide, kWindowNarrow>(
      a, wide, vec, per_lane, unroll, nblk, cap, code, (cudaStream_t)stream,
      [](auto w, auto v, auto c, auto u, auto r) {
        return &window_fwd_kernel<decltype(w)::value != 0, decltype(v)::value,
                                  decltype(c)::value, decltype(u)::value,
                                  decltype(r)::value != 0, T>;
      });
}

}  // namespace

extern "C" {

// Every entry but window_cap: h is float32, or bfloat16 where flags has
// kBf16Table (the library built with -DGAT_BF16_TABLE, which has
// window_forward and window_backward in modes 0 and 1 only); flags
// is the bfloat16 mode's word (attention_common.cuh), 0 for float32.
// s_src (n, nh) is the source-score table (the v5 library's
// source_scores); the forwards take the lane plan (wide, vec, per_lane,
// lanes, unroll) of v5_attention.lane_plan.

// Forward: num (n, d_feat), den (n, nh), cap (1,), code (1,).
// send (e7,), dst_perm (e7,), dst_ptr (n + 1,); blk_max / blk_code are
// (nblk,) scratch. drop (e7, nh) may be NULL.
int window_forward(const void* h, const float* s_src, const float* s_dst,
                   const float* drop, const int* send, const int* dst_perm,
                   const int* dst_ptr, int n, int d_feat, int nh, int f,
                   float slope, float* num, float* den, float* blk_max,
                   int* blk_code, float* cap, int* code, int wide, int vec,
                   int per_lane, int lanes, int unroll, int nblk, int flags,
                   void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_window_forward(hp, s_src, s_dst, drop, send, dst_perm,
                                 dst_ptr, n, d_feat, nh, f, slope, 0.f, false,
                                 nullptr, num, den, blk_max, blk_code, cap,
                                 code, wide, vec, per_lane, lanes, unroll,
                                 nblk, flags, stream);
  });
}

#ifndef GAT_BF16_TABLE
// The 2-phase cap pass, a stream over the real slots' scores: cap (1,) =
// max of s_src[send[s], k] + s_dst[recv[s], k] over the slots s < e7 with
// recv[s] >= 0 and the heads, code (1,) = its lowest s*nh + k; blk_max /
// blk_code are (nblk,) scratch.
int window_cap(const float* s_src, const float* s_dst, const int* send,
               const int* recv, int e7, int nh, float* blk_max,
               int* blk_code, float* cap, int* code, int nblk,
               void* stream) {
  return launch_cap_stream(s_src, s_dst, send, recv, e7, nh, blk_max,
                           blk_code, cap, code, nblk, stream);
}

// The 2-phase forward: out (n, d_feat) normalised, den (n, nh), from the
// cap at `cap` (device memory). drop (e7, nh) may be NULL.
int window_forward_two_phase(const void* h, const float* s_src,
                             const float* s_dst, const float* cap,
                             const float* drop, const int* send,
                             const int* dst_perm, const int* dst_ptr, int n,
                             int d_feat, int nh, int f, float eps,
                             float slope, float* out, float* den, int wide,
                             int vec, int per_lane, int lanes, int unroll,
                             int nblk, int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_window_forward(hp, s_src, s_dst, drop, send, dst_perm,
                                 dst_ptr, n, d_feat, nh, f, slope, eps, true,
                                 cap, out, den, nullptr, nullptr, nullptr,
                                 nullptr, wide, vec, per_lane, lanes, unroll,
                                 nblk, flags, stream);
  });
}

#endif  // GAT_BF16_TABLE

// Backward by sender, mode 0 (normalised: g = d(out), out and den the
// forward's, eps' at epsp on the device), 1 (parts: g = d(num), den =
// d(den); out, epsp and cap unread) or 2 (2-phase: the cap at `cap`, the
// plain eps; not in the bfloat16-table library). h and s_src have n_src
// rows, the destinations n (fewer on a dst-owned shard's layout, whose
// senders index the whole table). d_h (n_src, d_feat), d_drop (e7, nh) or
// NULL, d_sdst (n, nh), d_asrc (d_feat, nh) and in mode 2 d(cap) after
// it. items: the item table of the layout's sender runs
// (build.SenderItems.table, n_items items, n_split cut runs). Scratch: dsd
// (e7, nh), dsum (n_items, nh), part (nblk, d_feat*nh [+ 1]), dh_part (the
// cut runs' partial rows, d_feat; NULL where n_split is 0), dden (n, nh;
// unread in mode 1). recv, src_perm, dst_perm (e7,), src_ptr (n_src + 1,),
// dst_ptr (n + 1,): the layout's; (vec, per_lane, lanes, unroll):
// v5_attention.row_plan.
int window_backward(const void* h, const float* a_src, const float* s_src,
                    const float* s_dst, const float* drop, const int* recv,
                    const int* src_perm, const int* src_ptr,
                    const int* dst_perm, const int* dst_ptr,
                    const int* items, int n_items, int n_split, int n_src,
                    int n, int e7,
                    int d_feat, int nh, int f, int mode, float slope,
                    float eps, const float* g, const float* out,
                    const float* den, const float* epsp, const float* cap,
                    float* d_h, float* d_drop, float* d_sdst, float* d_asrc,
                    float* dsd, float* dsum, float* part, float* dh_part,
                    float* dden, int vec, int per_lane, int lanes,
                    int unroll, int nblk, int flags, void* stream) {
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
#ifdef GAT_BF16_TABLE
  if (mode == 2) return (int)cudaErrorInvalidValue;
#endif
  return with_table(h, flags, [&](auto hp) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(hp)>>;
    // every slot of dst_perm's runs is real (e_real: no bound)
    BwdArgs<T> a{hp,       a_src,   s_src,    s_dst,   drop,
                 recv,     src_perm, src_ptr, dst_perm, dst_ptr,
                 n_src,    n,       e7,       INT_MAX, d_feat,
                 nh,       f,       lanes,    (Bwd)mode, slope,
                 eps,      flags,   g,        out,     den,
                 epsp,     cap,     d_h,      d_drop,  dsd,
                 dsum,     part,    0};
    a.items = items;
    a.n_items = n_items;
    a.n_split = n_split;
    a.dh_part = dh_part;
    a.dden = dden;
    return launch_bwd_by_sender<kBwdLimit, kBwdMaxC>(
        a, d_sdst, d_asrc, vec, per_lane, unroll, nblk, (cudaStream_t)stream,
        [](auto v, auto c, auto u, auto al, auto dd) {
          return &window_bwd_kernel<decltype(v)::value, decltype(c)::value,
                                    decltype(u)::value,
                                    decltype(al)::value != 0, T,
                                    decltype(dd)::value != 0>;
        });
  });
}

}  // extern "C"
