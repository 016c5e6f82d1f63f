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
// The backward is owned by senders (window_bwd_kernel): a warp takes a
// sender, reads its own h row once and walks its run of src_perm (the real
// slots by sender) in batches, a lane a (slot, head) taking the slot's
// destination, payload and exp once, teams of lanes sized to the row (the
// forward's) gathering g[dst] for a slot each; the per-head dots h . g of
// a team are reduced together (team_sums), and the slots' d(h) terms are
// added in ascending position of the run, from 0, with no contraction: the
// order of the per-slot rows' reduction by sender that it replaces
// (segment_sum.cu), so no (E7, d) rows are written or read back. d(den)
// = -inv * sum out * g, a destination's, is taken per slot from out[dst]
// gathered beside g[dst] (a second row from L2, where a prologue of its
// own would be a third launch); d(s_dst), each destination's slots' terms
// summed in dst_perm order, is the tail's (window_bwd_tail_kernel), which
// also adds the blocks' d(a_src) [| d(cap)] partial rows in row order. d(a_src) is h^T S with S each sender's d(raw)
// summed over its slots: the products once a sender. Every output row has
// one writer and a fixed order of sums: no atomics, bitwise reproducible;
// the cap with its argmax code, d(a_src) and d(cap) go through per-block
// partials over a fixed grid and an ordered second pass.
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
    attention_fwd_wide<V, C, RACC>(a);  // U = in_flight(C * V)
  } else {
    attention_fwd_narrow<V, C, U, RACC>(a);
  }
}

// The backward by sender, every mode (Bwd of attention_common.cuh, a
// runtime argument here: the modes differ in a few scalars a (slot, head)).
template <typename T>
struct BwdArgs {
  const T* h;            // (n, d_feat): the table the forward read
  const float* a_src;    // (d_feat, nh)
  const float* s_src;    // (n, nh): the source-score table
  const float* s_dst;    // (n, nh)
  const float* drop;     // (e7, nh) or NULL
  const int* recv;       // (e7,)
  const int* src_perm;   // (e7,): the real slots by sender
  const int* src_ptr;    // (n + 1,)
  const int* dst_perm;   // (e7,): the slots by destination, pad slots last
  const int* dst_ptr;    // (n + 1,)
  int n, e7, d_feat, nh, f, lanes;
  Bwd mode;
  float slope, eps;      // eps: the 2-phase mode's plain eps
  int flags;
  const float* g;        // d(out), or d(num) in the parts mode
  const float* out;      // the forward's output; NULL in the parts mode
  const float* den;      // the forward's den, or d(den) in the parts mode
  const float* epsp;     // kNorm: eps' on the device
  const float* cap_in;   // kTwoPhase: the cap on the device
  float* d_h;            // (n, d_feat)
  float* d_drop;         // (e7, nh) or NULL
  float* dsd;            // (e7, nh) scratch: each slot's d(s_dst) term
  float* dsum;           // (n, nh) scratch: each sender's d(raw) summed
  float* part;           // (gridDim.x, stride): d(a_src) [| -d(cap)]
  int stride;
};

// Warp w of block b owns the senders b * kWarps + w, then every
// gridDim.x * kWarps-th after it, in teams of `lanes` lanes that each hold
// a whole row (RowLanes). A batch is 32 / nh positions of the sender's run
// of src_perm: lane i * nh + k takes slot i's index, destination, head k's
// den (inv, rounded where kRoundPayload), s_dst entry and mask entry, and
// its exp once. Team g gathers g[dst] of the slots i0 + u * teams + g, U of
// them in flight, and reads out[dst] into the dots as it arrives; the
// per-head dots out . g and h . g reach the slot's lane, which takes
// d(den) = -inv * out . g (before g is rounded: kRoundPayload rounds the
// payload after d(den) is taken from it), d(raw), d(drop) and the slot's
// d(s_dst) term. Where a head is whole lanes of one vector each (C = 1, V
// divides f: Pubmed's 8 x 8, Cora's 1 x 7), a head's dot is a sum over its
// f / V lanes (the instance AL); elsewhere (Pubmed's 8 x 3, whose vectors
// of 4 meet two heads) each lane sums its elements per head and team_sums
// reduces all heads together. Each team then takes its slot's
// d(h) term, round_if(d(raw) @ a_src^T + coef * g, kRoundDh), and every
// lane adds the teams' terms in slot order, so that a sender's d(h) row is
// the sum of its slots' terms in ascending position of its run, from 0,
// with no contraction: the order in which segment_sum.cu reduced the
// per-slot rows. At 16 or more elements a lane (one team a warp) the sums
// live in shared memory and the sender's own row is read per slot (from
// L1): held in registers beside a g row, they spilled. Each sender's d(raw)
// sums (kRoundDraw) go to dsum; at the end the block takes its senders'
// h^T dsum into its partial row of d(a_src) (the products once a sender).
template <int V, int C>
constexpr bool kWideRow = V * C >= 16;

// AL: heads of whole lanes (C == 1, V divides f), the fast path below
template <int V, int C, int U, bool AL, typename T>
__global__ void __launch_bounds__(kWarps * 32, 1)
window_bwd_kernel(const BwdArgs<T> a) {
  constexpr bool kWide = kWideRow<V, C>;
  extern __shared__ float smem[];
  float* sa = smem;  // a_src transposed, (nh, d_feat)
  __shared__ float wdcap[kWarps];
  const int d_feat = a.d_feat, nh = a.nh, lanes = a.lanes;
  for (int i = threadIdx.x; i < d_feat * nh; i += blockDim.x)
    sa[(i % nh) * d_feat + i / nh] = a.a_src[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // kWide: this warp's sums, (d_feat,); one team, so one lane an element
  float* sacc = smem + d_feat * nh + warp * d_feat;
  const RowLanes<V, C> r(lane, lanes, d_feat, a.f);
  const int teams = r.teams;
  const int per = 32 / nh;                            // positions a batch
  const int mine = lane / nh, kh = lane - mine * nh;  // (slot, head) owned
  // heads of whole lanes: hl lanes a head
  static_assert(!AL || C == 1, "whole-lane heads take one vector a lane");
  const int hl = a.f / V;
  const bool hl_pow2 = !(hl & (hl - 1));
  const int from = AL ? kh * hl : kh * (lanes / kMaxHeads);
  const bool two = a.mode == Bwd::kTwoPhase, parts = a.mode == Bwd::kParts;
  const float eps_p = a.mode == Bwd::kNorm ? *a.epsp : a.eps;
  const float cap = two ? *a.cap_in : 0.f, slope = a.slope;
  const bool r_rows = a.flags & kRoundRows, r_pay = a.flags & kRoundPayload,
             r_dh = a.flags & kRoundDh, r_draw = a.flags & kRoundDraw,
             r_sds = a.flags & kRoundDsdst;
  float dcap = 0.f;

  // the sum over head (lane / hl)'s lanes of x, in every one of them
  auto head_sum = [&](float x) {
    if (hl_pow2) {
      for (int o = hl >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
      return x;
    }
    const int first = lane - r.t % hl;
    float s = 0.f;
    for (int o = 0; o < hl; ++o) s += __shfl_sync(kFull, x, (first + o) & 31);
    return s;
  };

  // pad slots (the tail of dst_perm) get a zero dropout cotangent
  if (a.d_drop) {
    const int n_real = a.dst_ptr[a.n], pads = (a.e7 - n_real) * nh;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < pads;
         i += gridDim.x * blockDim.x)
      a.d_drop[(size_t)a.dst_perm[n_real + i / nh] * nh + i % nh] = 0.f;
  }

  for (int s = blockIdx.x * kWarps + warp; s < a.n;
       s += gridDim.x * kWarps) {
    // the sender's own row, rounded where kRoundRows (the dots and d(a_src)
    // read it so)
    const T* hrow = a.h + (size_t)s * d_feat;
    auto own = [&](int c, float (&x)[V]) {
      Vec<T, V> y;
      if (r.live(c)) {
        y.load(hrow + r.j0(c));
      } else {
        y.zero();
      }
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = round_if(y.e(v), r_rows);
    };
    float hv[kWide ? 1 : C][V], acc[kWide ? 1 : C][V];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if constexpr (kWide) {
        if (r.live(c)) {
#pragma unroll
          for (int v = 0; v < V; ++v) sacc[r.j0(c) + v] = 0.f;
        }
      } else {
        own(c, hv[c]);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[c][v] = 0.f;
      }
    }
    const float ss = a.s_src[(size_t)s * nh + kh];
    float dsa = 0.f;  // lane (i, k): its slots' d(raw) as d(a_src) reads it
    const int lo = a.src_ptr[s], hi = a.src_ptr[s + 1];
    for (int b = lo; b < hi; b += per) {
      const int cnt = min(per, hi - b);
      const bool mine_ok = mine < cnt;
      int slot = 0, dst = 0;
      float ex = 0.f, m = 1.f, inv = 0.f, inv_p = 0.f, dn = 0.f, coef = 0.f,
            pre = 0.f;
      if (mine_ok) {
        slot = a.src_perm[b + mine];
        dst = a.recv[slot];
        const size_t dk = (size_t)dst * nh + kh;
        dn = a.den[dk];
        // the caller's epilogue owns the quotient in the parts mode
        inv = parts ? 1.f : dn > 0.f ? 1.f / (dn + eps_p) : 0.f;
        inv_p = round_if(inv, r_pay);  // the payload's, rounded
        if (a.drop) m = a.drop[(size_t)slot * nh + kh];
        const float raw = ss + a.s_dst[dk];
        if (two) {
          pre = raw - cap;
          ex = expf(leaky(pre, slope));
        } else {
          ex = expf(slope * raw);
        }
        coef = ex * m * inv_p;
      }
      for (int i0 = 0; i0 < cnt; i0 += teams * U) {
        // team g takes the slot i0 + u * teams + g: U rows of g in flight
        float gv[U][C][V];
        int base[U];  // the lane of (the team's slot, head 0)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (i0 + u * teams >= cnt) break;  // the same for every lane
          const int i = i0 + u * teams + r.g;
          base[u] = (i * nh) & 31;
          const int du = __shfl_sync(kFull, dst, base[u]);
          const float* grow = a.g + (size_t)du * d_feat;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (i < cnt && r.live(c)) {
              load_vec<V>(grow + r.j0(c), gv[u][c]);
            } else {
#pragma unroll
              for (int v = 0; v < V; ++v) gv[u][c][v] = 0.f;
            }
          }
        }
        // slot by slot of the U in flight: the per-head dots out . g
        // (d(den), from the unrounded g) and h . g (from the payload's g),
        // the slot's lane's d(raw), then the team's d(h) term
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (i0 + u * teams >= cnt) break;  // the same for every lane
          const int i = i0 + u * teams + r.g;
          const float* orow =
              a.out + (size_t)__shfl_sync(kFull, dst, base[u]) * d_feat;
          float red_og = 0.f, red_hg;
          if constexpr (AL) {  // C == 1: the lane's vector is one head's
            float xo = 0.f, xh = 0.f;
            if (!parts) {
              float ov[V];
              if (i < cnt && r.live(0)) {
                load_vec<V>(orow + r.j0(0), ov);
              } else {
#pragma unroll
                for (int v = 0; v < V; ++v) ov[v] = 0.f;
              }
#pragma unroll
              for (int v = 0; v < V; ++v) xo = fmaf(ov[v], gv[u][0][v], xo);
              red_og = head_sum(xo);
            }
#pragma unroll
            for (int v = 0; v < V; ++v) {
              gv[u][0][v] = round_if(gv[u][0][v], r_pay);
              xh = fmaf(hv[0][v], gv[u][0][v], xh);  // never a wide row
            }
            red_hg = head_sum(xh);
          } else {
            float q[kMaxHeads];
            if (!parts) {
#pragma unroll
              for (int k = 0; k < kMaxHeads; ++k) q[k] = 0.f;
#pragma unroll
              for (int c = 0; c < C; ++c) {
                float ov[V];
                if (i < cnt && r.live(c)) {
                  load_vec<V>(orow + r.j0(c), ov);
                } else {
#pragma unroll
                  for (int v = 0; v < V; ++v) ov[v] = 0.f;
                }
                r.add_head_dots(ov, gv[u][c], c, q);
              }
              red_og = team_sums<kMaxHeads>(q, lane, lanes);
            }
            if (r_pay) {
#pragma unroll
              for (int c = 0; c < C; ++c)
#pragma unroll
                for (int v = 0; v < V; ++v)
                  gv[u][c][v] = round_bf16(gv[u][c][v]);
            }
#pragma unroll
            for (int k = 0; k < kMaxHeads; ++k) q[k] = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              float x[V];
              if constexpr (kWide) {
                own(c, x);
              } else {
#pragma unroll
                for (int v = 0; v < V; ++v) x[v] = hv[c][v];
              }
              r.add_head_dots(x, gv[u][c], c, q);
            }
            red_hg = team_sums<kMaxHeads>(q, lane, lanes);
          }
          // lane (i, k) of a slot of this u takes its dots for head k
          const int gg = mine - i0 - u * teams;  // the team of slot mine
          const int src = ((gg & (teams - 1)) * lanes + from) & 31;
          const float hg = __shfl_sync(kFull, red_hg, src);
          const float og = parts ? 0.f : __shfl_sync(kFull, red_og, src);
          float draw = 0.f;
          if (mine_ok && gg >= 0 && gg < teams) {
            const float dd = round_if(parts ? dn : -og * inv, r_pay);
            const float q = hg * inv_p * m + dd;
            if (two) {
              // the slope where pre <= 0: the argmax slot has pre == 0
              const float dlg = ex * q;
              draw = pre > 0.f ? dlg : slope * dlg;
              dcap += draw;
            } else {
              // d(raw') through the negative LeakyReLU branch
              draw = slope * ex * q;
            }
            const size_t sk = (size_t)slot * nh + kh;
            if (a.d_drop) a.d_drop[sk] = hg * ex * inv_p;
            a.dsd[sk] = round_if(draw, r_sds);
            dsa += round_if(draw, r_draw);
          }
          // the team's d(h) term of its slot, a vector at a time; every
          // lane adds the teams' terms in slot order (every team ends with
          // the same sums)
          float dr[kMaxHeads];
#pragma unroll
          for (int k = 0; k < kMaxHeads; ++k)
            dr[k] = k < nh ? __shfl_sync(kFull, draw, (base[u] + k) & 31)
                           : 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float c0 =
                __shfl_sync(kFull, coef, (base[u] + r.h0(c)) & 31);
            const float c1 =
                r.split ? __shfl_sync(kFull, coef, (base[u] + r.h1(c)) & 31)
                        : c0;
            float term[V];
#pragma unroll
            for (int v = 0; v < V; ++v) term[v] = 0.f;
            if (r.live(c)) {
#pragma unroll
              for (int k = 0; k < kMaxHeads; ++k) {
                if (k >= nh) continue;
                float av[V];
                lds_vec<V>(sa + k * d_feat + r.j0(c), av);
#pragma unroll
                for (int v = 0; v < V; ++v)
                  term[v] = fmaf(av[v], dr[k], term[v]);
              }
            }
#pragma unroll
            for (int v = 0; v < V; ++v)
              term[v] = round_if(
                  fmaf(r.first(c, v) ? c0 : c1, gv[u][c][v], term[v]), r_dh);
            if constexpr (kWide) {  // one team: this lane's elements alone
              if (r.live(c)) {
#pragma unroll
                for (int v = 0; v < V; ++v) {
                  float* p = sacc + r.j0(c) + v;
                  *p = __fadd_rn(*p, term[v]);
                }
              }
            } else {
              for (int t2 = 0; t2 < teams; ++t2) {
                const bool real = i0 + u * teams + t2 < cnt;  // all lanes
#pragma unroll
                for (int v = 0; v < V; ++v) {
                  const float y =
                      __shfl_sync(kFull, term[v], t2 * lanes + r.t);
                  if (real) acc[c][v] = __fadd_rn(acc[c][v], y);
                }
              }
            }
          }
        }
      }
    }
    if (r.g == 0) {
      float* drow = a.d_h + (size_t)s * d_feat;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!r.live(c)) continue;
        if constexpr (kWide) {
          float x[V];
#pragma unroll
          for (int v = 0; v < V; ++v) x[v] = sacc[r.j0(c) + v];
          store_vec<V>(drow + r.j0(c), x);
        } else {
          store_vec<V>(drow + r.j0(c), acc[c]);
        }
      }
    }
    // the sender's d(raw) sums, head k's in lane k
    float tot = 0.f;
    for (int i = 0; i < per; ++i)
      tot += __shfl_sync(kFull, dsa, (i * nh + lane) & 31);
    if (lane < nh) a.dsum[(size_t)s * nh + lane] = tot;
  }

  // the block's d(a_src): sum over its senders s of hq[s, j] * dsum[s, k],
  // the senders of its warps in turn (eight loads in flight); then -d(cap)
  // (kTwoPhase), the warps' sums in warp order
  if (two) {
    const float w = warp_sum(dcap);
    if (lane == 0) wdcap[warp] = w;
  }
  __syncthreads();  // the block's dsum rows are written
  const int len = d_feat * nh;
  float* prow = a.part + (size_t)blockIdx.x * a.stride;
  for (int q = threadIdx.x; q < len; q += blockDim.x) {
    const int j = q / nh, k = q - j * nh;
    float x = 0.f;
    for (int s0 = blockIdx.x * kWarps; s0 < a.n; s0 += gridDim.x * kWarps) {
      float hq[kWarps], ds[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int s = s0 + w;
        hq[w] = s < a.n ? round_if(load_h(a.h + (size_t)s * d_feat + j),
                                   r_rows)
                        : 0.f;
        ds[w] = s < a.n ? a.dsum[(size_t)s * nh + k] : 0.f;
      }
#pragma unroll
      for (int w = 0; w < kWarps; ++w) x = fmaf(hq[w], ds[w], x);
    }
    prow[q] = x;  // (d_feat, nh)
  }
  if (two && threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += wdcap[w];
    prow[len] = -t;
  }
}

// After the backward: d_sdst[d, k] = sum over d's run of dst_perm, in
// order, of the slots' d(s_dst) terms (blocks below sd_blocks, a thread a
// (destination, head)), and the d(a_src) [| d(cap)] partial rows summed in
// row order (sum_rows_block, the blocks from sd_blocks on, 32 warps a
// block: a warp adds every 32nd row).
constexpr int kTailWarps = 32;

__global__ void __launch_bounds__(kTailWarps * 32, 1)
window_bwd_tail_kernel(const float* __restrict__ dsd,
                       const int* __restrict__ dst_perm,
                       const int* __restrict__ dst_ptr, int n, int nh,
                       int sd_blocks, const float* __restrict__ part,
                       int nrows, int len, float* __restrict__ d_sdst,
                       float* __restrict__ d_asrc) {
  if ((int)blockIdx.x < sd_blocks) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n * nh) return;
    const int d = i / nh, k = i - d * nh;
    float s = 0.f;
    for (int p = dst_ptr[d]; p < dst_ptr[d + 1]; ++p)
      s += dsd[(size_t)dst_perm[p] * nh + k];
    d_sdst[i] = s;
    return;
  }
  sum_rows_block<kTailWarps>(part, nrows, len, blockIdx.x - sd_blocks,
                            d_asrc);
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

// The backward over the plan (vec, per_lane, lanes, unroll) of
// v5_attention.row_plan: the kernel by sender on a fixed grid of nblk
// blocks, then the tail (d(s_dst) by destination, d(a_src) [| d(cap)] from
// the partial rows): two launches in every mode.
template <typename T>
int launch_window_backward(BwdArgs<T> a, float* d_sdst, float* d_asrc,
                           int vec, int per_lane, int unroll, int nblk,
                           cudaStream_t st) {
  const bool parts = a.mode == Bwd::kParts;
  if (!row_plan_ok(a.d_feat, a.nh, a.f, vec, per_lane, a.lanes) ||
      nblk < 1 || a.n < 1 || !aligned(a.h, vec * sizeof(T)) ||
      !aligned(a.g, vec * sizeof(float)) ||
      !aligned(a.d_h, vec * sizeof(float)) || (parts != !a.out) ||
      (a.out && !aligned(a.out, vec * sizeof(float))))
    return (int)cudaErrorInvalidValue;
  a.stride = a.d_feat * a.nh + (a.mode == Bwd::kTwoPhase ? 1 : 0);
  int err = (int)cudaSuccess;
  err = with_vc<kBwdLimit, kBwdMaxC>(vec, per_lane, [&](auto vv, auto cc) {
    constexpr int V = decltype(vv)::value, C = decltype(cc)::value;
    constexpr int U = row_flight(V * C);
    // a_src, and at wide rows the warps' sums
    const size_t smem =
        ((size_t)a.d_feat * a.nh + (kWideRow<V, C> ? kWarps * a.d_feat : 0)) *
        sizeof(float);
    if (kWideRow<V, C> && a.lanes != 32) return (int)cudaErrorInvalidValue;
    auto launch = [&](auto kern) {
      cudaError_t e = set_smem(kern, smem);
      if (e != cudaSuccess) return (int)e;
      kern<<<nblk, kWarps * 32, smem, st>>>(a);
      return (int)cudaGetLastError();
    };
    // the instance for heads of whole lanes where the plan gives them
    auto with_u = [&](auto uu) {
      constexpr int UU = decltype(uu)::value;
      if constexpr (C == 1)
        if (a.f % V == 0) return launch(window_bwd_kernel<V, C, UU, true, T>);
      return launch(window_bwd_kernel<V, C, UU, false, T>);
    };
    if (unroll == U) return with_u(Int<U>{});
    // two in flight: where a batch gives a team at most two slots (teams
    // of under 32 lanes, one vector a lane: row_plan)
    if constexpr (U != 2 && V * C <= 4)
      if (unroll == 2) return with_u(Int<2>{});
    return (int)cudaErrorInvalidValue;
  });
  if (err) return err;
  const int sd_blocks =
      (a.n * a.nh + kTailWarps * 32 - 1) / (kTailWarps * 32);
  const int sum_blocks = (a.stride + kSumCols - 1) / kSumCols;
  window_bwd_tail_kernel<<<sd_blocks + sum_blocks, kTailWarps * 32, 0, st>>>(
      a.dsd, a.dst_perm, a.dst_ptr, a.n, a.nh, sd_blocks, a.part, nblk,
      a.stride, d_sdst, d_asrc);
  return (int)cudaGetLastError();
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
// plain eps; not in the bfloat16-table library). d_h (n, d_feat), d_drop
// (e7, nh) or NULL, d_sdst (n, nh), d_asrc (d_feat, nh) and in mode 2
// d(cap) after it. Scratch: dsd (e7, nh), dsum (n, nh), part (nblk,
// d_feat*nh [+ 1]). recv, src_perm, dst_perm
// (e7,), src_ptr, dst_ptr (n + 1,): the layout's; (vec, per_lane, lanes,
// unroll): v5_attention.row_plan.
int window_backward(const void* h, const float* a_src, const float* s_src,
                    const float* s_dst, const float* drop, const int* recv,
                    const int* src_perm, const int* src_ptr,
                    const int* dst_perm, const int* dst_ptr, int n, int e7,
                    int d_feat, int nh, int f, int mode, float slope,
                    float eps, const float* g, const float* out,
                    const float* den, const float* epsp, const float* cap,
                    float* d_h, float* d_drop, float* d_sdst, float* d_asrc,
                    float* dsd, float* dsum, float* part,
                    int vec, int per_lane, int lanes, int unroll, int nblk,
                    int flags, void* stream) {
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
#ifdef GAT_BF16_TABLE
  if (mode == 2) return (int)cudaErrorInvalidValue;
#endif
  return with_table(h, flags, [&](auto hp) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(hp)>>;
    const BwdArgs<T> a{hp,    a_src,  s_src,   s_dst,    drop,   recv,
                       src_perm, src_ptr, dst_perm, dst_ptr, n,  e7,
                       d_feat, nh,    f,       lanes,    (Bwd)mode, slope,
                       eps,    flags, g,       out,      den,    epsp,
                       cap,    d_h,   d_drop,  dsd,      dsum,   part,
                       0};
    return launch_window_backward(a, d_sdst, d_asrc, vec, per_lane, unroll,
                                  nblk, (cudaStream_t)stream);
  });
}

}  // extern "C"
