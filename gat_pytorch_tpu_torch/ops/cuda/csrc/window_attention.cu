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
//   window_forward_two_phase (its phase 1), window_backward_two_phase.
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
// run in torch. The backward takes ex from the same table and emits the
// per-slot d(h) rows (pad rows are left unwritten: the reduction by
// sender reads real slots only), d(drop) per slot (0 on pad slots),
// d(s_dst) per destination and d(a_src). Its two modes (the template
// parameter NORM of window_bwd_kernel) are those of v5_attention.cu: the
// normalised mode takes g, out, den and eps' and derives inv and d(den)
// itself; the parts mode takes the raw cotangents d(num) and d(den) of
// the unnormalised parts from a caller that differentiates its own
// epilogue. The 2-phase entries are those of v5_attention.cu over the
// slots: window_cap (max raw, lowest slot*nh + k), window_forward_two_phase
// (exp(leaky(raw - cap)), out = num / (den + eps)), window_backward_two_phase
// (the full LeakyReLU's derivative and d(cap) = -sum d(raw)); every mode
// takes raw from the one score table of its op call, so the argmax slot
// has raw - cap == 0 exactly.
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
// slots' scores (cap_stream_kernel). The backward has one warp own one
// destination row at a time and walk its run in order: it loads the
// sender's h row (lane l holds features l, l+32, ...), reduces q = h . g
// per head through warp shuffles, takes raw from the table, and
// accumulates d(a_src) in registers. Every output row has one writer and
// a fixed order of sums: no atomics, bitwise reproducible. The cap with
// its argmax code, d(a_src) and d(cap) go through per-block partials over
// a fixed grid and an ordered second pass (attention_common.cuh).
//
// What the layout can buy on this card is locality: the warps of the grid
// work on neighbouring destination rows at the same time, whose senders
// sit in a narrow id window after the RCM reorder, so the gathered h rows
// hit in L2 (and the per-row runs are sender-sorted, so neighbouring
// reads are neighbouring rows). While the whole h table fits the 50 MB L2
// (5 MB at Pubmed size) the order of the reads matters little (PERF.md).
//
// What bounds it on the H100: by bytes, the h table, the slot arrays, the
// dropout mask and the outputs, a few MB at Pubmed size (microseconds at
// 3.35 TB/s). Pubmed averages 5.5 real slots a destination, so a
// destination is one or two batches: three dependent loads (position,
// sender and score, row) and a few shuffles each, besides the launches of
// the score pass and, in the 2-phase form, of the cap stream and its
// reduce.

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

// MODE as v5_bwd_kernel's (v5_attention.cu): kNorm, kParts, kTwoPhase.
template <int C, Bwd MODE, typename T>
__global__ void __launch_bounds__(kWarps * 32)
window_bwd_kernel(const T* __restrict__ h, const float* __restrict__ a_src,
                  const float* __restrict__ s_src,
                  const float* __restrict__ s_dst,
                  const float* __restrict__ drop, const int* __restrict__ send,
                  const int* __restrict__ dst_perm,
                  const int* __restrict__ dst_ptr, int n, int e7, int d_feat,
                  int nh, int f, float slope, float eps, int flags,
                  const float* __restrict__ g, const float* __restrict__ out,
                  const float* __restrict__ den,
                  const float* __restrict__ epsp,
                  const float* __restrict__ cap_in,
                  float* __restrict__ d_h_rows, float* __restrict__ d_drop,
                  float* __restrict__ d_sdst,
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

  // pad slots (the tail of dst_perm) get a zero dropout cotangent
  if (d_drop) {
    const int n_real = dst_ptr[n], pads = (e7 - n_real) * nh;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < pads;
         i += gridDim.x * blockDim.x)
      d_drop[(size_t)dst_perm[n_real + i / nh] * nh + i % nh] = 0.f;
  }

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

    const int lo = dst_ptr[d], hi = dst_ptr[d + 1];  // real slots only
    // The next slot's row and scores in flight while this one is reduced
    // (kPre: up to C = 4 features a lane; beyond, the registers hold
    // d(a_src) instead); every lane holds every head's score, as in
    // v5_bwd_kernel.
    constexpr bool kPre = C <= 4;
    float hn[C];
    int sl = 0;
    float svn[kMaxHeads];  // the scores of the slot's sender
    auto fetch = [&](int i_) {
      sl = dst_perm[i_];
      const int sn = send[sl];
      const T* nrow = h + (size_t)sn * d_feat;
#pragma unroll
      for (int c = 0; c < C; ++c)
        hn[c] = live[c] ? load_h(nrow + lane + 32 * c) : 0.f;
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k)
        svn[k] = k < nh ? s_src[(size_t)sn * nh + k] : 0.f;
    };
    if (kPre && lo < hi) fetch(lo);
    for (int i = lo; i < hi; ++i) {
      if constexpr (!kPre) fetch(i);
      const int slot = sl;
      float* dhrow = d_h_rows + (size_t)slot * d_feat;
      float hv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) hv[c] = hn[c];
      float sv[kMaxHeads];
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k) sv[k] = svn[k];
      if (kPre && i + 1 < hi) fetch(i + 1);
      float draw[kMaxHeads], coef[kMaxHeads];
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k) {
        draw[k] = coef[k] = 0.f;
        if (k < nh) {  // nh is warp-uniform: every lane joins the shuffles
          const float hg = head_dot<C>(hv, live, head, k, gv, r_rows);
          const float raw = sv[k] + sd[k];
          const float m = drop ? drop[(size_t)slot * nh + k] : 1.f;
          float ex;
          if constexpr (kTwo) {
            const float pre = raw - cap;
            ex = expf(leaky(pre, slope));
            // the slope where pre <= 0: the argmax slot has pre == 0
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
            d_drop[(size_t)slot * nh + k] = hg * ex * inv[k];
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

// The bfloat16-table library (-DGAT_BF16_TABLE) serves the packed window
// only, whose rows are nh*f <= 64 wide (one or two features a lane in the
// backward, a narrow plan of at most 4 elements a lane in the forward),
// and has no 2-phase entries (the packed window is a single-sweep form).
#ifdef GAT_BF16_TABLE
#define WINDOW_DISPATCH(LAUNCH)            \
  if (c_need <= 1) { LAUNCH(1); }          \
  else if (c_need <= 2) { LAUNCH(2); }     \
  else { err = cudaErrorInvalidValue; }
constexpr bool kWindowWide = false;
constexpr int kWindowNarrow = 4;
#else
#define WINDOW_DISPATCH(LAUNCH) ROWS_DISPATCH(LAUNCH)
constexpr bool kWindowWide = true;
constexpr int kWindowNarrow = 8;
#endif

int check_shape(int d_feat, int nh, int nblk) {
  return (d_feat < 1 || d_feat > 1024 || nh < 1 || nh > kMaxHeads || nblk < 1)
             ? (int)cudaErrorInvalidValue
             : (int)cudaSuccess;
}

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

template <Bwd MODE, typename T>
int launch_window_backward(const T* h, const float* a_src,
                           const float* s_src, const float* s_dst,
                           const float* drop,
                           const int* send, const int* dst_perm,
                           const int* dst_ptr, int n, int e7, int d_feat,
                           int nh, int f, float slope, float eps,
                           const float* g, const float* out, const float* den,
                           const float* epsp, const float* cap_in,
                           float* d_h_rows, float* d_drop, float* d_sdst,
                           float* dasrc_part, float* d_asrc, int nblk,
                           int flags, void* stream) {
  int bad = check_shape(d_feat, nh, nblk);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = 2 * (size_t)d_feat * nh * sizeof(float);
  const int c_need = (d_feat + 31) / 32;
  cudaError_t err = cudaSuccess;
#define WINDOW_BWD(CC)                                                      \
  err = set_smem(window_bwd_kernel<CC, MODE, T>, smem);                     \
  if (err == cudaSuccess)                                                   \
    window_bwd_kernel<CC, MODE, T><<<nblk, kWarps * 32, smem, st>>>(        \
        h, a_src, s_src, s_dst, drop, send, dst_perm, dst_ptr, n, e7,       \
        d_feat, nh, f, slope, eps, flags, g, out, den, epsp, cap_in,        \
        d_h_rows, d_drop, d_sdst, dasrc_part);
  WINDOW_DISPATCH(WINDOW_BWD)
#undef WINDOW_BWD
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

// Every entry but window_cap: h is float32, or bfloat16 where flags has
// kBf16Table (the library built with -DGAT_BF16_TABLE, which has
// window_forward, window_backward and window_backward_parts only); flags
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

// Backward, normalised mode: d_h_rows (e7, d_feat) in slot order (pad rows
// unwritten), d_drop (e7, nh) or NULL, d_sdst (n, nh), d_asrc (d_feat, nh);
// dasrc_part is (nblk, d_feat*nh) scratch. epsp points at
// eps' = eps*exp(slope*cap') on the device.
int window_backward(const void* h, const float* a_src, const float* s_src,
                    const float* s_dst, const float* drop, const int* send,
                    const int* dst_perm, const int* dst_ptr, int n, int e7,
                    int d_feat, int nh, int f, float slope, const float* g,
                    const float* out, const float* den, const float* epsp,
                    float* d_h_rows,
                    float* d_drop, float* d_sdst, float* dasrc_part,
                    float* d_asrc, int nblk, int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_window_backward<Bwd::kNorm>(
        hp, a_src, s_src, s_dst, drop, send, dst_perm, dst_ptr, n, e7,
        d_feat, nh, f, slope, 0.f, g, out, den, epsp, nullptr, d_h_rows,
        d_drop, d_sdst, dasrc_part, d_asrc, nblk, flags, stream);
  });
}

// Backward, parts mode: the same outputs from the raw cotangents d_num
// (n, d_feat) and d_den (n, nh) of the unnormalised parts.
int window_backward_parts(const void* h, const float* a_src,
                          const float* s_src, const float* s_dst,
                          const float* drop, const int* send,
                          const int* dst_perm,
                          const int* dst_ptr, int n, int e7, int d_feat,
                          int nh, int f, float slope, const float* d_num,
                          const float* d_den, float* d_h_rows, float* d_drop,
                          float* d_sdst, float* dasrc_part, float* d_asrc,
                          int nblk, int flags, void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_window_backward<Bwd::kParts>(
        hp, a_src, s_src, s_dst, drop, send, dst_perm, dst_ptr, n, e7,
        d_feat, nh, f, slope, 0.f, d_num, nullptr, d_den, nullptr, nullptr,
        d_h_rows, d_drop, d_sdst, dasrc_part, d_asrc, nblk, flags, stream);
  });
}

#ifndef GAT_BF16_TABLE
// Backward, 2-phase: the outputs of the normalised mode from g, out, den,
// the cap at `cap` and the plain eps; d_asrc_cap is (d_feat*nh + 1,):
// d(a_src) then d(cap). dasrc_part is (nblk, d_feat*nh + 1) scratch.
int window_backward_two_phase(const void* h, const float* a_src,
                              const float* s_src, const float* s_dst,
                              const float* cap,
                              const float* drop, const int* send,
                              const int* dst_perm, const int* dst_ptr, int n,
                              int e7, int d_feat, int nh, int f, float eps,
                              float slope, const float* g, const float* out,
                              const float* den, float* d_h_rows,
                              float* d_drop, float* d_sdst, float* dasrc_part,
                              float* d_asrc_cap, int nblk, int flags,
                              void* stream) {
  return with_table(h, flags, [&](auto hp) {
    return launch_window_backward<Bwd::kTwoPhase>(
        hp, a_src, s_src, s_dst, drop, send, dst_perm, dst_ptr, n, e7,
        d_feat, nh, f, slope, eps, g, out, den, nullptr, cap, d_h_rows,
        d_drop, d_sdst, dasrc_part, d_asrc_cap, nblk, flags, stream);
  });
}
#endif  // GAT_BF16_TABLE

}  // extern "C"
