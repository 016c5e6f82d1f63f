// v2 segment attention op for Hopper (sm_90a): forward and backward over a
// pre-gathered edge table, in the normalised and the partial (unnormalised)
// form.
//
// Replaces the TPU kernels
//   gat_pytorch_tpu/ops/pallas/segment_attention.py:_kernel
//     (launched by _forward for fused_segment_attention and, with
//     normalize=False, fused_segment_attention_partial)
//   gat_pytorch_tpu/ops/pallas/segment_attention_bwd.py:_kernel
//     (launched by backward_packed)
//
// Contract (per edge e with destination dst = receivers[e], head k,
// feature j; the logits come from the caller, masked to -1e30 on padding
// edges, whose exp is 0; edges e >= e_real are padding and not read):
//   ex[e,k]       = exp(logits[e,k])
//   den[dst,k]    = sum_e ex[e,k]                   (no dropout mask in den)
//   num[dst,kf+j] = sum_e ex[e,k] * drop[e,k] * h_src[e,kf+j]
// The partial form returns (num, den); the normalised form returns
//   out = num * inv, inv = den > 0 ? 1 / (den + eps) : 0.
// Every destination row in [0, n) is written, zeros where it has no edge:
// under edge sharding each shard's (num, den) are summed over the shards.
// Backward, a map over the edges with no reduction across them: each edge
// reads its destination's payload P = [g | inv | dden] and writes
//   d_h_src[e,kf+j] = ex[e,k] * drop[e,k] * inv[dst,k] * g[dst,kf+j]
//   d_logits[e,k]   = ex[e,k] * (hg[e,k] * inv[dst,k] * drop[e,k] + dden)
//   d_drop[e,k]     = hg[e,k] * ex[e,k] * inv[dst,k]
// with hg[e,k] = sum_j h_src[e,kf+j] * g[dst,kf+j]. Normalised:
// g = d(out), inv as above, dden = -inv * sum_j out * g over head k.
// Partial (segment_attention_bwd.backward_packed(normalize=False)):
// g = d(num), inv = 1, dden = d(den). Padding edges and edges whose
// receiver is no row of this call get zero cotangents.
//
// Design. The TPU kernel packs h_src, the logits, the mask and the
// receivers into one edge-major array (one DMA a block), reduces by
// destination with a one-hot MXU contraction over aligned-down edge
// blocks, and spreads a head's weight over its features with an expander
// matmul: all of it because Mosaic has no in-kernel random gather. Here
// the receivers are sorted, so the forward takes per-destination CSR
// offsets (the caller's, Graph.dst_ptr, or derived per call) and walks
// each destination's run with the forward bodies of the v5 and table ops
// (attention_common.cuh attention_fwd_wide and attention_fwd_narrow, the
// row source Src::kStream: an edge's row is its own, h_src[e], where the
// table op gathers h[senders[e]]). At f >= 32 a block of nh warps owns a
// destination and warp k head k: no head is selected per element; lane l
// holds vectors of the head's elements (16-byte where 4 divides f, 8-byte
// at 6 x 121, whose heads start mid-vector: the neighbouring head's
// elements are kept out of the stores); lane i of a batch of 32 edges
// takes edge i's logit and mask entry and its exp once, and the warp hands
// the weights out by shuffles; each lane has U edges' row loads in flight
// before it uses any, and adds m*ex*h and ex in float32 in ascending edge
// order. Below f = 32 one warp owns a destination in teams of lanes sized
// to the row (v5_attention.lane_plan): a lane takes an (edge, head)'s exp
// once, each team adds its edges in ascending order and the teams' sums
// are added in a fixed butterfly. No atomics, and two launches give the
// same bits. The rows are read once from device memory with evict-first
// loads (__ldcs), which keep L2 for the logits and the outputs.
// The backward is a map over the edges: no sum crosses them, so it
// gives each edge's row to a team of lanes sized to the row (the v5 and
// windowed kernels' teams, v5_attention.row_plan: 16-byte vectors where 4
// divides the row, 8-byte at 6 x 121, whose heads start mid-vector and
// whose neighbouring head's elements are kept out of each head's terms),
// several edges a warp at narrow rows; it takes each (edge, head)'s exp
// once, keeps U edges' row loads in flight before any is used, reduces
// the per-head dots of a team together (team_sums), and gathers the
// destination's payload per edge: g[dst] from L2, where the (n, d) table
// sits, and inv and d(den) per (edge, head). In the normalised mode d(den)
// = -inv * sum out * g is a per-destination prologue (dden_kernel,
// attention_common.cuh, the table op's). It reads no offsets: an edge's
// receiver says whether it is a row of the call.
//
// What bounds it on the H100: bytes. The forward reads the (E, nh*f)
// h_src table once, the backward reads it and writes d(h_src) of the
// same size: at PPI's 1024-wide rows and 58,556 real edges that is 480 MB
// a call, about 0.14 ms at 3.35 TB/s (the first kernel of the port whose
// byte bound is not negligible). The rows are read from device memory,
// not from L2 as the gathered tables of the other kernels are, so both
// start the loads of several rows before they use any of them (with each
// load consumed right after it started, the forward ran at a third of the
// backward's rate), and both stream h_src (and d(h_src)) past L2
// (evict-first loads and stores), keeping L2 for the gathered g table.
//
// The bfloat16 mode (flags, attention_common.cuh): the JAX package's
// GAT_TPU_KERNEL_DTYPE=bfloat16 rounds each edge's [m*ex*h | ex] to
// bfloat16 before the float32 sums of the forward (kRoundAcc). The
// backward has no such mode.

#include "attention_common.cuh"

#include <algorithm>

namespace {

// the backward's grid: a map over the edges with no partial sums, so any
// grid gives the same bits; up to 16 blocks an SM of the 132
constexpr int kV2Blocks = 16 * 132;

// The forward, both modes (FwdArgs.norm), over the caller's per-destination
// offsets of the dst-sorted edges: attention_fwd_wide at f >= 32 (a block
// of nh warps a destination, warp k head k), attention_fwd_narrow below
// (one warp a destination, teams of lanes sized to the row), each reading
// the edge table h_src as a stream (Src::kStream). minBlocks 1: without
// it ptxas held the narrow V = 4 instance to 48 registers and spilled.
template <bool WIDE, int V, int C, int U, bool RACC>
__global__ void __launch_bounds__(kWarps * 32, 1)
v2_fwd_kernel(const FwdArgs<float> a) {
  if constexpr (WIDE) {
    attention_fwd_wide<V, C, RACC, Src::kStream>(a);  // U = in_flight(C*V)
  } else {
    attention_fwd_narrow<V, C, U, RACC, Src::kStream>(a);
  }
}

// The backward, a map over the edges (every edge e < e_total is written):
// warp w of block b takes the batches of 32 / nh edges b * kWarps + w,
// then every gridDim.x * kWarps-th after it. Lane i * nh + k takes edge i's
// receiver and head k's logit, mask entry and payload (inv, d(den)), and
// its exp once; teams of `lanes` lanes, each a whole row (RowLanes), take
// the edges i0 + u * teams + g, U of them in flight: h_src[e] streamed
// from device memory (read once), g[dst] gathered (from L2; neighbouring
// edges share their receiver), d_h_src[e] = coef * g streamed out; the
// per-head dots h_src . g of a team reduced together (team_sums) to lane
// (i, k), which writes d(logits) and d(drop). pay: (n, nh) the forward's
// den (NORM) or d(den) (partial); dden: the prologue's d(den) (NORM only).
template <int V, int C, int U>
__global__ void __launch_bounds__(kWarps * 32, 1)
v2_bwd_kernel(const float* __restrict__ logits,
              const float* __restrict__ h_src,
              const float* __restrict__ drop,
              const int* __restrict__ receivers, int n, int e_real,
              int e_h, int e_total, int d_feat, int nh, int f, int lanes,
              float eps, bool norm, const float* __restrict__ g,
              const float* __restrict__ pay,
              const float* __restrict__ dden, float* __restrict__ d_h_src,
              float* __restrict__ d_logits, float* __restrict__ d_drop) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const RowLanes<V, C> r(lane, lanes, d_feat, f);
  const int teams = r.teams;
  const int per = 32 / nh;                            // edges a batch
  const int mine = lane / nh, kh = lane - mine * nh;  // (edge, head) owned
  const int from = kh * (lanes / kMaxHeads);  // team lane of head kh's sum
  const int batches = (e_total + per - 1) / per;
  for (int bi = blockIdx.x * kWarps + warp; bi < batches;
       bi += gridDim.x * kWarps) {
    const int b = bi * per, cnt = min(per, e_total - b);
    const bool own = mine < cnt;
    const int e = b + mine;
    int dst = 0;
    bool in = false;  // a real edge whose receiver is a row of this call
    float ex = 0.f, m = 1.f, inv = 0.f, dd = 0.f, coef = 0.f;
    if (own && e < e_real) {
      dst = receivers[e];
      in = dst < n;
    }
    if (in) {
      const size_t ek = (size_t)e * nh + kh, dk = (size_t)dst * nh + kh;
      ex = expf(logits[ek]);
      if (drop) m = drop[ek];
      const float pk = pay[dk];
      if (norm) {
        inv = pk > 0.f ? 1.f / (pk + eps) : 0.f;
        dd = dden[dk];
      } else {
        inv = 1.f;
        dd = pk;
      }
      coef = ex * m * inv;
    }
    float hg = 0.f;
    for (int i0 = 0; i0 < cnt; i0 += teams * U) {
      // team g takes the edge i0 + u * teams + g: U rows in flight
      float hv[U][C][V], gv[U][C][V];
      int base[U];  // the lane of (the team's edge, head 0)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u * teams >= cnt) break;  // the same for every lane
        const int i = i0 + u * teams + r.g;
        base[u] = (i * nh) & 31;
        const int du = __shfl_sync(kFull, dst, base[u]);
        const bool iu = __shfl_sync(kFull, in, base[u]) && i < cnt;
        const float* hrow = h_src + (size_t)(b + i) * d_feat;
        const float* grow = g + (size_t)du * d_feat;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (iu && r.live(c)) {
            load_vec_cs<V>(hrow + r.j0(c), hv[u][c]);
            load_vec<V>(grow + r.j0(c), gv[u][c]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) hv[u][c][v] = gv[u][c][v] = 0.f;
          }
        }
      }
      // d(h_src) = coef * g (0 on an edge that is not `in`), and the dots
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u * teams >= cnt) break;
        const int i = i0 + u * teams + r.g;
        float* drow = d_h_src + (size_t)(b + i) * d_feat;
        const bool row = i < cnt && b + i < e_h;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float c0 = __shfl_sync(kFull, coef, (base[u] + r.h0(c)) & 31);
          const float c1 =
              r.split ? __shfl_sync(kFull, coef, (base[u] + r.h1(c)) & 31)
                      : c0;
          if (!row || !r.live(c)) continue;
          float o[V];
#pragma unroll
          for (int v = 0; v < V; ++v)
            o[v] = (r.first(c, v) ? c0 : c1) * gv[u][c][v];
          store_vec_cs<V>(drow + r.j0(c), o);
        }
      }
      float red[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u * teams >= cnt) break;
        float q[kMaxHeads];
        r.head_dots(hv[u], gv[u], q);
        red[u] = team_sums<kMaxHeads>(q, lane, lanes);
      }
      // lane (i, k) takes edge i's hg for head k
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u * teams >= cnt) break;
        const int gg = mine - i0 - u * teams;  // the team of edge mine
        const float x = __shfl_sync(
            kFull, red[u], ((gg & (teams - 1)) * lanes + from) & 31);
        if (gg >= 0 && gg < teams) hg = x;
      }
    }
    if (own) {
      const size_t ek = (size_t)e * nh + kh;
      d_logits[ek] = in ? ex * (hg * inv * m + dd) : 0.f;
      if (d_drop) d_drop[ek] = in ? hg * ex * inv : 0.f;
    }
  }
}

// The backward at heads of f >= 32 features (PPI's 4 x 256 and 6 x 121):
// the layout of table_attention.cu's table_bwd_kernel over edges in place
// of a sender's run. A block of nh warps takes 32 edges at a time, warp k
// head k, lane l holding the vectors b + V*(l + 32c), c < C, of the head's
// elements (b: the vector holding its first; at 6 x 121 a vector may hold a
// neighbouring head's element, kept out of the dot and the stores). Lane i
// takes edge i's receiver and head k's logit, mask entry and payload, and
// its exp once; the warp streams U edges' h_src rows in, gathers their g
// rows, streams coef * g out as d(h_src), and reduces the U edges' dots
// together (warp_sums); lane i writes edge i's d(logits) and d(drop).
template <int V, int C>
__global__ void __launch_bounds__(kMaxHeads * 32, 1)
v2_bwd_wide_kernel(const float* __restrict__ logits,
                   const float* __restrict__ h_src,
                   const float* __restrict__ drop,
                   const int* __restrict__ receivers, int n, int e_real,
                   int e_h, int e_total, int d_feat, int nh, int f,
                   float eps, bool norm, const float* __restrict__ g,
                   const float* __restrict__ pay,
                   const float* __restrict__ dden,
                   float* __restrict__ d_h_src, float* __restrict__ d_logits,
                   float* __restrict__ d_drop) {
  constexpr int U = in_flight(C * V);
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  const int lo_k = k * f, hi_k = lo_k + f;     // head k's elements
  const int col = lo_k - lo_k % V + V * lane;  // the lane's first vector
  // taken when asked (arrays of them cost 64 registers at 32 elements)
  auto live = [&](int c) { return col + 32 * V * c < hi_k; };
  auto inh = [&](int c, int v) {  // the element is head k's
    const int j = col + 32 * V * c + v;
    return j >= lo_k && j < hi_k;
  };
  for (int b = blockIdx.x * 32; b < e_total; b += gridDim.x * 32) {
    const int cnt = min(32, e_total - b);
    // lane i: edge b + i's receiver and head k's terms
    const int e = b + lane;
    int dst = 0;
    bool in = false;  // a real edge whose receiver is a row of this call
    float ex = 0.f, m = 1.f, inv = 0.f, dd = 0.f, coef = 0.f;
    if (lane < cnt && e < e_real) {
      dst = receivers[e];
      in = dst < n;
    }
    if (in) {
      const size_t ek = (size_t)e * nh + k, dk = (size_t)dst * nh + k;
      ex = expf(logits[ek]);
      if (drop) m = drop[ek];
      const float pk = pay[dk];
      if (norm) {
        inv = pk > 0.f ? 1.f / (pk + eps) : 0.f;
        dd = dden[dk];
      } else {
        inv = 1.f;
        dd = pk;
      }
      coef = ex * m * inv;
    }
    float hg_mine = 0.f;
    for (int i0 = 0; i0 < cnt; i0 += U) {  // i0 + u < 32: U divides 32
      float hv[U][C][V], gv[U][C][V], cu[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u;
        const int du = __shfl_sync(kFull, dst, i);
        const bool iu = __shfl_sync(kFull, in, i) && i < cnt;
        cu[u] = __shfl_sync(kFull, coef, i);
        const float* hrow = h_src + (size_t)(b + i) * d_feat + col;
        const float* grow = g + (size_t)du * d_feat + col;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (iu && live(c)) {
            load_vec_cs<V>(hrow + 32 * V * c, hv[u][c]);
            load_vec<V>(grow + 32 * V * c, gv[u][c]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) hv[u][c][v] = gv[u][c][v] = 0.f;
          }
        }
      }
      // d(h_src) = coef * g over head k's elements (0 on an edge that is
      // not `in`), and the dots
      float q[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u;
        q[u] = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (inh(c, v)) q[u] = fmaf(hv[u][c][v], gv[u][c][v], q[u]);
        if (i >= cnt || b + i >= e_h) continue;
        float* drow = d_h_src + (size_t)(b + i) * d_feat + col;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (!live(c)) continue;
          float o[V];
          bool whole = true;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            o[v] = cu[u] * gv[u][c][v];
            whole = whole && inh(c, v);
          }
          if (whole) {
            store_vec_cs<V>(drow + 32 * V * c, o);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v)
              if (inh(c, v)) __stcs(drow + 32 * V * c + v, o[v]);
          }
        }
      }
      // lane i0 + u takes edge i0 + u's sum from lane u * (32 / U)
      const float hg = __shfl_sync(
          kFull, warp_sums<U>(q, lane), ((lane - i0) & (U - 1)) * (32 / U));
      if (lane >= i0 && lane < i0 + U) hg_mine = hg;
    }
    if (lane < cnt) {
      const size_t ek = (size_t)e * nh + k;
      d_logits[ek] = in ? ex * (hg_mine * inv * m + dd) : 0.f;
      if (d_drop) d_drop[ek] = in ? hg_mine * ex * inv : 0.f;
    }
  }
}

}  // namespace

extern "C" {

// Forward: (out (n, d_feat) normalised where normalize, else num; den
// (n, nh)). logits (E, nh), h_src (e_h >= e_real rows, d_feat; rows from
// e_real on are not read), drop (E, nh) or NULL, row_ptr (n + 1,) the
// offsets of each destination's run in the dst-sorted edge list, e_real
// the number of leading real edges; (wide, vec, per_lane, lanes, unroll)
// the lane plan of v5_attention.lane_plan, over nblk blocks; flags the
// bfloat16 mode's word (kRoundAcc or 0).
int v2_forward(const float* logits, const float* h_src, const float* drop,
               const int* row_ptr, int n, int e_real, int d_feat, int nh,
               int f, float eps, int normalize, float* out, float* den,
               int wide, int vec, int per_lane, int lanes, int unroll,
               int nblk, int flags, void* stream) {
  if (n < 1 || (flags & ~kRoundAcc)) return (int)cudaErrorInvalidValue;
  const FwdArgs<float> a{h_src,   nullptr, nullptr, drop,    nullptr,
                         nullptr, row_ptr, n,       e_real,  d_feat,
                         nh,      f,       lanes,   0.f,     eps,
                         flags,   false,   nullptr, out,     den,
                         nullptr, nullptr, logits,  normalize != 0};
  return launch_attention_fwd<true, 8>(
      a, wide, vec, per_lane, unroll, nblk, nullptr, nullptr,
      (cudaStream_t)stream, [](auto w, auto v, auto c, auto u, auto r) {
        return &v2_fwd_kernel<decltype(w)::value != 0, decltype(v)::value,
                              decltype(c)::value, decltype(u)::value,
                              decltype(r)::value != 0>;
      });
}

// Backward: d_h_src (e_h, d_feat), d_logits (E, nh), d_drop (E, nh) or
// NULL. Normalised: g = d(out), out the forward's output, pay its den, and
// dden (n, nh) scratch for the prologue's d(den) (dden_kernel). Partial:
// g = d(num), pay = d(den), out and dden NULL. The receivers (E,) are
// read per edge (no offsets). Heads of f >= 32 features take
// v2_bwd_wide_kernel (its split of a head from the alignment of h_src, g
// and d_h_src); narrower ones the plan (vec, per_lane, lanes, unroll) of
// v5_attention.row_plan. The normalised mode is two launches, the partial
// one.
int v2_backward(const float* logits, const float* h_src, const float* drop,
                const int* receivers, int n, int e_real, int e_h,
                int e_total, int d_feat, int nh, int f, float eps,
                int normalize, const float* g, const float* out,
                const float* pay, float* dden, float* d_h_src,
                float* d_logits, float* d_drop, int vec, int per_lane,
                int lanes, int unroll, void* stream) {
  if (d_feat < 1 || d_feat > 1024 || nh < 1 || nh > kMaxHeads ||
      nh * f != d_feat || n < 1 || e_real > e_h || e_h > e_total ||
      (normalize && (out == nullptr || dden == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (normalize) {
    const int err = launch_dden(g, out, pay, n, d_feat, nh, f, eps, dden,
                                st);
    if (err) return err;
  }
  if (f >= 32) {
    const long tiles = ((long)e_total + 31) / 32;
    const int nblk = (int)std::max(1L, std::min(tiles, (long)kV2Blocks));
    return with_vec(f, d_feat, h_src, g, d_h_src, [&](auto vc) {
      constexpr int V = decltype(vc)::value;
      return with_c<V>(f, [&](auto cc) {
        constexpr int C = decltype(cc)::value;
        v2_bwd_wide_kernel<V, C><<<nblk, nh * 32, 0, st>>>(
            logits, h_src, drop, receivers, n, e_real, e_h, e_total, d_feat,
            nh, f, eps, normalize != 0, g, pay, dden, d_h_src, d_logits,
            d_drop);
        return (int)cudaGetLastError();
      });
    });
  }
  if (!row_plan_ok(d_feat, nh, f, vec, per_lane, lanes) ||
      !aligned(h_src, vec * sizeof(float)) ||
      !aligned(g, vec * sizeof(float)) ||
      !aligned(d_h_src, vec * sizeof(float)))
    return (int)cudaErrorInvalidValue;
  const int per = 32 / nh;
  const long batches = ((long)e_total + per - 1) / per;
  const int nblk = (int)std::max(
      1L, std::min((batches + kWarps - 1) / kWarps, (long)kV2Blocks));
  // f < 32 and nh <= 8: rows under 256 floats, at most 8 elements a lane
  return with_vc<8, 8>(vec, per_lane, [&](auto vv, auto cc) {
    constexpr int V = decltype(vv)::value, C = decltype(cc)::value;
    constexpr int U = row_flight(V * C);
    auto launch = [&](auto kern) {
      kern<<<nblk, kWarps * 32, 0, st>>>(
          logits, h_src, drop, receivers, n, e_real, e_h, e_total, d_feat,
          nh, f, lanes, eps, normalize != 0, g, pay, dden, d_h_src,
          d_logits, d_drop);
      return (int)cudaGetLastError();
    };
    if (unroll == U) return launch(v2_bwd_kernel<V, C, U>);
    // two in flight: where a batch gives a team at most two edges (teams
    // of under 32 lanes, one vector a lane: row_plan)
    if constexpr (U != 2 && V * C <= 4)
      if (unroll == 2) return launch(v2_bwd_kernel<V, C, 2>);
    return (int)cudaErrorInvalidValue;
  });
}

}  // extern "C"
