// GATv2 attention op for Hopper (sm_90a): a forward by destination, and a
// backward in a pass by destination and a pass by sender.
//
// Replaces no TPU kernel: the JAX package has no GATv2 layer. It was added
// for GATv2's dynamic attention (Brody, Alon and Yahav, ICLR 2022,
// arXiv:2105.14491), whose logit does not split into per-node scores, so
// that neither the v5 op's source-score table nor the table op's given
// logits can compute it without an (E, NH*F) tensor.
//
// Contract (per edge e = (j -> i) of the dst-sorted edge list, e < e_real,
// head k, feature c of the head's f; xl, xr (n, NH*F) the two transforms,
// a (NH, F), m the attention dropout multipliers or 1):
//   z[e,k,c]   = xl[j,kf+c] + xr[i,kf+c]
//   l[e,k]     = sum_c a[k,c] * LeakyReLU(z[e,k,c])
//   mx[i,k]    = max over i's edges of l, den[i,k] = sum exp(l - mx)
//   p[e,k]     = exp(l[e,k] - mx[i,k]) / den[i,k]
//   out[i,kf+c] = sum over i's edges of m[e,k] p[e,k] xl[j,kf+c]
// A destination without a real edge has out 0, den 0 and mx 0.
// Backward, with g = d(out), q[i,k] = g[i,k] . out[i,k]:
//   de[e,k]    = p (m g[i,k] . xl[j,k] - q[i,k])
//   t[e,k,c]   = de[e,k] a[k,c] LeakyReLU'(z[e,k,c])   (the slope at 0,
//                as torch's leaky_relu backward)
//   d_xr[i]    = sum over i's edges of t
//   d_xl[j]    = sum over j's edges of m p g[i] + t
//   d_a[k,c]   = sum over the edges of de[e,k] LeakyReLU(z[e,k,c])
//
// Design. The logit needs the whole head of the sender's row, which the
// weighted sum loads anyway, so the forward computes it from that row in
// registers. As the v5 forward (attention_common.cuh attention_fwd_wide):
// a block of NH warps a destination, warp k head k. A warp is cut into
// teams of `lanes` lanes (the fewest, a power of two, whose vectors of V
// elements cover f: one team of 16 at 8 x 40, sixteen of 2 at 8 x 8);
// lane t of a team holds the vectors V*(t + lanes*c), c < C, of the head,
// and team g takes the edges g, g + teams, ... of each batch of teams * U,
// U edges' row loads in flight before it uses them. The blocks take the
// destinations by descending count of edges (dst_order, from the wrapper):
// a hub's walk, some 14,500 edges on ogbn-arxiv-sized graphs, starts with
// the launch and runs beside the other blocks, where in the order of the
// node ids it started wherever the relabelled graph put the hub and
// could end after all the others. A team reduces each
// edge's logit over its lanes (log2(lanes) shuffles), keeps a running max,
// rescales its sums where the max grows (the online softmax) and adds
// exp(l - max) * m * xl in ascending edge order; the teams' (max, den,
// sum) are merged in a fixed butterfly at the end. Each edge's xl row is
// read once, and no (E, NH*F) tensor exists.
// The backward's pass by destination (same plan) re-forms z and the logit
// from xl[j] and the destination's xr, g and out rows, held in registers,
// and writes de and the weight m p (E, NH) for the pass by sender, and
// d_xr, summed by destination. The pass by sender walks the items of the
// sender runs (ops/cuda/build.py sender_items: runs of more than L slots
// cut into items, each on its own block, their partial rows added in item
// order by the tail), holds xl[j] and re-forms z from the gathered xr[i],
// gathers g[i], and sums d_xl per item; each block also keeps its d_a
// partial row over its items, which the tail (the v5 backward's
// bwd_tail_kernel) adds in a fixed order. No float atomics: every sum has a fixed order, so a launch gives
// the same bits every time.
//
// What bounds it on the H100: by the op's contract (each table read once,
// each output written once; portbench/counts/gatv2.py) bytes, about 0.2 ms
// a call at ogbn-arxiv size and 8 x 40; in practice the gathered rows,
// E_real x F floats a head (xl in the forward and the pass by destination,
// g and xr in the pass by sender: 3.2 GB a pass at 2.5M edges and
// 8 x 40), come from device memory past the 50 MB L2, and a destination
// of many edges is walked by its block alone.

#include "attention_common.cuh"

namespace {

// q[u] summed over each team of `lanes` lanes (a power of two; a team is
// an aligned group of lanes): every lane of the team gets the sum
template <int N>
__device__ __forceinline__ void team_reduce(float (&q)[N], int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < N; ++u) q[u] += __shfl_xor_sync(kFull, q[u], o);
}

// A lane's elements of head k: vector c starts at element j0(c) of the
// head and is live where it lies in the head (V divides f where V > 1)
template <int V, int C>
struct HeadLanes {
  int t, team, teams, lanes, base;
  bool live[C];
  __device__ __forceinline__ HeadLanes(int lanes_, int k, int f) {
    const int lane = threadIdx.x & 31;
    lanes = lanes_;
    t = lane & (lanes - 1);
    team = lane / lanes;
    teams = 32 / lanes;
    base = k * f;
#pragma unroll
    for (int c = 0; c < C; ++c) live[c] = V * (t + lanes * c) < f;
  }
  __device__ __forceinline__ int at(int c) const {
    return base + V * (t + lanes * c);
  }
  // the lane's elements of row r of an (rows, d_feat) table, 0 where dead
  __device__ __forceinline__ void load(const float* __restrict__ tab,
                                       size_t r, int d_feat, bool ok,
                                       float (&x)[C][V]) const {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (ok && live[c]) {
        load_vec<V>(tab + r * d_feat + at(c), x[c]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) x[c][v] = 0.f;
      }
    }
  }
};

// the lane's share of the logit a . LeakyReLU(x + r), each product added
// with fmaf in element order (the forward and the backward's pass by
// destination take the same bits from it)
template <int V, int C>
__device__ __forceinline__ float logit_part(const float (&av)[C][V],
                                            const float (&x)[C][V],
                                            const float (&r)[C][V],
                                            float slope) {
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int v = 0; v < V; ++v)
      q = fmaf(av[c][v], leaky(__fadd_rn(x[c][v], r[c][v]), slope), q);
  return q;
}

// The forward: block b is destination dst_order[b], warp k head k (module
// doc)
template <int V, int C, int U>
__global__ void __launch_bounds__(kMaxHeads * 32)
gatv2_fwd_kernel(const float* __restrict__ xl, const float* __restrict__ xr,
                 const float* __restrict__ att,
                 const float* __restrict__ drop,
                 const int* __restrict__ send, const int* __restrict__ ptr,
                 const int* __restrict__ dst_order, int e_real, int d_feat,
                 int nh, int f, int lanes, float slope,
                 float* __restrict__ out, float* __restrict__ mx,
                 float* __restrict__ den) {
  const int k = threadIdx.x >> 5, d = dst_order[blockIdx.x];
  const HeadLanes<V, C> hl(lanes, k, f);
  float av[C][V], rv[C][V], acc[C][V];
  hl.load(att, 0, 0, true, av);
  hl.load(xr, d, d_feat, true, rv);
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[c][v] = 0.f;
  float run_max = -INFINITY, run_den = 0.f;
  const int lo = ptr[d], hi = min(ptr[d + 1], e_real);
  for (int b = lo; b < hi; b += hl.teams * U) {
    float x[U][C][V], m[U], q[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = b + hl.team + hl.teams * u;
      ok[u] = p < hi;
      const int s = ok[u] ? send[p] : 0;
      m[u] = ok[u] && drop ? drop[(size_t)p * nh + k] : 1.f;
      hl.load(xl, s, d_feat, ok[u], x[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) q[u] = logit_part<V, C>(av, x[u], rv, slope);
    team_reduce<U>(q, lanes);
    float top = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (ok[u]) top = fmaxf(top, q[u]);
    if (top == -INFINITY) continue;  // no edge of the team's (no shuffle)
    const float next = fmaxf(run_max, top);
    const float scale = expf(run_max - next);  // 0 from an empty start
    run_den *= scale;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[c][v] *= scale;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      const float ex = expf(q[u] - next);
      run_den += ex;
      const float w = ex * m[u];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[c][v] = fmaf(w, x[u][c][v], acc[c][v]);
    }
    run_max = next;
  }
  // the teams' (max, den, sums), merged in a fixed order
  for (int o = lanes; o < 32; o <<= 1) {
    const float om = __shfl_xor_sync(kFull, run_max, o);
    const float od = __shfl_xor_sync(kFull, run_den, o);
    const float next = fmaxf(run_max, om);
    const float s1 = run_max == -INFINITY ? 0.f : expf(run_max - next);
    const float s2 = om == -INFINITY ? 0.f : expf(om - next);
    run_den = run_den * s1 + od * s2;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float oa = __shfl_xor_sync(kFull, acc[c][v], o);
        acc[c][v] = acc[c][v] * s1 + oa * s2;
      }
    run_max = next;
  }
  if (hl.team != 0) return;
  const float inv = run_den > 0.f ? 1.f / run_den : 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (!hl.live[c]) continue;
    float o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = acc[c][v] * inv;
    store_vec<V>(out + (size_t)d * d_feat + hl.at(c), o);
  }
  if (hl.t == 0) {
    mx[(size_t)d * nh + k] = run_den > 0.f ? run_max : 0.f;
    den[(size_t)d * nh + k] = run_den;
  }
}

// The backward's pass by destination: de and m p (E, NH) of each real
// edge, and d_xr, summed over each destination's edges by team in edge
// order, the teams' sums added in a fixed butterfly
template <int V, int C, int U>
__global__ void __launch_bounds__(kMaxHeads * 32)
gatv2_bwd_dst_kernel(const float* __restrict__ xl,
                     const float* __restrict__ xr,
                     const float* __restrict__ att,
                     const float* __restrict__ drop,
                     const int* __restrict__ send,
                     const int* __restrict__ ptr,
                     const int* __restrict__ dst_order, int e_real,
                     int d_feat, int nh, int f, int lanes, float slope,
                     const float* __restrict__ g,
                     const float* __restrict__ out,
                     const float* __restrict__ mx,
                     const float* __restrict__ den, float* __restrict__ d_xr,
                     float* __restrict__ de_out,
                     float* __restrict__ w_out) {
  const int k = threadIdx.x >> 5, d = dst_order[blockIdx.x];
  const HeadLanes<V, C> hl(lanes, k, f);
  float av[C][V], rv[C][V], gv[C][V], ov[C][V], acc[C][V];
  hl.load(att, 0, 0, true, av);
  hl.load(xr, d, d_feat, true, rv);
  hl.load(g, d, d_feat, true, gv);
  hl.load(out, d, d_feat, true, ov);
  // g . out of the destination's head, the same in every team
  float go[1] = {0.f};
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      go[0] = fmaf(gv[c][v], ov[c][v], go[0]);
      acc[c][v] = 0.f;
    }
  team_reduce<1>(go, lanes);
  const float top = mx[(size_t)d * nh + k];
  const float dn = den[(size_t)d * nh + k];
  const float inv = dn > 0.f ? 1.f / dn : 0.f;
  const int lo = ptr[d], hi = min(ptr[d + 1], e_real);
  for (int b = lo; b < hi; b += hl.teams * U) {
    float x[U][C][V], m[U], ql[U * 2];
    bool ok[U];
    int pos[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      pos[u] = b + hl.team + hl.teams * u;
      ok[u] = pos[u] < hi;
      const int s = ok[u] ? send[pos[u]] : 0;
      m[u] = ok[u] && drop ? drop[(size_t)pos[u] * nh + k] : 1.f;
      hl.load(xl, s, d_feat, ok[u], x[u]);
    }
    // each edge's logit and g . xl[j], reduced over the team together
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ql[u] = logit_part<V, C>(av, x[u], rv, slope);
      float gx = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int v = 0; v < V; ++v) gx = fmaf(gv[c][v], x[u][c][v], gx);
      ql[U + u] = gx;
    }
    team_reduce<U * 2>(ql, lanes);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      const float p = expf(ql[u] - top) * inv;
      const float de = p * (m[u] * ql[U + u] - go[0]);
      if (hl.t == 0) {
        de_out[(size_t)pos[u] * nh + k] = de;
        w_out[(size_t)pos[u] * nh + k] = m[u] * p;
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float z = __fadd_rn(x[u][c][v], rv[c][v]);
          acc[c][v] = fmaf(de, av[c][v] * (z > 0.f ? 1.f : slope),
                           acc[c][v]);
        }
    }
  }
  for (int o = lanes; o < 32; o <<= 1)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[c][v] += __shfl_xor_sync(kFull, acc[c][v], o);
  if (hl.team != 0) return;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (hl.live[c]) store_vec<V>(d_xr + (size_t)d * d_feat + hl.at(c),
                                 acc[c]);
}

// The backward's pass by sender: block b takes the items b, b + gridDim.x,
// ... of the sender runs (ops/cuda/build.py SenderItems: ptr, src, part,
// then the cut senders and their partial rows); warp k head k, teams as
// above over an item's slots. d_xl of an item is summed by team in slot
// order, the teams' sums added in a fixed butterfly, and written to its
// sender's row, or to its partial row where its run is cut. The block's
// d_a terms, over all its items, go to its partial row.
template <int V, int C, int U>
__global__ void __launch_bounds__(kMaxHeads * 32)
gatv2_bwd_src_kernel(const float* __restrict__ xl,
                     const float* __restrict__ xr,
                     const float* __restrict__ att,
                     const int* __restrict__ receivers,
                     const int* __restrict__ order,
                     const int* __restrict__ items, int n_items, int d_feat,
                     int nh, int f, int lanes, float slope,
                     const float* __restrict__ g,
                     const float* __restrict__ de_in,
                     const float* __restrict__ w_in,
                     float* __restrict__ d_xl, float* __restrict__ dh_part,
                     float* __restrict__ da_part) {
  const int k = threadIdx.x >> 5;
  const HeadLanes<V, C> hl(lanes, k, f);
  const int* it_ptr = items;
  const int* it_src = items + n_items + 1;
  const int* it_part = it_src + n_items;
  float av[C][V], da[C][V];
  hl.load(att, 0, 0, true, av);
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int v = 0; v < V; ++v) da[c][v] = 0.f;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int s = it_src[it], lo = it_ptr[it], hi = it_ptr[it + 1];
    float xs[C][V], acc[C][V];
    hl.load(xl, s, d_feat, true, xs);
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[c][v] = 0.f;
    for (int b = lo; b < hi; b += hl.teams * U) {
      float rr[U][C][V], gg[U][C][V], w[U], de[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = b + hl.team + hl.teams * u;
        ok[u] = p < hi;
        int i = 0;
        w[u] = de[u] = 0.f;
        if (ok[u]) {
          const int e = order[p];
          i = receivers[e];
          w[u] = w_in[(size_t)e * nh + k];
          de[u] = de_in[(size_t)e * nh + k];
        }
        hl.load(xr, i, d_feat, ok[u], rr[u]);
        hl.load(g, i, d_feat, ok[u], gg[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float z = __fadd_rn(xs[c][v], rr[u][c][v]);
            const float t = de[u] * (av[c][v] * (z > 0.f ? 1.f : slope));
            acc[c][v] = __fadd_rn(acc[c][v], fmaf(w[u], gg[u][c][v], t));
            da[c][v] = fmaf(de[u], leaky(z, slope), da[c][v]);
          }
      }
    }
    for (int o = lanes; o < 32; o <<= 1)
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[c][v] += __shfl_xor_sync(kFull, acc[c][v], o);
    if (hl.team == 0) {
      const int part = it_part[it];
      float* row = part < 0 ? d_xl + (size_t)s * d_feat
                            : dh_part + (size_t)part * d_feat;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (hl.live[c]) store_vec<V>(row + hl.at(c), acc[c]);
    }
  }
  for (int o = lanes; o < 32; o <<= 1)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v)
        da[c][v] += __shfl_xor_sync(kFull, da[c][v], o);
  if (hl.team != 0) return;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (hl.live[c])
      store_vec<V>(da_part + (size_t)blockIdx.x * d_feat + hl.at(c), da[c]);
}

// the heads, row width and plan the kernels take (ops/cuda/
// gatv2_attention.py plan): V divides f where V > 1, lanes a power of two
// of at most 32, and the lanes' vectors cover f
bool bad_plan(int d_feat, int nh, int f, int vec, int per_lane,
              int lanes) {
  return nh < 1 || nh > kMaxHeads || f < 1 || nh * f != d_feat ||
         (vec > 1 && f % vec) || lanes < 1 || lanes > 32 ||
         (lanes & (lanes - 1)) || vec * lanes * per_lane < f;
}

}  // namespace

extern "C" {

// Forward: out (n, d_feat), mx and den (n, nh). xl, xr (n, d_feat), att
// (nh, f), drop (E, nh) or NULL, senders (E,) of the dst-sorted edges,
// row_ptr (n + 1,) each destination's run; edges >= e_real are padding
// and are not read. dst_order (n,): the destinations in the order the
// blocks take them. vec, per_lane, lanes: the plan.
int gatv2_forward(const float* xl, const float* xr, const float* att,
                  const float* drop, const int* senders, const int* row_ptr,
                  const int* dst_order, int n, int e_real, int d_feat,
                  int nh, int f, int vec, int per_lane, int lanes,
                  float slope, float* out, float* mx, float* den,
                  void* stream) {
  if (bad_plan(d_feat, nh, f, vec, per_lane, lanes) || n < 1)
    return (int)cudaErrorInvalidValue;
  return with_vc<8, 8>(vec, per_lane, [&](auto vv, auto cc) {
    constexpr int V = decltype(vv)::value, C = decltype(cc)::value;
    gatv2_fwd_kernel<V, C, in_flight(C * V)>
        <<<n, nh * 32, 0, (cudaStream_t)stream>>>(
            xl, xr, att, drop, senders, row_ptr, dst_order, e_real, d_feat,
            nh, f, lanes, slope, out, mx, den);
    return (int)cudaGetLastError();
  });
}

// Backward: d_xl, d_xr (n, d_feat) and d_a (nh * f). The forward's inputs,
// its out, mx and den, and dst_order; g (n, d_feat); receivers (E,); order
// (the real edges in sender order) and items (build.sender_items' table of
// n_items items, n_split cut senders) of the sender runs. Scratch: de and
// w (E, nh), dh_part (the items' partial rows), da_part (nblk, d_feat);
// nblk blocks walk the items.
int gatv2_backward(const float* xl, const float* xr, const float* att,
                   const float* drop, const int* senders,
                   const int* receivers, const int* row_ptr,
                   const int* dst_order, const int* order, const int* items,
                   int n_items, int n_split, int n, int e_real, int d_feat,
                   int nh, int f, int vec, int per_lane, int lanes,
                   float slope, const float* g, const float* out,
                   const float* mx, const float* den, float* d_xl,
                   float* d_xr, float* d_a, float* de, float* w,
                   float* dh_part, float* da_part, int nblk, void* stream) {
  if (bad_plan(d_feat, nh, f, vec, per_lane, lanes) || n < 1 || nblk < 1 ||
      n_items < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = with_vc<8, 8>(vec, per_lane, [&](auto vv, auto cc) {
    constexpr int V = decltype(vv)::value, C = decltype(cc)::value;
    gatv2_bwd_dst_kernel<V, C, in_flight(C * V)><<<n, nh * 32, 0, st>>>(
        xl, xr, att, drop, senders, row_ptr, dst_order, e_real, d_feat, nh,
        f, lanes, slope, g, out, mx, den, d_xr, de, w);
    int e = (int)cudaGetLastError();
    if (e) return e;
    gatv2_bwd_src_kernel<V, C, in_flight(2 * C * V)>
        <<<nblk, nh * 32, 0, st>>>(xl, xr, att, receivers, order, items,
                                   n_items, d_feat, nh, f, lanes, slope, g,
                                   de, w, d_xl, dh_part, da_part);
    return (int)cudaGetLastError();
  });
  if (err) return err;
  // the tail of the v5 backward by sender (attention_common.cuh
  // bwd_tail_kernel) without its d(s_dst) blocks: d_a, the blocks' partial
  // rows added in a fixed order, and each cut sender's d_xl, its items'
  // partial rows added in item order
  const int sum_blocks = (d_feat + kSumCols - 1) / kSumCols;
  const int split_blocks =
      (n_split * d_feat + kTailWarps * 32 - 1) / (kTailWarps * 32);
  const int* split_src = items + 3 * n_items + 1;
  bwd_tail_kernel<<<sum_blocks + split_blocks, kTailWarps * 32, 0, st>>>(
      nullptr, nullptr, nullptr, n, nh, e_real, 0, da_part, nblk, d_feat,
      sum_blocks, split_src, split_src + n_split, n_split, d_feat, dh_part,
      nullptr, d_a, d_xl);
  return (int)cudaGetLastError();
}

}  // extern "C"
