// Shared by the attention kernels (v5_attention.cu, window_attention.cu,
// table_attention.cu, segment_attention.cu):
// warp and block reduction helpers, the cross-block second passes, the
// bfloat16 rounding points, the dispatch on the row width and on the
// h table's element type, vector loads and stores, and the bodies that
// several ops share: the source-score pass, the cap stream, the forward
// (attention_fwd_wide, attention_fwd_narrow: the v5 and windowed ops over
// the score tables, the table op over its gathered rows, the v2 op over
// its streamed edge table) and the backward by sender with its tail
// (attention_bwd_by_sender, bwd_tail_kernel: the windowed op over its
// layout, the v5 op over its dst-sorted edge list).
// Everything sits in an anonymous namespace, so each source gets its own
// copy of what it instantiates.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;       // warps per block; one dst node per warp
constexpr int kMaxHeads = 8;    // the wrapper refuses more heads
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCapThreads = 256;  // threads of the cap reduction

// The flags word every attention C entry takes: where the JAX package's
// bfloat16 modes round (ops/cuda/rounding.py Rounding names the same
// points). kBf16Table: h is a bfloat16 table (cast once by the wrapper;
// the logits and every product read its rows). The others round float32
// values in registers: kRoundRows the gathered float32 row after its
// logits are taken, kRoundAcc each edge's [weighted h | ex] before the
// float32 sums of the forward, kRoundPayload a destination's g, inv and
// d(den) in the backward (after d(den) is taken from g), kRoundDh the
// d(h) rows, kRoundDraw d(raw) in d(a_src), kRoundDsdst d(raw) in
// d(s_dst). Every sum stays float32.
constexpr int kRoundRows = 1;
constexpr int kRoundAcc = 2;
constexpr int kRoundPayload = 4;
constexpr int kRoundDh = 8;
constexpr int kRoundDraw = 16;
constexpr int kRoundDsdst = 32;
constexpr int kBf16Table = 64;

// x rounded to the nearest bfloat16, ties to even (as XLA's convert and
// torch's .to(torch.bfloat16)), as a float; never truncated
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float round_if(float x, bool on) {
  return on ? round_bf16(x) : x;
}

// one element of an h table, float32 or bfloat16
__device__ __forceinline__ float load_h(const float* p) { return *p; }
__device__ __forceinline__ float load_h(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// f(h as the table's element type): the C entries take h as void*. A
// library holds the kernels of one element type (bfloat16 where it is
// built with -DGAT_BF16_TABLE, ops/cuda/build.py) and refuses the other.
template <typename F>
int with_table(const void* h, int flags, F&& f) {
#ifdef GAT_BF16_TABLE
  if (!(flags & kBf16Table)) return (int)cudaErrorInvalidValue;
  return f(static_cast<const __nv_bfloat16*>(h));
#else
  if (flags & kBf16Table) return (int)cudaErrorInvalidValue;
  return f(static_cast<const float*>(h));
#endif
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: float addition commutes, so every lane ends bitwise equal
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The raw logit of an edge is no dot in any kernel: every v5 and windowed
// kernel takes it from the source-score table, s_src[src, k] +
// s_dst[dst, k] (source_scores_kernel below), so the cap pass, the forward
// and the backward get the same bits for the same edge: the 2-phase argmax
// edge then has raw - cap == 0 exactly, where LeakyReLU's slope-at-0
// convention decides its gradient.

// LeakyReLU as the 2-phase kernels apply it: the slope at x <= 0
__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : slope * x;
}

// The backward modes: kNorm (the sweep-1 op's normalised epilogue, eps'
// read from device memory), kParts (raw cotangents of the parts),
// kTwoPhase (the 2-phase op: the full LeakyReLU, the plain eps, and a
// d(cap) output). The forwards take their mode as a flag (FwdArgs).
enum class Bwd { kNorm, kParts, kTwoPhase };

// (m, c) <- the larger value; on a tie, the lower (edge, head) code
__device__ __forceinline__ void take_max(float& m, int& c, float v, int vc) {
  if (v > m || (v == m && vc < c)) {
    m = v;
    c = vc;
  }
}

// Global (max, lowest code) over the per-block partials: one block, a
// strided scan then a shared-memory tree. max and min-code are exact, so
// the result does not depend on the order of the comparisons.
__global__ void __launch_bounds__(kCapThreads)
cap_reduce_kernel(const float* __restrict__ blk_max,
                  const int* __restrict__ blk_code, int nblk,
                  float* __restrict__ cap, int* __restrict__ code) {
  __shared__ float sm[kCapThreads];
  __shared__ int sc[kCapThreads];
  const int t = threadIdx.x;
  float m = -INFINITY;
  int c = INT_MAX;
  for (int b = t; b < nblk; b += kCapThreads)
    take_max(m, c, blk_max[b], blk_code[b]);
  sm[t] = m;
  sc[t] = c;
  __syncthreads();
  for (int s = kCapThreads / 2; s > 0; s >>= 1) {
    if (t < s) take_max(sm[t], sc[t], sm[t + s], sc[t + s]);
    __syncthreads();
  }
  if (t == 0) {
    *cap = sm[0];
    *code = sc[0];
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// -- vectors ------------------------------------------------------------------

template <int N>
using Int = std::integral_constant<int, N>;

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// V consecutive floats from p, in one load of V elements (aligned to its
// size)
template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

// V consecutive floats read or written once (a stream through device
// memory that L2 need not keep: evict-first)
template <int V>
__device__ __forceinline__ void load_vec_cs(const float* __restrict__ p,
                                            float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = __ldcs(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec_cs(float* __restrict__ p,
                                             const float (&v)[V]) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcs(p, v[0]);
  }
}

// V consecutive elements of T, loaded in one load of V elements (aligned
// to its size) and read as floats by e(). A bfloat16 vector keeps its
// loaded bits and widens each element where it is read: widened at the
// load, every load waited for its data before the next was issued.
template <typename T, int V>
struct Vec;

template <int V>
struct Vec<float, V> {
  float v[V];
  __device__ __forceinline__ void load(const float* __restrict__ p) {
    load_vec<V>(p, v);
  }
  // read once from device memory (evict-first): a streamed table
  __device__ __forceinline__ void load_cs(const float* __restrict__ p) {
    load_vec_cs<V>(p, v);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = 0.f;
  }
  __device__ __forceinline__ float e(int i) const { return v[i]; }
};

template <int V>
struct Vec<__nv_bfloat16, V> {
  using Bits = std::conditional_t<
      V == 4, uint2, std::conditional_t<V == 2, unsigned, unsigned short>>;
  Bits q;
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ p) {
    q = *reinterpret_cast<const Bits*>(p);
  }
  __device__ __forceinline__ void zero() { q = Bits{}; }
  // a bfloat16 is the high half of its float
  __device__ __forceinline__ float e(int i) const {
    if constexpr (V == 4) {
      const unsigned w = i < 2 ? q.x : q.y;
      return __uint_as_float(i % 2 ? w & 0xffff0000u : w << 16);
    } else if constexpr (V == 2) {
      return __uint_as_float(i ? q & 0xffff0000u : q << 16);
    } else {
      return __uint_as_float((unsigned)q << 16);
    }
  }
};

template <int V>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// v's elements idx .. idx + V - 1 that lie in [lo, hi): one vector store
// where all do
template <int V>
__device__ __forceinline__ void store_in(float* __restrict__ p,
                                         const float (&v)[V], int idx,
                                         int lo, int hi) {
  if (idx >= lo && idx + V <= hi) {
    store_vec<V>(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (idx + e >= lo && idx + e < hi) p[e] = v[e];
  }
}

// edges whose row loads a lane keeps in flight: U x C x V elements
__host__ __device__ constexpr int in_flight(int elems) {
  return elems >= 32 ? 1 : elems >= 16 ? 2 : elems >= 8 ? 4 : 8;
}

// U warp sums at once (U a power of two): each step halves the values a
// lane holds, exchanging the half its partner keeps, so the U sums take
// U - 1 + log2(32 / U) shuffles, not 5 U. Returns the sum of q[lane /
// (32 / U)]; q is overwritten.
template <int U>
__device__ __forceinline__ float warp_sums(float (&q)[U], int lane) {
#pragma unroll
  for (int m = U, o = 16; m > 1; m >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int j = 0; j < m / 2; ++j) {
      const float keep = up ? q[j + m / 2] : q[j];
      const float give = up ? q[j] : q[j + m / 2];
      q[j] = keep + __shfl_xor_sync(kFull, give, o);
    }
  }
  float s = q[0];
#pragma unroll
  for (int o = 16 / U; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// warp_sums over each team of `lanes` lanes (a power of two >= KP, KP a
// power of two; a team is an aligned group of lanes): KP - 1 +
// log2(lanes / KP) shuffles. Lane t of a team returns the team's sum of
// q[t / (lanes / KP)]; q is overwritten.
template <int KP>
__device__ __forceinline__ float team_sums(float (&q)[KP], int lane,
                                           int lanes) {
  int o = lanes >> 1;
#pragma unroll
  for (int m = KP; m > 1; m >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int j = 0; j < m / 2; ++j) {
      const float keep = up ? q[j + m / 2] : q[j];
      const float give = up ? q[j] : q[j + m / 2];
      q[j] = keep + __shfl_xor_sync(kFull, give, o);
    }
  }
  float s = q[0];
  for (; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// -- the backwards' d(den) prologue -------------------------------------------
//
// dden[d, k] = -inv[d, k] * sum over head k's features j of out[d, kf+j] *
// g[d, kf+j], inv = den > 0 ? 1 / (den + eps) : 0: the per-destination
// d(den) term of the normalised backwards of the table and v2 ops
// (table_attention.cu, segment_attention.cu). Heads of at least 32
// features: one warp a (destination, head), the products summed with fmaf
// in a fixed order and a butterfly; narrower heads: one thread a
// (destination, head), its products summed with fmaf in feature order.
constexpr int kDdenWarps = 8;

// (destination, head) w's d(den), by the whole warp (f >= 32)
__device__ __forceinline__ void dden_warp(const float* __restrict__ g,
                                          const float* __restrict__ out,
                                          const float* __restrict__ den,
                                          int d_feat, int nh, int f,
                                          float eps, float* __restrict__ dden,
                                          int w) {
  const int lane = threadIdx.x & 31;
  const int d = w / nh, k = w - d * nh;
  const size_t base = (size_t)d * d_feat + (size_t)k * f;
  float p = 0.f;
#pragma unroll 4
  for (int j = lane; j < f; j += 32) p = fmaf(out[base + j], g[base + j], p);
  const float dn = den[w];
  const float inv = dn > 0.f ? 1.f / (dn + eps) : 0.f;
  const float s = warp_sum(p);
  if (lane == 0) dden[w] = -s * inv;
}

// (destination, head) w's d(den), by one thread (f < 32)
__device__ __forceinline__ void dden_thread(const float* __restrict__ g,
                                            const float* __restrict__ out,
                                            const float* __restrict__ den,
                                            int d_feat, int nh, int f,
                                            float eps,
                                            float* __restrict__ dden, int w) {
  const int d = w / nh, k = w - d * nh;
  const size_t base = (size_t)d * d_feat + (size_t)k * f;
  float p = 0.f;
  for (int j = 0; j < f; ++j) p = fmaf(out[base + j], g[base + j], p);
  const float dn = den[w];
  const float inv = dn > 0.f ? 1.f / (dn + eps) : 0.f;
  dden[w] = -p * inv;
}

__global__ void __launch_bounds__(kDdenWarps * 32, 1)
dden_kernel(const float* __restrict__ g, const float* __restrict__ out,
            const float* __restrict__ den, int n, int d_feat, int nh, int f,
            float eps, float* __restrict__ dden) {
  const int w = blockIdx.x * kDdenWarps + (threadIdx.x >> 5);
  if (w >= n * nh) return;  // the whole warp
  dden_warp(g, out, den, d_feat, nh, f, eps, dden, w);
}

__global__ void __launch_bounds__(kDdenWarps * 32, 1)
dden_narrow_kernel(const float* __restrict__ g, const float* __restrict__ out,
                   const float* __restrict__ den, int n, int d_feat, int nh,
                   int f, float eps, float* __restrict__ dden) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n * nh) return;
  dden_thread(g, out, den, d_feat, nh, f, eps, dden, w);
}

inline int launch_dden(const float* g, const float* out, const float* den,
                       int n, int d_feat, int nh, int f, float eps,
                       float* dden, cudaStream_t st) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int threads = kDdenWarps * 32;
  if (f >= 32) {
    const int blocks = (n * nh + kDdenWarps - 1) / kDdenWarps;
    dden_kernel<<<blocks, threads, 0, st>>>(g, out, den, n, d_feat, nh, f,
                                            eps, dden);
  } else {
    const int blocks = (n * nh + threads - 1) / threads;
    dden_narrow_kernel<<<blocks, threads, 0, st>>>(g, out, den, n, d_feat,
                                                   nh, f, eps, dden);
  }
  return (int)cudaGetLastError();
}

// out[i] = sum over the rows r < nrows, in order, of part[r, i], for the
// kSumCols columns i of block `blk` (of ceil(len / kSumCols) blocks of
// WARPS warps): warp w adds the rows w, w + WARPS, ..., lane l column
// blk * kSumCols + l, then the warps' sums are added in warp order. A fixed
// order whatever the grid of the pass that wrote the rows.
constexpr int kSumCols = 32;

template <int WARPS>
__device__ __forceinline__ void sum_rows_block(const float* __restrict__ part,
                                               int nrows, int len, int blk,
                                               float* __restrict__ out) {
  __shared__ float ws[WARPS][kSumCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blk * kSumCols + lane;
  float s = 0.f;
  if (i < len) {
#pragma unroll 4
    for (int r = warp; r < nrows; r += WARPS) s += part[(size_t)r * len + i];
  }
  ws[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < len) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += ws[w][lane];
    out[i] = t;
  }
}

// The plan of a kernel that gives a whole row to a team of `lanes` lanes
// (ops/cuda/v5_attention.py row_plan): lane t of a team holds the vectors
// of V elements starting at V * (t + lanes * c), c < C; teams of at least
// kMaxHeads lanes (team_sums over the heads), a vector meeting at most two
// heads (V <= f + 1), every pointer aligned to V elements.
inline bool row_plan_ok(int d_feat, int nh, int f, int vec, int per_lane,
                        int lanes) {
  const bool pow2 = lanes >= kMaxHeads && lanes <= 32 && !(lanes & (lanes - 1));
  return d_feat >= 1 && d_feat <= 1024 && nh >= 1 && nh <= kMaxHeads &&
         nh * f == d_feat && vec >= 1 && per_lane >= 1 && !(d_feat % vec) &&
         pow2 && lanes * vec * per_lane >= d_feat &&
         (f % vec == 0 || vec <= f + 1);
}

// The rows a team of such a kernel keeps in flight: one at 12 or more
// elements a lane (one team a warp: more held more registers, and the
// warps an SM fewer, and took longer on the card, PERF.md), else
// in_flight's, at most four (eight left a team's per-head partial sums of
// every row live at once, and ptxas spilled them)
__host__ __device__ constexpr int row_flight(int elems) {
  return elems >= 12 ? 1 : in_flight(elems) < 4 ? in_flight(elems) : 4;
}

// A lane's place in such a plan: its team g and lane t in the team, and
// per vector c its first element j0, whether it lies in the row (live),
// the heads h0 and h1 of its first and last element, and whether element
// v of it is head h0's (first). The heads are packed four bits a vector
// and the elements one bit each, worked out once: taken per element, the
// divisions by f cost more than the row's loads at 6 x 121, and arrays of
// them took 160 registers at 32 elements a lane.
template <int V, int C>
struct RowLanes {
  static_assert(V * C <= 32, "one mask bit an element");
  int teams, g, t, lanes, d_feat;
  bool split;
  unsigned firsts;                 // bit V*c + v: element v is head h0's
  unsigned heads[(C + 7) / 8];     // h0 of vector c: 4 bits at 4*(c%8)
  __device__ __forceinline__ RowLanes(int lane, int lanes_, int d_feat_,
                                      int f)
      : teams(32 / lanes_), g(lane / lanes_), t(lane & (lanes_ - 1)),
        lanes(lanes_), d_feat(d_feat_), split(f % V != 0), firsts(0u) {
#pragma unroll
    for (int i = 0; i < (C + 7) / 8; ++i) heads[i] = 0u;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0(c);
      const int h = j < d_feat ? j / f : 0;
      heads[c / 8] |= (unsigned)h << (4 * (c % 8));
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (j >= d_feat || j + v < (h + 1) * f) firsts |= 1u << (V * c + v);
    }
  }
  // at 16 or more elements a lane the plan has one team of 32 lanes: the
  // offsets are then constants past t (a register each, else)
  __device__ __forceinline__ int j0(int c) const {
    if constexpr (V * C >= 16) {
      return V * (t + 32 * c);
    } else {
      return V * (t + lanes * c);
    }
  }
  __device__ __forceinline__ bool live(int c) const {
    return j0(c) < d_feat;
  }
  __device__ __forceinline__ int h0(int c) const {
    return (heads[c / 8] >> (4 * (c % 8))) & 15;
  }
  // element v of vector c belongs to head h0 (else h1 = h0 + 1)
  __device__ __forceinline__ bool first(int c, int v) const {
    return (firsts >> (V * c + v)) & 1u;
  }
  __device__ __forceinline__ int h1(int c) const {
    return h0(c) + (((~firsts >> (V * c)) & ((1u << V) - 1u)) ? 1 : 0);
  }
  // q[k] += this lane's part of sum over head k's elements of x * y
  __device__ __forceinline__ void add_head_dots(const float (&x)[V],
                                                const float (&y)[V], int c,
                                                float (&q)[kMaxHeads]) const {
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (first(c, v)) {
        p0 = fmaf(x[v], y[v], p0);
      } else {
        p1 = fmaf(x[v], y[v], p1);
      }
    }
    const int k0 = h0(c);
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k) {
      if (k == k0) q[k] += p0;
      if (split && k == k0 + 1) q[k] += p1;
    }
  }
  // q[k] = this lane's part of sum over head k's elements of x * y
  __device__ __forceinline__ void head_dots(const float (&x)[C][V],
                                            const float (&y)[C][V],
                                            float (&q)[kMaxHeads]) const {
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k) q[k] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) add_head_dots(x[c], y[c], c, q);
  }
};

// V consecutive floats of shared memory at p, read where they are used:
// volatile, so that the compiler does not hoist a loop-invariant table
// (a_src, nh x 32 floats a lane at wide rows) into registers; sts_vec
// writes them, volatile too, so that the two stay in program order
template <int V>
__device__ __forceinline__ void lds_vec(const float* p, float (&v)[V]) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if constexpr (V == 4) {
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "r"(a));
  } else if constexpr (V == 2) {
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                 : "=f"(v[0]), "=f"(v[1])
                 : "r"(a));
  } else {
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[0]) : "r"(a));
  }
}

template <int V>
__device__ __forceinline__ void sts_vec(float* p, const float (&v)[V]) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if constexpr (V == 4) {
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(a),
                 "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]));
  } else if constexpr (V == 2) {
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(a), "f"(v[0]),
                 "f"(v[1]));
  } else {
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v[0]));
  }
}

// p[0, V) += t, V consecutive floats of shared memory, aligned to V
template <int V>
__device__ __forceinline__ void sts_add(float* p, const float (&t)[V]) {
  if constexpr (V == 4) {
    float4* q = reinterpret_cast<float4*>(p);
    float4 x = *q;
    x.x = __fadd_rn(x.x, t[0]);
    x.y = __fadd_rn(x.y, t[1]);
    x.z = __fadd_rn(x.z, t[2]);
    x.w = __fadd_rn(x.w, t[3]);
    *q = x;
  } else if constexpr (V == 2) {
    float2* q = reinterpret_cast<float2*>(p);
    float2 x = *q;
    x.x = __fadd_rn(x.x, t[0]);
    x.y = __fadd_rn(x.y, t[1]);
    *q = x;
  } else {
    *p = __fadd_rn(*p, t[0]);
  }
}

// fn(Int<V>, Int<C>) for the vector width `vec` and the vectors a lane
// holds `per_lane`, among the pairs with V * C <= LIMIT elements a lane
// and C <= MAXC; cudaErrorInvalidValue for any other pair
#define GAT_TRY_VC(VV, CC)                                      \
  if constexpr (VV * CC <= LIMIT && CC <= MAXC)                 \
    if (vec == VV && per_lane == CC) return fn(Int<VV>{}, Int<CC>{});
template <int LIMIT, int MAXC, typename F>
int with_vc(int vec, int per_lane, F&& fn) {
  GAT_TRY_VC(4, 1) GAT_TRY_VC(4, 2) GAT_TRY_VC(4, 4) GAT_TRY_VC(4, 8)
  GAT_TRY_VC(2, 1) GAT_TRY_VC(2, 2) GAT_TRY_VC(2, 4) GAT_TRY_VC(2, 8)
  GAT_TRY_VC(2, 16)
  GAT_TRY_VC(1, 1) GAT_TRY_VC(1, 2) GAT_TRY_VC(1, 4) GAT_TRY_VC(1, 8)
  GAT_TRY_VC(1, 16) GAT_TRY_VC(1, 32)
  return (int)cudaErrorInvalidValue;
}

// with_vc's pairs and those of three vectors a lane, which row_plan gives
// a team of 32 lanes where three cover the row (three=True: a 320-float
// row in three vectors of four, not four with the last one dead)
template <int LIMIT, int MAXC, typename F>
int with_vc_rows(int vec, int per_lane, F&& fn) {
  GAT_TRY_VC(4, 3) GAT_TRY_VC(2, 3) GAT_TRY_VC(1, 3)
  return with_vc<LIMIT, MAXC>(vec, per_lane, fn);
}
#undef GAT_TRY_VC

// The split of a head's elements over a warp (table_attention.cu, and the
// v2 backward at f >= 32): lane l holds the vectors b + V*(l + 32c), c < C,
// b the vector that holds the head's first element.
// fn(Int<V>): the widest vector of V elements to which every row of the
// h table (elements of T) and of the float tables a, b is aligned: 4 where
// it divides f (no vector straddles two heads), else 2 where it divides the
// row (a vector may straddle two heads: the kernels mask by element), else 1
template <typename T, typename F>
int with_vec(int f, int d_feat, const T* h, const float* a, const float* b,
             F&& fn) {
  if (f % 4 == 0 && aligned(h, 4 * sizeof(T)) && aligned(a, 16) &&
      aligned(b, 16))
    return fn(Int<4>{});
  if (d_feat % 2 == 0 && aligned(h, 2 * sizeof(T)) && aligned(a, 8) &&
      aligned(b, 8))
    return fn(Int<2>{});
  return fn(Int<1>{});
}

// fn(Int<C>): the vectors a lane needs to cover head k's elements from the
// vector that holds the first, C*V <= 32
template <int V, typename F>
int with_c(int f, F&& fn) {
  const int span = f % V ? f + V - 1 : f;
  const int c_need = (span + 32 * V - 1) / (32 * V);
  if (c_need <= 1) return fn(Int<1>{});
  if (c_need <= 2) return fn(Int<2>{});
  if (c_need <= 4) return fn(Int<4>{});
  if (c_need <= 8) return fn(Int<8>{});
  if constexpr (V <= 2)
    if (c_need <= 16) return fn(Int<16>{});
  if constexpr (V == 1)
    if (c_need <= 32) return fn(Int<32>{});
  return (int)cudaErrorInvalidValue;
}

// The (max, lowest code) of every thread of the block into
// blk_max / blk_code[blockIdx.x]: a butterfly over each warp, then thread
// 0 over the warps. take_max is exact, so the order does not matter.
__device__ __forceinline__ void block_max_partial(float m, int c,
                                                  float* __restrict__ blk_max,
                                                  int* __restrict__ blk_code) {
  __shared__ float wmax[kWarps];
  __shared__ int wcode[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(kFull, m, o);
    const int oc = __shfl_xor_sync(kFull, c, o);
    take_max(m, c, om, oc);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    wmax[warp] = m;
    wcode[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      take_max(m, c, wmax[w], wcode[w]);
    blk_max[blockIdx.x] = m;
    blk_code[blockIdx.x] = c;
  }
}

// -- the source-score pass ---------------------------------------------------
//
// s_src[s, k] = h[s, :] . a_src[:, k], float32, for every row s of the h
// table the kernels read (a bfloat16 table in the kBf16Table mode; under
// kRoundRows the float32 rows, before they are rounded). Written once per
// op call; every v5 and windowed kernel takes its raw logit from it,
// s_src[src, k] + s_dst[dst, k], and computes no source dot. It replaces
// the per-edge h_blk @ a_src of the TPU kernels _kernel_v5_auto, _kernel_v5
// and _kernel_v5_cap (gat_pytorch_tpu/ops/pallas/segment_attention.py),
// _kernel_v5_bwd (segment_attention_bwd.py), _kernel_v6 and _kernel_v6_bwd
// (segment_attention_window.py), which recompute the sender's dot on every
// edge: about 24 times a sender on PPI.
// Design. A team of `lanes` lanes (a power of two) reads a row in
// vectors of V elements, C of them a lane in flight, chunk after chunk of
// lanes * V * C elements; a_src sits transposed in shared memory and is
// read as V-float vectors. Each lane sums its elements per head with fmaf
// in a fixed order and the team adds its lanes' sums in a butterfly: no
// atomics, and a row's sums depend on nothing but the row and the plan
// (not on its position in the table, the block or the grid), so two
// launches give the same bits. What bounds it: reading the h table once
// (n_src x d_feat elements) and writing the table, about 0.003 ms for
// PPI's 2,432 x 1024 floats at 3.35 TB/s.
constexpr int kScoreThreads = 256;

template <int V, int C, typename T>
__global__ void __launch_bounds__(kScoreThreads)
source_scores_kernel(const T* __restrict__ h, const float* __restrict__ a_src,
                     int n_src, int d_feat, int nh, int lanes,
                     float* __restrict__ s_src) {
  extern __shared__ float sa[];  // a_src transposed, (nh, d_feat)
  for (int i = threadIdx.x; i < d_feat * nh; i += blockDim.x)
    sa[(i % nh) * d_feat + i / nh] = a_src[i];
  __syncthreads();
  const int t = threadIdx.x & (lanes - 1);
  const int teams = kScoreThreads / lanes;
  const int chunk = lanes * V * C;
  for (int base = blockIdx.x * teams; base < n_src;
       base += gridDim.x * teams) {  // the same passes for every lane
    const int r = base + (int)threadIdx.x / lanes;
    const bool ok = r < n_src;
    const T* row = h + (size_t)(ok ? r : 0) * d_feat;
    float p[kMaxHeads];
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k) p[k] = 0.f;
    for (int c0 = 0; c0 < d_feat; c0 += chunk) {
      Vec<T, V> hv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = c0 + V * (t + lanes * c);
        if (ok && j < d_feat) {
          hv[c].load(row + j);
        } else {
          hv[c].zero();
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = c0 + V * (t + lanes * c);
        if (j >= d_feat) continue;
#pragma unroll
        for (int k = 0; k < kMaxHeads; ++k) {
          if (k >= nh) continue;
          float av[V];
          load_vec<V>(sa + k * d_feat + j, av);
#pragma unroll
          for (int v = 0; v < V; ++v) p[k] = fmaf(hv[c].e(v), av[v], p[k]);
        }
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k)
        if (k < nh) p[k] += __shfl_xor_sync(kFull, p[k], o);
    }
    if (ok) {
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k)
        if (k < nh && (k & (lanes - 1)) == t)
          s_src[(size_t)r * nh + k] = p[k];
    }
  }
}

// -- the cap stream -----------------------------------------------------------
//
// The 2-phase cap pass (v5_cap, window_cap): the max over the slots i <
// count with recv[i] >= 0 and the heads k of s_src[send[i], k] +
// s_dst[recv[i], k], the same sum the forward and the backward take, and
// its lowest code i*nh + k; per-block partials, then cap_reduce_kernel.
// A stream over count x nh scores: no h row is read.
constexpr int kStreamThreads = 256;

__global__ void __launch_bounds__(kStreamThreads)
cap_stream_kernel(const float* __restrict__ s_src,
                  const float* __restrict__ s_dst,
                  const int* __restrict__ send, const int* __restrict__ recv,
                  int count, int nh, float* __restrict__ blk_max,
                  int* __restrict__ blk_code) {
  float m = -INFINITY;
  int code = INT_MAX;
  const int total = count * nh;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    const int i = idx / nh, k = idx - i * nh;
    const int r = recv[i];
    if (r < 0) continue;  // a pad slot of the window layout
    take_max(m, code,
             s_src[(size_t)send[i] * nh + k] + s_dst[(size_t)r * nh + k],
             idx);
  }
  block_max_partial(m, code, blk_max, blk_code);
}

int launch_cap_stream(const float* s_src, const float* s_dst,
                      const int* send, const int* recv, int count, int nh,
                      float* blk_max, int* blk_code, float* cap, int* code,
                      int nblk, void* stream) {
  if (count < 0 || nh < 1 || nh > kMaxHeads || nblk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cap_stream_kernel<<<nblk, kStreamThreads, 0, st>>>(
      s_src, s_dst, send, recv, count, nh, blk_max, blk_code);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cap_reduce_kernel<<<1, kCapThreads, 0, st>>>(blk_max, blk_code, nblk, cap,
                                               code);
  return (int)cudaGetLastError();
}

// -- the forward -------------------------------------------------------------
//
// The forwards of four ops, which differ only in where an edge's weight
// and row come from (Src):
//   kScores  the v5 op (v5_fwd_kernel) and the windowed op
//            (window_fwd_kernel): destination d's run of edge positions p
//            in [ptr[d], min(ptr[d+1], e_end)); its slot is perm[p] (the
//            window layout's dst_perm) or p (perm NULL: the v5 op's
//            dst-sorted edges); the slot's sender send[slot], mask row
//            drop[slot, :] and argmax code slot*nh + k. Per (slot, head):
//            raw = s_src[send, k] + s_dst[d, k]; the sweep-1 mode takes
//            ex = exp(slope * raw) (s_dst B-shifted), tracks the (max raw,
//            lowest code) and writes num unnormalised; the 2-phase mode
//            takes ex = exp(leaky(raw - *cap_in)) and writes out = num /
//            (den + eps), 0 where den == 0;
//   kLogits  the table op (table_fwd_kernel): edge p of the run, ex =
//            exp(logits[p, k]), the row h[send[p]] gathered (from L2,
//            where the (n_src, d) table sits);
//   kStream  the v2 op (v2_fwd_kernel): edge p of the run, ex =
//            exp(logits[p, k]), the row h[p] of the pre-gathered (E, d)
//            edge table, read once from device memory with evict-first
//            loads (__ldcs): nothing else reads it, and L2 is kept for
//            the logits and the outputs.
// The logit ops write out = num / (den + eps), 0 where den == 0, where
// `norm`, else num (the v2 op's partial mode). den sums ex (no mask), num
// ex * drop * row, each edge's terms rounded to bfloat16 first where
// kRoundAcc.
enum class Src { kScores, kLogits, kStream };

template <typename T>
struct FwdArgs {
  const T* h;            // (n_src, d_feat); kStream: (E, d_feat) edge rows
  const float* s_src;    // (n_src, nh), the source-score table (kScores)
  const float* s_dst;    // (n, nh) (kScores)
  const float* drop;     // (slots, nh) or NULL
  const int* send;
  const int* perm;       // NULL: a slot is its position
  const int* ptr;        // (n + 1,)
  int n, e_end, d_feat, nh, f, lanes;
  float slope, eps;
  int flags;
  bool two_phase;
  const float* cap_in;   // the 2-phase mode's cap
  float* num;            // (n, d_feat): num, or out in the 2-phase mode
  float* den;            // (n, nh)
  float* blk_max;        // (gridDim.x,): the sweep-1 (max, code) partials
  int* blk_code;
  const float* logits;   // (E, nh): kLogits and kStream
  bool norm;             // kLogits and kStream: write out, else num
};

// ex of one (slot, head) from its score: (w = ex * m, the weight of the
// sender's row; term = ex, rounded where kRoundAcc, den's), the sweep-1
// (max, code) updated
template <bool RACC, typename T>
__device__ __forceinline__ void edge_weight(const FwdArgs<T>& a, float raw,
                                            float cap, float m, int code,
                                            float& vmax, int& vcode,
                                            float& w, float& term) {
  float ex;
  if (a.two_phase) {
    ex = expf(leaky(raw - cap, a.slope));
  } else {
    take_max(vmax, vcode, raw, code);
    ex = expf(a.slope * raw);
  }
  term = RACC ? round_bf16(ex) : ex;
  w = ex * m;
}

// the same from a given logit (kLogits, kStream)
template <bool RACC>
__device__ __forceinline__ void logit_weight(float logit, float m, float& w,
                                             float& term) {
  const float ex = expf(logit);
  term = RACC ? round_bf16(ex) : ex;
  w = ex * m;
}

// acc += w * x, each product rounded to bfloat16 first where RACC
template <bool RACC>
__device__ __forceinline__ void add_term(float& acc, float w, float x) {
  acc = RACC ? __fadd_rn(acc, round_bf16(__fmul_rn(w, x))) : fmaf(w, x, acc);
}

// An edge's row: its sender's (kScores, kLogits: src, shuffled in from the
// lane that loaded it) or its own, at edge position pos (kStream), whose
// loads are evict-first
template <Src SRC, typename T>
__device__ __forceinline__ const T* edge_row(const FwdArgs<T>& a, int pos,
                                             int src) {
  return a.h + (size_t)(SRC == Src::kStream ? pos : src) * a.d_feat;
}

template <Src SRC, typename T, int V>
__device__ __forceinline__ void load_row(Vec<T, V>& v, const T* p) {
  if constexpr (SRC == Src::kStream) {
    v.load_cs(p);
  } else {
    v.load(p);
  }
}

// Rows of f >= 32 features a head (PPI's 4 x 256 and 6 x 121): a block of
// nh warps a destination, warp k head k. Lane l holds the vectors b +
// V*(l + 32c), c < C, of the row, b the vector that holds the head's first
// element; V = 4 where it divides f, else 2 where it divides the row
// (6 x 121: heads start mid-vector, and the elements of a neighbouring
// head are kept out of the stores), else 1. The edges come 32 at a time:
// lane i takes edge i's slot, sender, score (or logit) and mask entry and
// its exp once (after the batch's first row loads are issued), and the
// warp hands them out by shuffles. Each lane issues U edges' row loads
// before it uses them and adds w * h in ascending edge order.
template <int V, int C, bool RACC, Src SRC, typename T>
__device__ __forceinline__ void attention_fwd_wide(const FwdArgs<T>& a) {
  constexpr int U = in_flight(C * V);
  constexpr bool kScore = SRC == Src::kScores;
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  const int nh = a.nh, d_feat = a.d_feat;
  const int lo_k = k * a.f, hi_k = lo_k + a.f;  // head k's elements
  const int col = lo_k - lo_k % V + V * lane;   // the lane's first vector
  bool live[C];
#pragma unroll
  for (int c = 0; c < C; ++c) live[c] = col + 32 * V * c < hi_k;
  const bool r_rows = kScore && (a.flags & kRoundRows);
  const float cap = kScore && a.two_phase ? *a.cap_in : 0.f;
  // the epilogue's quotient: the 2-phase mode, or a logit op's `norm`
  const bool norm = kScore ? a.two_phase : a.norm;
  float vmax = -INFINITY;
  int vcode = INT_MAX;

  for (int d = blockIdx.x; d < a.n; d += gridDim.x) {
    float acc[C][V];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[c][v] = 0.f;
    float dsum = 0.f;
    const float sd = kScore ? a.s_dst[(size_t)d * nh + k] : 0.f;
    const int lo = a.ptr[d], hi = min(a.ptr[d + 1], a.e_end);
    for (int b = lo; b < hi; b += 32) {
      const int cnt = min(32, hi - b);
      // lane i: edge b + i's slot, sender, score (logit) and mask entry
      int slot = 0, src = 0;
      float ss = 0.f, m = 1.f, w = 0.f, term = 0.f;
      if (lane < cnt) {
        slot = kScore && a.perm ? a.perm[b + lane] : b + lane;
        if constexpr (SRC != Src::kStream) src = a.send[slot];
        ss = kScore ? a.s_src[(size_t)src * nh + k]
                    : a.logits[(size_t)slot * nh + k];
        if (a.drop) m = a.drop[(size_t)slot * nh + k];
      }
      for (int i0 = 0; i0 < cnt; i0 += U) {
        Vec<T, V> hv[U][C];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u;  // past cnt: nothing is loaded or added
          int s = 0;
          if constexpr (SRC != Src::kStream)
            s = __shfl_sync(kFull, src, i & 31);
          const T* row = edge_row<SRC>(a, b + i, s) + col;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (i < cnt && live[c]) {
              load_row<SRC>(hv[u][c], row + 32 * V * c);
            } else {
              hv[u][c].zero();
            }
          }
        }
        if (i0 == 0 && lane < cnt) {  // the batch's exps, once
          if constexpr (kScore) {
            edge_weight<RACC>(a, ss + sd, cap, m, slot * nh + k, vmax,
                              vcode, w, term);
          } else {
            logit_weight<RACC>(ss, m, w, term);
          }
        }
        float wu[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u;
          wu[u] = __shfl_sync(kFull, w, i & 31);
          const float tu = __shfl_sync(kFull, term, i & 31);
          if (i < cnt) dsum += tu;
        }
        // in ascending edge order: the loads above are all in flight by now
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (i0 + u >= cnt) break;
#pragma unroll
          for (int c = 0; c < C; ++c)
#pragma unroll
            for (int v = 0; v < V; ++v)
              add_term<RACC>(acc[c][v], wu[u],
                             round_if(hv[u][c].e(v), r_rows));
        }
      }
    }
    const float inv = dsum > 0.f ? 1.f / (dsum + a.eps) : 0.f;
    float* orow = a.num + (size_t)d * d_feat + col;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!live[c]) continue;
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) o[v] = norm ? acc[c][v] * inv : acc[c][v];
      store_in<V>(orow + 32 * V * c, o, col + 32 * V * c, lo_k, hi_k);
    }
    if (lane == 0) a.den[(size_t)d * nh + k] = dsum;
  }
  if constexpr (kScore)
    if (!a.two_phase) block_max_partial(vmax, vcode, a.blk_max, a.blk_code);
}

// Rows of f < 32 features a head (Cora's 8 x 8 and 1 x 7, Pubmed's 8 x 8
// and 8 x 3, PATTERN's 4 x 12, 4 x 24 and 1 x 1): one warp a destination,
// split into 32 / lanes teams of `lanes` lanes, each team a whole row:
// lane t of a team holds the vectors V*(t + lanes*c), c < C, and team g
// takes the edges g, g + teams, ... of a batch. A batch is 32 / nh edges:
// lane i*nh + k takes (edge i, head k)'s slot, sender, score (logit), mask
// entry and exp once; a team shuffles in its edge's sender and, per
// vector, the weight of the vector's head, or of its two heads where one
// starts mid-vector (V does not divide f; the plan keeps V <= f + 1, so a
// vector meets at most two heads): there each element is tested against
// the boundary. Each team adds its edges in ascending order, and the
// teams' sums are added in a butterfly at the end; den sums the batch's
// terms in edge order in every lane (head lane % nh), lane k < nh writes
// head k's.
// U: the edges whose rows a team has in flight, 2 where a batch gives a
// team at most two (many heads, few teams: the registers of more would
// only cost resident warps), else in_flight(C * V).
template <int V, int C, int U, bool RACC, Src SRC, typename T>
__device__ __forceinline__ void attention_fwd_narrow(const FwdArgs<T>& a) {
  constexpr bool kScore = SRC == Src::kScores;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nh = a.nh, d_feat = a.d_feat, f = a.f, lanes = a.lanes;
  const int teams = 32 / lanes, g = lane / lanes, t = lane & (lanes - 1);
  const int per = 32 / nh;  // edges a batch
  const int mine = lane / nh, kh = lane - mine * nh;  // (edge, head) owned
  const bool split = f % V != 0;  // a vector may meet two heads
  int j0[C], h0[C], h1[C], cut[C];
  bool live[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    j0[c] = V * (t + lanes * c);
    live[c] = j0[c] < d_feat;
    h0[c] = live[c] ? j0[c] / f : 0;
    h1[c] = live[c] ? (j0[c] + V - 1) / f : 0;
    cut[c] = (h0[c] + 1) * f;  // the first element of head h0 + 1
  }
  const bool r_rows = kScore && (a.flags & kRoundRows);
  const float cap = kScore && a.two_phase ? *a.cap_in : 0.f;
  const bool norm = kScore ? a.two_phase : a.norm;
  float vmax = -INFINITY;
  int vcode = INT_MAX;

  for (int d = blockIdx.x * kWarps + warp; d < a.n;
       d += gridDim.x * kWarps) {
    float acc[C][V];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[c][v] = 0.f;
    float dsum = 0.f;  // head kh's
    const float sd = kScore ? a.s_dst[(size_t)d * nh + kh] : 0.f;
    const int lo = a.ptr[d], hi = min(a.ptr[d + 1], a.e_end);
    for (int b = lo; b < hi; b += per) {
      const int cnt = min(per, hi - b);
      int slot = 0, src = 0;
      float ss = 0.f, m = 1.f, w = 0.f, term = 0.f;
      const bool own = mine < cnt;
      if (own) {
        slot = kScore && a.perm ? a.perm[b + mine] : b + mine;
        if constexpr (SRC != Src::kStream) src = a.send[slot];
        ss = kScore ? a.s_src[(size_t)src * nh + kh]
                    : a.logits[(size_t)slot * nh + kh];
        if (a.drop) m = a.drop[(size_t)slot * nh + kh];
      }
      for (int i0 = 0; i0 < cnt; i0 += teams * U) {
        Vec<T, V> hv[U][C];
        int base[U];  // lane of the team's edge's head 0
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (i0 + u * teams >= cnt) break;  // the same for every lane
          const int i = i0 + u * teams + g;
          base[u] = (i * nh) & 31;
          int s = 0;
          if constexpr (SRC != Src::kStream)
            s = __shfl_sync(kFull, src, base[u]);
          const T* row = edge_row<SRC>(a, b + i, s);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (i < cnt && live[c]) {
              load_row<SRC>(hv[u][c], row + j0[c]);
            } else {
              hv[u][c].zero();
            }
          }
        }
        if (i0 == 0) {  // the batch's exps, once, and their den terms
          if (own) {
            if constexpr (kScore) {
              edge_weight<RACC>(a, ss + sd, cap, m, slot * nh + kh, vmax,
                                vcode, w, term);
            } else {
              logit_weight<RACC>(ss, m, w, term);
            }
          }
          for (int i = 0; i < cnt; ++i)
            dsum += __shfl_sync(kFull, term, i * nh + kh);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (i0 + u * teams >= cnt) break;
          const int i = i0 + u * teams + g;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float w0 = __shfl_sync(kFull, w, base[u] + h0[c]);
            const float w1 =
                split ? __shfl_sync(kFull, w, base[u] + h1[c]) : w0;
            if (i >= cnt) continue;
#pragma unroll
            for (int v = 0; v < V; ++v)
              add_term<RACC>(acc[c][v], j0[c] + v < cut[c] ? w0 : w1,
                             round_if(hv[u][c].e(v), r_rows));
          }
        }
      }
    }
    // the teams' sums, in a fixed order
    for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[c][v] += __shfl_xor_sync(kFull, acc[c][v], o);
    }
    const float inv = dsum > 0.f ? 1.f / (dsum + a.eps) : 0.f;  // head kh
    float* orow = a.num + (size_t)d * d_feat;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float i0v = 1.f, i1v = 1.f;
      if (norm) {  // lane k < nh holds head k's
        i0v = __shfl_sync(kFull, inv, h0[c]);
        i1v = split ? __shfl_sync(kFull, inv, h1[c]) : i0v;
      }
      if (g != 0 || !live[c]) continue;
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        o[v] = norm ? acc[c][v] * (j0[c] + v < cut[c] ? i0v : i1v)
                    : acc[c][v];
      store_vec<V>(orow + j0[c], o);
    }
    if (lane < nh) a.den[(size_t)d * nh + lane] = dsum;
  }
  if constexpr (kScore)
    if (!a.two_phase) block_max_partial(vmax, vcode, a.blk_max, a.blk_code);
}

// Checks the lane plan (wide, vec, per_lane, lanes, unroll) that the wrapper
// chose (ops/cuda/v5_attention.py lane_plan) against the shapes and the
// pointers: cudaSuccess where the kernels cover every element once.
template <typename T>
int check_plan(const FwdArgs<T>& a, int wide, int vec, int per_lane) {
  const int d = a.d_feat, f = a.f, lanes = a.lanes;
  if (d < 1 || d > 1024 || a.nh < 1 || a.nh > kMaxHeads || a.nh * f != d ||
      vec < 1 || per_lane < 1 || d % vec ||
      !aligned(a.h, vec * sizeof(T)) || !aligned(a.num, vec * sizeof(float)))
    return (int)cudaErrorInvalidValue;
  if (wide) {
    const int span = f % vec ? f + vec - 1 : f;
    return lanes == 32 && 32 * vec * per_lane >= span
               ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
  }
  const bool pow2 = lanes >= 1 && lanes <= 32 && !(lanes & (lanes - 1));
  return pow2 && lanes * vec * per_lane >= d &&
                 (f % vec == 0 || vec <= f + 1)
             ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// One forward launch over the plan, then, in the sweep-1 mode of the score
// ops, the cap reduce into cap and code (a logit op, a.logits given, has
// no cap). kernel_of(Int<WIDE>, Int<V>, Int<C>, Int<U>, Int<RACC>) is the
// source's __global__ kernel of that instance; the wide plans take V * C
// <= 32 elements a lane and U = in_flight(V * C), the narrow ones
// NARROW_LIMIT and U = 2 or in_flight(V * C) (WIDE_OK false: a library
// without the wide instances).
template <bool WIDE_OK, int NARROW_LIMIT, typename T, typename K>
int launch_attention_fwd(const FwdArgs<T>& a, int wide, int vec,
                         int per_lane, int unroll, int nblk, float* cap,
                         int* code, cudaStream_t st, K kernel_of) {
  int err = check_plan(a, wide, vec, per_lane);
  if (err || nblk < 1) return err ? err : (int)cudaErrorInvalidValue;
  const bool racc = a.flags & kRoundAcc;
  auto launch = [&](auto w, auto vv, auto cc, auto uu, int threads) {
    auto kern = racc ? kernel_of(w, vv, cc, uu, Int<1>{})
                     : kernel_of(w, vv, cc, uu, Int<0>{});
    kern<<<nblk, threads, 0, st>>>(a);
    return (int)cudaGetLastError();
  };
  if (wide) {
    if constexpr (WIDE_OK) {
      err = with_vc<32, 32>(vec, per_lane, [&](auto vv, auto cc) {
        constexpr int U = in_flight(decltype(vv)::value * decltype(cc)::value);
        return unroll == U ? launch(Int<1>{}, vv, cc, Int<U>{}, a.nh * 32)
                           : (int)cudaErrorInvalidValue;
      });
    } else {
      err = (int)cudaErrorInvalidValue;
    }
  } else {
    err = with_vc<NARROW_LIMIT, 32>(vec, per_lane, [&](auto vv, auto cc) {
      constexpr int U = in_flight(decltype(vv)::value * decltype(cc)::value);
      if (unroll == U) return launch(Int<0>{}, vv, cc, Int<U>{}, kWarps * 32);
      if (unroll == 2) return launch(Int<0>{}, vv, cc, Int<2>{}, kWarps * 32);
      return (int)cudaErrorInvalidValue;
    });
  }
  if (err || a.two_phase || a.logits) return err;
  cap_reduce_kernel<<<1, kCapThreads, 0, st>>>(a.blk_max, a.blk_code, nblk,
                                               cap, code);
  return (int)cudaGetLastError();
}

// The source-score pass over the plan (vec, per_lane, lanes) the wrapper
// chose (ops/cuda/v5_attention.py score_plan).
template <typename T>
int launch_source_scores(const T* h, const float* a_src, int n_src,
                         int d_feat, int nh, int vec, int per_lane, int lanes,
                         float* s_src, int nblk, cudaStream_t st) {
  const bool pow2 = lanes >= 1 && lanes <= 32 && !(lanes & (lanes - 1));
  if (d_feat < 1 || d_feat > 1024 || nh < 1 || nh > kMaxHeads || n_src < 0 ||
      nblk < 1 || !pow2 || vec < 1 || d_feat % vec ||
      !aligned(h, vec * sizeof(T)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)d_feat * nh * sizeof(float);
  return with_vc<32, 8>(vec, per_lane, [&](auto vv, auto cc) {
    constexpr int V = decltype(vv)::value, C = decltype(cc)::value;
    source_scores_kernel<V, C, T><<<nblk, kScoreThreads, smem, st>>>(
        h, a_src, n_src, d_feat, nh, lanes, s_src);
    return (int)cudaGetLastError();
  });
}

// -- the backward by sender ---------------------------------------------------
//
// The backward by sender, every mode (Bwd, a runtime argument here: the
// modes differ in a few scalars a (slot, head)), over a list of slots: the
// windowed op's layout slots (window_bwd_kernel: pad slots have recv ==
// -1 and are never visited, dst_perm lists the slots by destination, pad
// slots last), or the v5 op's dst-sorted edges (v5_bwd_sender_kernel: a
// slot is an edge, dst_perm is NULL, the real edges come first, e_real of
// them). src_perm lists the real slots by sender, each sender's run in
// ascending slot order: the windowed layout's src_perm, or the v5 graph's
// src_order (Graph.src_order, build.sender_runs). The warps take items
// (build.sender_items): runs of at most L slots of one sender, a longer
// run cut into several in slot order, each of which writes a partial d(h)
// row (dh_part) that the tail adds in item order.
template <typename T>
struct BwdArgs {
  const T* h;            // (n_src, d_feat): the table the forward read
  const float* a_src;    // (d_feat, nh)
  const float* s_src;    // (n_src, nh): the source-score table
  const float* s_dst;    // (n, nh)
  const float* drop;     // (e7, nh) or NULL
  const int* recv;       // (e7,)
  const int* src_perm;   // the real slots by sender
  const int* src_ptr;    // (n_src + 1,)
  const int* dst_perm;   // (e7,): the slots by destination; NULL: identity
  const int* dst_ptr;    // (n + 1,)
  int n_src, n, e7, e_real, d_feat, nh, f, lanes;
  Bwd mode;
  float slope, eps;      // eps: the 2-phase mode's plain eps
  int flags;
  const float* g;        // d(out), or d(num) in the parts mode
  const float* out;      // the forward's output; NULL in the parts mode
  const float* den;      // the forward's den, or d(den) in the parts mode
  const float* epsp;     // kNorm: eps' on the device
  const float* cap_in;   // kTwoPhase: the cap on the device
  float* d_h;            // (n_src, d_feat)
  float* d_drop;         // (e7, nh) or NULL
  float* dsd;            // (e7, nh) scratch: each slot's d(s_dst) term
  float* dsum;           // (n_items, nh) scratch: each item's d(raw) summed
  float* part;           // (gridDim.x, stride): d(a_src) [| -d(cap)]
  int stride;
  // the item table of src_ptr's runs (build.SenderItems: ptr, src, part,
  // split_src, split_ptr packed)
  const int* items;
  int n_items, n_split;
  float* dh_part;        // (the partial rows, d_feat): the cut runs' items'
  // (n, nh): each destination's d(den), taken by the first launch
  // (bwd_dden); unread in the parts mode, where den carries d(den)
  float* dden;
};

// dden[d, k] = -inv[d, k] * out[d] . g[d] over head k's elements (inv =
// 1 / (den + eps'), eps' at epsp in the normalised mode, the plain eps in
// the 2-phase one; 0 where den is 0), a grid-stride pass over the
// (destination, head) pairs: a warp a pair at f >= 32, else a thread
template <typename T>
__device__ __forceinline__ void bwd_dden(const BwdArgs<T>& a) {
  const float eps = a.mode == Bwd::kNorm ? *a.epsp : a.eps;
  const int pairs = a.n * a.nh;
  if (a.f >= 32) {
    const int warps = gridDim.x * (blockDim.x >> 5);
    for (int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
         w < pairs; w += warps)
      dden_warp(a.g, a.out, a.den, a.d_feat, a.nh, a.f, eps, a.dden, w);
  } else {
    for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < pairs;
         w += gridDim.x * blockDim.x)
      dden_thread(a.g, a.out, a.den, a.d_feat, a.nh, a.f, eps, a.dden,
                  w);
  }
}

// Item it of a BwdArgs: its sender s, the positions [lo, hi) of src_perm
// it walks, and its partial d(h) row (-1: it writes d_h[s] itself)
struct BwdItem {
  int s, lo, hi, part;
};

template <typename T>
__device__ __forceinline__ BwdItem bwd_item(const BwdArgs<T>& a, int it) {
  const int* p = a.items;
  return {p[a.n_items + 1 + it], p[it], p[it + 1],
          p[2 * a.n_items + 1 + it]};
}

// Warp w of block b owns the items b * kWarps + w, then every
// gridDim.x * kWarps-th after it, in teams of `lanes` lanes that each hold
// a whole row (RowLanes). A batch is 32 / nh positions of the item's run
// of src_perm: lane i * nh + k takes slot i's index, destination, head k's
// den (inv, rounded where kRoundPayload), s_dst entry and mask entry, and
// its exp once; a batch's slots and destinations are loaded two and one
// batches ahead, so that a batch waits on one load before its rows. Team g
// gathers g[dst] of the slots i0 + u * teams + g, U of them in flight; the
// per-head dots h . g reach the slot's lane, which takes d(raw), d(drop)
// and the slot's d(s_dst) term from them and from its destination's
// d(den) = -inv * out . g, read from dden (taken once a destination by the
// launch before, from the unrounded g: kRoundPayload rounds the payload
// after d(den) is taken from it). Where a head is whole lanes of one
// vector each (C = 1, V divides f: Pubmed's 8 x 8, Cora's 1 x 7), a head's
// dot is a sum over its f / V lanes (the instance AL); elsewhere (Pubmed's
// 8 x 3, whose vectors of 4 meet two heads) each lane sums its elements
// per head and team_sums reduces all heads together. Each team then takes
// its slot's d(h) term, round_if(d(raw) @ a_src^T + coef * g, kRoundDh),
// and every lane adds the teams' terms in slot order, so that an item's
// d(h) row is the sum of its slots' terms in ascending position of its
// run, from 0,
// with no contraction (for a sender of one item, the order in which
// segment_sum.cu reduced the per-slot rows); where neither kRoundDh nor
// kRoundDraw rounds (fold), a slot's term is coef * g alone and the item
// adds d(raw)'s sums @ a_src^T after its slots, the products once an
// item. A cut run's partial rows are added in item order by the tail. At
// 16 or more elements a lane (one team a warp) the sums and the sender's
// own row live in shared memory, the row read once an item: held in
// registers beside the g rows they spilled, and read a slot from device
// memory the row missed L1, which the gathered rows fill. Each item's
// d(raw) sums (kRoundDraw) go to dsum; at the end the block takes its
// items' h[s]^T dsum into its partial row of d(a_src) (the products once
// an item: the association is linear, so it holds for a cut run).
template <int V, int C>
constexpr bool kWideRow = V * C >= 12;

// the blocks of kWarps warps an SM that an instance must fit
// (__launch_bounds__): two of the plans of one vector a lane or two
// elements, and of three vectors of four (a 320-float row), whose slots
// wait on memory and shuffles and want the warps, and which fit 128
// registers without a spill (ptxas); one of the others
template <int V, int C>
constexpr int kBwdBlocks = C == 1 || V * C <= 2 || V * C == 12 ? 2 : 1;

// AL: heads of whole lanes (C == 1, V divides f), the fast path below.
// The body of a __global__ kernel of kWarps warps, kBwdBlocks<V, C> of
// them an SM (__launch_bounds__), with the dynamic shared memory of
// bwd_smem_bytes.
template <int V, int C, int U, bool AL, typename T>
__device__ __forceinline__ void attention_bwd_by_sender(const BwdArgs<T>& a) {
  constexpr bool kWide = kWideRow<V, C>;
  extern __shared__ float smem[];
  float* sa = smem;  // a_src transposed, (nh, d_feat)
  __shared__ float wdcap[kWarps];
  const int d_feat = a.d_feat, nh = a.nh, lanes = a.lanes;
  for (int i = threadIdx.x; i < d_feat * nh; i += blockDim.x)
    sa[(i % nh) * d_feat + i / nh] = a.a_src[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // kWide: this warp's sums, (d_feat,), and its item's sender's row as the
  // dots read it, (d_feat,); one team, so one lane an element
  float* sacc = smem + d_feat * nh + warp * d_feat;
  float* sown = smem + d_feat * nh + (kWarps + warp) * d_feat;
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
  // d(h)'s d(raw) @ a_src^T is linear in d(raw): where neither a slot's
  // d(h) term nor d(raw) is rounded, it is taken once an item from the
  // item's d(raw) sums, and a slot adds coef * g alone
  const bool fold = !(r_dh || r_draw);
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

  // the slots that are no edges (the tail of dst_perm: pad slots, or the
  // padding edges from e_real on) get a zero dropout cotangent
  if (a.d_drop) {
    const int n_real = min(a.dst_ptr[a.n], a.e_real);
    const int pads = (a.e7 - n_real) * nh;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < pads;
         i += gridDim.x * blockDim.x) {
      const int p = n_real + i / nh;
      a.d_drop[(size_t)(a.dst_perm ? a.dst_perm[p] : p) * nh + i % nh] = 0.f;
    }
  }

  for (int it = blockIdx.x * kWarps + warp; it < a.n_items;
       it += gridDim.x * kWarps) {
    const BwdItem item = bwd_item(a, it);
    const int s = item.s;
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
          // read once an item: from device memory a slot, L1 lost it to
          // the gathered rows
          float x[V];
          own(c, x);
          sts_vec<V>(sown + r.j0(c), x);
        }
      } else {
        own(c, hv[c]);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[c][v] = 0.f;
      }
    }
    const float ss = a.s_src[(size_t)s * nh + kh];
    float dsa = 0.f;  // lane (i, k): its slots' d(raw) as d(a_src) reads it
    const int lo = item.lo, hi = item.hi;
    // the slot of position p of the item, and of the next batch's
    auto slot_at = [&](int p) { return p < hi ? a.src_perm[p] : 0; };
    int slot1 = slot_at(lo + mine);
    int dst1 = lo + mine < hi ? a.recv[slot1] : 0;
    int slot2 = slot_at(lo + per + mine);
    for (int b = lo; b < hi; b += per) {
      const int cnt = min(per, hi - b);
      const bool mine_ok = mine < cnt;
      const int slot = slot1, dst = dst1;
      // the next batch's destination (its slot came a batch ago) and the
      // slot of the one after, in flight while this batch runs
      slot1 = slot2;
      dst1 = b + per + mine < hi ? a.recv[slot1] : 0;
      slot2 = slot_at(b + 2 * per + mine);
      float ex = 0.f, m = 1.f, inv = 0.f, inv_p = 0.f, dn = 0.f, coef = 0.f,
            pre = 0.f, dd_dst = 0.f;
      if (mine_ok) {
        const size_t dk = (size_t)dst * nh + kh;
        dn = a.den[dk];
        if (!parts) dd_dst = a.dden[dk];
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
        // slot by slot of the U in flight: the per-head dots h . g (from
        // the payload's g), the slot's lane's d(raw), then the team's d(h)
        // term
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (i0 + u * teams >= cnt) break;  // the same for every lane
          float red_hg;
          if constexpr (AL) {  // C == 1: the lane's vector is one head's
            float xh = 0.f;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              gv[u][0][v] = round_if(gv[u][0][v], r_pay);
              xh = fmaf(hv[0][v], gv[u][0][v], xh);  // never a wide row
            }
            red_hg = head_sum(xh);
          } else {
            float q[kMaxHeads];
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
                if (r.live(c)) {
                  lds_vec<V>(sown + r.j0(c), x);
                } else {
#pragma unroll
                  for (int v = 0; v < V; ++v) x[v] = 0.f;
                }
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
          float draw = 0.f;
          if (mine_ok && gg >= 0 && gg < teams) {
            const float dd = round_if(parts ? dn : dd_dst, r_pay);
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
          // the same sums). Where fold, the term is coef * g, and d(raw) @
          // a_src^T is added once an item, below
          float dr[kMaxHeads];
#pragma unroll
          for (int k = 0; k < kMaxHeads; ++k)
            dr[k] = !fold && k < nh
                        ? __shfl_sync(kFull, draw, (base[u] + k) & 31)
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
            if (!fold && r.live(c)) {
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
              if (r.live(c)) sts_add<V>(sacc + r.j0(c), term);
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
    // the item's d(raw) sums, head k's in lane k
    float tot = 0.f;
    for (int i = 0; i < per; ++i)
      tot += __shfl_sync(kFull, dsa, (i * nh + lane) & 31);
    if (fold) {  // d(raw) @ a_src^T of the item's slots, from their sums
      float dr[kMaxHeads];
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k)
        dr[k] = k < nh ? __shfl_sync(kFull, tot, k) : 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!r.live(c)) continue;
        float term[V];
#pragma unroll
        for (int v = 0; v < V; ++v) term[v] = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxHeads; ++k) {
          if (k >= nh) continue;
          float av[V];
          lds_vec<V>(sa + k * d_feat + r.j0(c), av);
#pragma unroll
          for (int v = 0; v < V; ++v) term[v] = fmaf(av[v], dr[k], term[v]);
        }
        if constexpr (kWide) {
          sts_add<V>(sacc + r.j0(c), term);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[c][v] = __fadd_rn(acc[c][v], term[v]);
        }
      }
    }
    if (r.g == 0) {
      float* drow = item.part < 0 ? a.d_h + (size_t)s * d_feat
                                  : a.dh_part + (size_t)item.part * d_feat;
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
    if (lane < nh) a.dsum[(size_t)it * nh + lane] = tot;
  }

  // the block's d(a_src): sum over its items of hq[s, j] * dsum[item, k],
  // s the item's sender, the items of its warps in turn: thread t takes
  // the features t, t + 256, ... and every head, so that an item's row is
  // read once a block, coalesced, and its dsum row once a thread; then
  // -d(cap) (kTwoPhase), the warps' sums in warp order
  if (two) {
    const float w = warp_sum(dcap);
    if (lane == 0) wdcap[warp] = w;
  }
  __syncthreads();  // the block's dsum rows are written
  const int len = d_feat * nh;
  float* prow = a.part + (size_t)blockIdx.x * a.stride;
  const int* it_src = a.items + a.n_items + 1;
  constexpr int kJ = 1024 / (kWarps * 32);  // features a thread at 1024
  float xs[kJ][kMaxHeads];
#pragma unroll
  for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k) xs[jj][k] = 0.f;
  for (int i0 = blockIdx.x * kWarps; i0 < a.n_items;
       i0 += gridDim.x * kWarps) {
#pragma unroll 2
    for (int w = 0; w < kWarps; ++w) {
      const int it = i0 + w;
      if (it >= a.n_items) break;  // the same for every thread
      const T* hrow = a.h + (size_t)it_src[it] * d_feat;
      float ds[kMaxHeads];
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k)
        ds[k] = k < nh ? a.dsum[(size_t)it * nh + k] : 0.f;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int j = threadIdx.x + jj * kWarps * 32;
        if (j >= d_feat) break;
        const float hq = round_if(load_h(hrow + j), r_rows);
#pragma unroll
        for (int k = 0; k < kMaxHeads; ++k)
          xs[jj][k] = fmaf(hq, ds[k], xs[jj][k]);
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < kJ; ++jj) {
    const int j = threadIdx.x + jj * kWarps * 32;
    if (j >= d_feat) break;
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k)
      if (k < nh) prow[(size_t)j * nh + k] = xs[jj][k];  // (d_feat, nh)
  }
  if (two && threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += wdcap[w];
    prow[len] = -t;
  }
}

// After the backward: d_sdst[d, k] = sum over d's run of dst_perm below
// e_real of the slots' d(s_dst) terms (blocks below sd_blocks): with a
// dst_perm, a thread a (destination, head), in run order; without one (the
// v5 op's dst-sorted edges, whose run is a block of dsd's rows) a warp a
// destination, lane l adding the elements l, l + 32, ... of the block to
// its head's sum (one sum a lane where nh divides 32), then a butterfly
// per head, so that a hub's run is read by 32 lanes and not one thread a
// head; the
// d(a_src) [| d(cap)] partial rows summed in row order (sum_rows_block,
// the next sum_blocks blocks, 32 warps a block: a warp adds every 32nd
// row); and the d(h) rows of the senders whose runs were cut, each the sum
// of its items' partial rows in item order, from 0 (the blocks after
// those, a thread a (cut sender, element): split_src[j]'s partial rows are
// dh_part[split_ptr[j]:split_ptr[j+1]]).
constexpr int kTailWarps = 32;

__global__ void __launch_bounds__(kTailWarps * 32, 1)
bwd_tail_kernel(const float* __restrict__ dsd,
                const int* __restrict__ dst_perm,
                const int* __restrict__ dst_ptr, int n, int nh, int e_real,
                int sd_blocks, const float* __restrict__ part, int nrows,
                int len, int sum_blocks, const int* __restrict__ split_src,
                const int* __restrict__ split_ptr, int n_split, int d_feat,
                const float* __restrict__ dh_part,
                float* __restrict__ d_sdst, float* __restrict__ d_asrc,
                float* __restrict__ d_h) {
  if ((int)blockIdx.x < sd_blocks) {
    if (!dst_perm) {
      const int d = blockIdx.x * kTailWarps + (threadIdx.x >> 5);
      const int lane = threadIdx.x & 31;
      if (d >= n) return;  // the whole warp
      const int lo = dst_ptr[d] * nh, hi = min(dst_ptr[d + 1], e_real) * nh;
      if (32 % nh == 0) {  // lane l adds head l % nh's elements alone
        float acc = 0.f;
#pragma unroll 8
        for (int i = lo + lane; i < hi; i += 32) acc += dsd[i];
        for (int o = 16; o >= nh; o >>= 1)
          acc += __shfl_xor_sync(kFull, acc, o);
        if (lane < nh) d_sdst[(size_t)d * nh + lane] = acc;
        return;
      }
      float acc[kMaxHeads];
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k) acc[k] = 0.f;
      const int step = 32 % nh;  // the head moves by this a row of lanes
      int hd = lane % nh;
#pragma unroll 4
      for (int i = lo + lane; i < hi; i += 32) {
        const float v = dsd[i];
#pragma unroll
        for (int k = 0; k < kMaxHeads; ++k) acc[k] += k == hd ? v : 0.f;
        hd += step;
        if (hd >= nh) hd -= nh;
      }
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k) {
        if (k >= nh) break;  // the same for every lane
        const float t = warp_sum(acc[k]);
        if (lane == k) d_sdst[(size_t)d * nh + k] = t;
      }
      return;
    }
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n * nh) return;
    const int d = i / nh, k = i - d * nh;
    const int hi = min(dst_ptr[d + 1], e_real);
    float s = 0.f;
    for (int p = dst_ptr[d]; p < hi; ++p)
      s += dsd[(size_t)dst_perm[p] * nh + k];
    d_sdst[i] = s;
    return;
  }
  if ((int)blockIdx.x < sd_blocks + sum_blocks) {
    sum_rows_block<kTailWarps>(part, nrows, len, blockIdx.x - sd_blocks,
                              d_asrc);
    return;
  }
  const int i = (blockIdx.x - sd_blocks - sum_blocks) * blockDim.x +
                threadIdx.x;
  if (i >= n_split * d_feat) return;
  const int j = i / d_feat, c = i - j * d_feat;
  float s = 0.f;
  for (int r = split_ptr[j]; r < split_ptr[j + 1]; ++r)
    s += dh_part[(size_t)r * d_feat + c];
  d_h[(size_t)split_src[j] * d_feat + c] = s;
}

// the dynamic shared memory of attention_bwd_by_sender: a_src, and at wide
// rows the warps' sums and their senders' rows
template <int V, int C>
size_t bwd_smem_bytes(int d_feat, int nh) {
  return ((size_t)d_feat * nh + (kWideRow<V, C> ? 2 * kWarps * d_feat : 0)) *
         sizeof(float);
}

// The backward by sender over the plan (vec, per_lane, lanes, unroll) of
// v5_attention.row_plan: in the normalised and 2-phase modes each
// destination's d(den) (bwd_dden), then the kernel on a fixed grid of nblk
// blocks, then the tail (d(s_dst) by destination, d(a_src) [| d(cap)] from
// the partial rows, the cut runs' d(h) rows): three launches, two in the
// parts mode. kernel_of(Int<V>, Int<C>, Int<U>, Int<AL>, Int<DDEN>) is the
// source's __global__ kernel of that instance (DDEN: the d(den) launch,
// the others unread), among the plans of V * C <= LIMIT elements a lane
// and C <= MAXC.
template <int LIMIT, int MAXC, typename T, typename K>
int launch_bwd_by_sender(BwdArgs<T> a, float* d_sdst, float* d_asrc,
                         int vec, int per_lane, int unroll, int nblk,
                         cudaStream_t st, K kernel_of) {
  const bool parts = a.mode == Bwd::kParts;
  if (!row_plan_ok(a.d_feat, a.nh, a.f, vec, per_lane, a.lanes) ||
      nblk < 1 || a.n < 1 || a.n_src < 1 || a.e_real < 1 ||
      !aligned(a.h, vec * sizeof(T)) || !aligned(a.g, vec * sizeof(float)) ||
      !aligned(a.d_h, vec * sizeof(float)) || (parts != !a.out) ||
      (a.out && !aligned(a.out, vec * sizeof(float))) || !a.items ||
      a.n_items < a.n_src || a.n_split < 0 ||
      (a.n_split > 0 && !aligned(a.dh_part, vec * sizeof(float))) ||
      (!parts && !a.dden))
    return (int)cudaErrorInvalidValue;
  a.stride = a.d_feat * a.nh + (a.mode == Bwd::kTwoPhase ? 1 : 0);
  if (!parts) {  // each destination's d(den), before the walk
    const int pairs = a.n * a.nh, per = a.f >= 32 ? kWarps : kWarps * 32;
    kernel_of(Int<1>{}, Int<1>{}, Int<1>{}, Int<0>{}, Int<1>{})
        <<<(pairs + per - 1) / per, kWarps * 32, 0, st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  int err = with_vc_rows<LIMIT, MAXC>(vec, per_lane, [&](auto vv, auto cc) {
    constexpr int V = decltype(vv)::value, C = decltype(cc)::value;
    constexpr int U = row_flight(V * C);
    const size_t smem = bwd_smem_bytes<V, C>(a.d_feat, a.nh);
    if (kWideRow<V, C> && a.lanes != 32) return (int)cudaErrorInvalidValue;
    auto launch = [&](auto kern) {
      cudaError_t e = set_smem(kern, smem);
      if (e != cudaSuccess) return (int)e;
      kern<<<nblk, kWarps * 32, smem, st>>>(a);
      return (int)cudaGetLastError();
    };
    // the instance for heads of whole lanes where the plan gives them
    auto with_u = [&](auto uu) {
      if constexpr (C == 1)
        if (a.f % V == 0)
          return launch(kernel_of(vv, cc, uu, Int<1>{}, Int<0>{}));
      return launch(kernel_of(vv, cc, uu, Int<0>{}, Int<0>{}));
    };
    if (unroll == U) return with_u(Int<U>{});
    // two in flight: where a batch gives a team at most two slots (teams
    // of under 32 lanes, one vector a lane: row_plan)
    if constexpr (U != 2 && V * C <= 4)
      if (unroll == 2) return with_u(Int<2>{});
    return (int)cudaErrorInvalidValue;
  });
  if (err) return err;
  // a thread a (destination, head), or with no dst_perm a warp a
  // destination
  const int sd_blocks =
      a.dst_perm ? (a.n * a.nh + kTailWarps * 32 - 1) / (kTailWarps * 32)
                 : (a.n + kTailWarps - 1) / kTailWarps;
  const int sum_blocks = (a.stride + kSumCols - 1) / kSumCols;
  const int split_blocks =
      (a.n_split * a.d_feat + kTailWarps * 32 - 1) / (kTailWarps * 32);
  const int* split = a.items + 3 * a.n_items + 1;
  bwd_tail_kernel<<<sd_blocks + sum_blocks + split_blocks, kTailWarps * 32,
                    0, st>>>(
      a.dsd, a.dst_perm, a.dst_ptr, a.n, a.nh, a.e_real, sd_blocks, a.part,
      nblk, a.stride, sum_blocks, split, split + a.n_split,
      a.n_split, a.d_feat, a.dh_part, d_sdst, d_asrc, a.d_h);
  return (int)cudaGetLastError();
}

}  // namespace
