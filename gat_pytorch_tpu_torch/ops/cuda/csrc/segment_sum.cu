// Sorted row segment sums for Hopper (sm_90a): the d(h) reduction of the
// attention backward in its row-major (seg_rows_kernel and, for rows wider
// than 256 floats, seg_rows_wide_kernel) and feature-major
// (seg_rows_t_kernel, further down, with its own header) forms, and the
// plain sorted segment sum (sorted_sum_kernel, with its own header).
//
// seg_rows_kernel and seg_rows_wide_kernel replace the TPU kernel
//   gat_pytorch_tpu/ops/pallas/segment_sum.py:_kernel_rows_nt
//     (segment_sum_pallas_rows(no_transpose=True)), together with the
//   jnp.take permutation of gat_pytorch_tpu/ops/pallas/segment_attention.py
//     :_dh_reduce that feeds it.
//
// Contract: out[s, :] = sum over i in [seg_ptr[s], seg_ptr[s+1]) of
// values[order[i], :] (order NULL: the identity). Each sum starts at 0.f
// and adds its rows in ascending i, one float add at a time: the order is
// part of the contract, so that every form and every launch gives the same
// bits. Rows order[i] >= row_limit are skipped: the caller says they are
// zero (the attention backward's padding edges). float32, 1 <= D <= 1024.
// With order = src_order and seg_ptr the offsets of each sender's run of
// the sender-sorted edges (Graph.src_ptr), this is the d(h) reduction of
// the attention backward: the per-edge d(h) rows (in dst order) summed per
// sender, the permutation fused into the read.
//
// Design. The TPU reduced with one-hot matmuls over edge blocks. Here the
// parallelism comes from segments, features and loads in flight, never
// from splitting a segment's sum:
//  - a group of G lanes owns one segment, G the next power of two >= the
//    row's vectors (min 32): a warp holds 32/G segments (4 at D = 7), and
//    lane k of a group owns the vectors k, k+G, ... of the row, 16-byte
//    float4s where D % 4 == 0 and the table is 16-byte aligned (D = 24,
//    64, 1024), single floats otherwise;
//  - the group reads 32 of its segment's row indices at once (lane k the
//    indices base + qG + k, one coalesced load a step q), votes on which
//    are under row_limit, skips a chunk of padding rows whole, and hands
//    the indices out by shuffles within the group;
//  - it issues U rows' loads into registers (U = 8, 4 for wide lanes)
//    before adding them, in order, to its accumulators;
//  - rows wider than 256 floats (PPI's 726 and 1024) take
//    seg_rows_wide_kernel: the 256 threads of a block share one segment's
//    features, so each row is one coalesced read by the block; the block
//    stages 256 row indices in shared memory per step;
//  - the grid holds every segment at once (no fixed grid: nothing here
//    crosses blocks). One writer per output row, no atomics.
//
// What bounds it on the H100: bytes, the rows read once (E x D x 4), the
// row indices and offsets once, the table written once (N x D x 4): 1.4 us
// at Cora's size, below a launch, 0.13 ms at PPI's (the bounds
// chip_smoke.py prints for the real rows). A segment's sum is one
// chain of dependent adds, so a long segment (a hub, or the sink's padding
// rows when the caller passes no offsets) is bound by that chain.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr unsigned kFull = 0xffffffffu;

// V consecutive floats from p (16-byte aligned where V == 4)
template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// G lanes a segment, V floats a vector, C vectors a lane (C > 1 only at
// G = 32): lane k of a group owns the vectors k + G c of its segment's row.
template <int G, int V, int C>
__global__ void __launch_bounds__(kWarps * 32)
seg_rows_kernel(const float* __restrict__ values, const int* __restrict__ order,
                const int* __restrict__ seg_ptr, int nseg, int row_limit,
                int d_feat, float* __restrict__ out) {
  constexpr int P = 32 / G;                   // segments a warp; index
                                              // registers a lane
  constexpr int U = C * V >= 8 ? 4 : 8;       // rows' loads in flight
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = lane % G, grp = lane / G;
  const unsigned gmask = G == 32 ? kFull : ((1u << G) - 1u) << (grp * G);
  const int s = (blockIdx.x * kWarps + warp) * P + grp;
  if (s >= nseg) return;                      // the whole group
  const int nvec = d_feat / V;
  bool live[C];
#pragma unroll
  for (int c = 0; c < C; ++c) live[c] = k + G * c < nvec;
  float acc[C][V];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[c][e] = 0.f;
  const int lo = seg_ptr[s], hi = seg_ptr[s + 1];
  for (int base = lo; base < hi; base += 32) {
    // the chunk's 32 row indices: row base + qG + k in lane k, register q
    int idx[P];
    bool any = false;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int i = base + q * G + k;
      idx[q] = i < hi ? (order ? order[i] : i) : row_limit;
      any |= idx[q] < row_limit;
    }
    if (!(__ballot_sync(gmask, any) & gmask)) continue;  // padding only
    const int cnt = min(32, hi - base);
#pragma unroll
    for (int r0 = 0; r0 < 32; r0 += U) {
      if (r0 >= cnt) continue;  // the rest of the chunk is past hi
      int src[U];
      float v[U][C][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        src[u] = __shfl_sync(gmask, idx[(r0 + u) / G], (r0 + u) % G, G);
        const float* row = values + (size_t)src[u] * d_feat + V * k;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (src[u] < row_limit && live[c]) {
            load_vec<V>(row + V * G * c, v[u][c]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) v[u][c][e] = 0.f;
          }
        }
      }
      // in ascending i: the loads above are all in flight by now
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (src[u] < row_limit) {
#pragma unroll
          for (int c = 0; c < C; ++c)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[c][e] += v[u][c][e];
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (live[c])
      store_vec<V>(out + (size_t)s * d_feat + V * (k + G * c), acc[c]);
}

constexpr int kWideThreads = 256;  // one segment a block, D > 256

// thread t owns the vectors t + 256 c of the block's segment's row
template <int V, int C>
__global__ void __launch_bounds__(kWideThreads)
seg_rows_wide_kernel(const float* __restrict__ values,
                     const int* __restrict__ order,
                     const int* __restrict__ seg_ptr, int nseg, int row_limit,
                     int d_feat, float* __restrict__ out) {
  constexpr int U = 8;  // rows' loads in flight
  __shared__ int rows[kWideThreads];
  const int t = threadIdx.x, s = blockIdx.x;
  const int nvec = d_feat / V;
  bool live[C];
#pragma unroll
  for (int c = 0; c < C; ++c) live[c] = t + kWideThreads * c < nvec;
  float acc[C][V];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[c][e] = 0.f;
  const int lo = seg_ptr[s], hi = seg_ptr[s + 1];
  for (int base = lo; base < hi; base += kWideThreads) {
    const int i = base + t;
    const int mine = i < hi ? (order ? order[i] : i) : row_limit;
    rows[t] = mine;
    if (!__syncthreads_or(mine < row_limit)) continue;  // padding only
    const int cnt = min(kWideThreads, hi - base);
    for (int r0 = 0; r0 < cnt; r0 += U) {
      int src[U];
      float v[U][C][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        src[u] = r0 + u < cnt ? rows[r0 + u] : row_limit;
        const float* row = values + (size_t)src[u] * d_feat + V * t;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (src[u] < row_limit && live[c]) {
            load_vec<V>(row + V * kWideThreads * c, v[u][c]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) v[u][c][e] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (src[u] < row_limit) {
#pragma unroll
          for (int c = 0; c < C; ++c)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[c][e] += v[u][c][e];
        }
      }
    }
    __syncthreads();  // every thread has read rows[] before it is rewritten
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (live[c])
      store_vec<V>(out + (size_t)s * d_feat + V * (t + kWideThreads * c),
                   acc[c]);
}

// ---------------------------------------------------------------------------
// The d(h) reduction, feature-major.
//
// seg_rows_t_kernel replaces the TPU kernel
//   gat_pytorch_tpu/ops/pallas/segment_sum.py:_kernel_rows
//     (segment_sum_pallas_rows(no_transpose=False)), which
//   gat_pytorch_tpu/ops/pallas/segment_attention.py:_dh_reduce takes under
//   GAT_TPU_DH_REDUCE_NT=0.
//
// Contract: that of seg_rows_kernel. Each thread owns one (feature j,
// segment s) accumulator, which starts at 0.f and adds values[order[i], j]
// for i in [seg_ptr[s], seg_ptr[s+1]) in ascending i, rows order[i] >=
// row_limit skipped; out is (nseg, d_feat), row-major, as the JAX kernel's
// result after its transpose. Each sum adds the same floats in the same
// order as seg_rows_kernel's, so the two forms give the same bits.
//
// Design. The TPU kernel stages blocks of rows on chip, transposes them
// and sums them with a one-hot matrix product into a (D, N) accumulator.
// Here one block owns a tile of 32 segments and FT = min(D, 32) features,
// 32 x FT accumulators. The tile's segments own one contiguous run of rows
// [seg_ptr[s0], seg_ptr[s0 + 32]); the block stages it 128 rows at a time
// into shared memory with cp.async, FT floats a row (a 128-byte line at
// FT = 32), into a double buffer: the next chunk's rows are in flight
// while this one is summed, and the row indices of the chunk after it are
// loaded into registers meanwhile. A group of G lanes (G the next power of
// two >= FT) owns one segment, lane k its feature k: the group walks its
// segment's rows of the chunk out of shared memory, every lane adding a
// row's element to its accumulator. (With a warp a feature and a lane a
// segment, as the (D, N) accumulator would lay them out, only the lanes
// whose segment lies in the chunk work, about 5 of 32 at PPI's degrees:
// on the H100 that sum, not the copies, took most of the kernel's time.)
// A group's accumulators are its segment's output row, so the (N, D)
// result is written directly, G consecutive floats a segment: no
// transpose, in shared memory or after. No atomics: one writer per
// output, a fixed order.
//
// What bounds it on the H100: bytes, as seg_rows_kernel (the row indices
// read once per 32 features), read 128 bytes of a row at a time by D/32
// blocks. A long segment is one group's chain of adds; a chunk of padding
// rows (a caller without offsets) costs its two barriers, not its rows.

constexpr int kTileSegs = 32;    // segments a block
constexpr int kTileFeats = 32;   // most features a block
constexpr int kChunkRows = 128;  // rows staged a chunk
constexpr int kStageRows = kChunkRows / kTileSegs;  // rows a thread stages

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// blockDim.x = 32 G: G lanes a segment, G the next power of two >=
// min(d_feat, 32); grid (tiles of 32 segments, tiles of 32 features)
__global__ void __launch_bounds__(kTileSegs * kTileFeats)
seg_rows_t_kernel(const float* __restrict__ values,
                  const int* __restrict__ order,
                  const int* __restrict__ seg_ptr, int nseg, int row_limit,
                  int d_feat, float* __restrict__ out) {
  __shared__ int rows[2][kChunkRows];
  __shared__ float tile[2][kChunkRows][kTileFeats + 1];  // +1: no conflicts
  const int g = blockDim.x / kTileSegs;
  const int t = threadIdx.x, k = t % g, sub = t / g;  // sub < 32
  const int s0 = blockIdx.x * kTileSegs, f0 = blockIdx.y * kTileFeats;
  const int s_end = min(s0 + kTileSegs, nseg);
  const int lo_t = seg_ptr[s0], hi_t = seg_ptr[s_end];
  // the sum role: feature f0 + k of segment s0 + sub
  const int s = s0 + sub;
  const int my_lo = s < nseg ? seg_ptr[s] : hi_t;
  const int my_hi = s < nseg ? seg_ptr[s + 1] : hi_t;
  const bool k_live = k < kTileFeats && f0 + k < d_feat;
  // the staging role: feature f0 + k of the chunk's rows sub + 32 q
  const float* col = values + f0 + k;
  int nxt[kStageRows];
  auto fetch = [&](int base) {
#pragma unroll
    for (int q = 0; q < kStageRows; ++q) {
      const int i = base + sub + kTileSegs * q;
      nxt[q] = i < hi_t ? (order ? order[i] : i) : row_limit;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kStageRows; ++q) {
      const int r = sub + kTileSegs * q, src = nxt[q];
      if (k == 0) rows[buf][r] = src;
      if (k_live && src < row_limit)
        cp_async4(&tile[buf][r][k], col + (size_t)src * d_feat);
    }
    cp_async_commit();
  };
  const int nchunk = (hi_t - lo_t + kChunkRows - 1) / kChunkRows;
  float acc = 0.f;
  if (nchunk > 0) {
    fetch(lo_t);
    stage(0);
    if (nchunk > 1) fetch(lo_t + kChunkRows);
  }
  for (int kc = 0; kc < nchunk; ++kc) {
    const int buf = kc & 1, base = lo_t + kc * kChunkRows;
    if (kc + 1 < nchunk) {
      stage(buf ^ 1);  // the buffer summed in the step before
      if (kc + 2 < nchunk) fetch(base + 2 * kChunkRows);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int a = max(my_lo, base) - base;
    const int b = min(my_hi, base + kChunkRows) - base;
#pragma unroll 4
    for (int r = a; r < b; ++r)
      if (rows[buf][r] < row_limit) acc += tile[buf][r][k];
    __syncthreads();
  }
  if (s < nseg && k_live) out[(size_t)s * d_feat + f0 + k] = acc;
}

// ---------------------------------------------------------------------------
// Plain sorted segment sum.
//
// Replaces the TPU kernel
//   gat_pytorch_tpu/ops/pallas/segment_sum.py:_kernel (segment_sum_pallas),
//   the reduction behind ops/pallas/gather.py:gather_rows_src_sorted and
//   ops/segment.py:gather_rows_sorted_grad: the transpose of a row gather
//   whose indices are sorted.
//
// Contract: out[s, :] = sum of values[e, :] over the rows e with
// ids[e] == s, for ids ascending; ids >= nseg (and < 0) are dropped;
// float32, any width 1 <= d_feat <= 1024, no permutation.
//
// Design. Two passes in one call. seg_offsets_kernel turns the sorted ids
// into row offsets, ptr[j] = the first row with id >= j: thread i looks at
// the boundary between rows i-1 and i and writes the offsets of the ids
// that begin there, so every offset has one writer. sorted_sum_kernel then
// gives one warp one segment, whose rows lie next to each other in memory.
// The widths this meets are the (E, nh) score cotangents, nh = 1..8, and
// nh*f = 24..1024. For d_feat <= 32 a row takes G = the next power of two
// >= d_feat lanes, so the warp reads 32/G consecutive rows per step (one
// coalesced load when d_feat is a power of two) into one accumulator per
// lane, and the 32/G partial rows are folded by a butterfly of shuffles,
// a fixed tree. Wider rows give lane l the features l, l+32, ... of one
// row per step. The loads of a segment do not depend on one another, so
// several are in flight. One writer per output row, a fixed order of sums,
// no atomics: two launches give the same bits. A long segment (the sink
// node of a padded batch holds thousands of padding edges) is still one
// warp's, at 32/G rows a step with up to 16 steps' loads in flight.
//
// What bounds it on the H100: bytes, values (E x D x 4) and ids (E x 4)
// read once, out (N x D x 4) written once; the offsets (N x 4, written and
// read) are scratch on top. At a few MB the launch of two kernels and the
// short per-segment chains (offsets, rows, shuffles, store) dominate.

__global__ void seg_offsets_kernel(const int* __restrict__ ids, int e,
                                   int nseg, int* __restrict__ ptr) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i <= e;
       i += gridDim.x * blockDim.x) {
    const int prev = i == 0 ? -1 : max(-1, min(ids[i - 1], nseg));
    const int cur = i == e ? nseg : max(-1, min(ids[i], nseg));
    for (int j = prev + 1; j <= cur; ++j) ptr[j] = i;
  }
}

// acc += rows [base, base + k*U*per_step) for the largest k that stays under
// hi, U steps' loads in flight at once; returns the first row not summed.
template <int U, int C>
__device__ __forceinline__ int sum_steps(const float* __restrict__ values,
                                         int base, int hi, int per_step,
                                         int sub, int j, int d_feat,
                                         const bool (&live)[C],
                                         float (&acc)[C]) {
  for (; base + U * per_step <= hi; base += U * per_step) {
    float v[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t row = (size_t)(base + u * per_step + sub);
#pragma unroll
      for (int c = 0; c < C; ++c)
        v[u][c] = live[c] ? values[row * d_feat + j + 32 * c] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float part = v[0][c];
#pragma unroll
      for (int u = 1; u < U; ++u) part += v[u][c];
      acc[c] += part;
    }
  }
  return base;
}

// group: lanes per row (a power of two, 32 when d_feat > 32); C: features
// per lane (1 when d_feat <= 32)
template <int C>
__global__ void __launch_bounds__(kWarps * 32)
sorted_sum_kernel(const float* __restrict__ values,
                  const int* __restrict__ ptr, int nseg, int d_feat, int group,
                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / group, j = lane % group, per_step = 32 / group;
  bool live[C];
#pragma unroll
  for (int c = 0; c < C; ++c) live[c] = j + 32 * c < d_feat;
  for (int s = blockIdx.x * kWarps + warp; s < nseg; s += gridDim.x * kWarps) {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    const int lo = ptr[s], hi = ptr[s + 1];
    int base = lo;
    // A long segment (the sink's padding rows) is one warp's, and a step
    // costs a memory latency: take 16, then 4 steps' loads at once (none
    // depends on another) while the segment has that many left. Wide rows
    // already have C loads per lane in flight.
    if constexpr (C == 1)
      base = sum_steps<16, C>(values, base, hi, per_step, sub, j, d_feat, live,
                              acc);
    if constexpr (C <= 4)
      base = sum_steps<4, C>(values, base, hi, per_step, sub, j, d_feat, live,
                             acc);
    for (; base < hi; base += per_step) {
      const int row = base + sub;
      if (row < hi) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (live[c]) acc[c] += values[(size_t)row * d_feat + j + 32 * c];
      }
    }
    if (C == 1) {  // fold the 32/group partial rows, a fixed tree
      for (int o = 16; o >= group; o >>= 1)
        acc[0] += __shfl_xor_sync(kFull, acc[0], o);
    }
    if (sub == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (live[c]) out[(size_t)s * d_feat + j + 32 * c] = acc[c];
    }
  }
}

}  // namespace

extern "C" {

// out (nseg, d_feat), the row-major form; order may be NULL; row_limit =
// the number of rows of `values` reads them all. The grid holds every
// segment.
int segment_sum_rows(const float* values, const int* order,
                     const int* seg_ptr, int nseg, int row_limit, int d_feat,
                     float* out, void* stream) {
  if (d_feat < 1 || d_feat > 1024 || nseg < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // float4 rows where the width and both tables allow it
  const bool vec4 = d_feat % 4 == 0 && (uintptr_t)values % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  const int nvec = vec4 ? d_feat / 4 : d_feat;
  const dim3 block(kWarps * 32);
#define SEG_ROWS(GG, VV, CC)                                               \
  seg_rows_kernel<GG, VV, CC>                                              \
      <<<(nseg + kWarps * (32 / GG) - 1) / (kWarps * (32 / GG)), block, 0, \
         st>>>(values, order, seg_ptr, nseg, row_limit, d_feat, out)
#define SEG_ROWS_G(VV)                    \
  if (nvec <= 1) SEG_ROWS(1, VV, 1);      \
  else if (nvec <= 2) SEG_ROWS(2, VV, 1); \
  else if (nvec <= 4) SEG_ROWS(4, VV, 1); \
  else if (nvec <= 8) SEG_ROWS(8, VV, 1); \
  else if (nvec <= 16) SEG_ROWS(16, VV, 1); \
  else SEG_ROWS(32, VV, 1)
#define SEG_ROWS_WIDE(VV, CC)                                             \
  seg_rows_wide_kernel<VV, CC><<<nseg, kWideThreads, 0, st>>>(            \
      values, order, seg_ptr, nseg, row_limit, d_feat, out)
  if (d_feat > 256) {
    if (vec4) SEG_ROWS_WIDE(4, 1);
    else if (nvec <= 2 * kWideThreads) SEG_ROWS_WIDE(1, 2);
    else if (nvec <= 3 * kWideThreads) SEG_ROWS_WIDE(1, 3);
    else SEG_ROWS_WIDE(1, 4);
  } else if (nvec <= 32) {
    if (vec4) { SEG_ROWS_G(4); }
    else { SEG_ROWS_G(1); }
  } else if (vec4) {
    SEG_ROWS(32, 4, 2);
  } else if (nvec <= 64) {
    SEG_ROWS(32, 1, 2);
  } else if (nvec <= 128) {
    SEG_ROWS(32, 1, 4);
  } else {
    SEG_ROWS(32, 1, 8);
  }
#undef SEG_ROWS_WIDE
#undef SEG_ROWS_G
#undef SEG_ROWS
  return (int)cudaGetLastError();
}

// out (nseg, d_feat), the feature-major form of segment_sum_rows.
int segment_sum_rows_t(const float* values, const int* order,
                       const int* seg_ptr, int nseg, int row_limit,
                       int d_feat, float* out, void* stream) {
  if (d_feat < 1 || d_feat > 1024 || nseg < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nseg + kTileSegs - 1) / kTileSegs,
                  (d_feat + kTileFeats - 1) / kTileFeats);
  int g = kTileFeats;  // lanes a segment
  while (g / 2 >= d_feat) g /= 2;
  seg_rows_t_kernel<<<grid, kTileSegs * g, 0, (cudaStream_t)stream>>>(
      values, order, seg_ptr, nseg, row_limit, d_feat, out);
  return (int)cudaGetLastError();
}

// out (nseg, d_feat) from values (e, d_feat) and ascending ids (e,);
// ptr is (nseg + 1,) int scratch.
int segment_sum_sorted(const float* values, const int* ids, int e, int nseg,
                       int d_feat, int* ptr, float* out, void* stream) {
  if (d_feat < 1 || d_feat > 1024 || e < 0 || nseg < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  seg_offsets_kernel<<<(e + 256) / 256, 256, 0, st>>>(ids, e, nseg, ptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int group = 32;
  while (group / 2 >= d_feat) group /= 2;
  const int c_need = (d_feat + 31) / 32;
  const int nblk = (nseg + kWarps - 1) / kWarps;  // every segment in flight
#define SORTED_SUM(CC)                                   \
  sorted_sum_kernel<CC><<<nblk, kWarps * 32, 0, st>>>(   \
      values, ptr, nseg, d_feat, group, out)
  if (c_need <= 1) SORTED_SUM(1);
  else if (c_need <= 2) SORTED_SUM(2);
  else if (c_need <= 4) SORTED_SUM(4);
  else if (c_need <= 8) SORTED_SUM(8);
  else if (c_need <= 16) SORTED_SUM(16);
  else SORTED_SUM(32);
#undef SORTED_SUM
  return (int)cudaGetLastError();
}

}  // extern "C"
