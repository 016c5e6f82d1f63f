// Sorted row segment sums for Hopper (sm_90a): the d(h) reduction of the
// attention backward in its row-major (seg_rows_kernel and, for rows wider
// than 256 floats, seg_rows_wide_kernel) and feature-major
// (seg_rows_t_kernel, further down, with its own header) forms, and the
// plain sorted segment sum (sorted_sum_kernel, load-balanced over rows,
// with its own header).
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

// V consecutive floats from p (16-byte aligned where V == 4, 8-byte
// where V == 2); CG: through L2 only (data another block wrote in this
// launch, after a fence)
template <int V, bool CG = false>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = CG ? __ldcg(reinterpret_cast<const float4*>(p))
                        : *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = CG ? __ldcg(reinterpret_cast<const float2*>(p))
                        : *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = CG ? __ldcg(p) : *p;
  }
}

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
// Sorted segment sum (row 11), load-balanced over rows.
//
// Replaces the TPU kernel
//   gat_pytorch_tpu/ops/pallas/segment_sum.py:_kernel (segment_sum_pallas),
//   the reduction behind ops/pallas/gather.py:gather_rows_src_sorted, whose
//   jnp.take permutation of the cotangent is fused into the read here, and
//   ops/segment.py:gather_rows_sorted_grad: the transpose of a row gather
//   whose indices are sorted.
//
// Contract: out[s, :] = sum of values[r_i, :] over the positions i whose
// segment is s, r_i = order[i] (order NULL: i), for positions
// i < min(e, row_limit) (the caller says the rows past row_limit are
// zero; they are not read). The segment of position i is given one of two
// ways: by ids, ids[r_i], ascending in i, ids < 0 or >= nseg dropped;
// or by CSR offsets, the positions [ptr[s], ptr[s+1]) (positions before
// ptr[0] or from ptr[nseg] on belong to none). Every segment is written, 0
// where it has no row. float32, 1 <= d_feat <= 1024.
//
// Design. The TPU kernel reduced blocks of 1024 rows with one-hot matmuls
// into tiles of 128 segments. Here the work is cut by rows, not by
// segments, so that a long segment (the sink's thousands of padding rows
// in a padded batch) is spread over many workers:
//  - a worker, G lanes (the next power of two >= the row's vectors, at
//    most 32; lane k owns the vectors k, k+G, ... of a row, float4 or
//    float2 where the width and the tables' alignment allow), owns a chunk
//    of kChunk = 32 consecutive positions; it issues U rows' loads (and,
//    by ids, their ids) at once, then walks them in order, adding each row
//    to the run of its segment;
//  - where the segment changes, the run is flushed: a segment that lies
//    wholly in the chunk is written directly; a segment that crosses a
//    chunk boundary leaves one partial a chunk (slot 1 of the chunk where
//    it starts, slot 0 of every later one); after its walk each worker
//    adds an arrival code for each partial to the segment's int counter,
//    all workers of a warp together after one fence (a post inside the
//    walk would serialise the warp's diverging workers). The codes sum to
//    kArrived exactly when all its chunks have arrived, so the last to
//    arrive, whichever it is, folds the partials (a segment over more
//    than 8 chunks with its whole warp: 32 lanes over the chunks, then a
//    fixed butterfly), writes the segment and sets its counter back to 0:
//    one launch, whatever the segments' lengths, and a second pass that
//    has nothing to do where no segment crosses. (A worker that read on
//    into the next chunk to finish a segment that crosses one boundary,
//    in place of posting it, measured slower: a second round of loads on
//    most workers costs more than the post.)
//  - a worker finds the segment of its first position from the ids (one
//    load) or by a binary search of the offsets, and zeroes the empty
//    segments that begin in its chunk (the last chunk those after the last
//    row), so every output row has one writer.
// No float atomics, and the order of every sum is fixed by the chunking: a
// segment's rows in order within a chunk, then its chunks in order (over
// a warp: in a fixed tree). So two
// launches give the same bits, and the offsets form gives the bits of the
// ids form on the same rows; a segment's sum is not a left-to-right sum
// of its rows (its chunks' sums are added), and the contract promises no
// particular association. The counters are int32 scratch that the caller
// hands over zeroed and gets back zeroed.
//
// What bounds it on the H100: bytes, the rows read once (E x D x 4), the
// ids or order read once (E x 4), out written once (N x D x 4): about a
// microsecond at PPI's score widths, below a launch. So the launch, a
// chunk's rounds of loads, the posts and the fold of the longest segment
// (its chunks' partials over a warp, 8 loads in flight a lane) make its
// time.

constexpr int kChunk = 32;  // positions a worker
constexpr int kSms = 132;   // the H100's streaming multiprocessors
// Arrival codes of a segment spanning chunks c0 < c1: c0 adds
// kArrivalBase + c0 + 1, c1 adds kArrivalBase - c1, every chunk between
// adds 1. They sum to kArrived, and no proper subset does (c1 <
// kArrivalBase): without c0's code the sum stays below kArrivalBase,
// without c1's below kArrivalBase + c1, and with both but j chunks between
// missing it is kArrived - j.
constexpr int kArrivalBase = 1 << 29;
constexpr int kArrived = 2 * kArrivalBase;
constexpr int kFoldLoads = 8;  // partials in flight while a segment folds

__device__ __forceinline__ int clamp_id(int id, int nseg) {
  return id < 0 ? -1 : min(id, nseg);
}

// the largest s in [0, nseg) with ptr[s] <= i, or -1 where ptr[0] > i:
// a gallop from the guess that segments are of equal length (a few loads
// where they nearly are), then a binary search of what is left
__device__ __forceinline__ int segment_of(const int* __restrict__ ptr,
                                          int nseg, int i, int total) {
  int lo = -1, hi = nseg - 1;  // the answer lies in [lo, hi]
  const int guess =
      min(max((int)((long long)i * nseg / max(total, 1)), 0), nseg - 1);
  if (ptr[guess] <= i) {
    lo = guess;
    int step = 1;
    while (lo + step <= hi && ptr[lo + step] <= i) {
      lo += step;
      step *= 2;
    }
    hi = min(hi, lo + step - 1);
  } else {
    hi = guess - 1;
    int step = 1;
    while (guess - step >= 0 && ptr[guess - step] > i) {
      hi = guess - step - 1;
      step *= 2;
    }
    lo = max(guess - step, -1);
  }
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ptr[mid] <= i) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// G lanes a worker, V floats a vector, C vectors a lane (C > 1 only at
// G = 32), U rows' loads in flight. cnt (nseg,): the crossing segments'
// arrival counters, zeroed; span (2 nseg,): their first and last chunks.
// part: 2 rows of d_feat a chunk. Every thread of a block runs to the end
// (a worker past the last chunk idles): the posts and the folds are
// warp-wide.
template <int G, int V, int C, int U>
__global__ void __launch_bounds__(kWarps * 32)
sorted_sum_kernel(const float* __restrict__ values,
                  const int* __restrict__ ids, const int* __restrict__ order,
                  const int* __restrict__ ptr, int e, int row_limit,
                  int nseg, int d_feat, float* __restrict__ part,
                  int* __restrict__ cnt, int* __restrict__ span,
                  float* __restrict__ out) {
  constexpr int P = 32 / G;  // workers a warp
  // partials in flight a lane in a warp's fold: 32 floats' worth
  constexpr int kLongLoads = 32 / (C * V) > kFoldLoads ? 32 / (C * V)
                                                       : kFoldLoads;
  static_assert(kChunk % U == 0, "a chunk is whole rounds of loads");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = lane % G, grp = lane / G;
  const int wpb = blockDim.x >> 5;  // warps a block (1 to kWarps)
  const int c = (blockIdx.x * wpb + warp) * P + grp;  // the chunk
  const int nrows = min(ptr ? min(ptr[nseg], e) : e, row_limit);
  const int last = nrows > 0 ? (nrows - 1) / kChunk : 0;
  const int nvec = d_feat / V;
  bool live[C];
#pragma unroll
  for (int q = 0; q < C; ++q) live[q] = k + G * q < nvec;

  auto store_row = [&](float* dst, const float (&a)[C][V]) {
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (live[q]) store_vec<V>(dst + V * (k + G * q), a[q]);
  };
  auto zero_range = [&](int a, int b) {  // out[s] = 0 for s in [a, b)
    float z[V];
#pragma unroll
    for (int x = 0; x < V; ++x) z[x] = 0.f;
    for (int s = max(a, 0); s < min(b, nseg); ++s) {
#pragma unroll
      for (int q = 0; q < C; ++q)
        if (live[q])
          store_vec<V>(out + (size_t)s * d_feat + V * (k + G * q), z);
    }
  };
  auto row_of = [&](int i) { return order ? order[i] : i; };

  // This worker's crossing segments: slot 0, the one that began before
  // the chunk; slot 1, the one that begins in it and goes on after it.
  // Their partials are stored as the walk flushes them; the arrivals are
  // posted after the walk, by all workers of the warp together.
  int post_seg[2] = {-1, -1}, post_code[2] = {0, 0};
  if (c <= last && nrows == 0) {  // chunk 0 alone: every segment is empty
    zero_range(0, nseg);
  } else if (c <= last) {
    const int lo = c * kChunk, hi = min(lo + kChunk, nrows);
    float acc[C][V];
#pragma unroll
    for (int q = 0; q < C; ++q)
#pragma unroll
      for (int x = 0; x < V; ++x) acc[q][x] = 0.f;

    // the run of segment s ends: written, or its partial stored
    auto flush = [&](int s, bool from_before, bool to_after) {
      if (s < 0 || s >= nseg) return;  // dropped rows
      if (!from_before && !to_after) {
        store_row(out + (size_t)s * d_feat, acc);
        return;
      }
      const int slot = from_before ? 0 : 1;
      store_row(part + ((size_t)c * 2 + slot) * d_feat, acc);
      if (!from_before) span[2 * s] = c;
      if (!to_after) span[2 * s + 1] = c;
      post_seg[slot] = s;
      post_code[slot] = !from_before ? kArrivalBase + c + 1
                                     : (to_after ? 1 : kArrivalBase - c);
    };

    int key[U];
    float v[U][C][V];
    // U positions' rows (and, by ids, their segments) from base on, all in
    // flight at once
    auto load_round = [&](int base) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u;
        const bool in = i < hi;
        const int r = in ? row_of(i) : 0;
        key[u] = (in && !ptr) ? clamp_id(ids[r], nseg) : -1;
        const float* row = values + (size_t)r * d_feat + V * k;
#pragma unroll
        for (int q = 0; q < C; ++q) {
          if (in && live[q]) {
            load_vec<V>(row + V * G * q, v[u][q]);
          } else {
#pragma unroll
            for (int x = 0; x < V; ++x) v[u][q][x] = 0.f;
          }
        }
      }
    };
    load_round(lo);  // in flight while the chunk's first segment is found

    // the segment of the first position, whether it began before this
    // chunk, and the empty segments that begin at lo
    int cur, nb = 0;  // nb (offsets): where cur's run ends, clipped
    bool head;
    int next = -2;    // ids: the segment of position hi
    if (ptr) {
      cur = segment_of(ptr, nseg, lo, nrows);
      head = cur >= 0 && ptr[cur] < lo;
      if (!head)
        for (int s = cur - 1; s >= 0 && ptr[s] >= lo; --s)
          zero_range(s, s + 1);
      nb = min(ptr[cur + 1], nrows);
    } else {
      if (hi < nrows) next = clamp_id(ids[row_of(hi)], nseg);
      const int prev = lo > 0 ? clamp_id(ids[row_of(lo - 1)], nseg) : -1;
      cur = key[0];
      head = lo > 0 && prev == cur;
      if (!head) zero_range(prev + 1, cur);
    }

    for (int base = lo; base < hi; base += U) {
      if (base > lo) load_round(base);
      // in order: the loads above are all in flight by now
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u;
        if (i >= hi) break;
        int key_i = ptr ? cur : key[u];
        if (ptr && i >= nb) {  // cur's run ended: the largest s, ptr[s] <= i
          key_i = cur + 1;
          while (key_i < nseg - 1 && ptr[key_i + 1] <= i) ++key_i;
        }
        if (key_i != cur) {
          flush(cur, head, false);
          zero_range(cur + 1, key_i);
          cur = key_i;
          head = false;
          if (ptr) nb = min(ptr[cur + 1], nrows);
#pragma unroll
          for (int q = 0; q < C; ++q)
#pragma unroll
            for (int x = 0; x < V; ++x) acc[q][x] = 0.f;
        }
        if (cur >= 0 && cur < nseg) {
#pragma unroll
          for (int q = 0; q < C; ++q)
#pragma unroll
            for (int x = 0; x < V; ++x) acc[q][x] += v[u][q][x];
        }
      }
    }
    flush(cur, head, ptr ? nb > hi : next == cur);
    if (c == last) zero_range(cur + 1, nseg);
  }

  // Post the arrivals (one lane a worker, after the fence that makes the
  // partials and spans visible); a worker whose arrival completes a
  // segment asks for its fold.
  if (post_seg[0] >= 0 || post_seg[1] >= 0) __threadfence();
  int fold[2] = {-1, -1};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (k == 0 && post_seg[j] >= 0 &&
        atomicAdd(cnt + post_seg[j], post_code[j]) + post_code[j] == kArrived)
      fold[j] = post_seg[j];
  }
  // The folds. A segment over at most kFoldLoads chunks (the common case:
  // a segment that crosses one or two chunk boundaries) is folded by the
  // worker that completed it, its partials in chunk order, all such
  // workers of a warp at once. A longer one (the sink's padding rows) by
  // the whole warp, one after another: group p adds the partials of the
  // chunks c0 + p, c0 + p + P, ... in order, and the groups' sums meet in
  // a fixed butterfly. Which way, and so the order of the sum, depends on
  // the chunking alone.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int s = __shfl_sync(kFull, fold[j], grp * G);  // the group's ask
    int c0 = 0, c1 = -1;
    if (s >= 0) {
      __threadfence();
      c0 = __ldcg(span + 2 * s);
      c1 = __ldcg(span + 2 * s + 1);
    }
    if (s >= 0 && c1 - c0 < kFoldLoads) {
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if (!live[q]) continue;
        const int off = V * (k + G * q);
        float w[kFoldLoads][V];
#pragma unroll
        for (int t = 0; t < kFoldLoads; ++t)
          if (c0 + t <= c1)
            load_vec<V, true>(
                part + ((size_t)(c0 + t) * 2 + (t == 0 ? 1 : 0)) * d_feat +
                    off,
                w[t]);
#pragma unroll
        for (int t = 1; t < kFoldLoads; ++t)
          if (c0 + t <= c1)
#pragma unroll
            for (int x = 0; x < V; ++x) w[0][x] += w[t][x];
        store_vec<V>(out + (size_t)s * d_feat + off, w[0]);
      }
      if (k == 0) cnt[s] = 0;  // zeroed for the next launch
    }
    unsigned asked = __ballot_sync(kFull, k == 0 && s >= 0 &&
                                              c1 - c0 >= kFoldLoads);
    while (asked) {
      const int src = __ffs(asked) - 1;
      asked &= asked - 1;
      const int sl = __shfl_sync(kFull, s, src);
      __threadfence();
      const int l0 = __shfl_sync(kFull, c0, src);
      const int l1 = __shfl_sync(kFull, c1, src);
      if constexpr (C == 1 && G > 1 && G * V <= 8) {
        // rows of at most 8 floats: each lane takes whole partial rows, of
        // the chunks l0 + lane, l0 + lane + 32, ..., and the 32 lanes'
        // sums meet in a fixed butterfly (the groups of G lanes would leave
        // all but 32 / G of the lanes' loads idle)
        float tot[G][V];
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
          for (int x = 0; x < V; ++x) tot[q][x] = 0.f;
        for (int cc = l0 + lane; cc <= l1; cc += 32 * kFoldLoads) {
          float w[kFoldLoads][G][V];
#pragma unroll
          for (int t = 0; t < kFoldLoads; ++t) {
            const int ct = cc + 32 * t;
#pragma unroll
            for (int q = 0; q < G; ++q)
              if (q < nvec && ct <= l1)
                load_vec<V, true>(part +
                                      ((size_t)ct * 2 + (ct == l0 ? 1 : 0)) *
                                          d_feat +
                                      V * q,
                                  w[t][q]);
          }
#pragma unroll
          for (int t = 0; t < kFoldLoads; ++t)
#pragma unroll
            for (int q = 0; q < G; ++q)
              if (q < nvec && cc + 32 * t <= l1)
#pragma unroll
                for (int x = 0; x < V; ++x) tot[q][x] += w[t][q][x];
        }
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1)
#pragma unroll
          for (int q = 0; q < G; ++q)
#pragma unroll
            for (int x = 0; x < V; ++x)
              tot[q][x] += __shfl_xor_sync(kFull, tot[q][x], o);
        if (lane == 0)
#pragma unroll
          for (int q = 0; q < G; ++q)
            if (q < nvec)
              store_vec<V>(out + (size_t)sl * d_feat + V * q, tot[q]);
        if (lane == 0) cnt[sl] = 0;  // zeroed for the next launch
        continue;
      }
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int off = V * (k + G * q);
        float tot[V];
#pragma unroll
        for (int x = 0; x < V; ++x) tot[x] = 0.f;
        for (int cc = l0 + grp; cc <= l1; cc += P * kLongLoads) {
          float w[kLongLoads][V];
#pragma unroll
          for (int t = 0; t < kLongLoads; ++t) {
            const int ct = cc + P * t;
            if (live[q] && ct <= l1)
              load_vec<V, true>(
                  part + ((size_t)ct * 2 + (ct == l0 ? 1 : 0)) * d_feat + off,
                  w[t]);
          }
#pragma unroll
          for (int t = 0; t < kLongLoads; ++t)
            if (live[q] && cc + P * t <= l1)
#pragma unroll
              for (int x = 0; x < V; ++x) tot[x] += w[t][x];
        }
#pragma unroll
        for (int o = 16; o >= G; o >>= 1)
#pragma unroll
          for (int x = 0; x < V; ++x)
            tot[x] += __shfl_xor_sync(kFull, tot[x], o);
        if (grp == 0 && live[q])
          store_vec<V>(out + (size_t)sl * d_feat + off, tot);
      }
      if (lane == 0) cnt[sl] = 0;  // zeroed for the next launch
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

// out (nseg, d_feat): the sorted segment sum of the rows values[order[i]]
// (order NULL: values[i]) over the positions i < min(e, row_limit), by ids
// (ids[order[i]] ascending in i; NULL where ptr is given) or by the CSR
// offsets ptr (nseg + 1,). part: (max(1, ceil(min(e, row_limit) / 32)),
// 2, d_feat) float scratch; cnt: (nseg,) int32 counters that are 0, and
// are 0 again when the kernel ends (nothing else may write them); span:
// (2 nseg,) int32 scratch.
int segment_sum_sorted(const float* values, const int* ids, const int* order,
                       const int* ptr, int e, int row_limit, int nseg,
                       int d_feat, float* part, int* cnt, int* span,
                       float* out, void* stream) {
  if (d_feat < 1 || d_feat > 1024 || e < 0 || nseg < 1 ||
      (ids == nullptr) == (ptr == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int limit = min(max(row_limit, 0), e);
  const int nchunk = max(1, (limit + kChunk - 1) / kChunk);
  // float4 or float2 rows where the width and every float table allow it
  auto aligned = [&](uintptr_t a) {
    return (uintptr_t)values % a == 0 && (uintptr_t)out % a == 0 &&
           (uintptr_t)part % a == 0;
  };
  const int vw = d_feat % 4 == 0 && aligned(16) ? 4
                 : d_feat % 2 == 0 && aligned(8) ? 2 : 1;
  const int nvec = d_feat / vw;
  // warps a block: enough blocks to reach every SM where the chunks are
  // few (PPI's 2,040 chunks of float4 rows fill 64 warps: a warp a block)
  auto wpb = [&](int per_warp) {
    const int warps = (nchunk + per_warp - 1) / per_warp;
    return max(1, min(kWarps, (warps + kSms - 1) / kSms));
  };
#define SORTED_SUM(GG, VV, CC, UU)                                          \
  do {                                                                      \
    const int w = wpb(32 / GG);                                             \
    sorted_sum_kernel<GG, VV, CC, UU>                                       \
        <<<(nchunk + w * (32 / GG) - 1) / (w * (32 / GG)), w * 32, 0, st>>>( \
            values, ids, order, ptr, e, limit, nseg, d_feat, part, cnt,     \
            span, out);                                                     \
  } while (0)
#define SORTED_NARROW(VV, UU)                      \
  if (nvec <= 1) SORTED_SUM(1, VV, 1, UU);         \
  else if (nvec <= 2) SORTED_SUM(2, VV, 1, UU);    \
  else if (nvec <= 4) SORTED_SUM(4, VV, 1, UU);    \
  else if (nvec <= 8) SORTED_SUM(8, VV, 1, UU);    \
  else if (nvec <= 16) SORTED_SUM(16, VV, 1, UU);  \
  else SORTED_SUM(32, VV, 1, UU)
  if (vw == 4) {
    if (nvec <= 32) { SORTED_NARROW(4, 8); }
    else if (nvec <= 64) SORTED_SUM(32, 4, 2, 4);
    else if (nvec <= 128) SORTED_SUM(32, 4, 4, 2);
    else SORTED_SUM(32, 4, 8, 2);
  } else if (vw == 2) {
    if (nvec <= 32) { SORTED_NARROW(2, 8); }
    else if (nvec <= 64) SORTED_SUM(32, 2, 2, 8);
    else if (nvec <= 128) SORTED_SUM(32, 2, 4, 4);
    else if (nvec <= 256) SORTED_SUM(32, 2, 8, 2);
    else SORTED_SUM(32, 2, 16, 2);
  } else {
    if (nvec <= 32) { SORTED_NARROW(1, 8); }
    else if (nvec <= 64) SORTED_SUM(32, 1, 2, 16);
    else if (nvec <= 128) SORTED_SUM(32, 1, 4, 8);
    else if (nvec <= 256) SORTED_SUM(32, 1, 8, 4);
    else if (nvec <= 512) SORTED_SUM(32, 1, 16, 2);
    else SORTED_SUM(32, 1, 32, 2);
  }
#undef SORTED_NARROW
#undef SORTED_SUM
  return (int)cudaGetLastError();
}

}  // extern "C"
