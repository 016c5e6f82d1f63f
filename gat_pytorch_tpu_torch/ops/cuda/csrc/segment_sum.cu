// Sorted row segment sums for Hopper (sm_90a): the d(h) reduction of the
// attention backward (seg_rows_kernel) and the plain sorted segment sum
// (sorted_sum_kernel, further down, with its own header).
//
// seg_rows_kernel replaces the TPU kernel
//   gat_pytorch_tpu/ops/pallas/segment_sum.py:_kernel_rows_nt
//     (segment_sum_pallas_rows(no_transpose=True)), together with the
//   jnp.take permutation of gat_pytorch_tpu/ops/pallas/segment_attention.py
//     :_dh_reduce that feeds it.
//
// Contract: out[s, :] = sum over i in [seg_ptr[s], seg_ptr[s+1]) of
// values[order[i], :] (order NULL: the identity), summed in increasing i.
// Rows order[i] >= row_limit are skipped: the caller says they are zero
// (the attention backward's padding edges).
// With order = src_order and seg_ptr the CSR offsets of the sender-sorted
// edges, this is the d(h) reduction of the attention backward: the
// per-edge d(h) rows (in dst order) summed per sender, the permutation
// fused into the read.
//
// Design. The TPU reduced with one-hot matmuls over edge blocks; on Hopper
// one warp owns one segment and streams its rows (lane l sums features
// l, l+32, ...). Each output row is written once by one warp, in a fixed
// order: no atomics, bitwise reproducible. The warp reads its segment's
// row indices 32 at a time (one coalesced load), votes on which are under
// row_limit and walks only those: a batch padded to its bucket hangs
// thousands of padding edges on the sink node, and their one warp then
// steps over them 32 at a time without touching a row.
//
// What bounds it on the H100: by bytes, the rows read (E x D x 4) and the
// table written (N x D x 4), about a microsecond at Cora size. As written
// it is bound by latency: a warp reads its segment's rows one after
// another through `order`, and narrow rows (D = 7) leave most lanes idle.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;  // warps per block; one segment per warp
constexpr unsigned kFull = 0xffffffffu;

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
seg_rows_kernel(const float* __restrict__ values, const int* __restrict__ order,
                const int* __restrict__ seg_ptr, int nseg, int row_limit,
                int d_feat, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool live[C];
#pragma unroll
  for (int c = 0; c < C; ++c) live[c] = lane + 32 * c < d_feat;
  for (int s = blockIdx.x * kWarps + warp; s < nseg; s += gridDim.x * kWarps) {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    const int lo = seg_ptr[s], hi = seg_ptr[s + 1];
    for (int base = lo; base < hi; base += 32) {
      const int i = base + lane;
      const int mine = i < hi ? (order ? order[i] : i) : row_limit;
      // the set bits, lowest first, keep the sum in increasing i
      unsigned todo = __ballot_sync(kFull, mine < row_limit);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const float* row =
            values + (size_t)__shfl_sync(kFull, mine, src) * d_feat;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (live[c]) acc[c] += row[lane + 32 * c];
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (live[c]) out[(size_t)s * d_feat + lane + 32 * c] = acc[c];
  }
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

// out (nseg, d_feat); order may be NULL; row_limit = the number of rows of
// `values` reads them all.
int segment_sum_rows(const float* values, const int* order,
                     const int* seg_ptr, int nseg, int row_limit, int d_feat,
                     float* out, int nblk, void* stream) {
  if (d_feat < 1 || d_feat > 1024 || nblk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int c_need = (d_feat + 31) / 32;
#define SEG_ROWS(CC)                                                   \
  seg_rows_kernel<CC><<<nblk, kWarps * 32, 0, st>>>(                   \
      values, order, seg_ptr, nseg, row_limit, d_feat, out)
  if (c_need <= 1) SEG_ROWS(1);
  else if (c_need <= 2) SEG_ROWS(2);
  else if (c_need <= 4) SEG_ROWS(4);
  else if (c_need <= 8) SEG_ROWS(8);
  else if (c_need <= 16) SEG_ROWS(16);
  else SEG_ROWS(32);
#undef SEG_ROWS
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
