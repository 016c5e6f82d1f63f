// Sorted row segment sum for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   gat_pytorch_tpu/ops/pallas/segment_sum.py:_kernel_rows_nt
//     (segment_sum_pallas_rows(no_transpose=True)), together with the
//   jnp.take permutation of gat_pytorch_tpu/ops/pallas/segment_attention.py
//     :_dh_reduce that feeds it.
//
// Contract: out[s, :] = sum over i in [seg_ptr[s], seg_ptr[s+1]) of
// values[order[i], :] (order NULL: the identity), summed in increasing i.
// With order = src_order and seg_ptr the CSR offsets of the sender-sorted
// edges, this is the d(h) reduction of the attention backward: the
// per-edge d(h) rows (in dst order) summed per sender, the permutation
// fused into the read.
//
// Design. The TPU reduced with one-hot matmuls over edge blocks; on Hopper
// one warp owns one segment and streams its rows (lane l sums features
// l, l+32, ...). Each output row is written once by one warp, in a fixed
// order: no atomics, bitwise reproducible.
//
// What bounds it on the H100: by bytes, the rows read (E x D x 4) and the
// table written (N x D x 4), about a microsecond at Cora size. As written
// it is bound by latency: a warp reads its segment's rows one after
// another through `order`, and narrow rows (D = 7) leave most lanes idle.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;  // warps per block; one segment per warp

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
seg_rows_kernel(const float* __restrict__ values, const int* __restrict__ order,
                const int* __restrict__ seg_ptr, int nseg, int d_feat,
                float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool live[C];
#pragma unroll
  for (int c = 0; c < C; ++c) live[c] = lane + 32 * c < d_feat;
  for (int s = blockIdx.x * kWarps + warp; s < nseg; s += gridDim.x * kWarps) {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    const int lo = seg_ptr[s], hi = seg_ptr[s + 1];
    for (int i = lo; i < hi; ++i) {
      const float* row = values + (size_t)(order ? order[i] : i) * d_feat;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (live[c]) acc[c] += row[lane + 32 * c];
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (live[c]) out[(size_t)s * d_feat + lane + 32 * c] = acc[c];
  }
}

}  // namespace

extern "C" {

// out (nseg, d_feat); order may be NULL.
int segment_sum_rows(const float* values, const int* order,
                     const int* seg_ptr, int nseg, int d_feat, float* out,
                     int nblk, void* stream) {
  if (d_feat < 1 || d_feat > 1024 || nblk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int c_need = (d_feat + 31) / 32;
#define SEG_ROWS(CC)                                                   \
  seg_rows_kernel<CC><<<nblk, kWarps * 32, 0, st>>>(values, order, seg_ptr, \
                                                    nseg, d_feat, out)
  if (c_need <= 1) SEG_ROWS(1);
  else if (c_need <= 2) SEG_ROWS(2);
  else if (c_need <= 4) SEG_ROWS(4);
  else if (c_need <= 8) SEG_ROWS(8);
  else if (c_need <= 16) SEG_ROWS(16);
  else SEG_ROWS(32);
#undef SEG_ROWS
  return (int)cudaGetLastError();
}

}  // extern "C"
