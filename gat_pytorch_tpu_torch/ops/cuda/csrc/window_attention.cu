// Windowed whole-attention op over the block layout, for Hopper (sm_90a):
// forward and backward.
//
// Replaces the TPU kernels
//   gat_pytorch_tpu/ops/pallas/segment_attention_window.py:_kernel_v6
//     (block-layout "v7" form, single-sweep "v10" mode, float32
//      contractions; launched by _forward_v6 for fused_gat_window_v7)
//   gat_pytorch_tpu/ops/pallas/segment_attention_window.py:_kernel_v6_bwd
//     (the same form and mode, launched by backward_v6)
//
// Contract. The edges live in layout slots: grouped per nb-row destination
// tile, sender-sorted within a tile, padded per block to eb slots; a pad
// slot has recv == -1 and contributes nothing. Per real slot s = (send,
// recv) and head k:
//   raw'[s,k] = h[send,:] . a_src[:,k] + s_dst'[recv,k]  (s_dst' B-shifted)
//   ex[s,k]   = exp(slope * raw'[s,k])
//   num[recv, k*f+j] += ex[s,k] * drop[s,k] * h[send, k*f+j]
//   den[recv, k]     += ex[s,k]                (no dropout mask in den)
//   cap' = max raw', code = lowest s*nh + k attaining it
// drop is (E7, nh) in slot order. The normalising epilogue
// out = num / (den + eps*exp(slope*cap')) and the cap cotangent run in
// torch. The backward recomputes ex from the same inputs and emits the
// per-slot d(h) rows (pad rows are left unwritten: the reduction by
// sender reads real slots only), d(drop) per slot (0 on pad slots),
// d(s_dst) per destination and d(a_src).
//
// Design. The TPU kernel streams a window of the node table into VMEM per
// destination tile and gathers from it with one-hot matrix products, per
// eb-slot block against a wb-row slice, because Mosaic has no in-kernel
// row gather; `window`, `wb`, `base`, `tile_base` and `dmax` size those
// streams. Hopper gathers rows directly, so none of them reaches the
// kernels. What the kernels walk is the layout's slot order through two
// index arrays computed once with the layout: dst_perm lists the slots by
// destination (stable, so still sender-sorted within a row, pad slots
// last) and dst_ptr cuts it into per-row runs. One warp owns one
// destination row at a time and walks its run in order: it loads the
// sender's h row (lane l holds features l, l+32, ...), contracts it with
// a_src (in shared memory) through warp shuffles, and accumulates num/den
// in registers. Every output row has one writer and a fixed order of
// sums: no atomics, bitwise reproducible. Pad slots are never visited:
// dst_ptr[n] is the count of real slots. The cap with its argmax code and
// d(a_src) go through per-block partials over a fixed grid and an ordered
// second pass (attention_common.cuh).
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
// 3.35 TB/s). As written it is bound by latency instead: each warp walks
// its slots one after another, and every slot is a dependent chain (slot
// index, sender index, row gather, nh warp reductions). Staging a tile's
// sender window in shared memory with TMA, and narrower lane groups per
// row for the 64- and 24-wide rows of Pubmed, are the next steps
// (PERF.md).

#include "attention_common.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
window_fwd_kernel(const float* __restrict__ h, const float* __restrict__ a_src,
                  const float* __restrict__ s_dst,
                  const float* __restrict__ drop, const int* __restrict__ send,
                  const int* __restrict__ dst_perm,
                  const int* __restrict__ dst_ptr, int n, int d_feat, int nh,
                  int f, float slope, float* __restrict__ num,
                  float* __restrict__ den, float* __restrict__ blk_max,
                  int* __restrict__ blk_code) {
  extern __shared__ float sa[];  // a_src transposed, (nh, d_feat)
  __shared__ float wmax[kWarps];
  __shared__ int wcode[kWarps];
  for (int i = threadIdx.x; i < d_feat * nh; i += blockDim.x)
    sa[(i % nh) * d_feat + i / nh] = a_src[i];
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
  float vmax = -INFINITY;
  int vcode = INT_MAX;

  for (int d = blockIdx.x * kWarps + warp; d < n; d += gridDim.x * kWarps) {
    float sd[kMaxHeads], dsum[kMaxHeads], acc[C];
#pragma unroll
    for (int k = 0; k < kMaxHeads; ++k) {
      sd[k] = k < nh ? s_dst[(size_t)d * nh + k] : 0.f;
      dsum[k] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;

    const int lo = dst_ptr[d], hi = dst_ptr[d + 1];  // real slots only
    for (int i = lo; i < hi; ++i) {
      const int slot = dst_perm[i];
      const float* hrow = h + (size_t)send[slot] * d_feat;
      float hv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) hv[c] = live[c] ? hrow[lane + 32 * c] : 0.f;
      float ex[kMaxHeads];
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k) {
        ex[k] = 0.f;
        if (k < nh) {  // nh is warp-uniform: every lane joins the shuffles
          float p = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (live[c]) p += hv[c] * sa[k * d_feat + lane + 32 * c];
          const float raw = warp_sum(p) + sd[k];
          take_max(vmax, vcode, raw, slot * nh + k);
          ex[k] = expf(slope * raw);
          dsum[k] += ex[k];
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!live[c]) continue;
        float w = select_head(ex, head[c]);
        if (drop) w *= drop[(size_t)slot * nh + head[c]];
        acc[c] += w * hv[c];
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (live[c]) num[(size_t)d * d_feat + lane + 32 * c] = acc[c];
    if (lane < nh) den[(size_t)d * nh + lane] = select_head(dsum, lane);
  }

  if (lane == 0) {
    wmax[warp] = vmax;
    wcode[warp] = vcode;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = -INFINITY;
    int code = INT_MAX;
    for (int w = 0; w < kWarps; ++w) take_max(m, code, wmax[w], wcode[w]);
    blk_max[blockIdx.x] = m;
    blk_code[blockIdx.x] = code;
  }
}

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
window_bwd_kernel(const float* __restrict__ h, const float* __restrict__ a_src,
                  const float* __restrict__ s_dst,
                  const float* __restrict__ drop, const int* __restrict__ send,
                  const int* __restrict__ dst_perm,
                  const int* __restrict__ dst_ptr, int n, int e7, int d_feat,
                  int nh, int f, float slope, const float* __restrict__ g,
                  const float* __restrict__ out, const float* __restrict__ den,
                  const float* __restrict__ epsp, float* __restrict__ d_h_rows,
                  float* __restrict__ d_drop, float* __restrict__ d_sdst,
                  float* __restrict__ dasrc_part) {
  extern __shared__ float smem[];
  float* sa = smem;                  // a_src transposed, (nh, d_feat)
  float* sacc = smem + d_feat * nh;  // this block's d(a_src), (nh, d_feat)
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
  const float eps_p = *epsp;

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
        inv[k] = dn > 0.f ? 1.f / (dn + eps_p) : 0.f;
        float p = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (live[c] && head[c] == k)
            p += out[(size_t)d * d_feat + lane + 32 * c] * gv[c];
        dden[k] = -warp_sum(p) * inv[k];
        sd[k] = s_dst[(size_t)d * nh + k];
      }
    }

    const int lo = dst_ptr[d], hi = dst_ptr[d + 1];  // real slots only
    for (int i = lo; i < hi; ++i) {
      const int slot = dst_perm[i];
      float* dhrow = d_h_rows + (size_t)slot * d_feat;
      const float* hrow = h + (size_t)send[slot] * d_feat;
      float hv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) hv[c] = live[c] ? hrow[lane + 32 * c] : 0.f;
      float draw[kMaxHeads], coef[kMaxHeads];
#pragma unroll
      for (int k = 0; k < kMaxHeads; ++k) {
        draw[k] = coef[k] = 0.f;
        if (k < nh) {
          float p = 0.f, q = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (!live[c]) continue;
            p += hv[c] * sa[k * d_feat + lane + 32 * c];
            if (head[c] == k) q += hv[c] * gv[c];
          }
          const float raw = warp_sum(p) + sd[k];
          const float hg = warp_sum(q);
          const float ex = expf(slope * raw);
          const float m = drop ? drop[(size_t)slot * nh + k] : 1.f;
          // d(raw') through the negative LeakyReLU branch (raw' <= cap')
          draw[k] = slope * ex * (hg * inv[k] * m + dden[k]);
          coef[k] = ex * m * inv[k];
          sds[k] += draw[k];
          if (d_drop && lane == k)
            d_drop[(size_t)slot * nh + k] = hg * ex * inv[k];
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!live[c]) continue;
        const int j = lane + 32 * c;
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxHeads; ++k) {
          if (k < nh) {
            v += sa[k * d_feat + j] * draw[k];
            da[c][k] += hv[c] * draw[k];
          }
        }
        dhrow[j] = v + select_head(coef, head[c]) * gv[c];
      }
    }
    if (lane < nh) d_sdst[(size_t)d * nh + lane] = select_head(sds, lane);
  }

  // block sum of d(a_src): warps add in a fixed order (deterministic)
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
  for (int i = threadIdx.x; i < d_feat * nh; i += blockDim.x)
    dasrc_part[(size_t)blockIdx.x * d_feat * nh + i] =
        sacc[(i % nh) * d_feat + i / nh];  // back to (d_feat, nh)
}

}  // namespace

extern "C" {

// Forward: num (n, d_feat), den (n, nh), cap (1,), code (1,).
// send (e7,), dst_perm (e7,), dst_ptr (n + 1,); blk_max / blk_code are
// (nblk,) scratch. drop (e7, nh) may be NULL.
int window_forward(const float* h, const float* a_src, const float* s_dst,
                   const float* drop, const int* send, const int* dst_perm,
                   const int* dst_ptr, int n, int d_feat, int nh, int f,
                   float slope, float* num, float* den, float* blk_max,
                   int* blk_code, float* cap, int* code, int nblk,
                   void* stream) {
  if (d_feat < 1 || d_feat > 1024 || nh < 1 || nh > kMaxHeads || nblk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)d_feat * nh * sizeof(float);
  const int c_need = (d_feat + 31) / 32;
  cudaError_t err = cudaSuccess;
#define WINDOW_FWD(CC)                                                     \
  err = set_smem(window_fwd_kernel<CC>, smem);                             \
  if (err == cudaSuccess)                                                  \
    window_fwd_kernel<CC><<<nblk, kWarps * 32, smem, st>>>(                \
        h, a_src, s_dst, drop, send, dst_perm, dst_ptr, n, d_feat, nh, f,  \
        slope, num, den, blk_max, blk_code);
  ROWS_DISPATCH(WINDOW_FWD)
#undef WINDOW_FWD
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cap_reduce_kernel<<<1, kCapThreads, 0, st>>>(blk_max, blk_code, nblk, cap,
                                               code);
  return (int)cudaGetLastError();
}

// Backward: d_h_rows (e7, d_feat) in slot order (pad rows unwritten),
// d_drop (e7, nh) or NULL, d_sdst (n, nh), d_asrc (d_feat, nh);
// dasrc_part is (nblk, d_feat*nh) scratch. epsp points at
// eps' = eps*exp(slope*cap') on the device.
int window_backward(const float* h, const float* a_src, const float* s_dst,
                    const float* drop, const int* send, const int* dst_perm,
                    const int* dst_ptr, int n, int e7, int d_feat, int nh,
                    int f, float slope, const float* g, const float* out,
                    const float* den, const float* epsp, float* d_h_rows,
                    float* d_drop, float* d_sdst, float* dasrc_part,
                    float* d_asrc, int nblk, void* stream) {
  if (d_feat < 1 || d_feat > 1024 || nh < 1 || nh > kMaxHeads || nblk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = 2 * (size_t)d_feat * nh * sizeof(float);
  const int c_need = (d_feat + 31) / 32;
  cudaError_t err = cudaSuccess;
#define WINDOW_BWD(CC)                                                      \
  err = set_smem(window_bwd_kernel<CC>, smem);                              \
  if (err == cudaSuccess)                                                   \
    window_bwd_kernel<CC><<<nblk, kWarps * 32, smem, st>>>(                 \
        h, a_src, s_dst, drop, send, dst_perm, dst_ptr, n, e7, d_feat, nh,  \
        f, slope, g, out, den, epsp, d_h_rows, d_drop, d_sdst, dasrc_part);
  ROWS_DISPATCH(WINDOW_BWD)
#undef WINDOW_BWD
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = d_feat * nh;
  sum_partials_kernel<<<(len + 255) / 256, 256, 0, st>>>(dasrc_part, nblk,
                                                         len, d_asrc);
  return (int)cudaGetLastError();
}

}  // extern "C"
