// The per-warp online-softmax step shared by the attention kernels
// (flash_attention.cu, decode_attention.cu, paged_attention.cu), for Hopper
// (sm_90a), and the merge of a block's per-warp states used by the two
// decode kernels.
//
// One warp holds R query rows and meets one chunk of up to 32 keys at a
// time: lane j owns key j of the chunk for the scores, and head-dim slots
// d = lane + 32 i (i < kMaxNI) for the output accumulator. Everything is f32:
// inputs are converted as they are staged, scores and the running
// (max m, normaliser l, accumulator acc) never leave registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace repro_attn {

constexpr int kChunk = 32;      // keys per warp step: one per lane
constexpr int kMaxNI = 4;       // head dim up to kMaxNI * 32 = 128
constexpr int kMaxHeadDim = kMaxNI * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Online-softmax state of R rows. m and l are the same in every lane; acc
// holds row r's output at d = lane + 32 i. m stays -inf until the row has
// met a valid key, so a row that never meets one ends with l = 0, acc = 0.
template <int R>
struct RowState {
  float m[R], l[R], acc[R][kMaxNI];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxNI; ++i) acc[r][i] = 0.f;
    }
  }
  // acc / max(l, 1e-30): zeros for a row that met no valid key, as the
  // TPU kernels give.
  __device__ __forceinline__ float out(int r, int i) const {
    return acc[r][i] / fmaxf(l[r], 1e-30f);
  }
};

// Row j of a chunk's values at p + j * ld (a strided cache or a tile).
template <typename VT>
struct StridedRows {
  const VT* p;
  long long ld;
  __device__ __forceinline__ const VT* operator()(int j) const {
    return p + j * ld;
  }
};

// Row j of a chunk's values at p + off[j] (positions scattered over the
// blocks of a paged pool; off in shared memory).
template <typename VT>
struct OffsetRows {
  const VT* p;
  const long long* off;
  __device__ __forceinline__ const VT* operator()(int j) const {
    return p + off[j];
  }
};

// One chunk of keys against the warp's R rows.
//   qs:   R rows of scaled f32 queries, row stride ldq (shared memory; every
//         lane reads the same element, a broadcast);
//   ks:   the chunk's keys as f32, row stride D + 1 so that lane j's reads
//         of key j fall in distinct banks (shared memory);
//   vrow: vrow(j) points at the chunk's value j, read at d = lane + 32 i
//         (f32 shared memory, or the cache itself in global memory);
//   lim:  keys [0, lim[r]) of the chunk are valid for row r;
//   jmax: max over r of lim[r]; values past it are never read, so a
//         non-finite value outside the valid range cannot leak in.
// lim and jmax must be the same in every lane (the shuffles need the whole
// warp).
template <int R, typename Rows>
__device__ __forceinline__ void attend_chunk_rows(RowState<R>& st,
                                                  const float* qs, int ldq,
                                                  const float* ks, Rows vrow,
                                                  int D, const int (&lim)[R],
                                                  int jmax, int lane) {
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
  const float* krow = ks + lane * (D + 1);
  for (int d = 0; d < D; ++d) {
    const float kd = krow[d];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = fmaf(qs[r * ldq + d], kd, s[r]);
  }
  float p[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool valid = lane < lim[r];
    const float m_new = fmaxf(st.m[r], warp_max(valid ? s[r] : -INFINITY));
    const float alpha = m_new == -INFINITY ? 1.f : expf(st.m[r] - m_new);
    p[r] = valid ? expf(s[r] - m_new) : 0.f;
    st.l[r] = st.l[r] * alpha + warp_sum(p[r]);
    st.m[r] = m_new;
#pragma unroll
    for (int i = 0; i < kMaxNI; ++i) st.acc[r][i] *= alpha;
  }
  for (int j = 0; j < jmax; ++j) {
    const auto* vj_row = vrow(j);
    float vj[kMaxNI];
#pragma unroll
    for (int i = 0; i < kMaxNI; ++i) {
      const int d = lane + 32 * i;
      vj[i] = d < D ? to_f32(vj_row[d]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
      for (int i = 0; i < kMaxNI; ++i)
        st.acc[r][i] = fmaf(pj, vj[i], st.acc[r][i]);
    }
  }
}

// The same with values at v + j * ldv.
template <int R, typename VT>
__device__ __forceinline__ void attend_chunk(RowState<R>& st, const float* qs,
                                             int ldq, const float* ks,
                                             const VT* v, long long ldv,
                                             int D, const int (&lim)[R],
                                             int jmax, int lane) {
  attend_chunk_rows<R>(st, qs, ldq, ks, StridedRows<VT>{v, ldv}, D, lim,
                       jmax, lane);
}

// Merge the W warps' partial states of the block's R rows (the first nr are
// real) through shared memory and write row r's output element d through
// out(r, d, value). `scratch` holds W * R * (D + 2) floats and is free;
// every thread of the block calls this after the warps' last chunk.
template <int W, int R, typename Out>
__device__ __forceinline__ void merge_warps(const RowState<R>& st,
                                            float* scratch, int nr, int D,
                                            int warp, int lane, int tid,
                                            Out out) {
  __syncthreads();
  float* ms = scratch;                // W x R
  float* ls = ms + W * R;             // W x R
  float* as = ls + W * R;             // W x R x D
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      ms[warp * R + r] = st.m[r];
      ls[warp * R + r] = st.l[r];
    }
#pragma unroll
    for (int i = 0; i < kMaxNI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) as[(warp * R + r) * D + d] = st.acc[r][i];
    }
  }
  __syncthreads();
  for (int e = tid; e < nr * D; e += W * 32) {
    const int r = e / D, d = e - (e / D) * D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) m = fmaxf(m, ms[w * R + r]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float mw = ms[w * R + r];
      if (mw != -INFINITY) {
        const float c = expf(mw - m);
        l += ls[w * R + r] * c;
        a += as[(w * R + r) * D + d] * c;
      }
    }
    out(r, d, a / fmaxf(l, 1e-30f));
  }
}

// Raise a kernel's dynamic shared memory limit to `bytes` (once per kernel
// and size) so that a launch above the 48 KB default is not refused.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes, int* done) {
  if (bytes <= *done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done = bytes;
  return e;
}

}  // namespace repro_attn
