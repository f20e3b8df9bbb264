// The per-warp online-softmax step of the CUDA-core attention kernel
// (flash_attention.cu), for Hopper (sm_90a), and the small helpers that the
// attention kernels share (conversions, warp reductions, the shared-memory
// limit).
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

constexpr float kLn2 = 0.6931471805599453f;

// A row's log-sum-exp m + log l of its scaled scores (natural units), or
// +inf for a row that met no key (l = 0): exp(s - lse) is then 0 and the
// backward's dS vanishes there instead of turning into NaN.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : INFINITY;
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

// One chunk of keys against the warp's R rows.
//   qs:   R rows of scaled f32 queries, row stride ldq (shared memory; every
//         lane reads the same element, a broadcast);
//   ks:   the chunk's keys as f32, row stride D + 1 so that lane j's reads
//         of key j fall in distinct banks (shared memory);
//   v:    the chunk's values, value j at v + j * ldv, read at d = lane + 32 i
//         (f32 shared memory);
//   lim:  keys [0, lim[r]) of the chunk are valid for row r;
//   jmax: max over r of lim[r]; values past it are never read, so a
//         non-finite value outside the valid range cannot leak in.
// lim and jmax must be the same in every lane (the shuffles need the whole
// warp).
template <int R, typename VT>
__device__ __forceinline__ void attend_chunk(RowState<R>& st, const float* qs,
                                             int ldq, const float* ks,
                                             const VT* v, long long ldv,
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
    const VT* vj_row = v + j * ldv;
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

}  // namespace repro_attn
