// Grouped-query decode attention: one new token per row against its KV
// cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` / `gqa_decode_attention` in
// src/repro/kernels/decode_attention.py. Same function:
//
//   out[b, h] = softmax_{j < n_b}(q[b, h] . k[b, h / G, j] * D^-0.5) . v[b, h / G, j]
//
// with n_b = min(kv_len[b], Smax), G = Hq / Hkv, f32 math, output in the
// input's type (f32 or bf16). A row with kv_len <= 0 gives zeros, as the
// TPU kernel does. Positions at or past n_b are never read, so whatever the
// cache holds there (stale tokens, padding, NaN) cannot reach the output.
// The port's serving engine runs it for every layer of every decode step.
//
// What bounds it: the bytes of the cache read, 2 * n_b * D elements per
// (b, kv head), against ~4 * G * n_b * D operations: G operations a byte in
// bf16 (2 for qwen3-1.7b), so device memory at 3.35 TB/s is the only limit.
//
// What the design does about it, simply:
//   * one block of 4 warps per (kv head, batch row), so the G query heads of
//     a group share every K/V byte read, as the TPU kernel's group-folded
//     matmul does; the group's queries sit in shared memory as scaled f32;
//   * the 4 warps split the cache positions in chunks of 32 (warp w takes
//     chunks w, w + 4, ...), each with its own online softmax (m, l, acc) in
//     registers, and the block merges the 4 partial states at the end;
//   * a warp stages its chunk's keys in shared memory (rows padded to D + 1
//     for a conflict-free score loop) and reads the values straight from
//     the cache, lane by lane along d, which is coalesced;
//   * the loop ends at n_b: chunks past it are neither loaded nor computed;
//   * K and V are read through element strides, so one layer's slice of the
//     engine's (B, Smax, Hkv, D) cache is read in place: no transpose, no
//     copy.
// With 4 warps per (b, kv head), B * Hkv blocks may not fill the card's 132
// SMs at small batch; splitting the positions over blocks is later work.

#include "attention_tile.cuh"

namespace {

using namespace repro_attn;

constexpr int kWarps = 4;

struct Strides {
  long long b, h, s;  // element strides of (batch, head, position); d is 1
};

template <typename T, int R>
__global__ void __launch_bounds__(kWarps * 32)
gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ kv_len,
                  T* __restrict__ o, int G, int Smax, int D, float scale,
                  Strides qst, Strides kst, Strides vst, Strides ost) {
  extern __shared__ float smem[];
  float* qs = smem;                        // R x D
  float* ks = qs + R * D;                  // kWarps x kChunk x (D + 1)

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n = min(max(kv_len[b], 0), Smax);
  const T* kb = k + b * kst.b + hk * kst.h;
  const T* vb = v + b * vst.b + hk * vst.h;
  float* kw = ks + warp * kChunk * (D + 1);

  // one pass per block of R query heads: a single pass when G <= R
  for (int g0 = 0; g0 < G; g0 += R) {
    const int nr = min(R, G - g0);
    __syncthreads();  // the previous pass's merge is read
    for (int e = tid; e < R * D; e += kWarps * 32) {
      const int r = e / D, d = e - (e / D) * D;
      qs[e] = r < nr ? to_f32(q[b * qst.b + (hk * G + g0 + r) * qst.h + d]) *
                           scale
                     : 0.f;
    }
    __syncthreads();

    RowState<R> st;
    st.init();
    for (int k0 = warp * kChunk; k0 < n; k0 += kWarps * kChunk) {
      const int nk = min(kChunk, n - k0);
      __syncwarp();  // the previous chunk's keys are consumed
      for (int e = lane; e < kChunk * D; e += 32) {
        const int j = e / D, d = e - (e / D) * D;
        kw[j * (D + 1) + d] = j < nk ? to_f32(kb[(k0 + j) * kst.s + d]) : 0.f;
      }
      __syncwarp();
      int lim[R];
#pragma unroll
      for (int r = 0; r < R; ++r) lim[r] = r < nr ? nk : 0;
      attend_chunk<R, T>(st, qs, D, kw, vb + k0 * vst.s, vst.s, D, lim, nk,
                         lane);
    }

    // merge the warps' partial states through shared memory (the key
    // chunks' space is free once every warp is done)
    __syncthreads();
    float* ms = ks;                     // kWarps x R
    float* ls = ms + kWarps * R;        // kWarps x R
    float* as = ls + kWarps * R;        // kWarps x R x D
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
    for (int e = tid; e < nr * D; e += kWarps * 32) {
      const int r = e / D, d = e - (e / D) * D;
      float m = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, ms[w * R + r]);
      float l = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = ms[w * R + r];
        if (mw != -INFINITY) {
          const float c = expf(mw - m);
          l += ls[w * R + r] * c;
          a += as[(w * R + r) * D + d] * c;
        }
      }
      o[b * ost.b + (hk * G + g0 + r) * ost.h + d] =
          from_f32<T>(a / fmaxf(l, 1e-30f));
    }
  }
}

template <typename T, int R>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* o, int B, int Hkv, int G, int Smax, int D, Strides qst,
           Strides kst, Strides vst, Strides ost, cudaStream_t stream) {
  static int smem_allowed = 48 * 1024;
  const int smem = (int)sizeof(float) * (R * D + kWarps * kChunk * (D + 1));
  cudaError_t e = allow_smem(gqa_decode_kernel<T, R>, smem, &smem_allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Hkv, B);
  gqa_decode_kernel<T, R><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(o), G, Smax, D,
      (float)(1.0 / sqrt((double)D)), qst, kst, vst, ost);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const void* q, const void* k, const void* v,
                const int* kv_len, void* o, int B, int Hkv, int G, int Smax,
                int D, Strides qst, Strides kst, Strides vst, Strides ost,
                cudaStream_t s) {
  // the smallest register block of query heads that holds the group
  if (G <= 1)
    return launch<T, 1>(q, k, v, kv_len, o, B, Hkv, G, Smax, D, qst, kst, vst,
                        ost, s);
  if (G <= 2)
    return launch<T, 2>(q, k, v, kv_len, o, B, Hkv, G, Smax, D, qst, kst, vst,
                        ost, s);
  if (G <= 4)
    return launch<T, 4>(q, k, v, kv_len, o, B, Hkv, G, Smax, D, qst, kst, vst,
                        ost, s);
  return launch<T, 8>(q, k, v, kv_len, o, B, Hkv, G, Smax, D, qst, kst, vst,
                      ost, s);
}

}  // namespace

// q: (B, Hq, D) with (batch, head) strides; k/v: (B, Hkv, Smax, D) with
// (batch, head, position) strides; kv_len: (B,) int32; o: (B, Hq, D) with
// (batch, head) strides. The last dimension of each is contiguous. dtype:
// 0 = float32, 1 = bfloat16. Launches on `stream`, allocates nothing, and
// returns cudaGetLastError().
extern "C" int repro_gqa_decode(const void* q, const void* k, const void* v,
                                const void* kv_len, void* o, int B, int Hq,
                                int Hkv, int Smax, int D, int dtype,
                                long long q_sb, long long q_sh,
                                long long k_sb, long long k_sh,
                                long long k_ss, long long v_sb,
                                long long v_sh, long long v_ss,
                                long long o_sb, long long o_sh,
                                void* stream) {
  if (B <= 0 || B > 65535 || Smax <= 0 || D <= 0 || D > kMaxHeadDim ||
      Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const Strides qst{q_sb, q_sh, 0}, kst{k_sb, k_sh, k_ss},
      vst{v_sb, v_sh, v_ss}, ost{o_sb, o_sh, 0};
  const int* len = static_cast<const int*>(kv_len);
  cudaStream_t s = (cudaStream_t)stream;
  const int G = Hq / Hkv;
  if (dtype == 0)
    return launch_rows<float>(q, k, v, len, o, B, Hkv, G, Smax, D, qst, kst,
                              vst, ost, s);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(q, k, v, len, o, B, Hkv, G, Smax, D,
                                      qst, kst, vst, ost, s);
  return (int)cudaErrorInvalidValue;
}
