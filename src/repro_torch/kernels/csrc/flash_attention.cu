// Causal or non-causal grouped-query flash attention, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py. Same function:
//
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / G, j] * D^-0.5) . v[b, h / G, j]
//
// with j <= i when causal, G = Hq / Hkv, f32 math, output in the input's
// type (f32 or bf16). The port's serving engine runs it for every prompt's
// prefill and `train_logits` runs it for every layer.
//
// What bounds it: the work is 4 * B * Hq * S^2 * D operations (halved when
// causal) against (2 * Hq + 2 * Hkv) * B * S * D elements moved. At the
// serving heads (Hq = 16, Hkv = 8, D = 128, bf16) that is S / 3 operations
// a byte, 43 at S = 128 and 170 at S = 512: below the tensor cores'
// balance point of ~295, but far above the ~20 of the f32 CUDA cores this
// first kernel computes on, so it is bound by operations at their rate.
//
// What the design does about it, simply:
//   * one block of 4 warps per (q tile of 32 rows, q head, batch row); each
//     warp owns 8 rows, held as scaled f32 queries in shared memory, and
//     keeps their running (m, l, acc) in registers (attention_tile.cuh);
//   * K and V tiles of 32 keys of kv head h / G are staged once per block in
//     shared memory as f32 and shared by the 4 warps; K rows are padded to
//     D + 1 so the score loop reads them without bank conflicts;
//   * the loop over key tiles stops at the tile's last row when causal, so
//     tiles above the diagonal are never loaded;
//   * the ragged last q tile and k tile are masked in the kernel: any S >= 1
//     works with no padding. Inputs are read through element strides, so
//     the (B, S, H, D) projections are read in place, without a transpose.
// The tensor cores (wgmma) and a pipelined K/V ring are later work.

#include "attention_tile.cuh"

namespace {

using namespace repro_attn;

constexpr int kWarps = 4;
constexpr int kRows = 8;                  // q rows per warp
constexpr int kTileQ = kWarps * kRows;    // 32
constexpr int kTileK = kChunk;            // 32

struct Strides {
  long long b, h, s;  // element strides of (batch, head, position); d is 1
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int D, int group, int causal, float scale, Strides qst,
                       Strides kst, Strides vst, Strides ost) {
  extern __shared__ float smem[];
  float* qs = smem;                       // kTileQ x D
  float* ks = qs + kTileQ * D;            // kTileK x (D + 1)
  float* vs = ks + kTileK * (D + 1);      // kTileK x D

  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const T* qb = q + b * qst.b + h * qst.h;
  const T* kb = k + b * kst.b + (h / group) * kst.h;
  const T* vb = v + b * vst.b + (h / group) * vst.h;
  T* ob = o + b * ost.b + h * ost.h;

  for (int e = tid; e < kTileQ * D; e += kWarps * 32) {
    const int r = e / D, d = e - (e / D) * D;
    const int row = q0 + r;
    qs[e] = row < S ? to_f32(qb[row * qst.s + d]) * scale : 0.f;
  }

  const int q_last = min(q0 + kTileQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int r0 = q0 + warp * kRows;
  RowState<kRows> st;
  st.init();
  for (int k0 = 0; k0 < k_end; k0 += kTileK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    const int nk = min(kTileK, S - k0);
    for (int e = tid; e < kTileK * D; e += kWarps * 32) {
      const int j = e / D, d = e - (e / D) * D;
      float kx = 0.f, vx = 0.f;
      if (j < nk) {
        kx = to_f32(kb[(k0 + j) * kst.s + d]);
        vx = to_f32(vb[(k0 + j) * vst.s + d]);
      }
      ks[j * (D + 1) + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();
    int lim[kRows];
    int jmax = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = r0 + r;
      int n = causal ? min(row + 1 - k0, nk) : nk;
      n = row < S ? max(n, 0) : 0;
      lim[r] = n;
      jmax = max(jmax, n);
    }
    if (jmax > 0)
      attend_chunk<kRows, float>(st, qs + warp * kRows * D, D, ks, vs, D, D,
                                 lim, jmax, lane);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = r0 + r;
    if (row >= S) break;
#pragma unroll
    for (int i = 0; i < kMaxNI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) ob[row * ost.s + d] = from_f32<T>(st.out(r, i));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int D, int causal, Strides qst,
           Strides kst, Strides vst, Strides ost, cudaStream_t stream) {
  static int smem_allowed = 48 * 1024;
  const int smem = (int)sizeof(float) *
                   (kTileQ * D + kTileK * (D + 1) + kTileK * D);
  cudaError_t e = allow_smem(flash_attention_kernel<T>, smem, &smem_allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kTileQ - 1) / kTileQ, Hq, B);
  flash_attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, D, Hq / Hkv, causal,
      (float)(1.0 / sqrt((double)D)), qst, kst, vst, ost);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Hq, S, D), k/v: (B, Hkv, S, D), o: (B, Hq, S, D), each given by its
// data pointer and its (batch, head, position) element strides; the last
// dimension is contiguous. dtype: 0 = float32, 1 = bfloat16. Launches on
// `stream`, allocates nothing, and returns cudaGetLastError().
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int S, int D, int causal, int dtype, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || D > kMaxHeadDim || Hkv <= 0 ||
      Hq % Hkv != 0 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qst{q_sb, q_sh, q_ss}, kst{k_sb, k_sh, k_ss},
      vst{v_sb, v_sh, v_ss}, ost{o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, Hq, Hkv, S, D, causal, qst, kst, vst,
                         ost, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, D, causal, qst,
                                 kst, vst, ost, s);
  return (int)cudaErrorInvalidValue;
}
