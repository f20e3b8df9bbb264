// The backward pass of grouped-query flash attention, for Hopper (sm_90a).
//
// The TPU kernel `flash_attention` of src/repro/kernels/flash_attention.py
// has no backward: the reference trains through `_xla_attention` on the
// CPU, and `jax.grad` cannot differentiate the Pallas kernel. Its gradient
// is the gradient of the same function,
//
//   P = softmax(scale * Q K^T) (masked causally or not), O = P V,
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),  D_i = sum_d dO_i O_i,
//   dQ = scale * dS K,  dK = scale * dS^T Q,
//
// summed over the G = Hq / Hkv query heads that share a kv head for dK and
// dV. The forward (flash_attention.cu) saves each row's log-sum-exp, so P is
// recomputed tile by tile as exp(scale * q.k - lse) and never stored.
//
// What bounds it: the work is 2.5 times the forward's, 10 * B * Hq * S^2 * D
// operations (halved when causal), against q, k, v, o, dO, dq, dk, dv and
// the f32 lse and D moved once; at the training heads (Hq 16, Hkv 8, D 128,
// S 128) S / 3 operations a byte, so on the tensor cores it would be bound
// by bytes. Here the math runs on the CUDA cores in f32 for both input
// types (the FlashAttention-2 algorithm without its tensor-core schedule),
// so it is bound by operations, read from shared memory. The tensor-core
// version (`wgmma`, TMA) is later work.
//
// Two kernels, both deterministic (no atomics, every sum in a fixed order):
//
// `flash_bwd_dq_kernel<T>`: one block of 256 threads per (32-row q tile, q
//   head, batch row). Its prologue computes D for its rows from dO and O in
//   f32 (in dP's order of summation) and writes it to `dsum` for the second
//   kernel; then it walks the key
//   tiles of 32 up to the diagonal (all of them when not causal), recomputes
//   P and dS for the 32 x 32 pairs and accumulates dQ = dS K in registers.
// `flash_bwd_dkdv_kernel<T>`: one block per (32-key tile, kv head, batch
//   row). It holds its K and V tile and walks the G query heads of its
//   group and their q tiles from the key tile's diagonal on (all of them
//   when not causal), recomputes P and dS, and accumulates dV = P^T dO and
//   dK = dS^T Q in registers: the group's sum happens inside the block, so
//   neither a second reduction nor an atomic is needed. It runs after the
//   first kernel, on the same stream, and reads its D.
//
// Layout: tiles are staged as f32 in shared memory with rows padded to
// D + 1 (conflict-free column reads). For the 32 x 32 pairs of a step, warp
// w takes rows w + 8 m (m < 4) and lane j key j. For the accumulators,
// thread t owns one row of the output tile (t / 8) and the head-dim slots
// d = t % 8 + 8 i. Rows past S are never loaded: they stage as zeros and are
// masked out of P, so neither padding nor NaN there reaches a gradient. A
// row with lse = +inf (it met no key) gets P = 0 and dS = 0.

#include "attention_tile.cuh"
#include "cp_async.cuh"

namespace {

using namespace repro_attn;
using repro_async::allow_smem;

constexpr int kThreads = 256;
constexpr int kWarpsB = kThreads / 32;        // 8
constexpr int kTile = 32;                     // q rows and keys of a tile
constexpr int kPairRows = kTile / kWarpsB;    // 4 rows a warp in a step
constexpr int kSlots = kMaxHeadDim / 8;       // head-dim slots a thread owns

struct Strides {
  long long b, h, s;  // element strides of (batch, head, position); d is 1
};

// Rows [r0, r0 + kTile) of one head into a kTile x (D + 1) f32 tile; rows
// past S are zeros, never read.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int r0, int S, int D, int tid) {
  for (int e = tid; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e - (e / D) * D;
    dst[r * (D + 1) + d] = r0 + r < S ? to_f32(src[(r0 + r) * ss + d]) : 0.f;
  }
}

// P and dS of the kTile x kTile pairs (q rows q0 + r, keys k0 + j) into
// shared memory (row stride kTile + 1). qs, dos: the q tile and its dO;
// ks, vs: the key tile's K and V; lse_s, dd: the q rows' lse and D.
__device__ __forceinline__ void pairs(float* ps, float* dss, const float* qs,
                                      const float* dos, const float* ks,
                                      const float* vs, const float* lse_s,
                                      const float* dd, int q0, int k0, int S,
                                      int D, int causal, float scale,
                                      int warp, int lane) {
  float s[kPairRows], dp[kPairRows];
#pragma unroll
  for (int m = 0; m < kPairRows; ++m) s[m] = dp[m] = 0.f;
  const float* kr = ks + lane * (D + 1);
  const float* vr = vs + lane * (D + 1);
  for (int d = 0; d < D; ++d) {
    const float kd = kr[d], vd = vr[d];
#pragma unroll
    for (int m = 0; m < kPairRows; ++m) {
      const int r = warp + kWarpsB * m;
      s[m] = fmaf(qs[r * (D + 1) + d], kd, s[m]);
      dp[m] = fmaf(dos[r * (D + 1) + d], vd, dp[m]);
    }
  }
  const int key = k0 + lane;
#pragma unroll
  for (int m = 0; m < kPairRows; ++m) {
    const int r = warp + kWarpsB * m, row = q0 + r;
    const bool valid = row < S && key < S && (!causal || key <= row);
    // exp(-inf) = 0 where the row met no key (lse = +inf)
    const float p = valid ? expf(s[m] * scale - lse_s[r]) : 0.f;
    ps[r * (kTile + 1) + lane] = p;
    dss[r * (kTile + 1) + lane] = valid ? p * (dp[m] - dd[r]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dsum,
                    T* __restrict__ dq, int S, int D, int group, int causal,
                    float scale, Strides qst, Strides kst, Strides vst,
                    Strides ost, Strides dost, Strides dqst) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;                        // kTile x ld each
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;            // holds O in the prologue
  float* vs = ks + kTile * ld;
  float* ps = vs + kTile * ld;             // kTile x (kTile + 1) each
  float* dss = ps + kTile * (kTile + 1);
  float* lse_s = dss + kTile * (kTile + 1);
  float* dd = lse_s + kTile;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hk = h / group;
  const long long row_base = ((long long)b * gridDim.y + h) * S;

  stage<T>(qs, q + b * qst.b + h * qst.h, qst.s, q0, S, D, tid);
  stage<T>(dos, dout + b * dost.b + h * dost.h, dost.s, q0, S, D, tid);
  stage<T>(ks, o + b * ost.b + h * ost.h, ost.s, q0, S, D, tid);
  __syncthreads();
  // D = rowsum(dO o O), one thread a row, summed in the order of dP in
  // `pairs`: where O is a row of V (one visible key), dP - D is then exactly
  // 0, as the softmax's gradient is. Written once for the dK/dV kernel.
  if (tid < kTile) {
    const int row = q0 + tid;
    float x = 0.f;
    for (int d = 0; d < D; ++d)
      x = fmaf(dos[tid * ld + d], ks[tid * ld + d], x);
    dd[tid] = x;
    lse_s[tid] = row < S ? lse[row_base + row] : 0.f;
    if (row < S) dsum[row_base + row] = x;
  }

  const int orow = tid / 8, c0 = tid % 8;
  float acc[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) acc[i] = 0.f;
  const T* kb = k + b * kst.b + hk * kst.h;
  const T* vb = v + b * vst.b + hk * vst.h;
  const int k_end = causal ? min(q0 + kTile, S) : S;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the last tile is consumed (and O, D, lse are read)
    stage<T>(ks, kb, kst.s, k0, S, D, tid);
    stage<T>(vs, vb, vst.s, k0, S, D, tid);
    __syncthreads();
    pairs(ps, dss, qs, dos, ks, vs, lse_s, dd, q0, k0, S, D, causal, scale,
          warp, lane);
    __syncthreads();
    // dQ[orow] += sum_j dS[orow][j] K[j]
    for (int j = 0; j < kTile; ++j) {
      const float g = dss[orow * (kTile + 1) + j];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int d = c0 + 8 * i;
        if (d < D) acc[i] = fmaf(g, ks[j * ld + d], acc[i]);
      }
    }
  }
  const int row = q0 + orow;
  if (row < S) {
    T* out = dq + b * dqst.b + h * dqst.h + row * dqst.s;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int d = c0 + 8 * i;
      if (d < D) out[d] = from_f32<T>(acc[i] * scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int D, int Hq, int causal,
                      float scale, Strides qst, Strides kst, Strides vst,
                      Strides dost, Strides dkst, Strides dvst) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;
  float* vs = ks + kTile * ld;
  float* ps = vs + kTile * ld;
  float* dss = ps + kTile * (kTile + 1);
  float* lse_s = dss + kTile * (kTile + 1);
  float* dd = lse_s + kTile;

  const int k0 = blockIdx.x * kTile;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  stage<T>(ks, k + b * kst.b + hk * kst.h, kst.s, k0, S, D, tid);
  stage<T>(vs, v + b * vst.b + hk * vst.h, vst.s, k0, S, D, tid);

  const int krow = tid / 8, c0 = tid % 8;
  float adk[kSlots], adv[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) adk[i] = adv[i] = 0.f;
  // the q tiles that see this key tile: from its diagonal on when causal
  const int q_start = causal ? k0 : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long row_base = ((long long)b * Hq + h) * S;
    const T* qb = q + b * qst.b + h * qst.h;
    const T* dob = dout + b * dost.b + h * dost.h;
    for (int q0 = q_start; q0 < S; q0 += kTile) {
      __syncthreads();  // the last q tile is consumed
      stage<T>(qs, qb, qst.s, q0, S, D, tid);
      stage<T>(dos, dob, dost.s, q0, S, D, tid);
      if (tid < kTile) {
        const int row = q0 + tid;
        lse_s[tid] = row < S ? lse[row_base + row] : 0.f;
        dd[tid] = row < S ? dsum[row_base + row] : 0.f;
      }
      __syncthreads();
      pairs(ps, dss, qs, dos, ks, vs, lse_s, dd, q0, k0, S, D, causal, scale,
            warp, lane);
      __syncthreads();
      // dV[krow] += sum_r P[r][krow] dO[r]; dK[krow] += sum_r dS[r][krow] Q[r]
      for (int r = 0; r < kTile; ++r) {
        const float p = ps[r * (kTile + 1) + krow];
        const float g2 = dss[r * (kTile + 1) + krow];
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          const int d = c0 + 8 * i;
          if (d < D) {
            adv[i] = fmaf(p, dos[r * ld + d], adv[i]);
            adk[i] = fmaf(g2, qs[r * ld + d], adk[i]);
          }
        }
      }
    }
  }
  const int key = k0 + krow;
  if (key < S) {
    T* ok = dk + b * dkst.b + hk * dkst.h + key * dkst.s;
    T* ov = dv + b * dvst.b + hk * dvst.h + key * dvst.s;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int d = c0 + 8 * i;
      if (d < D) {
        ok[d] = from_f32<T>(adk[i] * scale);
        ov[d] = from_f32<T>(adv[i]);
      }
    }
  }
}

int smem_bytes(int D) {
  return (int)sizeof(float) *
         (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) + 2 * kTile);
}

bool bad_shape(int B, int Hq, int Hkv, int S, int D, int dtype) {
  return B <= 0 || B > 65535 || S <= 0 || D <= 0 || D > kMaxHeadDim ||
         Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || (dtype != 0 && dtype != 1);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* dsum, void* dq, int B,
              int Hq, int Hkv, int S, int D, int causal, Strides qst,
              Strides kst, Strides vst, Strides ost, Strides dost,
              Strides dqst, cudaStream_t stream) {
  static int smem_allowed = 48 * 1024;
  const int smem = smem_bytes(D);
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T>, smem, &smem_allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kTile - 1) / kTile, Hq, B);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dsum), static_cast<T*>(dq), S, D, Hq / Hkv, causal,
      (float)(1.0 / sqrt((double)D)), qst, kst, vst, ost, dost, dqst);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* dsum, void* dk, void* dv, int B,
                int Hq, int Hkv, int S, int D, int causal, Strides qst,
                Strides kst, Strides vst, Strides dost, Strides dkst,
                Strides dvst, cudaStream_t stream) {
  static int smem_allowed = 48 * 1024;
  const int smem = smem_bytes(D);
  cudaError_t e = allow_smem(flash_bwd_dkdv_kernel<T>, smem, &smem_allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kTile - 1) / kTile, Hkv, B);
  flash_bwd_dkdv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dk), static_cast<T*>(dv), S, D, Hq, causal,
      (float)(1.0 / sqrt((double)D)), qst, kst, vst, dost, dkst, dvst);
  return (int)cudaGetLastError();
}

}  // namespace

// The first backward kernel: dq, and D for the second. q, o, dout, dq: (B,
// Hq, S, D); k, v: (B, Hkv, S, D); each by its data pointer and its (batch,
// head, position) element strides, the last dimension contiguous. lse (the
// forward's) and dsum: contiguous f32 (B, Hq, S); dsum is written. dtype: 0
// = float32, 1 = bfloat16 (math in f32 either way). Launches on `stream`,
// allocates nothing, and returns cudaGetLastError().
extern "C" int repro_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, int B, int Hq,
    int Hkv, int S, int D, int causal, int dtype, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, long long do_sb,
    long long do_sh, long long do_ss, long long dq_sb, long long dq_sh,
    long long dq_ss, void* stream) {
  if (bad_shape(B, Hq, Hkv, S, D, dtype)) return (int)cudaErrorInvalidValue;
  const Strides qst{q_sb, q_sh, q_ss}, kst{k_sb, k_sh, k_ss},
      vst{v_sb, v_sh, v_ss}, ost{o_sb, o_sh, o_ss}, dost{do_sb, do_sh, do_ss},
      dqst{dq_sb, dq_sh, dq_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dq<float>(q, k, v, o, dout, lse, dsum, dq, B, Hq, Hkv, S,
                            D, causal, qst, kst, vst, ost, dost, dqst, s);
  return launch_dq<__nv_bfloat16>(q, k, v, o, dout, lse, dsum, dq, B, Hq,
                                  Hkv, S, D, causal, qst, kst, vst, ost, dost,
                                  dqst, s);
}

// The second backward kernel: dk and dv, (B, Hkv, S, D), from the first's
// dsum; arguments as above. Must run after it on the same stream.
extern "C" int repro_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dk, void* dv, int B, int Hq,
    int Hkv, int S, int D, int causal, int dtype, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dk_sb,
    long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
    long long dv_ss, void* stream) {
  if (bad_shape(B, Hq, Hkv, S, D, dtype)) return (int)cudaErrorInvalidValue;
  const Strides qst{q_sb, q_sh, q_ss}, kst{k_sb, k_sh, k_ss},
      vst{v_sb, v_sh, v_ss}, dost{do_sb, do_sh, do_ss},
      dkst{dk_sb, dk_sh, dk_ss}, dvst{dv_sb, dv_sh, dv_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dkdv<float>(q, k, v, dout, lse, dsum, dk, dv, B, Hq, Hkv,
                              S, D, causal, qst, kst, vst, dost, dkst, dvst,
                              s);
  return launch_dkdv<__nv_bfloat16>(q, k, v, dout, lse, dsum, dk, dv, B, Hq,
                                    Hkv, S, D, causal, qst, kst, vst, dost,
                                    dkst, dvst, s);
}
