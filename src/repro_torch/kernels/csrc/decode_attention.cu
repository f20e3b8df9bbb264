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
// bf16 (2 for qwen3-1.7b), so device memory at 3.35 TB/s is the only limit,
// and the design's one goal is to keep enough bytes in flight to stream the
// cache.
//
// What the design does about it:
//   * the grid is (splits, Hkv, B): a block takes a span of positions of
//     one (b, kv head) and all G query heads of the group, so every K/V
//     byte is read once. The host picks the span from Smax (it cannot read
//     kv_len without a sync), a multiple of 128 positions, so that the grid
//     holds about 2-4 blocks per SM where Smax allows (kernels/
//     decode_attention.py: decode_split); a block whose span starts at or
//     past n_b writes an empty state and leaves;
//   * in a span, warp w takes positions w * 32 .. w * 32 + 31 of every 128,
//     and each lane issues its share of the 32 K rows and then of the 32 V
//     rows as 16-byte `cp.async` copies (8 bf16 or 4 f32 along d,
//     neighbouring lanes on neighbouring addresses), 2 * D / 8 of them in
//     flight per lane for bf16 (32 at D = 128). Rows at or past n_b are
//     zero-filled without a read. K rows are padded by one 16-byte chunk so
//     that lane j's reads of key j fall in distinct banks;
//   * as soon as K has landed, lane j scores key j against the group's
//     queries (f32 in shared memory, read as broadcasts), scaled after the
//     dot, and the warp runs its online softmax (m, l) while V lands; then
//     P.V reads V from shared memory, each lane owning 4 columns of d;
//   * the block merges its 4 warps' states in warp order and writes its
//     partial state (m, l, acc) to f32 scratch; an int32 ticket per
//     (b, kv head) counts the finished blocks (atomicAdd after
//     __threadfence), and the last block to arrive merges all the spans in
//     split order, not arrival order, so the result is deterministic, and
//     resets the ticket to 0 for the next call. One launch per call: a
//     second merge kernel would add a host launch per layer to a decode
//     path that is bound by its host's launches.
// K and V are read through element strides, so one layer's slice of the
// engine's (B, Smax, Hkv, D) cache is read in place: no transpose, no copy.

#include "attention_tile.cuh"
#include "cp_async.cuh"

namespace {

using namespace repro_attn;
using namespace repro_async;

constexpr int kWarps = 4;
constexpr int kPos = 32;              // positions per warp step, a lane each
constexpr int kStep = kWarps * kPos;  // per block step: a span's multiple

struct Strides {
  long long b, h, s;  // element strides of (batch, head, position); d is 1
};

// 16 bytes of T at p (16-byte aligned) as f32, and 4 elements at p.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kChunk = 4;
  __device__ static void chunk(const float* p, float (&x)[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  }
  __device__ static void quad(const float* p, float (&x)[4]) { chunk(p, x); }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kChunk = 8;
  __device__ static void chunk(const __nv_bfloat16* p, float (&x)[8]) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x, x[2 * i + 1] = f.y;
    }
  }
  __device__ static void quad(const __nv_bfloat16* p, float (&x)[4]) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    const float2 f0 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&a.x));
    const float2 f1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&a.y));
    x[0] = f0.x, x[1] = f0.y, x[2] = f1.x, x[3] = f1.y;
  }
};

// Block (split, kv head, b) over positions [split * span, split * span +
// span) of row b, for the G query heads of the kv head, R of them per
// pass. part holds, per (b, q head, split), D accumulator values, then m
// and l (f32); tickets one int32 per (b, kv head), 0 between calls.
template <typename T, int R>
__global__ void __launch_bounds__(kWarps * 32)
gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ kv_len,
                  T* __restrict__ o, float* __restrict__ part,
                  int* __restrict__ tickets, int G, int Smax, int D, int span,
                  float scale, Strides qst, Strides kst, Strides vst,
                  Strides ost) {
  constexpr int E = Vec<T>::kChunk;     // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int splits = gridDim.x;
  const int Hq = gridDim.y * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n = min(max(kv_len[b], 0), Smax);
  const int s_begin = split * span;
  const int s_end = min(s_begin + span, n);
  const int ldp = D + 2;  // a partial state: acc[D], m, l
  // head g's partial state of this split at pb + g * splits * ldp
  float* pb = part + ((long long)(b * Hq + hk * G) * splits + split) * ldp;

  if (s_begin < s_end) {
    const int cpr = D / E;        // 16-byte chunks in a row
    const int ldk = D + E;        // K rows padded by one chunk
    float* qs = reinterpret_cast<float*>(smem);               // R x D
    unsigned char* stage = smem + R * D * sizeof(float);
    T* kw = reinterpret_cast<T*>(stage) + warp * kPos * (ldk + D);
    T* vw = kw + kPos * ldk;                                   // kPos x D
    const T* kb = k + b * kst.b + hk * kst.h;
    const T* vb = v + b * vst.b + hk * vst.h;

    // one pass per R query heads: a single pass when G <= R
    for (int g0 = 0; g0 < G; g0 += R) {
      const int nr = min(R, G - g0);
      __syncthreads();  // the previous pass's merge is read
      for (int e = tid; e < R * D; e += kWarps * 32) {
        const int r = e / D, d = e - (e / D) * D;
        qs[e] = r < nr
                    ? to_f32(q[b * qst.b + (hk * G + g0 + r) * qst.h + d])
                    : 0.f;
      }
      __syncthreads();

      float m[R], l[R], acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
      }
      for (int s0 = s_begin + warp * kPos; s0 < s_end; s0 += kStep) {
        const int nv = min(kPos, s_end - s0);
        for (int e = lane; e < kPos * cpr; e += 32) {
          const int j = e / cpr, c = e - j * cpr;
          const bool ok = j < nv;
          cp_async_16(smem_addr(kw + j * ldk + c * E),
                      ok ? kb + (s0 + j) * kst.s + c * E : kb, ok ? 16 : 0);
        }
        cp_async_commit();
        for (int e = lane; e < kPos * cpr; e += 32) {
          const int j = e / cpr, c = e - j * cpr;
          const bool ok = j < nv;
          cp_async_16(smem_addr(vw + j * D + c * E),
                      ok ? vb + (s0 + j) * vst.s + c * E : vb, ok ? 16 : 0);
        }
        cp_async_commit();
        cp_async_wait<1>();  // the keys
        __syncwarp();

        // lane j scores key s0 + j against the R queries
        float sc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) sc[r] = 0.f;
        const T* kr = kw + lane * ldk;
        for (int c = 0; c < cpr; ++c) {
          float kx[E];
          Vec<T>::chunk(kr + c * E, kx);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float* qr = qs + r * D + c * E;
#pragma unroll
            for (int x = 0; x < E; x += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + x);
              sc[r] = fmaf(qv.x, kx[x], sc[r]);
              sc[r] = fmaf(qv.y, kx[x + 1], sc[r]);
              sc[r] = fmaf(qv.z, kx[x + 2], sc[r]);
              sc[r] = fmaf(qv.w, kx[x + 3], sc[r]);
            }
          }
        }
        const bool valid = lane < nv;
        float p[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float sv = sc[r] * scale;
          const float m_new =
              fmaxf(m[r], warp_max(valid ? sv : -INFINITY));
          const float alpha = m_new == -INFINITY ? 1.f : expf(m[r] - m_new);
          p[r] = valid ? expf(sv - m_new) : 0.f;
          l[r] = l[r] * alpha + warp_sum(p[r]);
          m[r] = m_new;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][i] *= alpha;
        }

        cp_async_wait<0>();  // the values
        __syncwarp();
        const bool owns = 4 * lane < D;
        for (int j = 0; j < nv; ++j) {
          float vx[4] = {0.f, 0.f, 0.f, 0.f};
          if (owns) Vec<T>::quad(vw + j * D + 4 * lane, vx);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(pj, vx[i], acc[r][i]);
          }
        }
        __syncwarp();  // the chunk is read before the next one lands
      }

      // merge the warps' states in warp order (the staging space is free
      // once every warp is done) and write the block's partial state
      __syncthreads();
      float* ms = reinterpret_cast<float*>(stage);   // kWarps x R
      float* ls = ms + kWarps * R;                    // kWarps x R
      float* as = ls + kWarps * R;                    // kWarps x R x D
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (lane == 0) {
          ms[warp * R + r] = m[r];
          ls[warp * R + r] = l[r];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = 4 * lane + i;
          if (d < D) as[(warp * R + r) * D + d] = acc[r][i];
        }
      }
      __syncthreads();
      for (int e = tid; e < nr * D; e += kWarps * 32) {
        const int r = e / D, d = e - (e / D) * D;
        float mm = -INFINITY;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, ms[w * R + r]);
        float ll = 0.f, aa = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float mw = ms[w * R + r];
          if (mw != -INFINITY) {
            const float c = expf(mw - mm);
            ll += ls[w * R + r] * c;
            aa += as[(w * R + r) * D + d] * c;
          }
        }
        float* dst = pb + (long long)(g0 + r) * splits * ldp;
        dst[d] = aa;
        if (d == 0) {
          dst[D] = mm;
          dst[D + 1] = ll;
        }
      }
    }
  } else {
    // an empty span: an empty state (m = -inf, l = 0) for every head
    for (int g = tid; g < G; g += kWarps * 32) {
      float* dst = pb + (long long)g * splits * ldp;
      dst[D] = -INFINITY;
      dst[D + 1] = 0.f;
    }
  }

  // the last block of this (b, kv head) to finish merges the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = tickets + b * gridDim.y + hk;
    is_last = atomicAdd(ticket, 1) == splits - 1;
    if (is_last) *ticket = 0;  // every block has arrived: reset for the next
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int e = tid; e < G * D; e += kWarps * 32) {
    const int g = e / D, d = e - (e / D) * D;
    const float* src = part + (long long)(b * Hq + hk * G + g) * splits * ldp;
    float mm = -INFINITY;
    for (int s = 0; s < splits; ++s) mm = fmaxf(mm, __ldcg(src + s * ldp + D));
    float ll = 0.f, aa = 0.f;
    for (int s = 0; s < splits; ++s) {  // in split order
      const float ms = __ldcg(src + s * ldp + D);
      if (ms != -INFINITY) {
        const float c = expf(ms - mm);
        ll += __ldcg(src + s * ldp + D + 1) * c;
        aa += __ldcg(src + s * ldp + d) * c;
      }
    }
    // acc / max(l, 1e-30): zeros for a row with kv_len <= 0
    o[b * ost.b + (hk * G + g) * ost.h + d] =
        from_f32<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int R>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* o, float* part, int* tickets, int B, int Hkv, int G,
           int Smax, int D, int span, int splits, Strides qst, Strides kst,
           Strides vst, Strides ost, cudaStream_t stream) {
  static int smem_allowed = 48 * 1024;
  const int smem = (int)(R * D * sizeof(float) +
                         kWarps * kPos * (2 * D + Vec<T>::kChunk) * sizeof(T));
  cudaError_t e = allow_smem(gqa_decode_kernel<T, R>, smem, &smem_allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(splits, Hkv, B);
  gqa_decode_kernel<T, R><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(o), part, tickets, G,
      Smax, D, span, (float)(1.0 / sqrt((double)D)), qst, kst, vst, ost);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const void* q, const void* k, const void* v,
                const int* kv_len, void* o, float* part, int* tickets, int B,
                int Hkv, int G, int Smax, int D, int span, int splits,
                Strides qst, Strides kst, Strides vst, Strides ost,
                cudaStream_t s) {
  // the smallest register block of query heads that holds the group
  if (G <= 1)
    return launch<T, 1>(q, k, v, kv_len, o, part, tickets, B, Hkv, G, Smax,
                        D, span, splits, qst, kst, vst, ost, s);
  if (G <= 2)
    return launch<T, 2>(q, k, v, kv_len, o, part, tickets, B, Hkv, G, Smax,
                        D, span, splits, qst, kst, vst, ost, s);
  if (G <= 4)
    return launch<T, 4>(q, k, v, kv_len, o, part, tickets, B, Hkv, G, Smax,
                        D, span, splits, qst, kst, vst, ost, s);
  return launch<T, 8>(q, k, v, kv_len, o, part, tickets, B, Hkv, G, Smax, D,
                      span, splits, qst, kst, vst, ost, s);
}

}  // namespace

// q: (B, Hq, D) with (batch, head) strides; k/v: (B, Hkv, Smax, D) with
// (batch, head, position) strides; kv_len: (B,) int32; o: (B, Hq, D) with
// (batch, head) strides. The last dimension of each is contiguous; D % 8
// == 0, and k, v and their strides are 16-byte aligned (the wrapper checks
// them). dtype: 0 = float32, 1 = bfloat16. The positions are split in
// `splits` spans of `span` (a multiple of 128; splits = ceil(Smax / span)).
// part: B * Hq * splits * (D + 2) f32 of scratch; tickets: B * Hkv int32,
// zero, and left zero. Launches on `stream`, allocates nothing, and returns
// cudaGetLastError().
extern "C" int repro_gqa_decode(const void* q, const void* k, const void* v,
                                const void* kv_len, void* o, void* part,
                                void* tickets, int B, int Hq, int Hkv,
                                int Smax, int D, int dtype, int span,
                                int splits, long long q_sb, long long q_sh,
                                long long k_sb, long long k_sh,
                                long long k_ss, long long v_sb,
                                long long v_sh, long long v_ss,
                                long long o_sb, long long o_sh,
                                void* stream) {
  if (B <= 0 || B > 65535 || Smax <= 0 || D <= 0 || D > kMaxHeadDim ||
      D % 8 != 0 || Hkv <= 0 || Hkv > 65535 || Hq % Hkv != 0 || span <= 0 ||
      span % kStep != 0 || splits != (Smax + span - 1) / span)
    return (int)cudaErrorInvalidValue;
  const Strides qst{q_sb, q_sh, 0}, kst{k_sb, k_sh, k_ss},
      vst{v_sb, v_sh, v_ss}, ost{o_sb, o_sh, 0};
  const int* len = static_cast<const int*>(kv_len);
  float* pt = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t s = (cudaStream_t)stream;
  const int G = Hq / Hkv;
  if (dtype == 0)
    return launch_rows<float>(q, k, v, len, o, pt, tk, B, Hkv, G, Smax, D,
                              span, splits, qst, kst, vst, ost, s);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(q, k, v, len, o, pt, tk, B, Hkv, G,
                                      Smax, D, span, splits, qst, kst, vst,
                                      ost, s);
  return (int)cudaErrorInvalidValue;
}
