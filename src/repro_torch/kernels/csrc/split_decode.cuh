// The split decode kernel: grouped-query attention of one new token per row
// against its keys and values, with the positions of each (row, kv head)
// split over several blocks, for Hopper (sm_90a). One kernel body, two
// ways to find a position's K and V rows:
//
//   * ContiguousRows: a (B, Hkv, Smax, D) cache read through element
//     strides (decode_attention.cu);
//   * PagedRows: (n_blocks, Hkv, bs, D) pools addressed by a block table,
//     position p of row b in block max(block_table[b, p / bs], 0) at offset
//     p % bs (paged_attention.cu).
//
// Both compute, for n_b = min(kv_len[b], cap) (cap = Smax, or max_blocks *
// bs),
//
//   out[b, h] = softmax_{p < n_b}(q[b, h] . k_p * D^-0.5) . v_p
//
// with f32 math and the output in the input's type (f32 or bf16); a row with
// kv_len <= 0 gives zeros. Positions at or past n_b are never read, nor are
// the table entries that name them, so whatever lies there (stale rows, pad
// entries, NaN) cannot reach the output. The arithmetic does not depend on
// the policy: on the same rows, with the same (span, splits), the two give
// the same bits.
//
// What bounds it: the bytes of K and V read, 2 * n_b * D elements per
// (b, kv head), against ~4 * G * n_b * D operations: G operations a byte in
// bf16 (2 for qwen3-1.7b), so device memory at 3.35 TB/s is the only limit,
// and the design's one goal is to keep enough bytes in flight.
//
// What the design does about it:
//   * the grid is (splits, Hkv, B): a block takes a span of positions of
//     one (b, kv head) and all G query heads of the group, so every K/V
//     byte is read once. The host picks the span from the shapes (it cannot
//     read kv_len without a sync), a multiple of 128 positions, so that the
//     grid holds about 2-4 blocks per SM where the shapes allow (kernels/
//     decode_attention.py: decode_split); a block whose span starts at or
//     past n_b writes an empty state and leaves;
//   * a paged block first reads the table entries of its span into shared
//     memory, clamped at 0, once; then each lane resolves the K and V row
//     addresses of its own position of a 32-position chunk, and the copies
//     take them from it by a warp shuffle;
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
//
// The partial mode (Partial = true, ContiguousRows only) is the same
// kernel over one block of a cache whose positions are split over ranks:
// the merging block writes the normalized result in f32, the very value
// the default mode rounds to the input's type, and lse = m + log(l) per
// (b, q head) (-inf for a row with kv_len <= 0, whose result is zeros), so
// that the blocks' results merge by their lse (models/tensor_parallel.py:
// merge_partials) and one block's result rounds to the default mode's bits.
#pragma once

#include "attention_tile.cuh"
#include "cp_async.cuh"

namespace repro_split {

using namespace repro_attn;
using namespace repro_async;

constexpr int kWarps = 4;
constexpr int kPos = 32;              // positions per warp step, a lane each
constexpr int kStep = kWarps * kPos;  // per block step: a span's multiple

struct Strides {
  // element strides of (batch or block, head, position); d is 1
  long long b, h, s;
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

// A (B, Hkv, Smax, D) cache: position p of row b at k + b * kst.b +
// hk * kst.h + p * kst.s.
template <typename T>
struct ContiguousRows {
  const T* k;
  const T* v;
  Strides kst, vst;

  static int table_ints(int /*span*/) { return 0; }
  struct Span {
    const T* kb;
    const T* vb;
  };
  __device__ Span span(int b, int hk, int, int, int*, int) const {
    return {k + b * kst.b + hk * kst.h, v + b * vst.b + hk * vst.h};
  }
  struct Lane {};
  __device__ Lane lane_row(const Span&, int, bool) const { return {}; }
  __device__ const T* k_row(const Span& s, const Lane&, int p, int) const {
    return s.kb + p * kst.s;
  }
  __device__ const T* v_row(const Span& s, const Lane&, int p, int) const {
    return s.vb + p * vst.s;
  }
};

// (n_blocks, Hkv, bs, D) pools: position p of row b at pool +
// max(bt[b * bt_sb + p / bs], 0) * st.b + hk * st.h + (p % bs) * st.s.
template <typename T>
struct PagedRows {
  const T* k;
  const T* v;
  Strides kst, vst;  // (block, head, position in the block)
  const int* bt;
  long long bt_sb;
  int bs;

  // the entries of a span [s_begin, s_end): at most span / bs + 2
  int table_ints(int span) const { return span / bs + 2; }
  struct Span {
    const T* kb;
    const T* vb;
    const int* tbl;  // shared memory: entries first, first + 1, ...
    int first;
  };
  // Read the span's entries, clamped at 0, into tbl (every thread calls
  // this; the caller's next __syncthreads publishes them).
  __device__ Span span(int b, int hk, int s_begin, int s_end, int* tbl,
                       int tid) const {
    const int first = s_begin / bs;
    if (s_begin < s_end) {
      const int cnt = (s_end - 1) / bs - first + 1;
      for (int e = tid; e < cnt; e += kWarps * 32)
        tbl[e] = max(bt[b * bt_sb + first + e], 0);
    }
    return {k + hk * kst.h, v + hk * vst.h, tbl, first};
  }
  // the element offsets of position p's K and V rows (p valid), in the
  // lane that owns p in its chunk
  struct Lane {
    long long k, v;
  };
  __device__ Lane lane_row(const Span& s, int p, bool valid) const {
    if (!valid) return {0, 0};
    const int i = p / bs;
    const long long blk = s.tbl[i - s.first];
    const int off = p - i * bs;
    return {blk * kst.b + off * kst.s, blk * vst.b + off * vst.s};
  }
  // row j of the chunk, from lane j (every lane of the warp calls these)
  __device__ const T* k_row(const Span& s, const Lane& l, int, int j) const {
    return s.kb + __shfl_sync(0xffffffffu, l.k, j);
  }
  __device__ const T* v_row(const Span& s, const Lane& l, int, int j) const {
    return s.vb + __shfl_sync(0xffffffffu, l.v, j);
  }
};

// Block (split, kv head, b) over positions [split * span, split * span +
// span) of row b, for the G query heads of the kv head, R of them per
// pass. part holds, per (b, q head, split), D accumulator values, then m
// and l (f32); tickets one int32 per (b, kv head), 0 between calls. With
// Partial, o is f32 and lse (B, Hq) f32 gets each head's log-sum-exp.
template <typename T, int R, typename Rows, bool Partial>
__global__ void __launch_bounds__(kWarps * 32)
split_decode_kernel(const T* __restrict__ q, const int* __restrict__ kv_len,
                    T* __restrict__ o, float* __restrict__ lse,
                    float* __restrict__ part, int* __restrict__ tickets,
                    int G, int cap, int D, int span, float scale,
                    Strides qst, Strides ost, Rows rows) {
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
  const int n = min(max(kv_len[b], 0), cap);
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
    int* tbl = reinterpret_cast<int*>(stage + kWarps * kPos * (ldk + D) *
                                                  sizeof(T));
    const typename Rows::Span sp = rows.span(b, hk, s_begin, s_end, tbl, tid);

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
        const typename Rows::Lane own = rows.lane_row(sp, s0 + lane,
                                                      lane < nv);
        // kPos * cpr is a multiple of 32: every lane runs every step
        for (int e = lane; e < kPos * cpr; e += 32) {
          const int j = e / cpr, c = e - j * cpr;
          const bool ok = j < nv;
          const T* src = rows.k_row(sp, own, s0 + j, j);
          cp_async_16(smem_addr(kw + j * ldk + c * E),
                      ok ? src + c * E : sp.kb, ok ? 16 : 0);
        }
        cp_async_commit();
        for (int e = lane; e < kPos * cpr; e += 32) {
          const int j = e / cpr, c = e - j * cpr;
          const bool ok = j < nv;
          const T* src = rows.v_row(sp, own, s0 + j, j);
          cp_async_16(smem_addr(vw + j * D + c * E),
                      ok ? src + c * E : sp.vb, ok ? 16 : 0);
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
    const float out = aa / fmaxf(ll, 1e-30f);
    if constexpr (Partial) {
      reinterpret_cast<float*>(o)[b * ost.b + (hk * G + g) * ost.h + d] = out;
      if (d == 0) lse[b * Hq + hk * G + g] = mm + logf(ll);
    } else {
      o[b * ost.b + (hk * G + g) * ost.h + d] = from_f32<T>(out);
    }
  }
}

// The launch shared by both policies: the grid (splits, Hkv, B), the
// smallest register block R of query heads that holds the group, and
// dynamic shared memory for the queries, the staged K/V rows and the
// policy's table.
struct Launch {
  const void* q;
  const int* kv_len;
  void* o;
  float* part;
  int* tickets;
  int B, Hkv, G, cap, D, span, splits;
  Strides qst, ost;
  float* lse = nullptr;  // the partial mode's (B, Hq) log-sum-exps
};

template <typename T, int R, typename Rows, bool Partial>
int launch_r(const Launch& a, const Rows& rows, cudaStream_t stream) {
  static int smem_allowed = 48 * 1024;
  const int smem = (int)(R * a.D * sizeof(float) +
                         kWarps * kPos * (2 * a.D + Vec<T>::kChunk) *
                             sizeof(T) +
                         rows.table_ints(a.span) * sizeof(int));
  cudaError_t e = allow_smem(split_decode_kernel<T, R, Rows, Partial>, smem,
                             &smem_allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.splits, a.Hkv, a.B);
  split_decode_kernel<T, R, Rows, Partial>
      <<<grid, kWarps * 32, smem, stream>>>(
          static_cast<const T*>(a.q), a.kv_len, static_cast<T*>(a.o), a.lse,
          a.part, a.tickets, a.G, a.cap, a.D, a.span,
          (float)(1.0 / sqrt((double)a.D)), a.qst, a.ost, rows);
  return (int)cudaGetLastError();
}

template <typename T, typename Rows, bool Partial = false>
int launch(const Launch& a, const Rows& rows, cudaStream_t s) {
  if (a.G <= 1) return launch_r<T, 1, Rows, Partial>(a, rows, s);
  if (a.G <= 2) return launch_r<T, 2, Rows, Partial>(a, rows, s);
  if (a.G <= 4) return launch_r<T, 4, Rows, Partial>(a, rows, s);
  return launch_r<T, 8, Rows, Partial>(a, rows, s);
}

// The checks both entry points make of what the kernel takes: D % 8 == 0
// (16-byte copies), a span of whole 128-position steps that covers cap in
// `splits` spans, and grid dimensions the card takes.
inline bool valid_launch(const Launch& a, int Hq) {
  return a.B > 0 && a.B <= 65535 && a.cap > 0 && a.D > 0 &&
         a.D <= kMaxHeadDim && a.D % 8 == 0 && a.Hkv > 0 && a.Hkv <= 65535 &&
         Hq % a.Hkv == 0 && a.span > 0 && a.span % kStep == 0 &&
         a.splits == (a.cap + a.span - 1) / a.span;
}

}  // namespace repro_split
