// Grouped-query decode attention over a paged KV pool addressed by a block
// table, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` / `paged_gqa_decode_attention` in
// src/repro/kernels/paged_attention.py. Same function as the contiguous
// decode kernel (decode_attention.cu), with row b's position p read from
// physical block max(block_table[b, p / bs], 0) at offset p % bs:
//
//   out[b, h] = softmax_{p < n_b}(q[b, h] . k[blk(b, p), h / G, p % bs] * D^-0.5)
//               . v[blk(b, p), h / G, p % bs]
//
// with n_b = min(kv_len[b], max_blocks * bs), f32 math, output in the
// input's type (f32 or bf16). A row with kv_len <= 0 gives zeros (the TPU
// kernel clamps its normaliser to 1e-30). Positions at or past n_b are
// never read, so the block-table entries past them (pad entries, any id)
// and whatever their blocks hold (NaN included) cannot reach the output.
//
// What bounds it: the bytes of the blocks read, 2 * n_b * D elements per
// (b, kv head), against ~4 * G * n_b * D operations: G operations a byte in
// bf16, so device memory is the only limit, as for the contiguous kernel.
//
// What the design does about it, simply: the contiguous kernel's design
// (one block of 4 warps per (kv head, batch row), the G query heads of a
// group sharing every K/V byte, warps splitting the positions in chunks of
// 32 and merging their online-softmax states at the end), with one change.
// The TPU kernel resolves a block id in its BlockSpec index map from the
// prefetched table; here each lane resolves the address of its own key of
// the chunk (table read, clamp, block stride, offset in the block) once, and
// the warp keeps the chunk's 32 K and V offsets in shared memory, so the
// key staging and the value loop read through them. The pool is read
// through element strides of (block, head, position in block), so both the
// TPU layout (n_blocks, Hkv, bs, D) and one layer of the serving store's
// (n_blocks, bs, Hkv, D) pool are read in place.

#include "attention_tile.cuh"

namespace {

using namespace repro_attn;

constexpr int kWarps = 4;

struct PoolStrides {
  long long blk, h, s;  // element strides of (block, head, position); d is 1
};

struct RowStrides {
  long long b, h;  // element strides of (batch, head); d is 1
};

template <typename T, int R>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool,
                    const int* __restrict__ block_table,
                    const int* __restrict__ kv_len, T* __restrict__ o, int G,
                    int max_blocks, int bs, int D, float scale,
                    long long bt_sb, RowStrides qst, PoolStrides kst,
                    PoolStrides vst, RowStrides ost) {
  extern __shared__ float smem[];
  float* qs = smem;                               // R x D
  float* ks = qs + R * D;                         // kWarps x kChunk x (D + 1)
  // kWarps x kChunk K offsets, then as many V offsets (8-byte aligned)
  long long* koffs = reinterpret_cast<long long*>(
      smem + ((R * D + kWarps * kChunk * (D + 1) + 1) & ~1));
  long long* voffs = koffs + kWarps * kChunk;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n = min(max(kv_len[b], 0), max_blocks * bs);
  const int* bt = block_table + b * bt_sb;
  const T* kb = kpool + hk * kst.h;
  const T* vb = vpool + hk * vst.h;
  float* kw = ks + warp * kChunk * (D + 1);
  long long* koff = koffs + warp * kChunk;
  long long* voff = voffs + warp * kChunk;

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
      __syncwarp();  // the previous chunk's keys and offsets are consumed
      if (lane < nk) {
        const int p = k0 + lane;
        const long long blk = max(bt[p / bs], 0);
        const int off = p - (p / bs) * bs;
        koff[lane] = blk * kst.blk + off * kst.s;
        voff[lane] = blk * vst.blk + off * vst.s;
      }
      __syncwarp();
      for (int e = lane; e < kChunk * D; e += 32) {
        const int j = e / D, d = e - (e / D) * D;
        kw[j * (D + 1) + d] = j < nk ? to_f32(kb[koff[j] + d]) : 0.f;
      }
      __syncwarp();
      int lim[R];
#pragma unroll
      for (int r = 0; r < R; ++r) lim[r] = r < nr ? nk : 0;
      attend_chunk_rows<R>(st, qs, D, kw, OffsetRows<T>{vb, voff}, D, lim, nk,
                           lane);
    }

    T* ob = o + b * ost.b + (hk * G + g0) * ost.h;
    merge_warps<kWarps, R>(st, ks, nr, D, warp, lane, tid,
                           [&](int r, int d, float x) {
                             ob[r * ost.h + d] = from_f32<T>(x);
                           });
  }
}

struct Args {
  const void *q, *kpool, *vpool;
  const int *bt, *kv_len;
  void* o;
  int B, Hkv, G, max_blocks, bs, D;
  long long bt_sb;
  RowStrides qst;
  PoolStrides kst, vst;
  RowStrides ost;
};

template <typename T, int R>
int launch(const Args& a, cudaStream_t stream) {
  static int smem_allowed = 48 * 1024;
  const int floats = (R * a.D + kWarps * kChunk * (a.D + 1) + 1) & ~1;
  const int smem = (int)sizeof(float) * floats +
                   (int)sizeof(long long) * 2 * kWarps * kChunk;
  cudaError_t e = allow_smem(paged_decode_kernel<T, R>, smem, &smem_allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.Hkv, a.B);
  paged_decode_kernel<T, R><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kpool),
      static_cast<const T*>(a.vpool), a.bt, a.kv_len, static_cast<T*>(a.o),
      a.G, a.max_blocks, a.bs, a.D, (float)(1.0 / sqrt((double)a.D)),
      a.bt_sb, a.qst, a.kst, a.vst, a.ost);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const Args& a, cudaStream_t s) {
  // the smallest register block of query heads that holds the group
  if (a.G <= 1) return launch<T, 1>(a, s);
  if (a.G <= 2) return launch<T, 2>(a, s);
  if (a.G <= 4) return launch<T, 4>(a, s);
  return launch<T, 8>(a, s);
}

}  // namespace

// q: (B, Hq, D) with (batch, head) strides; k/v pools: (n_blocks, Hkv, bs,
// D) with (block, head, position) strides; block_table: (B, max_blocks)
// int32 with batch stride bt_sb (contiguous along blocks), ids < n_blocks,
// negative ids read block 0; kv_len: (B,) int32; o: (B, Hq, D) with
// (batch, head) strides. The last dimension of each is contiguous. dtype:
// 0 = float32, 1 = bfloat16. Launches on `stream`, allocates nothing, and
// returns cudaGetLastError().
extern "C" int repro_paged_gqa_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* kv_len, void* o, int B, int Hq,
    int Hkv, int max_blocks, int bs, int D, int dtype, long long q_sb,
    long long q_sh, long long k_sblk, long long k_sh, long long k_ss,
    long long v_sblk, long long v_sh, long long v_ss, long long bt_sb,
    long long o_sb, long long o_sh, void* stream) {
  if (B <= 0 || B > 65535 || max_blocks <= 0 || bs <= 0 || D <= 0 ||
      D > kMaxHeadDim || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q,
               k_pool,
               v_pool,
               static_cast<const int*>(block_table),
               static_cast<const int*>(kv_len),
               o,
               B,
               Hkv,
               Hq / Hkv,
               max_blocks,
               bs,
               D,
               bt_sb,
               RowStrides{q_sb, q_sh},
               PoolStrides{k_sblk, k_sh, k_ss},
               PoolStrides{v_sblk, v_sh, v_ss},
               RowStrides{o_sb, o_sh}};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_rows<float>(a, s);
  if (dtype == 1) return launch_rows<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
