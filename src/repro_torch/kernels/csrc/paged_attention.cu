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
// never read, nor are the block-table entries past them, so pad entries
// (any id) and whatever their blocks hold (NaN included) cannot reach the
// output.
//
// The kernel is split_decode.cuh's, with the PagedRows policy: the decode
// kernel's grid, 16-byte copies, online softmax and ordered merge, with a
// position's row address resolved through the span's table entries, which
// each block reads once into shared memory. The TPU kernel resolves a block
// id in its BlockSpec index map from the prefetched table; here the lane
// that owns a position of a chunk resolves it. On the same rows with the
// same (span, splits) it gives the decode kernel's bits: the paged result
// equals the decode kernel's on the gathered cache whenever that cache's
// Smax is max_blocks * bs. The pools are read through element strides of
// (block, head, position in block), so both the TPU layout (n_blocks, Hkv,
// bs, D) and one layer of the serving store's (n_blocks, bs, Hkv, D) pool
// are read in place. The design note is in split_decode.cuh.

#include "split_decode.cuh"

using namespace repro_split;

namespace {

template <typename T>
int launch_paged(const Launch& a, const void* k_pool, const void* v_pool,
                 Strides kst, Strides vst, const int* bt, long long bt_sb,
                 int bs, cudaStream_t s) {
  return launch<T>(a, PagedRows<T>{static_cast<const T*>(k_pool),
                                   static_cast<const T*>(v_pool), kst, vst,
                                   bt, bt_sb, bs},
                   s);
}

}  // namespace

// q: (B, Hq, D) with (batch, head) strides; k/v pools: (n_blocks, Hkv, bs,
// D) with (block, head, position) strides; block_table: (B, max_blocks)
// int32 with batch stride bt_sb (contiguous along blocks), ids < n_blocks,
// negative ids read block 0; kv_len: (B,) int32; o: (B, Hq, D) with
// (batch, head) strides. The last dimension of each is contiguous; D % 8
// == 0, and the pools and their strides are 16-byte aligned (the wrapper
// checks them). dtype: 0 = float32, 1 = bfloat16. The max_blocks * bs
// positions are split in `splits` spans of `span` (a multiple of 128;
// splits = ceil(max_blocks * bs / span)). part: B * Hq * splits * (D + 2)
// f32 of scratch; tickets: B * Hkv int32, zero, and left zero. Launches on
// `stream`, allocates nothing, and returns cudaGetLastError().
extern "C" int repro_paged_gqa_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* kv_len, void* o, void* part,
    void* tickets, int B, int Hq, int Hkv, int max_blocks, int bs, int D,
    int dtype, int span, int splits, long long q_sb, long long q_sh,
    long long k_sblk, long long k_sh, long long k_ss, long long v_sblk,
    long long v_sh, long long v_ss, long long bt_sb, long long o_sb,
    long long o_sh, void* stream) {
  if (max_blocks <= 0 || bs <= 0 || max_blocks > (1 << 30) / bs)
    return (int)cudaErrorInvalidValue;
  const Launch a{q, static_cast<const int*>(kv_len), o,
                 static_cast<float*>(part), static_cast<int*>(tickets), B,
                 Hkv, Hkv > 0 ? Hq / Hkv : 0, max_blocks * bs, D, span,
                 splits, Strides{q_sb, q_sh, 0}, Strides{o_sb, o_sh, 0}};
  if (!valid_launch(a, Hq)) return (int)cudaErrorInvalidValue;
  const Strides kst{k_sblk, k_sh, k_ss}, vst{v_sblk, v_sh, v_ss};
  const int* bt = static_cast<const int*>(block_table);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_paged<float>(a, k_pool, v_pool, kst, vst, bt, bt_sb, bs, s);
  if (dtype == 1)
    return launch_paged<__nv_bfloat16>(a, k_pool, v_pool, kst, vst, bt,
                                       bt_sb, bs, s);
  return (int)cudaErrorInvalidValue;
}
