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
// The kernel is split_decode.cuh's, with the ContiguousRows policy: K and V
// are read through element strides, so one layer's slice of the engine's
// (B, Smax, Hkv, D) cache is read in place: no transpose, no copy. The
// design note (what bounds it, what the design does about it) is there.
// Its partial mode (repro_gqa_decode_partial) is what a rank of the
// sharded serve step runs over its block of a cache split by position.

#include "split_decode.cuh"

using namespace repro_split;

namespace {

template <bool Partial>
int decode(const void* q, const void* k, const void* v, const void* kv_len,
           void* o, float* lse, void* part, void* tickets, int B, int Hq,
           int Hkv, int Smax, int D, int dtype, int span, int splits,
           long long q_sb, long long q_sh, long long k_sb, long long k_sh,
           long long k_ss, long long v_sb, long long v_sh, long long v_ss,
           long long o_sb, long long o_sh, void* stream) {
  const Launch a{q, static_cast<const int*>(kv_len), o,
                 static_cast<float*>(part), static_cast<int*>(tickets), B,
                 Hkv, Hkv > 0 ? Hq / Hkv : 0, Smax, D, span, splits,
                 Strides{q_sb, q_sh, 0}, Strides{o_sb, o_sh, 0}, lse};
  if (!valid_launch(a, Hq)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, ContiguousRows<float>, Partial>(
        a, ContiguousRows<float>{static_cast<const float*>(k),
                                 static_cast<const float*>(v),
                                 Strides{k_sb, k_sh, k_ss},
                                 Strides{v_sb, v_sh, v_ss}}, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, ContiguousRows<__nv_bfloat16>, Partial>(
        a, ContiguousRows<__nv_bfloat16>{
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               Strides{k_sb, k_sh, k_ss}, Strides{v_sb, v_sh, v_ss}}, s);
  return (int)cudaErrorInvalidValue;
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
  return decode<false>(q, k, v, kv_len, o, nullptr, part, tickets, B, Hq,
                       Hkv, Smax, D, dtype, span, splits, q_sb, q_sh, k_sb,
                       k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, stream);
}

// The partial mode, for a block of a cache whose positions are split over
// ranks: as repro_gqa_decode, but o is f32 (the normalized result before
// the default mode's rounding) and lse, (B, Hq) contiguous f32, gets each
// (b, q head)'s log-sum-exp m + log(l) of the scaled scores (-inf where
// kv_len <= 0).
extern "C" int repro_gqa_decode_partial(
    const void* q, const void* k, const void* v, const void* kv_len, void* o,
    void* lse, void* part, void* tickets, int B, int Hq, int Hkv, int Smax,
    int D, int dtype, int span, int splits, long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    void* stream) {
  return decode<true>(q, k, v, kv_len, o, static_cast<float*>(lse), part,
                      tickets, B, Hq, Hkv, Smax, D, dtype, span, splits,
                      q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,
                      o_sh, stream);
}
