// Causal or non-causal grouped-query flash attention, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py. Same function:
//
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / G, j] * D^-0.5) . v[b, h / G, j]
//
// with j <= i when causal, G = Hq / Hkv, f32 softmax, output in the input's
// type (f32 or bf16). The port's serving engine runs it for every prompt's
// prefill and `train_logits` runs it for every layer.
//
// Its prefix-extend variant runs in every admission that reuses a cached
// prefix (the reference computes it with `_xla_attention` and the mask of
// `attention_prefill_extend`, src/repro/models/layers.py:142-270): the S
// suffix queries attend the first prefix_len rows of a cached prefix, all
// visible, then the suffix's own keys causally. The prefix buffer may be
// padded past prefix_len (the bucketed admission pads it with block 0):
// the loop over prefix tiles ends at prefix_len, so those rows are never
// loaded and neither padding nor garbage can leak into a sum. The prefix
// and the suffix are two inputs read in place, so nothing is concatenated.
//
// What bounds it: the work is 4 * B * Hq * S^2 * D operations (halved when
// causal) against (2 * Hq + 2 * Hkv) * B * S * D elements moved. At the
// serving heads (Hq = 16, Hkv = 8, D = 128, bf16) that is S / 3 operations
// a byte, 43 at S = 128 and 170 at S = 512: below the tensor cores'
// balance point of ~295, so on the tensor cores it is bound by bytes and
// by how well the loads overlap the math, and on the f32 CUDA cores (~20
// operations a byte) by operations.
//
// Two kernels, chosen by the input's type in `repro_flash_attention`:
//
// bf16, `flash_attention_kernel_wgmma<DP, G>`, the FlashAttention-2
// schedule on the tensor cores. The serving engine runs only this one.
//   * one block per (64-row q tile, q head, batch row), of G warpgroups of 4
//     warps; warp w of a warpgroup owns q rows 16 w .. 16 w + 15 of the
//     tile. With G = 2 both warpgroups own all 64 rows and take the key
//     tiles in turns, each with its own softmax state, and warpgroup 0
//     merges the two at the end in a fixed order: the longest row's tiles
//     run two at a time. The host takes G = 2 wherever the last q tile has
//     two key tiles or more (`flash_attention.flash_groups`);
//   * the q tile is staged once in shared memory; each warpgroup's K and V
//     tiles of 64 keys of kv head h / G arrive by 16-byte `cp.async` copies
//     into its own ring of two stages, so its next tile loads while the
//     current one is computed. Every tile is stored in the 128-byte
//     swizzled layout that `wgmma` reads (blocks of 64 columns, 16-byte
//     chunk c of row r at chunk c ^ (r % 8)), the head dim zero-padded to
//     64 or 128 columns (D = 80 -> 128: the padding adds zeros to the
//     scores). The products run over the whole padded width, with no branch
//     around a `wgmma`, which would make ptxas serialize them (warning
//     C7515). Rows past the limit (S, or prefix_len for the prefix) are
//     zero-filled by a copy of 0 source bytes: never read from device
//     memory, and zero, so a masked score's P = 0 never meets a NaN in V;
//   * S = Q K^T is `wgmma.mma_async m64n64k16` with both operands read from
//     shared memory through descriptors, accumulated in f32 registers, and
//     scaled in f32 after the product. With G = 2 two named barriers pass
//     the turn to issue it from one warpgroup to the other (ping-pong), so
//     one warpgroup's products run while the other runs its softmax;
//   * the online softmax (running max and normaliser per row, O rescaled)
//     runs on the accumulator fragment in registers, in base 2 on the
//     special-function unit (`ex2.approx`); the diagonal tile and the
//     ragged last tiles are masked with -inf before the max; tiles above
//     the diagonal are never loaded;
//   * P is rounded to bf16 and fed, from the same registers, as the A
//     operand of a second `wgmma` (m64n64k16 or m64n128k16) whose B operand
//     is the V tile through a transposed (MN-major) descriptor; O stays in
//     f32 registers and is written once, through the output's strides.
//   Between the `cp.async` writes (generic proxy) and the `wgmma` reads
//   (async proxy) each thread waits for its copies, fences the proxies and
//   meets the others at a barrier. Within a warpgroup S = Q K^T, the
//   softmax and P.V of a tile run in series: issuing the next tile's
//   Q K^T before the softmax made ptxas serialize the products (warning
//   C7514).
//
// f32, `flash_attention_kernel<float>`, on the CUDA cores. Neither the
// TF32 nor the bf16 tensor cores can meet the 2e-5 tolerance that f32
// calls are held to (the f32 checks and the CPU-parity paths), so f32
// stays here, by an explicit choice on the type and not as a fallback: a
// bf16 call never reaches it.
//   * one block of 4 warps per (q tile of 32 rows, q head, batch row); each
//     warp owns 8 rows, held as scaled f32 queries in shared memory, and
//     keeps their running (m, l, acc) in registers (attention_tile.cuh);
//   * K and V tiles of 32 keys of kv head h / G are staged once per block in
//     shared memory as f32 and shared by the 4 warps; K rows are padded to
//     D + 1 so the score loop reads them without bank conflicts.
// Both mask their ragged last q and k tiles (any S >= 1 works, with no
// padding) and read their inputs through element strides, so the
// (B, S, H, D) projections are read in place, without a transpose.

#include "attention_tile.cuh"
#include "cp_async.cuh"
#include "wgmma_tile.cuh"

namespace {

using namespace repro_attn;
using namespace repro_async;
using namespace repro_wgmma;

constexpr int kWarps = 4;
constexpr int kRows = 8;                  // q rows per warp
constexpr int kTileQ = kWarps * kRows;    // 32
constexpr int kTileK = kChunk;            // 32

struct Strides {
  long long b, h, s;  // element strides of (batch, head, position); d is 1
};

// Stage keys and values [k0, k0 + nk) of one kv head in shared memory as
// f32 (zeros past nk) and attend the warp's rows to them; row r0 + r sees
// the first min(diag + r0 + r + 1 - k0, nk) of them (no limit when diag is
// kNoDiag), none when it is past the last query row S.
constexpr int kNoDiag = 1 << 30;

template <typename T>
__device__ __forceinline__ void attend_tile(RowState<kRows>& st,
                                            const float* qw, float* ks,
                                            float* vs, const T* kb,
                                            const T* vb, long long ks_s,
                                            long long vs_s, int k0, int nk,
                                            int diag, int r0, int S, int D,
                                            int tid, int lane) {
  __syncthreads();  // the previous tile is consumed (and qs is written)
  for (int e = tid; e < kTileK * D; e += kWarps * 32) {
    const int j = e / D, d = e - (e / D) * D;
    float kx = 0.f, vx = 0.f;
    if (j < nk) {
      kx = to_f32(kb[(k0 + j) * ks_s + d]);
      vx = to_f32(vb[(k0 + j) * vs_s + d]);
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
    int n = diag == kNoDiag ? nk : min(diag + row + 1 - k0, nk);
    n = row < S ? max(n, 0) : 0;
    lim[r] = n;
    jmax = max(jmax, n);
  }
  if (jmax > 0)
    attend_chunk<kRows, float>(st, qw, D, ks, vs, D, D, lim, jmax, lane);
}

// S query rows over (prefix, suffix) keys. The prefix (kp, vp) has
// prefix_len visible rows, seen by every query row; the suffix (k, v) has S
// rows, row j seen by query row i iff j <= i when causal. The full-sequence
// kernel is the case prefix_len = 0.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ kp,
                       const T* __restrict__ vp, T* __restrict__ o,
                       float* __restrict__ lse, int S, int prefix_len, int D,
                       int group, int causal, float scale, Strides qst,
                       Strides kst, Strides vst, Strides kpst, Strides vpst,
                       Strides ost) {
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
  T* ob = o + b * ost.b + h * ost.h;

  for (int e = tid; e < kTileQ * D; e += kWarps * 32) {
    const int r = e / D, d = e - (e / D) * D;
    const int row = q0 + r;
    qs[e] = row < S ? to_f32(qb[row * qst.s + d]) * scale : 0.f;
  }

  const int r0 = q0 + warp * kRows;
  const float* qw = qs + warp * kRows * D;
  RowState<kRows> st;
  st.init();
  // the cached prefix: only its first prefix_len rows are loaded
  const T* kpb = kp + b * kpst.b + (h / group) * kpst.h;
  const T* vpb = vp + b * vpst.b + (h / group) * vpst.h;
  for (int k0 = 0; k0 < prefix_len; k0 += kTileK)
    attend_tile<T>(st, qw, ks, vs, kpb, vpb, kpst.s, vpst.s, k0,
                   min(kTileK, prefix_len - k0), kNoDiag, r0, S, D, tid,
                   lane);
  // the suffix: the loop stops at the tile's last row when causal, so
  // tiles above the diagonal are never loaded
  const T* kb = k + b * kst.b + (h / group) * kst.h;
  const T* vb = v + b * vst.b + (h / group) * vst.h;
  const int q_last = min(q0 + kTileQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  for (int k0 = 0; k0 < k_end; k0 += kTileK)
    attend_tile<T>(st, qw, ks, vs, kb, vb, kst.s, vst.s, k0,
                   min(kTileK, S - k0), causal ? 0 : kNoDiag, r0, S, D, tid,
                   lane);

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = r0 + r;
    if (row >= S) break;
#pragma unroll
    for (int i = 0; i < kMaxNI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) ob[row * ost.s + d] = from_f32<T>(st.out(r, i));
    }
    if (lse != nullptr && lane == 0)
      lse[((long long)b * gridDim.y + h) * S + row] =
          row_lse(st.m[r], st.l[r]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kp,
           const void* vp, void* o, float* lse, int B, int Hq, int Hkv, int S,
           int prefix_len, int D, int causal, Strides qst, Strides kst,
           Strides vst, Strides kpst, Strides vpst, Strides ost,
           cudaStream_t stream) {
  static int smem_allowed = 48 * 1024;
  const int smem = (int)sizeof(float) *
                   (kTileQ * D + kTileK * (D + 1) + kTileK * D);
  cudaError_t e = allow_smem(flash_attention_kernel<T>, smem, &smem_allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kTileQ - 1) / kTileQ, Hq, B);
  flash_attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<T*>(o), lse, S, prefix_len, D,
      Hq / Hkv, causal, (float)(1.0 / sqrt((double)D)), qst, kst, vst, kpst,
      vpst, ost);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWgThreads = 128;          // one warpgroup
constexpr int kWgKeys = 64;              // keys per K/V tile
constexpr int kWgStages = 2;             // depth of each warpgroup's ring
// named barriers: 1 + g is warpgroup g's turn on the tensor cores, 3 + g
// its own ring's (0 is __syncthreads)
constexpr int kBarTurn = 1, kBarRing = 3;

// Named barriers by immediate id: id BASE + i for a warpgroup-uniform i of
// 0 or 1 (the tensor-core turns of the two warpgroups).
template <int ID, int N>
__device__ __forceinline__ void bar_sync_n() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(N) : "memory");
}
template <int BASE, int N>
__device__ __forceinline__ void bar_sync(int i) {
  if (i == 0) bar_sync_n<BASE, N>();
  else bar_sync_n<BASE + 1, N>();
}
template <int BASE, int N>
__device__ __forceinline__ void bar_arrive(int i) {
  if (i == 0) asm volatile("bar.arrive %0, %1;\n" ::"n"(BASE), "n"(N) : "memory");
  else asm volatile("bar.arrive %0, %1;\n" ::"n"(BASE + 1), "n"(N) : "memory");
}

// One block computes 64 query rows against (prefix, suffix) keys, as the
// f32 kernel above: prefix rows [0, prefix_len) seen by every row, suffix
// row j seen by query row i iff j <= i when causal. DP is the head dim
// padded to the swizzle's 64-column blocks (64 or 128); G is the number of
// warpgroups (1 or 2).
//
// The key tiles, prefix first, are numbered t = 0 .. n_tiles - 1. With
// G = 2 the two warpgroups share the q tile and take the key tiles in
// turns (warpgroup g takes tiles 2 i + g), each with its own ring, running
// max, normaliser and output; at the end warpgroup 0 merges warpgroup 1's
// state into its own, in that fixed order, so the result does not depend
// on timing. The longest row's tiles run two at a time, and a pair of
// named barriers hands the tensor cores from one warpgroup to the other
// (ping-pong): one issues S = Q K^T while the other runs its softmax. When
// n_tiles is odd, warpgroup 1's last tile lies past the keys: it is
// zero-filled without a read and fully masked, so it adds nothing, and the
// products run with no branch around a `wgmma`. The host takes G = 2
// where a second warpgroup has a tile (`flash_attention.flash_groups`).
//
// Register fragments (wgmma's accumulator layout): thread (warp w of its
// warpgroup, lane l) holds rows 16 w + l / 4 (row 0) and 16 w + l / 4 + 8
// (row 1) of the tile; of the scores, columns 8 j + 2 (l % 4) + {0, 1} for
// j < 8 in s[4 j + {0, 1}] (row 0) and s[4 j + {2, 3}] (row 1); the output
// the same way over DP / 8 groups of 8 columns. The scores of keys 16 kk ..
// 16 kk + 15, rounded to bf16 and paired, are exactly the A fragment of the
// P.V product's step kk.
template <int DP, int G>
__global__ void __launch_bounds__(G * kWgThreads)
flash_attention_kernel_wgmma(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ kp,
                             const bf16* __restrict__ vp,
                             bf16* __restrict__ o, float* __restrict__ lse,
                             int S, int prefix_len, int D, int group,
                             int causal, float scale_log2,
                             Strides qst, Strides kst, Strides vst,
                             Strides kpst, Strides vpst, Strides ost) {
  constexpr int kTile = DP / 64 * kSwBlock;  // bytes of one 64-row tile
  constexpr int kNO = DP / 2;                // output registers per thread
  extern __shared__ unsigned char smem_raw[];
  // the tiles: q, then warpgroup g's slot s (of kWgStages) at n = g *
  // kWgStages + s, K at sq + kTile (1 + 2 n), V after it
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;

  const int q0 = blockIdx.x * kWgRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;
  const int wtid = tid % kWgThreads;
  const int warp = wtid / 32;
  const int lane = tid % 32;
  const int hk = h / group;
  const bf16* kpb = kp + b * kpst.b + hk * kpst.h;
  const bf16* vpb = vp + b * vpst.b + hk * vpst.h;
  const bf16* kb = k + b * kst.b + hk * kst.h;
  const bf16* vb = v + b * vst.b + hk * vst.h;
  const int n_pre = (prefix_len + kWgKeys - 1) / kWgKeys;
  // the suffix tiles end at the q tile's last row when causal, so tiles
  // above the diagonal are never loaded
  const int k_end = causal ? min(q0 + kWgRows, S) : S;
  const int n_tiles = n_pre + (k_end + kWgKeys - 1) / kWgKeys;
  const int n_iter = (n_tiles + G - 1) / G;
  auto slot = [&](int it) {
    return sq + kTile * (1 + 2 * (wg * kWgStages + it % kWgStages));
  };

  // this warpgroup's tile of iteration it, by its own 128 threads; a tile
  // past the keys is zeros
  auto issue = [&](int it) {
    const int t = G * it + wg;
    const uint32_t ks = slot(it);
    if (t < n_pre) {
      const int k0 = t * kWgKeys, rows = min(kWgKeys, prefix_len - k0);
      load_tile<DP, kWgThreads>(ks, kpb + k0 * kpst.s, kpst.s, rows, D, wtid);
      load_tile<DP, kWgThreads>(ks + kTile, vpb + k0 * vpst.s, vpst.s, rows,
                                D, wtid);
    } else if (t < n_tiles) {
      const int k0 = (t - n_pre) * kWgKeys, rows = min(kWgKeys, S - k0);
      load_tile<DP, kWgThreads>(ks, kb + k0 * kst.s, kst.s, rows, D, wtid);
      load_tile<DP, kWgThreads>(ks + kTile, vb + k0 * vst.s, vst.s, rows, D,
                                wtid);
    } else {
      load_tile<DP, kWgThreads>(ks, kb, kst.s, 0, D, wtid);
      load_tile<DP, kWgThreads>(ks + kTile, vb, vst.s, 0, D, wtid);
    }
  };

  // q by every thread; one commit group per tile, q with the first
  load_tile<DP, G * kWgThreads>(sq, q + b * qst.b + h * qst.h + q0 * qst.s,
                                qst.s, min(kWgRows, S - q0), D, tid);
#pragma unroll
  for (int it = 0; it < kWgStages - 1; ++it) {
    if (it < n_iter) issue(it);
    cp_async_commit();
  }
  // warpgroup 0 takes the tensor cores first
  if (G == 2 && wg == 1) bar_arrive<kBarTurn, 2 * kWgThreads>(0);

  float s[32], acc[kNO];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i] = 0.f;
  // running max (of log2-scaled scores) and this thread's share of the
  // normaliser, for its two rows
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + warp * 16 + lane / 4, row1 = row0 + 8;
  const int col = 2 * (lane % 4);

  // the warpgroup's barrier: every thread of the warpgroup is here (a
  // named barrier by a register id: measured faster than a branch between
  // two immediate ids)
  auto wg_sync = [&]() {
    if constexpr (G == 1)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(kBarRing + wg), "n"(kWgThreads)
                   : "memory");
  };
  for (int it = 0; it < n_iter; ++it) {
    // the warpgroup is done with the tile of it - 1, whose slot the next
    // takes
    wg_sync();
    if (it + kWgStages - 1 < n_iter) issue(it + kWgStages - 1);
    cp_async_commit();
    cp_async_wait<kWgStages - 1>();  // this thread's copies of this tile
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // and the warpgroup's; the first tile's group holds q, copied by every
    // thread of the block
    if (it == 0)
      __syncthreads();
    else
      wg_sync();

    const int t = G * it + wg;
    const uint32_t ks = slot(it);
    // S = Q K^T, in steps of 16 columns of the (zero-padded) head dim, on
    // this warpgroup's turn; then the next one's
    if constexpr (G > 1) bar_sync<kBarTurn, 2 * kWgThreads>(wg);
    pin(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kSwBlock + (kk % 4) * 32;
      wgmma_ss_m64n64(s, sw128_desc(sq + off, 16, 1024),
                      sw128_desc(ks + off, 16, 1024), kk > 0);
    }
    wg_commit();
    if constexpr (G > 1)
      bar_arrive<kBarTurn, 2 * kWgThreads>(1 - wg);
    wg_wait_all();
    pin(s);

    // mask: only a tile that reaches past the limit, or past the warp's
    // first row on the diagonal, has keys to hide (a tile past the keys
    // starts past the limit, or above the diagonal, so all of it is hidden)
    const bool pre = t < n_pre;
    const int k0 = (pre ? t : t - n_pre) * kWgKeys;
    const int lim = pre ? prefix_len : S;
    const bool diag = !pre && causal;
    if (k0 + kWgKeys > lim || (diag && k0 + kWgKeys > q0 + warp * 16)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + 8 * j + col + e;
          if (c >= lim || (diag && c > row0)) s[4 * j + e] = -INFINITY;
          if (c >= lim || (diag && c > row1)) s[4 * j + 2 + e] = -INFINITY;
        }
      }
    }
    // the tile's row maxima; a row's 64 columns lie in the 4 lanes of a quad
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    // the running maxima, of scores scaled (in f32, after the product) to
    // base 2; a row that has met no valid key keeps m = -inf and
    // subtracts 0 instead, so no -inf - -inf appears
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    const float b0 = mn0 == -INFINITY ? 0.f : mn0;
    const float b1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = fast_exp2(m0 - b0), al1 = fast_exp2(m1 - b1);
    m0 = mn0;
    m1 = mn1;
    uint32_t p[16];  // P in bf16: p[2 j] row 0, p[2 j + 1] row 1
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)  // exp2(-inf) = 0 for a masked key
        x[e] = fast_exp2(fmaf(s[4 * j + e], scale_log2, e < 2 ? -b0 : -b1));
      ps0 += x[0] + x[1];
      ps1 += x[2] + x[3];
      p[2 * j] = pack_bf16(x[0], x[1]);
      p[2 * j + 1] = pack_bf16(x[2], x[3]);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int i = 0; i < kNO; i += 4) {
      acc[i] *= al0;
      acc[i + 1] *= al0;
      acc[i + 2] *= al1;
      acc[i + 3] *= al1;
    }

    // O += P V, in steps of 16 keys; V's descriptor walks 16 rows a step
    pin(acc);
    pin(p);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgKeys / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
      const uint64_t dv =
          sw128_desc(ks + kTile + kk * 16 * kSwRow, kSwBlock, 1024);
      if constexpr (DP == 64)
        wgmma_rs_m64n64(acc, a, dv, 1);
      else
        wgmma_rs_m64n128(acc, a, dv, 1);
    }
    wg_commit();
    wg_wait_all();
    pin(acc);
  }

  if constexpr (G == 2) {
    // warpgroup 0 takes warpgroup 1's last turn, so the turns balance
    if (wg == 0) bar_sync_n<kBarTurn, 2 * kWgThreads>();
    // warpgroup 1 hands its state to warpgroup 0 through the ring's slots,
    // which every thread is done with: element e of thread wtid at
    // xs[e * 128 + wtid], so the writes and reads are conflict-free
    cp_async_wait<0>();
    __syncthreads();
    float* xs = reinterpret_cast<float*>(smem_raw + (sq + kTile -
                                                     smem_addr(smem_raw))) +
                wtid;
    if (wg == 1) {
      xs[0 * kWgThreads] = m0;
      xs[1 * kWgThreads] = m1;
      xs[2 * kWgThreads] = l0;
      xs[3 * kWgThreads] = l1;
#pragma unroll
      for (int i = 0; i < kNO; ++i) xs[(4 + i) * kWgThreads] = acc[i];
    }
    __syncthreads();
    if (wg == 1) return;
    const float mb0 = xs[0 * kWgThreads], mb1 = xs[1 * kWgThreads];
    const float mn0 = fmaxf(m0, mb0), mn1 = fmaxf(m1, mb1);
    const float b0 = mn0 == -INFINITY ? 0.f : mn0;
    const float b1 = mn1 == -INFINITY ? 0.f : mn1;
    const float ca0 = fast_exp2(m0 - b0), cb0 = fast_exp2(mb0 - b0);
    const float ca1 = fast_exp2(m1 - b1), cb1 = fast_exp2(mb1 - b1);
    l0 = l0 * ca0 + xs[2 * kWgThreads] * cb0;
    l1 = l1 * ca1 + xs[3 * kWgThreads] * cb1;
#pragma unroll
    for (int i = 0; i < kNO; ++i) {  // acc[i] is row 0's for i % 4 < 2
      const bool r0 = (i & 2) == 0;
      acc[i] = acc[i] * (r0 ? ca0 : ca1) +
               xs[(4 + i) * kWgThreads] * (r0 ? cb0 : cb1);
    }
    m0 = mn0;  // the merged maxima, which only the lse reads
    m1 = mn1;
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  // acc / max(l, 1e-30): zeros for a row that met no valid key
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {  // m and l are in base 2
    float* lb = lse + ((long long)b * gridDim.y + h) * S;
    if (row0 < S) lb[row0] = row_lse(m0 * kLn2, l0);
    if (row1 < S) lb[row1] = row_lse(m1 * kLn2, l1);
  }
  bf16* ob = o + b * ost.b + h * ost.h;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int d = 8 * j + col;
    if (d >= D) continue;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * ost.s + d) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * ost.s + d) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1,
                                acc[4 * j + 3] * inv1);
  }
}

template <int DP, int G>
int launch_wgmma(const void* q, const void* k, const void* v, const void* kp,
                 const void* vp, void* o, float* lse, int B, int Hq, int Hkv,
                 int S,
                 int prefix_len, int D, int causal, Strides qst, Strides kst,
                 Strides vst, Strides kpst, Strides vpst, Strides ost,
                 cudaStream_t stream) {
  static int smem_allowed = 48 * 1024;
  // q, each warpgroup's kWgStages (K, V) pairs, and slack to align the
  // first to 1024
  const int smem = DP / 64 * kSwBlock * (1 + 2 * G * kWgStages) + 1024;
  cudaError_t e =
      allow_smem(flash_attention_kernel_wgmma<DP, G>, smem, &smem_allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kWgRows - 1) / kWgRows, Hq, B);
  flash_attention_kernel_wgmma<DP, G><<<grid, G * kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), static_cast<bf16*>(o), lse, S,
      prefix_len, D, Hq / Hkv, causal, (float)(1.4426950408889634 / sqrt((double)D)), qst,
      kst, vst, kpst, vpst, ost);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_wgmma(int groups, const void* q, const void* k, const void* v,
                 const void* kp, const void* vp, void* o, float* lse, int B,
                 int Hq, int Hkv, int S, int prefix_len, int D, int causal,
                 Strides qst, Strides kst, Strides vst, Strides kpst,
                 Strides vpst, Strides ost, cudaStream_t stream) {
  if (groups == 2)
    return launch_wgmma<DP, 2>(q, k, v, kp, vp, o, lse, B, Hq, Hkv, S,
                               prefix_len, D, causal, qst, kst, vst, kpst,
                               vpst, ost, stream);
  return launch_wgmma<DP, 1>(q, k, v, kp, vp, o, lse, B, Hq, Hkv, S,
                             prefix_len, D, causal, qst, kst, vst, kpst, vpst,
                             ost, stream);
}

}  // namespace

// q: (B, Hq, S, D), k/v: (B, Hkv, S, D), o: (B, Hq, S, D), and the prefix
// kp/vp: (B, Hkv, >= prefix_len, D), each given by its data pointer and its
// (batch, head, position) element strides; the last dimension is
// contiguous. lse, when not null, is a contiguous f32 (B, Hq, S) that gets
// each row's log-sum-exp of its scaled scores, m + log l (+inf for a row
// that met no key): the training forward saves it for the backward
// (flash_attention_bwd.cu); serving passes null and computes the same bits
// as without it. prefix_len = 0 is full-sequence attention (kp, vp unread);
// prefix_len > 0 needs causal. dtype: 0 = float32, on the CUDA cores;
// 1 = bfloat16, on the tensor cores, which also needs D % 8 == 0 and
// 16-byte aligned pointers and strides of q, k, v, kp, vp (the wrapper
// checks them), and runs `groups` (1 or 2) warpgroups a block; groups is
// 1 for float32. Launches on `stream`, allocates nothing, and returns
// cudaGetLastError().
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, const void* kp,
    const void* vp, void* o, void* lse, int B, int Hq, int Hkv, int S,
    int prefix_len, int D, int causal, int dtype, int groups, long long q_sb,
    long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long kp_sb,
    long long kp_sh, long long kp_ss, long long vp_sb, long long vp_sh,
    long long vp_ss, long long o_sb, long long o_sh, long long o_ss,
    void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || D > kMaxHeadDim || Hkv <= 0 ||
      Hq % Hkv != 0 || Hq > 65535 || prefix_len < 0 ||
      (prefix_len > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  const Strides qst{q_sb, q_sh, q_ss}, kst{k_sb, k_sh, k_ss},
      vst{v_sb, v_sh, v_ss}, kpst{kp_sb, kp_sh, kp_ss},
      vpst{vp_sb, vp_sh, vp_ss}, ost{o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  if (dtype == 0 && groups == 1)
    return launch<float>(q, k, v, kp, vp, o, l, B, Hq, Hkv, S, prefix_len, D,
                         causal, qst, kst, vst, kpst, vpst, ost, s);
  if (dtype != 1 || D % 8 != 0 || B > 65535 || groups < 1 || groups > 2)
    return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch_wgmma<64>(groups, q, k, v, kp, vp, o, l, B, Hq, Hkv, S,
                            prefix_len, D, causal, qst, kst, vst, kpst, vpst,
                            ost, s);
  return launch_wgmma<128>(groups, q, k, v, kp, vp, o, l, B, Hq, Hkv, S,
                           prefix_len, D, causal, qst, kst, vst, kpst, vpst,
                           ost, s);
}
