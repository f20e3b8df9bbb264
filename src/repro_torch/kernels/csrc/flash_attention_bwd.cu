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
// S 128) S / 3 operations a byte, so on the tensor cores it is bound by
// bytes, and at that size in practice by latency: a block walks at most
// four tile steps, each a chain of dependent products.
//
// Two routes, chosen by the input's type in the C entry points; both are
// two kernels, dq (which also writes D for the second) and then dk/dv, and
// both are deterministic (no atomics, every sum in a fixed order).
//
// bf16, `flash_bwd_dq_wgmma<DP>` and `flash_bwd_dkdv_wgmma<DP>`, the
// FlashAttention-2 backward on the tensor cores, built from the forward's
// pieces (wgmma_tile.cuh). DP is the head dim padded to the swizzle's
// 64-column blocks (64 or 128; D 80 -> 128, the padding adds zeros to every
// product). Each warpgroup owns a 64-row tile, warp w its rows 16 w .. 16 w
// + 15, in wgmma's accumulator layout.
//   * dq: one warpgroup per (64-row q tile, q head, batch row). Q and dO are
//     copied once into the swizzled layout; K and V tiles of 64 keys of kv
//     head h / G arrive through a two-stage `cp.async` ring, up to the
//     diagonal when causal. While the first copies fly, each thread computes
//     D for its two rows from dO and O in f32 (the quad's lanes take 8-column
//     chunks in turns, then sum by shuffles) and writes it for dk/dv. Per key
//     tile: S = Q K^T and dP = dO V^T (`wgmma` m64n64, both operands K-major
//     in shared memory) in one commit group; then P = exp2(S scale log2e -
//     lse log2e) masked, rounded to bf16, and dS = P (dP - D) rounded to
//     bf16 in the same registers, which are the A fragment of dQ += dS K
//     (m64n64 / m64n128, K read MN-major as the forward reads V).
//   * dk/dv: one block per (64-key tile, kv head, batch row). K and V are
//     copied once; the group's query heads and, for each, its q tiles from
//     the key tile's diagonal on (all when not causal) make a fixed walk of
//     steps, each through a two-stage ring of Q and dO tiles whose 64 rows'
//     lse and D ride in the same commit group by 4-byte `cp.async` copies
//     (zeros past S). Per step, computed transposed so that keys are the
//     rows: S^T = K Q^T; P^T rounded to bf16 and dV += P^T dO from
//     registers; dP^T = V dO^T, in the same commit group as dV; then dS^T =
//     P^T (dP^T - D) rounded to bf16 and dK += dS^T Q. P^T -> dV is issued
//     before dP^T -> dK so that dV, dK (64 + 64 f32), dP^T (32) and P^T (16
//     packed) are the most registers alive at once. The block of key tile 0
//     has the longest walk (the group's heads times the q tiles), so every
//     block runs two warpgroups: each takes every other step with its own
//     ring, dK and dV, and warpgroup 0 adds warpgroup 1's sums to its own at
//     the end, in that order (a walk of one step leaves warpgroup 1 only
//     the K and V copies and zeros to hand over). The GQA sum is the
//     block's own walk: no second reduction, no atomic. (One warpgroup
//     where the walk has one step was slower on an H100 at every shape
//     timed; a second warpgroup in dq, taking every other key tile, was
//     slower at S 1,024 and no faster at 128.)
//   Every tile is a 64-row tile copied once in the swizzled layout; P and dS
//   never go through shared memory. Rows past S are zero-filled by copies
//   of 0 source bytes, never read, and masked out of P (a q row past S, a
//   key past S in dq; a key row past S in dk/dv is never written), so
//   neither padding nor NaN there reaches a gradient. No branch surrounds a
//   `wgmma` (ptxas would serialize them, warning C7515), and no product of
//   the next step is issued before this step's elementwise work (C7514).
//   The masks are arithmetic (-inf added to a hidden exponent, a factor 0
//   on a lone row's dS) rather than selects that the compiler turns into
//   divergent branches around the shared loads and the MUFU (on an H100
//   those made the dk/dv kernel markedly slower).
//
// f32, `flash_bwd_dq_kernel` and `flash_bwd_dkdv_kernel`, on the CUDA cores.
// f32 calls are held to 1e-4 x max|g|, which neither TF32 nor bf16 products
// can meet, so f32 stays here, by an explicit choice on the type and not as
// a fallback: a bf16 call never reaches these kernels.
//   * dq: one block of 256 threads per (32-row q tile, q head, batch row).
//     Its prologue computes D for its rows from dO and O (in dP's order of
//     summation) and writes it for the second kernel; then it walks the key
//     tiles of 32 up to the diagonal (all of them when not causal),
//     recomputes P and dS for the 32 x 32 pairs and accumulates dQ = dS K in
//     registers.
//   * dk/dv: one block per (32-key tile, kv head, batch row). It holds its
//     K and V tile and walks the G query heads of its group and their q
//     tiles from the key tile's diagonal on, recomputes P and dS, and
//     accumulates dV = P^T dO and dK = dS^T Q in registers.
//   Tiles are staged as f32 in shared memory with rows padded to D + 1
//   (conflict-free column reads). For the 32 x 32 pairs of a step, warp w
//   takes rows w + 8 m (m < 4) and lane j key j. For the accumulators,
//   thread t owns one row of the output tile (t / 8) and the head-dim slots
//   d = t % 8 + 8 i. Rows past S stage as zeros and are masked out of P.
//
// A row with lse = +inf (it met no key) gets P = 0 and dS = 0 on both
// routes. A row that sees one key (causal row 0, or S = 1) has a softmax of
// one element, whose gradient is 0: the f32 route gets dP - D = 0 exactly by
// summing D in dP's order; the bf16 route, where dP comes from the tensor
// cores and D from the CUDA cores (and dk/dv's dP^T has its operands
// swapped), sets that row's dS to 0 in both kernels. So dq and dk are
// exactly 0 at S = 1, as the plain gradient is.

#include "attention_tile.cuh"
#include "cp_async.cuh"
#include "wgmma_tile.cuh"

namespace {

using namespace repro_attn;
using namespace repro_async;
using namespace repro_wgmma;

constexpr int kThreads = 256;
constexpr int kWarpsB = kThreads / 32;        // 8
constexpr int kTile = 32;                     // q rows and keys of a tile
constexpr int kPairRows = kTile / kWarpsB;    // 4 rows a warp in a step
constexpr int kSlots = kMaxHeadDim / 8;       // head-dim slots a thread owns

struct Strides {
  long long b, h, s;  // element strides of (batch, head, position); d is 1
};

// Rows [r0, r0 + kTile) of one head into a kTile x (D + 1) tile; rows past
// S are zeros, never read.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long ss, int r0, int S, int D,
                                      int tid) {
  for (int e = tid; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e - (e / D) * D;
    dst[r * (D + 1) + d] = r0 + r < S ? src[(r0 + r) * ss + d] : 0.f;
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

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dsum,
                    float* __restrict__ dq, int S, int D, int group,
                    int causal, float scale, Strides qst, Strides kst,
                    Strides vst, Strides ost, Strides dost, Strides dqst) {
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

  stage(qs, q + b * qst.b + h * qst.h, qst.s, q0, S, D, tid);
  stage(dos, dout + b * dost.b + h * dost.h, dost.s, q0, S, D, tid);
  stage(ks, o + b * ost.b + h * ost.h, ost.s, q0, S, D, tid);
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
  const float* kb = k + b * kst.b + hk * kst.h;
  const float* vb = v + b * vst.b + hk * vst.h;
  const int k_end = causal ? min(q0 + kTile, S) : S;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the last tile is consumed (and O, D, lse are read)
    stage(ks, kb, kst.s, k0, S, D, tid);
    stage(vs, vb, vst.s, k0, S, D, tid);
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
    float* out = dq + b * dqst.b + h * dqst.h + row * dqst.s;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int d = c0 + 8 * i;
      if (d < D) out[d] = acc[i] * scale;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, float* __restrict__ dk,
                      float* __restrict__ dv, int S, int D, int Hq,
                      int causal, float scale, Strides qst, Strides kst,
                      Strides vst, Strides dost, Strides dkst,
                      Strides dvst) {
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

  stage(ks, k + b * kst.b + hk * kst.h, kst.s, k0, S, D, tid);
  stage(vs, v + b * vst.b + hk * vst.h, vst.s, k0, S, D, tid);

  const int krow = tid / 8, c0 = tid % 8;
  float adk[kSlots], adv[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) adk[i] = adv[i] = 0.f;
  // the q tiles that see this key tile: from its diagonal on when causal
  const int q_start = causal ? k0 : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long row_base = ((long long)b * Hq + h) * S;
    const float* qb = q + b * qst.b + h * qst.h;
    const float* dob = dout + b * dost.b + h * dost.h;
    for (int q0 = q_start; q0 < S; q0 += kTile) {
      __syncthreads();  // the last q tile is consumed
      stage(qs, qb, qst.s, q0, S, D, tid);
      stage(dos, dob, dost.s, q0, S, D, tid);
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
    float* ok = dk + b * dkst.b + hk * dkst.h + key * dkst.s;
    float* ov = dv + b * dvst.b + hk * dvst.h + key * dvst.s;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int d = c0 + 8 * i;
      if (d < D) {
        ok[d] = adk[i] * scale;
        ov[d] = adv[i];
      }
    }
  }
}

int smem_bytes(int D) {
  return (int)sizeof(float) *
         (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) + 2 * kTile);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWgThreads = 128;          // one warpgroup a block
constexpr int kWgStages = 2;             // depth of the ring of tiles
constexpr float kLog2e = 1.4426950408889634f;

// A 4-byte asynchronous copy (`cp.async.ca`; the 16-byte `.cg` form cannot
// take a single f32): src_bytes = 0 reads nothing and writes a zero.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// `a`, opaque to the compiler: the descriptors of a tile that stays put
// (dq's Q and dO, dk/dv's K and V) are then rebuilt where each product uses
// them instead of being hoisted out of the tile loop, where their eight
// 64-bit values a tile would hold 32 registers.
__device__ __forceinline__ uint32_t opaque(uint32_t a) {
  asm volatile("" : "+r"(a));
  return a;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// This lane's part of sum_d a[d] b[d] in f32: its 8-column chunks c = part,
// part + 4, ... of D (16-byte loads; the wrapper checks the alignment).
__device__ __forceinline__ float dot_part(const bf16* a, const bf16* b, int D,
                                          int part) {
  float x = 0.f;
  for (int c = part; c * 8 < D; c += 4) {
    uint4 ua = *reinterpret_cast<const uint4*>(a + c * 8);
    uint4 ub = *reinterpret_cast<const uint4*>(b + c * 8);
    const uint32_t* pa = reinterpret_cast<const uint32_t*>(&ua);
    const uint32_t* pb = reinterpret_cast<const uint32_t*>(&ub);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = unpack_bf16(pa[i]), fb = unpack_bf16(pb[i]);
      x = fmaf(fa.x, fb.x, x);
      x = fmaf(fa.y, fb.y, x);
    }
  }
  return x;
}

// The sum of a value over the 4 lanes of a quad (the lanes that share a row
// of an accumulator fragment); every lane gets the same bits.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// dQ of one 64-row q tile; also D of its rows, into dsum.
//
// Register fragments (wgmma's accumulator layout): thread (warp w of its
// warpgroup, lane l) holds rows 16 w + l / 4 (row 0) and 16 w + l / 4 + 8
// (row 1) of the tile; of a 64-column product, columns 8 j + 2 (l % 4) +
// {0, 1} in s[4 j + {0, 1}] (row 0) and s[4 j + {2, 3}] (row 1). The bf16
// pairs of keys 16 kk .. 16 kk + 15 are the A fragment of step kk of a
// product over those keys.
template <int DP>
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ o,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ dsum,
                   bf16* __restrict__ dq, int S, int D, int group,
                   int causal, float scale, float scale_log2, Strides qst,
                   Strides kst, Strides vst, Strides ost, Strides dost,
                   Strides dqst) {
  constexpr int kBytes = DP / 64 * kSwBlock;  // one 64-row tile
  constexpr int kNO = DP / 2;                 // dQ registers a thread
  extern __shared__ unsigned char smem_raw[];
  // Q, dO, then stage s's K at sq + kBytes (2 + 2 s), its V after it
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + kBytes;

  const int q0 = blockIdx.x * kWgRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int hk = h / group;
  const bf16* kb = k + b * kst.b + hk * kst.h;
  const bf16* vb = v + b * vst.b + hk * vst.h;
  // the key tiles end at the q tile's last row when causal, so tiles above
  // the diagonal are never loaded; there is at least one
  const int k_end = causal ? min(q0 + kWgRows, S) : S;
  const int n_tiles = (k_end + kWgRows - 1) / kWgRows;
  auto slot = [&](int i) { return sq + kBytes * (2 + 2 * (i % kWgStages)); };
  auto issue = [&](int i) {
    const int k0 = i * kWgRows, rows = min(kWgRows, S - k0);
    const int t = (int)opaque(tid);
    load_tile<DP, kWgThreads>(slot(i), kb + k0 * kst.s, kst.s, rows, D, t);
    load_tile<DP, kWgThreads>(slot(i) + kBytes, vb + k0 * vst.s, vst.s, rows,
                              D, t);
  };
  // one commit group a stage; Q and dO with the first
  const int q_rows = min(kWgRows, S - q0);
  load_tile<DP, kWgThreads>(sq, q + b * qst.b + h * qst.h + q0 * qst.s,
                            qst.s, q_rows, D, tid);
  load_tile<DP, kWgThreads>(sdo, dout + b * dost.b + h * dost.h + q0 * dost.s,
                            dost.s, q_rows, D, tid);
#pragma unroll
  for (int i = 0; i < kWgStages; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  // while they fly: D and lse (base 2) of the thread's two rows, D written
  // for dk/dv by the quad's first lane; a row past S gets lse = +inf, so
  // its P is 0
  const int row0 = q0 + warp * 16 + lane / 4, row1 = row0 + 8;
  const int col = 2 * (lane % 4);
  const long long row_base = ((long long)b * gridDim.y + h) * S;
  float dd[2], l2[2], keep[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    float x = 0.f;
    if (row < S)
      x = dot_part(dout + b * dost.b + h * dost.h + row * dost.s,
                   o + b * ost.b + h * ost.h + row * ost.s, D, lane % 4);
    dd[r] = quad_sum(x);
    l2[r] = row < S ? lse[row_base + row] * kLog2e : INFINITY;
    if (row < S && lane % 4 == 0) dsum[row_base + row] = dd[r];
    // a row that sees one key: its dS is 0
    keep[r] = (causal ? row == 0 : S == 1) ? 0.f : 1.f;
  }

  float s[32], dp[32], acc[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i] = 0.f;
  // the first stage (with Q and dO) has landed, for every thread
  cp_async_wait<kWgStages - 1>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  for (int i = 0; i < n_tiles; ++i) {
    const uint32_t ks = slot(i), vs = ks + kBytes;
    const uint32_t q_s = opaque(sq), do_s = opaque(sdo);

    // S = Q K^T and dP = dO V^T, in steps of 16 columns of the head dim.
    // The wgmma's "+f" operands read the accumulators, so they are zeroed
    // first: the last tile's values then die at their last use instead of
    // living across the loop
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
    pin(s);
    pin(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kSwBlock + (kk % 4) * 32;
      wgmma_ss_m64n64(s, sw128_desc(q_s + off, 16, 1024),
                      sw128_desc(ks + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kSwBlock + (kk % 4) * 32;
      wgmma_ss_m64n64(dp, sw128_desc(do_s + off, 16, 1024),
                      sw128_desc(vs + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(s);
    pin(dp);

    // P, rounded to bf16, and dS = P (dP - D), rounded to bf16: ds[2 j]
    // row 0, ds[2 j + 1] row 1. Only a tile that reaches past S, or past
    // the warp's first row on the diagonal, has keys to hide.
    const int k0 = i * kWgRows;
    const bool edge =
        k0 + kWgRows > S || (causal && k0 + kWgRows > q0 + warp * 16);
    uint32_t ds[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, c = k0 + 8 * j + col + e % 2;
        const bool ok =
            !edge || (c < S && (!causal || c <= (r ? row1 : row0)));
        // a hidden key's exponent gets -inf added (exp2 gives 0), and a
        // lone row's dS a factor 0: every operand is used on every lane,
        // so nothing branches (divergent branches around the loads and the
        // MUFU cost more than the products)
        const float p = round_bf16(fast_exp2(
            fmaf(s[4 * j + e], scale_log2, -l2[r]) + (ok ? 0.f : -INFINITY)));
        x[e] = p * (dp[4 * j + e] - dd[r]) * keep[r];
      }
      ds[2 * j] = pack_bf16(x[0], x[1]);
      ds[2 * j + 1] = pack_bf16(x[2], x[3]);
    }

    // dQ += dS K, in steps of 16 keys; K read MN-major, 16 rows a step
    pin(acc);
    pin(ds);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk) {
      const uint32_t a[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2],
                             ds[4 * kk + 3]};
      const uint64_t db = sw128_desc(ks + kk * 16 * kSwRow, kSwBlock, 1024);
      if constexpr (DP == 64)
        wgmma_rs_m64n64(acc, a, db, 1);
      else
        wgmma_rs_m64n128(acc, a, db, 1);
    }
    wg_commit();
    wg_wait_all();
    pin(acc);

    // every thread is done with this stage: refill it, and wait for the
    // next one to land
    __syncthreads();
    if (i + kWgStages < n_tiles) issue(i + kWgStages);
    cp_async_commit();
    cp_async_wait<kWgStages - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }

  bf16* ob = dq + b * dqst.b + h * dqst.h;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int d = 8 * j + col;
    if (d >= D) continue;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * dqst.s + d) =
          __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * dqst.s + d) =
          __floats2bfloat162_rn(acc[4 * j + 2] * scale,
                                acc[4 * j + 3] * scale);
  }
}

// warpgroups of a dk/dv block
constexpr int kDkdvWgs = 2;

// The warpgroup's own barrier: every thread of warpgroup wg is here (named
// barrier 1 + wg of 128 threads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWgThreads)
               : "memory");
}

// dK and dV of one 64-key tile, summed over the group's query heads. The
// fragments as in the dq kernel, with keys as the rows and q rows as the
// columns of S^T and dP^T. Two warpgroups: warpgroup g takes the steps g,
// g + 2, ... of the (head, q tile) walk, each with its own ring and its own
// dK and dV, and warpgroup 0 adds warpgroup 1's to its own at the end, in
// that fixed order.
template <int DP>
__global__ void __launch_bounds__(kDkdvWgs * kWgThreads)
flash_bwd_dkdv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int D, int Hq, int causal,
                     float scale, float scale_log2, Strides qst, Strides kst,
                     Strides vst, Strides dost, Strides dkst, Strides dvst) {
  constexpr int kBytes = DP / 64 * kSwBlock;
  constexpr int kNO = DP / 2;
  extern __shared__ unsigned char smem_raw[];
  // K, V, then warpgroup g's stage s (n = g kWgStages + s): Q at sk +
  // kBytes (2 + 2 n), its dO after it; then each stage's lse and D of its
  // 64 q rows (2 x 64 f32 a stage, in the same order)
  const uint32_t sk = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sv = sk + kBytes;
  const uint32_t srow = sk + kBytes * (2 + 2 * kDkdvWgs * kWgStages);
  const float* rows_s =
      reinterpret_cast<const float*>(smem_raw + (srow - smem_addr(smem_raw)));

  const int k0 = blockIdx.x * kWgRows;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / gridDim.y;
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads, wtid = tid % kWgThreads;
  const int warp = wtid / 32, lane = tid % 32;
  // the q tiles that see this key tile, from its diagonal on when causal,
  // for each of the group's heads in turn: steps t = 0 .. n_steps - 1, this
  // warpgroup's t = 2 i + wg
  const int q_start = causal ? k0 : 0;
  const int n_q = (S - q_start + kWgRows - 1) / kWgRows;
  const int n_own = (group * n_q - wg + kDkdvWgs - 1) / kDkdvWgs;
  auto stage_of = [&](int i) { return wg * kWgStages + i % kWgStages; };
  auto slot = [&](int i) { return sk + kBytes * (2 + 2 * stage_of(i)); };
  auto issue = [&](int i) {
    const int t = kDkdvWgs * i + wg;
    const int h = hk * group + t / n_q;
    const int q0 = q_start + (t % n_q) * kWgRows, rows = min(kWgRows, S - q0);
    load_tile<DP, kWgThreads>(slot(i), q + b * qst.b + h * qst.h + q0 * qst.s,
                              qst.s, rows, D, wtid);
    load_tile<DP, kWgThreads>(
        slot(i) + kBytes, dout + b * dost.b + h * dost.h + q0 * dost.s,
        dost.s, rows, D, wtid);
    // threads 0 .. 63 of the warpgroup copy the rows' lse, 64 .. 127 their D
    const int r = wtid % kWgRows;
    const float* src = (wtid < kWgRows ? lse : dsum) +
                       ((long long)b * Hq + h) * S + min(q0 + r, S - 1);
    cp_async_4(srow + 4 * (2 * kWgRows * stage_of(i) + wtid), src,
               q0 + r < S ? 4 : 0);
  };
  const int k_rows = min(kWgRows, S - k0);
  load_tile<DP, kDkdvWgs * kWgThreads>(sk, k + b * kst.b + hk * kst.h + k0 * kst.s,
                                kst.s, k_rows, D, tid);
  load_tile<DP, kDkdvWgs * kWgThreads>(sv, v + b * vst.b + hk * vst.h + k0 * vst.s,
                                vst.s, k_rows, D, tid);
#pragma unroll
  for (int i = 0; i < kWgStages; ++i) {
    if (i < n_own) issue(i);
    cp_async_commit();
  }

  const int key0 = k0 + warp * 16 + lane / 4, key1 = key0 + 8;
  const int col = 2 * (lane % 4);
  float s[32], dp[32], adk[kNO], adv[kNO];
#pragma unroll
  for (int x = 0; x < kNO; ++x) adk[x] = adv[x] = 0.f;
  // the first stage (with K and V) has landed, for every thread
  cp_async_wait<kWgStages - 1>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  for (int i = 0; i < n_own; ++i) {
    const uint32_t qs = slot(i), dos = qs + kBytes;
    const float* lse_s = rows_s + 2 * kWgRows * stage_of(i);
    const float* dd_s = lse_s + kWgRows;
    const int q0 = q_start + ((kDkdvWgs * i + wg) % n_q) * kWgRows;
    const uint32_t k_s = opaque(sk), v_s = opaque(sv);

    // S^T = K Q^T (zeroed first, as in the dq kernel)
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = 0.f;
    pin(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kSwBlock + (kk % 4) * 32;
      wgmma_ss_m64n64(s, sw128_desc(k_s + off, 16, 1024),
                      sw128_desc(qs + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(s);

    // P^T, rounded to bf16: p[2 j] key row 0, p[2 j + 1] key row 1. Only a
    // tile that reaches past S, or the diagonal tile, has pairs to hide.
    const bool edge = q0 + kWgRows > S || (causal && q0 == k0);
    uint32_t p[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + col + e % 2, row = q0 + c;
        const bool ok =
            !edge || (row < S && (!causal || (e < 2 ? key0 : key1) <= row));
        x[e] = fast_exp2(fmaf(s[4 * j + e], scale_log2, -lse_s[c] * kLog2e) +
                         (ok ? 0.f : -INFINITY));
      }
      p[2 * j] = pack_bf16(x[0], x[1]);
      p[2 * j + 1] = pack_bf16(x[2], x[3]);
    }

    // dV += P^T dO (dO read MN-major), then dP^T = V dO^T, one commit group
#pragma unroll
    for (int x = 0; x < 32; ++x) dp[x] = 0.f;
    pin(adv);
    pin(p);
    pin(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
      const uint64_t db = sw128_desc(dos + kk * 16 * kSwRow, kSwBlock, 1024);
      if constexpr (DP == 64)
        wgmma_rs_m64n64(adv, a, db, 1);
      else
        wgmma_rs_m64n128(adv, a, db, 1);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kSwBlock + (kk % 4) * 32;
      wgmma_ss_m64n64(dp, sw128_desc(v_s + off, 16, 1024),
                      sw128_desc(dos + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(adv);
    pin(dp);

    // dS^T = P^T (dP^T - D), rounded to bf16 in P^T's registers; a q row
    // that sees one key contributes 0 (a factor, as in the dq kernel)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + col + e % 2, row = q0 + c;
        const float2 pp = unpack_bf16(p[2 * j + e / 2]);
        const float pe = e % 2 ? pp.y : pp.x;
        const float keep = (causal ? row == 0 : S == 1) ? 0.f : 1.f;
        x[e] = pe * (dp[4 * j + e] - dd_s[c]) * keep;
      }
      p[2 * j] = pack_bf16(x[0], x[1]);
      p[2 * j + 1] = pack_bf16(x[2], x[3]);
    }

    // dK += dS^T Q (Q read MN-major)
    pin(adk);
    pin(p);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
      const uint64_t db = sw128_desc(qs + kk * 16 * kSwRow, kSwBlock, 1024);
      if constexpr (DP == 64)
        wgmma_rs_m64n64(adk, a, db, 1);
      else
        wgmma_rs_m64n128(adk, a, db, 1);
    }
    wg_commit();
    wg_wait_all();
    pin(adk);

    // the warpgroup is done with this stage: refill it, and wait for the
    // next one to land
    wg_sync(wg);
    if (i + kWgStages < n_own) issue(i + kWgStages);
    cp_async_commit();
    cp_async_wait<kWgStages - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(wg);
  }

  // warpgroup 1 hands its dK and dV to warpgroup 0 through its own
  // ring's slots: element x of thread wtid at xs[x * 128 + wtid]
  cp_async_wait<0>();
  float* xs = reinterpret_cast<float*>(
                  smem_raw + (sk + kBytes * (2 + 2 * kWgStages) -
                              smem_addr(smem_raw))) +
              wtid;
  if (wg == 1) {
#pragma unroll
    for (int x = 0; x < kNO; ++x) {
      xs[x * kWgThreads] = adk[x];
      xs[(kNO + x) * kWgThreads] = adv[x];
    }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int x = 0; x < kNO; ++x) {
    adk[x] += xs[x * kWgThreads];
    adv[x] += xs[(kNO + x) * kWgThreads];
  }

  bf16* okb = dk + b * dkst.b + hk * dkst.h;
  bf16* ovb = dv + b * dvst.b + hk * dvst.h;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int d = 8 * j + col;
    if (d >= D) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = r ? key1 : key0;
      if (key >= S) continue;
      *reinterpret_cast<__nv_bfloat162*>(okb + key * dkst.s + d) =
          __floats2bfloat162_rn(adk[4 * j + 2 * r] * scale,
                                adk[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(ovb + key * dvst.s + d) =
          __floats2bfloat162_rn(adv[4 * j + 2 * r], adv[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool bad_shape(int B, int Hq, int Hkv, int S, int D, int dtype) {
  return B <= 0 || B > 65535 || S <= 0 || D <= 0 || D > kMaxHeadDim ||
         Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 ||
         (dtype != 0 && dtype != 1) || (dtype == 1 && D % 8 != 0);
}

float inv_sqrt(int D) { return (float)(1.0 / sqrt((double)D)); }
float inv_sqrt_log2(int D) {
  return (float)(1.4426950408889634 / sqrt((double)D));
}

// shared memory of a tensor-core kernel with n_wg warpgroups: two fixed
// 64-row tiles, each warpgroup's ring of two stages of two tiles, slack to
// align the first to 1024, and dk/dv's staged lse and D
template <int DP>
constexpr int wgmma_smem(int n_wg, int row_floats) {
  return DP / 64 * kSwBlock * (2 + 2 * n_wg * kWgStages) + 1024 +
         4 * row_floats;
}

int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* dsum, void* dq, int B,
              int Hq, int Hkv, int S, int D, int causal, Strides qst,
              Strides kst, Strides vst, Strides ost, Strides dost,
              Strides dqst, cudaStream_t stream) {
  static int smem_allowed = 48 * 1024;
  const int smem = smem_bytes(D);
  cudaError_t e = allow_smem(flash_bwd_dq_kernel, smem, &smem_allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kTile - 1) / kTile, Hq, B);
  flash_bwd_dq_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dsum), static_cast<float*>(dq), S, D, Hq / Hkv,
      causal, inv_sqrt(D), qst, kst, vst, ost, dost, dqst);
  return (int)cudaGetLastError();
}

int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* dsum, void* dk, void* dv, int B,
                int Hq, int Hkv, int S, int D, int causal, Strides qst,
                Strides kst, Strides vst, Strides dost, Strides dkst,
                Strides dvst, cudaStream_t stream) {
  static int smem_allowed = 48 * 1024;
  const int smem = smem_bytes(D);
  cudaError_t e = allow_smem(flash_bwd_dkdv_kernel, smem, &smem_allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kTile - 1) / kTile, Hkv, B);
  flash_bwd_dkdv_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<float*>(dk), static_cast<float*>(dv), S, D, Hq, causal,
      inv_sqrt(D), qst, kst, vst, dost, dkst, dvst);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lse,
                    void* dsum, void* dq, int B, int Hq, int Hkv, int S,
                    int D, int causal, Strides qst, Strides kst, Strides vst,
                    Strides ost, Strides dost, Strides dqst,
                    cudaStream_t stream) {
  static int smem_allowed = 48 * 1024;
  constexpr int smem = wgmma_smem<DP>(1, 0);
  cudaError_t e = allow_smem(flash_bwd_dq_wgmma<DP>, smem, &smem_allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kWgRows - 1) / kWgRows, Hq, B);
  flash_bwd_dq_wgmma<DP><<<grid, kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dsum), static_cast<bf16*>(dq), S, D, Hq / Hkv,
      causal, inv_sqrt(D), inv_sqrt_log2(D), qst, kst, vst, ost, dost, dqst);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkdv_wgmma(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dsum,
                      void* dk, void* dv, int B, int Hq, int Hkv, int S,
                      int D, int causal, Strides qst, Strides kst,
                      Strides vst, Strides dost, Strides dkst, Strides dvst,
                      cudaStream_t stream) {
  static int smem_allowed = 48 * 1024;
  constexpr int smem =
      wgmma_smem<DP>(kDkdvWgs, 2 * kWgRows * kDkdvWgs * kWgStages);
  cudaError_t e = allow_smem(flash_bwd_dkdv_wgmma<DP>, smem, &smem_allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kWgRows - 1) / kWgRows, Hkv, B);
  flash_bwd_dkdv_wgmma<DP><<<grid, kDkdvWgs * kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, D, Hq, causal,
      inv_sqrt(D), inv_sqrt_log2(D), qst, kst, vst, dost, dkst, dvst);
  return (int)cudaGetLastError();
}

}  // namespace

// The first backward kernel: dq, and D for the second. q, o, dout, dq: (B,
// Hq, S, D); k, v: (B, Hkv, S, D); each by its data pointer and its (batch,
// head, position) element strides, the last dimension contiguous. lse (the
// forward's) and dsum: contiguous f32 (B, Hq, S); dsum is written. dtype: 0
// = float32, on the CUDA cores; 1 = bfloat16, on the tensor cores, which
// also needs D % 8 == 0 and 16-byte aligned pointers and strides of q, k,
// v, o and dout (the wrapper checks them). Launches on `stream`, allocates
// nothing, and returns cudaGetLastError().
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
    return launch_dq(q, k, v, o, dout, lse, dsum, dq, B, Hq, Hkv, S, D,
                     causal, qst, kst, vst, ost, dost, dqst, s);
  if (D <= 64)
    return launch_dq_wgmma<64>(q, k, v, o, dout, lse, dsum, dq, B, Hq, Hkv,
                               S, D, causal, qst, kst, vst, ost, dost, dqst,
                               s);
  return launch_dq_wgmma<128>(q, k, v, o, dout, lse, dsum, dq, B, Hq, Hkv, S,
                              D, causal, qst, kst, vst, ost, dost, dqst, s);
}

// The second backward kernel: dk and dv, (B, Hkv, S, D), from the first's
// dsum; arguments and routes as above. Must run after it on the same stream.
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
    return launch_dkdv(q, k, v, dout, lse, dsum, dk, dv, B, Hq, Hkv, S, D,
                       causal, qst, kst, vst, dost, dkst, dvst, s);
  if (D <= 64)
    return launch_dkdv_wgmma<64>(q, k, v, dout, lse, dsum, dk, dv, B, Hq,
                                 Hkv, S, D, causal, qst, kst, vst, dost,
                                 dkst, dvst, s);
  return launch_dkdv_wgmma<128>(q, k, v, dout, lse, dsum, dk, dv, B, Hq, Hkv,
                                S, D, causal, qst, kst, vst, dost, dkst,
                                dvst, s);
}
