// Pareto dominance for NSGA-II, for Hopper (sm_90a): the dominance matrix
// of survival selection and the dominator counts.
//
// Replaces the TPU kernel `_dominance_tile_kernel` / `dominance_matrix_pallas`
// in src/repro/kernels/dominance.py. Same function:
//
//   D[i, j] = all_m(F[i, m] <= F[j, m]) && any_m(F[i, m] < F[j, m])
//
// over an f32 objective matrix F (P, M), written as one byte per entry. Every
// comparison is an f32 comparison, so a NaN compares false on both sides and
// its row neither dominates nor is dominated; equal rows (and the diagonal)
// give false because no objective is strictly smaller.
//
// What bounds it: the P*P byte write of the output. The P*M*4 byte read of F
// is negligible beside it, and the 2*P*P*M comparisons run below the card's
// f32 rate. At P = 4096 the write is 16 MiB, about 5 us at 3.35 TB/s. The
// instructions that make each byte come close behind: with 2M compares, a
// select and the byte packing an entry, issuing them took longer than the
// write.
//
// What the design does about it:
//   * a thread owns 16 consecutive columns j and keeps their objectives
//     resident for the whole block: in registers for M <= 8 (the objective
//     loop unrolled to M by a template, as the counts kernel below), read
//     from shared memory for 9 <= M <= 32 (<0>). A block stages its 512
//     columns' objectives once, by a coalesced copy, in a layout whose
//     16-byte reads hit distinct banks (a lane's 48 strided loads from
//     device memory cost more than all the compares). Past 32 objectives
//     (dominance_matrix_chunked_kernel) a block stages 32 at a time (80
//     KiB), keeps for a batch of 16 rows a warp a bit of "all <=" and one
//     of "any <" per column across the chunks, and stages each chunk again
//     for the next batch;
//   * the block's 8 warps walk a long run of rows i in turns, reading a
//     row's M values from shared memory as a broadcast, and end each row in
//     one 16-byte store of its 16 results: a warp writes 512 contiguous
//     bytes of a row per instruction, and consecutive rows' stores do not
//     depend on each other, so many are in flight;
//   * for finite objectives an entry costs M subtractions and two integer
//     operations, its byte packed by a byte permute (see the row loop); a
//     row or column with a NaN or an infinity takes the compares instead;
//   * the grid is (column strips of 512, row splits), chosen on the host
//     (kernels/dominance.py: dominance_grid) for about two blocks per SM at
//     P = 4096, so the staging latency is paid once per block, not once per
//     tile;
//   * plain stores: the front peel reads D again for every front, and
//     16 MiB stays in the 50 MB L2;
//   * the ragged edge is masked in the kernel: no padding of F or D, and
//     rows and columns past P are never written. A row's start i*P is
//     16-byte aligned only when P % 16 == 0, so each run of 16 bytes takes
//     the widest store its address allows (16, 8, 4 or 1 bytes), and a run
//     cut by the edge stores its valid bytes only.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kChunkM = 32;      // most objectives of <0>; chunk size past it
constexpr int kBatchRows = 16;   // rows a warp holds bits for past <0>
constexpr int kCols = 16;        // consecutive columns per thread
constexpr int kStrip = 32 * kCols;   // columns per block: a warp's 512
constexpr int kRowWarps = 8;     // warps per block, taking rows in turns
constexpr int kRowTile = 256;    // rows staged in shared memory at a time
constexpr int kLanePad = kCols + 4;          // a lane's staged columns
constexpr int kStripPad = 32 * kLanePad;     // floats per staged objective
constexpr int kMatrixThreads = 32 * kRowWarps;

// The 16 result bytes of one row's run (byte c of w for column j0 + c) to
// out, n of them valid (1 <= n <= 16): the widest stores that the address
// and n allow, and single bytes for the rest.
__device__ __forceinline__ void store_run(uint8_t* out, const uint32_t (&w)[4],
                                          int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(out);
  int done = 0;
  if (n == kCols && (a & 15u) == 0) {
    *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  if ((a & 7u) == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (8 * k + 8 <= n)
        *reinterpret_cast<uint2*>(out + 8 * k) = make_uint2(w[2 * k],
                                                            w[2 * k + 1]);
    done = n & ~7;
  } else if ((a & 3u) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * k + 4 <= n) *reinterpret_cast<uint32_t*>(out + 4 * k) = w[k];
    done = n & ~3;
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (c >= done && c < n) out[c] = (uint8_t)(w[c / 4] >> (8 * (c % 4)));
}

// Byte q of the result is 0xFF where y[q]'s sign bit is set, else 0:
// `prmt` with a selector nibble of 8 + i copies the sign of byte i into all
// eight bits, so two permutes take the top bytes' signs of y[0], y[1] and
// of y[2], y[3], and a third joins them.
__device__ __forceinline__ uint32_t sign_bytes(const uint32_t (&y)[4]) {
  uint32_t lo, hi, s;
  asm("prmt.b32 %0, %1, %2, 0x00FB;" : "=r"(lo) : "r"(y[0]), "r"(y[1]));
  asm("prmt.b32 %0, %1, %2, 0x00FB;" : "=r"(hi) : "r"(y[2]), "r"(y[3]));
  asm("prmt.b32 %0, %1, %2, 0x5410;" : "=r"(s) : "r"(lo), "r"(hi));
  return s;
}

// The same with one bit a byte: 1 where y[q]'s sign bit is set.
__device__ __forceinline__ uint32_t pack_signs(const uint32_t (&y)[4]) {
  return sign_bytes(y) & 0x01010101u;
}

// Objectives [m0, m0 + mc) of columns [strip0, strip0 + 512) into shared
// memory by one coalesced copy (contiguous when mc == M), objective-major,
// each lane's 16 columns padded to 20 floats so that the lanes' 16-byte
// reads of them fall in distinct banks; -0 becomes +0 (it compares equal to
// +0 anyway) and columns past P zeros.
__device__ __forceinline__ void stage_columns(float* fT,
                                              const float* __restrict__ F,
                                              int P, int M, int strip0,
                                              int m0, int mc) {
  const int ncol = min(kStrip, P - strip0);
  const float* src = F + (size_t)strip0 * M + m0;
  for (int e = threadIdx.x; e < kStrip * mc; e += kMatrixThreads) {
    const int c = e / mc, m = e - c * mc;
    fT[m * kStripPad + (c / kCols) * kLanePad + c % kCols] =
        c < ncol ? src[mc == M ? e : c * M + m] + 0.0f : 0.0f;
  }
}

// Block (strip, split): columns [strip * 512, strip * 512 + 512), rows
// [split * rows_per_split, ...) of D; its 8 warps share the columns and take
// the rows in turns. kM = M for 1 <= M <= 8 (the column objectives in
// registers); 0 for 9 <= M <= kChunkM (read from shared memory per row,
// M * kStripPad floats of dynamic shared memory).
template <int kM>
__global__ void __launch_bounds__(kMatrixThreads)
dominance_matrix_kernel(const float* __restrict__ F, uint8_t* __restrict__ D,
                        int P, int M_any, int rows_per_split) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int strip0 = blockIdx.x * kStrip;
  const int j0 = strip0 + lane * kCols;
  const int n = min(kCols, P - j0);        // this thread's valid columns
  const int i_begin = blockIdx.y * rows_per_split;
  const int i_end = min(P, i_begin + rows_per_split);
  const int lane_off = lane * kLanePad;

  if constexpr (kM > 0) {
    __shared__ __align__(16) float fT[kM * kStripPad];
    __shared__ float frow[kRowTile * kM];   // a tile of the split's rows
    stage_columns(fT, F, P, kM, strip0, 0, kM);
    float fj[kM][kCols];
    bool cols_finite = true;
    for (int t0 = i_begin; t0 < i_end; t0 += kRowTile) {
      const int nt = min(kRowTile, i_end - t0);
      __syncthreads();  // the columns are staged; the previous tile is read
      for (int e = threadIdx.x; e < nt * kM; e += kMatrixThreads)
        frow[e] = F[(size_t)t0 * kM + e] + 0.0f;
      __syncthreads();
      if (t0 == i_begin) {
#pragma unroll
        for (int m = 0; m < kM; ++m)
#pragma unroll
          for (int k = 0; k < kCols / 4; ++k) {
            const float4 x = *reinterpret_cast<const float4*>(
                fT + m * kStripPad + lane_off + 4 * k);
            fj[m][4 * k] = x.x, fj[m][4 * k + 1] = x.y;
            fj[m][4 * k + 2] = x.z, fj[m][4 * k + 3] = x.w;
            cols_finite &= isfinite(x.x) && isfinite(x.y) && isfinite(x.z) &&
                           isfinite(x.w);
          }
      }
      if (n <= 0) continue;
      for (int r = warp; r < nt; r += kRowWarps) {
        float a[kM];
        bool row_finite = true;
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          a[m] = frow[r * kM + m];   // the same address in every lane
          row_finite &= isfinite(a[m]);
        }
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (row_finite && cols_finite) {
          // Finite, and no -0: b - a is negative iff a > b and +0 iff
          // a == b (an IEEE difference is 0 only for equal operands, and
          // its sign is exact), so the OR x of the M differences' bits,
          // read as an int, is positive iff a <= b in every objective and
          // a < b in one; x is never INT_MIN (that is -0 alone), so -x has
          // its sign bit set exactly then. M subtractions on the FMA pipe
          // and two integer operations an entry, and three byte permutes
          // that pack four signs, in place of 2M compares and a select.
#pragma unroll
          for (int k = 0; k < kCols / 4; ++k) {
            uint32_t y[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              int x = 0;
#pragma unroll
              for (int m = 0; m < kM; ++m)
                x |= __float_as_int(fj[m][4 * k + q] - a[m]);
              y[q] = 0u - (uint32_t)x;
            }
            w[k] = pack_signs(y);
          }
        } else {
          // a NaN or an infinity: the comparisons themselves
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            bool lt = false;
#pragma unroll
            for (int m = 0; m < kM; ++m) lt |= a[m] < fj[m][c];
            bool dom = lt;
#pragma unroll
            for (int m = 0; m < kM; ++m) dom &= a[m] <= fj[m][c];
            w[c / 4] |= (uint32_t)dom << (8 * (c % 4));
          }
        }
        store_run(D + (size_t)(t0 + r) * P + j0, w, n);
      }
    }
  } else {
    const int M = M_any;
    extern __shared__ __align__(16) float fT[];   // M x kStripPad
    stage_columns(fT, F, P, M, strip0, 0, M);
    __syncthreads();
    if (n <= 0) return;
    for (int i = i_begin + warp; i < i_end; i += kRowWarps) {
      bool le[kCols], lt[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) le[c] = true, lt[c] = false;
      for (int m = 0; m < M; ++m) {
        const float a = __ldg(F + (size_t)i * M + m);
        const float4* b =
            reinterpret_cast<const float4*>(fT + m * kStripPad + lane_off);
#pragma unroll
        for (int k = 0; k < kCols / 4; ++k) {
          const float4 x = b[k];
          le[4 * k] &= a <= x.x, lt[4 * k] |= a < x.x;
          le[4 * k + 1] &= a <= x.y, lt[4 * k + 1] |= a < x.y;
          le[4 * k + 2] &= a <= x.z, lt[4 * k + 2] |= a < x.z;
          le[4 * k + 3] &= a <= x.w, lt[4 * k + 3] |= a < x.w;
        }
      }
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        w[c / 4] |= (uint32_t)(le[c] && lt[c]) << (8 * (c % 4));
      store_run(D + (size_t)i * P + j0, w, n);
    }
  }
}

// M > kChunkM: the objectives kChunkM at a time, each chunk staged again
// for every batch of rows. For each of up to kBatchRows rows a warp keeps
// one bit per column of "all <=" and one of "any <" across the chunks, and
// stores the rows when every chunk is seen. Same block and grid as above;
// kChunkM * kStripPad floats of dynamic shared memory.
__global__ void __launch_bounds__(kMatrixThreads)
dominance_matrix_chunked_kernel(const float* __restrict__ F,
                                uint8_t* __restrict__ D, int P, int M,
                                int rows_per_split) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int strip0 = blockIdx.x * kStrip;
  const int j0 = strip0 + lane * kCols;
  const int n = min(kCols, P - j0);        // this thread's valid columns
  const int i_begin = blockIdx.y * rows_per_split;
  const int i_end = min(P, i_begin + rows_per_split);
  const int lane_off = lane * kLanePad;
  extern __shared__ __align__(16) float fT[];   // kChunkM x kStripPad
  for (int b0 = i_begin; b0 < i_end; b0 += kRowWarps * kBatchRows) {
    uint32_t le[kBatchRows], lt[kBatchRows];
#pragma unroll
    for (int r = 0; r < kBatchRows; ++r) le[r] = 0xFFFFu, lt[r] = 0u;
    for (int m0 = 0; m0 < M; m0 += kChunkM) {
      const int mc = min(kChunkM, M - m0);
      __syncthreads();  // every warp is done with the previous chunk
      stage_columns(fT, F, P, M, strip0, m0, mc);
      __syncthreads();
      if (n <= 0) continue;
#pragma unroll
      for (int r = 0; r < kBatchRows; ++r) {
        const int i = b0 + r * kRowWarps + warp;
        if (i < i_end) {
          uint32_t e = le[r], t = lt[r];
          for (int m = 0; m < mc; ++m) {
            const float a = __ldg(F + (size_t)i * M + m0 + m);
            const float4* b = reinterpret_cast<const float4*>(
                fT + m * kStripPad + lane_off);
            uint32_t em = 0u, tm = 0u;
#pragma unroll
            for (int k = 0; k < kCols / 4; ++k) {
              const float4 x = b[k];
              em |= (uint32_t)(a <= x.x) << (4 * k) |
                    (uint32_t)(a <= x.y) << (4 * k + 1) |
                    (uint32_t)(a <= x.z) << (4 * k + 2) |
                    (uint32_t)(a <= x.w) << (4 * k + 3);
              tm |= (uint32_t)(a < x.x) << (4 * k) |
                    (uint32_t)(a < x.y) << (4 * k + 1) |
                    (uint32_t)(a < x.z) << (4 * k + 2) |
                    (uint32_t)(a < x.w) << (4 * k + 3);
            }
            e &= em, t |= tm;
          }
          le[r] = e, lt[r] = t;
        }
      }
    }
    if (n <= 0) continue;
#pragma unroll
    for (int r = 0; r < kBatchRows; ++r) {
      const int i = b0 + r * kRowWarps + warp;
      if (i < i_end) {
        const uint32_t dom = le[r] & lt[r];
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          w[c / 4] |= ((dom >> c) & 1u) << (8 * (c % 4));
        store_run(D + (size_t)i * P + j0, w, n);
      }
    }
  }
}

template <int kM>
int launch_matrix(const float* F, uint8_t* D, int P, int M, int rows,
                  dim3 grid, cudaStream_t s) {
  int smem = 0;
  if constexpr (kM == 0) {
    static int smem_allowed = 48 * 1024;
    smem = (int)sizeof(float) * M * kStripPad;
    cudaError_t e = repro_async::allow_smem(dominance_matrix_kernel<kM>,
                                            smem, &smem_allowed);
    if (e != cudaSuccess) return (int)e;
  }
  dominance_matrix_kernel<kM><<<grid, kMatrixThreads, smem, s>>>(F, D, P, M,
                                                                  rows);
  return (int)cudaGetLastError();
}

int launch_matrix_chunked(const float* F, uint8_t* D, int P, int M, int rows,
                          dim3 grid, cudaStream_t s) {
  static int smem_allowed = 48 * 1024;
  const int smem = (int)sizeof(float) * kChunkM * kStripPad;
  cudaError_t e = repro_async::allow_smem(dominance_matrix_chunked_kernel,
                                          smem, &smem_allowed);
  if (e != cudaSuccess) return (int)e;
  dominance_matrix_chunked_kernel<<<grid, kMatrixThreads, smem, s>>>(
      F, D, P, M, rows);
  return (int)cudaGetLastError();
}

// Dominator counts: C[j] = #{i : D[i, j]}, the column sums of the matrix
// above, without storing it.
//
// Replaces the TPU kernel `_dominance_counts_kernel` /
// `dominance_counts_pallas` in src/repro/kernels/dominance.py, which
// accumulates over i blocks per j block in its output block and pads F
// with +inf rows. Here the ragged edge is masked (no padding) and NaN
// compares false as above, so counts are exact integers.
//
// What bounds it: 2 * P * P * M f32 comparisons against a P*M*4 byte read
// and a P*4 byte write: operations, ~1.5 us of the card's f32 rate at
// P = 4096, M = 3. In practice, at large P, the issue of ~6.6
// instructions an entry (M subtractions on the FMA pipe, the integer work
// below on the ALU), which the loop below issues at well under the card's
// rate (PERF.md); at small P, the launch and the memory round trips.
//
// What the design does about it:
//   * up to 1,024 rows (dominance_counts_ballot_kernel) the work is too
//     small for the loop below to matter: a call is its launch and a few
//     dependent memory round trips. A lane holds one row, so a block holds
//     every row (a warp per 32), and owns 4 or 8 columns: for each column a
//     warp votes with `__ballot_sync` which of its rows dominate it and
//     counts them with `__popc`, the warps' counts meet in shared memory,
//     and each count is stored once. The comparisons themselves, so no
//     value needs a special path (-0 equals +0, NaN compares false). One
//     load of the rows and columns, one barrier, one pass;
//   * past 1,024 rows a thread owns 8 consecutive columns j and keeps
//     their objectives in registers (M <= 8, the loops unrolled to M by a
//     template; dominance_counts_kernel); a block
//     owns `groups` such groups (8, 16 or 32 columns) and all P rows: its
//     512 threads are the groups times 512 / groups row phases, a phase
//     taking every (512 / groups)-th row of a tile staged in shared memory,
//     two rows at a time. The tiles are double-buffered (the next tile's
//     loads are in flight while this one is counted) and each block starts
//     on its own tile, so that the blocks' loads spread over L2. A row's M
//     values are one or two 16-byte loads that serve 8 entries, whose
//     chains are independent;
//   * for finite objectives an entry costs M subtractions and a few
//     integer operations, as in the matrix kernel: x, the OR of the
//     differences' bits, is positive iff row i dominates column j, so the
//     sign of -x is the answer. `sign_bytes` packs four of them as 0xFF
//     bytes into a word that one add puts into four byte counters. The
//     counters then hold 255 * n mod 2^32 for the word n of the four
//     counts, so a multiply by 255's inverse reads n back, exact while no
//     count passes 255: they are flushed into 32-bit counts every
//     kCountFlush tiles, at most 128 rows a thread. A tile, or a thread's
//     columns, with a NaN or an infinity takes the comparisons instead;
//   * there, past 8 objectives (dominance_counts_chunked_kernel), the
//     block's columns and a batch of rows are staged in shared memory, 32
//     objectives at a time, and a thread keeps x for its 2 rows of the
//     batch by its 8 columns across the chunks;
//   * a block ends with its counts: the row phases' sums meet by warp
//     shuffles, then across the 16 warps in shared memory, and each count
//     is stored once. No block depends on another, so a call is one
//     launch: no memset, no atomics, no state kept between calls, and
//     integer sums in a fixed order. The host picks the kernel and its
//     block (kernels/dominance.py: dominance_counts_grid): past 1,024 rows
//     the widest block whose grid covers three quarters of the SMs in one
//     wave (an SM holds one block; P / 32 blocks at P = 4096, each reading
//     F once from L2).
constexpr int kCountCols = 8;                  // consecutive columns a thread
constexpr int kCountThreads = 512;             // 16 warps
constexpr int kCountWarps = kCountThreads / 32;
constexpr int kMaxGroups = 4;                  // a block: 8, 16 or 32 columns
constexpr int kCountTileBytes = 16384;         // a staged tile of rows
constexpr int kCountFlush = 16;                // tiles between flushes
constexpr int kCountLanePad = kCountCols + 4;  // a group's staged columns
constexpr int kCountBatch = 2;                 // rows a thread holds, M > 8
// rows a thread counts between flushes, at most: a tile of 4-float rows
// over the 128 phases of 4 groups, kCountFlush times
static_assert(kCountFlush * (kCountTileBytes / 16) * kMaxGroups /
                  kCountThreads <= 255,
              "byte counters would wrap");
constexpr uint32_t kInv255 = 0xFEFEFEFFu;      // 255 * kInv255 == 1 mod 2^32
constexpr int kBallotRows = 1024;              // a lane a row, one block
constexpr int kCountsBallot = 0, kCountsTiles = 1;   // the host's kernel

// P <= kBallotRows: columns [b * kCols, (b + 1) * kCols) against every row,
// a lane a row. kM = M for 1 <= M <= 8 (the lane's row in registers, the
// block's columns staged in shared memory); 0 past 8 (both read from L1 as
// the objectives are compared).
template <int kM, int kCols>
__global__ void __launch_bounds__(kBallotRows)
dominance_counts_ballot_kernel(const float* __restrict__ F,
                               int* __restrict__ C, int P, int M_any) {
  __shared__ float colv[kCols * (kM > 0 ? kM : 1)];
  __shared__ int red[kBallotRows / 32][kCols];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i = threadIdx.x, j0 = blockIdx.x * kCols;
  const int ncol = min(kCols, P - j0);   // the same in every lane
  int mine = 0;   // lane c: the warp's rows dominating column j0 + c
  if constexpr (kM > 0) {
    float a[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m)   // rows past P: NaN, which dominates none
      a[m] = i < P ? F[(size_t)i * kM + m] : __int_as_float(0x7FC00000);
    for (int e = threadIdx.x; e < ncol * kM; e += blockDim.x)
      colv[e] = F[(size_t)j0 * kM + e];
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c >= ncol) break;
      bool le = true, lt = false;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float b = colv[c * kM + m];   // the same address: a broadcast
        le &= a[m] <= b;
        lt |= a[m] < b;
      }
      const int n = __popc(__ballot_sync(0xFFFFFFFFu, le && lt));
      if (lane == c) mine = n;
    }
  } else {
    // an objective of the lane's row against it in each column at once
    const int M = M_any;
    bool le[kCols], lt[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) le[c] = i < P, lt[c] = false;
    if (i < P) {
      const float* row = F + (size_t)i * M;
      const float* col = F + (size_t)j0 * M;   // the block's columns
#pragma unroll 2
      for (int m = 0; m < M; ++m) {
        const float a = __ldg(row + m);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          // the same address in every lane: a broadcast
          const float b = c < ncol ? __ldg(col + (size_t)c * M + m) : 0.0f;
          le[c] &= a <= b;
          lt[c] |= a < b;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c >= ncol) break;
      const int n = __popc(__ballot_sync(0xFFFFFFFFu, le[c] && lt[c]));
      if (lane == c) mine = n;
    }
  }
  if (lane < kCols) red[warp][lane] = mine;
  __syncthreads();
  if (threadIdx.x < ncol) {
    int sum = 0;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) sum += red[w][threadIdx.x];
    C[j0 + threadIdx.x] = sum;
  }
}

template <int kCols>
void launch_ballot(const float* f, int* c, int P, int M, int blocks,
                   cudaStream_t s) {
  const int threads = 32 * ((P + 31) / 32);
  switch (M) {
#define REPRO_BALLOT(kM)                                          \
  case kM:                                                        \
    dominance_counts_ballot_kernel<kM, kCols>                     \
        <<<blocks, threads, 0, s>>>(f, c, P, M);                  \
    break;
    REPRO_BALLOT(1) REPRO_BALLOT(2) REPRO_BALLOT(3) REPRO_BALLOT(4)
    REPRO_BALLOT(5) REPRO_BALLOT(6) REPRO_BALLOT(7) REPRO_BALLOT(8)
#undef REPRO_BALLOT
    default:
      dominance_counts_ballot_kernel<0, kCols><<<blocks, threads, 0, s>>>(
          f, c, P, M);
  }
}

// One thread's rows of a staged tile (phase, phase + phases, ... < nt)
// against its columns fj, into the byte counters acc (byte k of acc[q]:
// 255 x the rows dominating column 4q + k), two rows at a time for
// independent work (the second masked out past nt). kFast: the
// subtraction test; else the comparisons.
template <int kM, int kRow, bool kFast>
__device__ __forceinline__ void count_tile(const float (&fj)[kM][kCountCols],
                                           const float* tile, int phase,
                                           int phases, int nt,
                                           uint32_t (&acc)[kCountCols / 4]) {
  for (int r = phase; r < nt; r += 2 * phases) {
    const int rows[2] = {r, min(r + phases, nt - 1)};
    const uint32_t keep = r + phases < nt ? ~0u : 0u;
    float a[2][kM];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < kRow / 4; ++k) {
        const float4 v4 =
            reinterpret_cast<const float4*>(tile)[rows[h] * (kRow / 4) + k];
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int m = 4 * k; m < 4 * k + 4; ++m)
          if (m < kM) a[h][m] = v[m - 4 * k];
      }
#pragma unroll
    for (int q = 0; q < kCountCols / 4; ++q) {
      uint32_t y[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = 4 * q + k;
          if constexpr (kFast) {
            // the matrix kernel's subtraction test (see its row loop)
            int x = 0;
#pragma unroll
            for (int m = 0; m < kM; ++m)
              x |= __float_as_int(fj[m][c] - a[h][m]);
            y[h][k] = 0u - (uint32_t)x;
          } else {
            bool lt = false, le = true;
#pragma unroll
            for (int m = 0; m < kM; ++m) {
              lt |= a[h][m] < fj[m][c];
              le &= a[h][m] <= fj[m][c];
            }
            y[h][k] = (uint32_t)(le && lt) << 31;
          }
        }
      acc[q] += sign_bytes(y[0]) + (sign_bytes(y[1]) & keep);
    }
  }
}

// The block's counts: each thread's 8 counts summed over the row phases
// (the lanes of a warp with its group, by shuffles, then the 16 warps in
// shared memory, `red`), one store a column.
__device__ __forceinline__ void store_counts(int (&count)[kCountCols],
                                             int (*red)[kMaxGroups *
                                                        kCountCols],
                                             int* __restrict__ C, int P,
                                             int groups) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 1; o < 32; o *= 2)
    if (o >= groups)   // the 8 shuffles of a step are independent
#pragma unroll
      for (int c = 0; c < kCountCols; ++c)
        count[c] += __shfl_xor_sync(0xFFFFFFFFu, count[c], o);
  if (lane < groups)
#pragma unroll
    for (int c = 0; c < kCountCols; ++c) red[warp][lane * kCountCols + c] =
        count[c];
  __syncthreads();
  const int width = groups * kCountCols, j = blockIdx.x * width + threadIdx.x;
  if (threadIdx.x < width && j < P) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kCountWarps; ++w) sum += red[w][threadIdx.x];
    C[j] = sum;
  }
}

// Block b: columns [b * 8 * groups, (b + 1) * 8 * groups), every row.
// kM = M, 1 <= M <= 8.
template <int kM>
__global__ void __launch_bounds__(kCountThreads)
dominance_counts_kernel(const float* __restrict__ F, int* __restrict__ C,
                        int P, int groups) {
  constexpr int kRow = kM <= 4 ? 4 : 8;              // floats a staged row
  constexpr int kTile = kCountTileBytes / (4 * kRow);  // 1024 or 512 rows
  constexpr int kPre = (kTile * kM + kCountThreads - 1) / kCountThreads;
  __shared__ __align__(16) float tile[2][kTile * kRow];
  __shared__ __align__(16) float colT[kMaxGroups * kCountCols * kRow];
  __shared__ int red[kCountWarps][kMaxGroups * kCountCols];
  const int g = threadIdx.x % groups;
  const int phase = threadIdx.x / groups, phases = kCountThreads / groups;
  // a tile's values, loaded into registers before they are stored
  float pre[kPre];
  auto load = [&](int t0) {
    const int n = min(kTile, P - t0) * kM;
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      const int e = threadIdx.x + k * kCountThreads;
      pre[k] = e < n ? F[(size_t)t0 * kM + e] : 0.0f;
    }
  };
  auto store = [&](float* t) {
    bool finite = true;
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      const int e = threadIdx.x + k * kCountThreads;
      const float v = pre[k] + 0.0f;   // -0 becomes +0
      if (e < kTile * kM) t[(e / kM) * kRow + e % kM] = v;
      finite &= isfinite(v);
    }
    return __syncthreads_and(finite) != 0;
  };
  // the blocks start on different tiles, so that their loads spread
  // over L2 instead of all asking for the same lines at once
  const int ntiles = (P + kTile - 1) / kTile, first = blockIdx.x % ntiles;
  auto tile_row = [&](int n) {   // n < ntiles
    const int t = first + n;
    return (t < ntiles ? t : t - ntiles) * kTile;
  };
  // the block's columns: one coalesced load, staged with the first tile
  const int width = groups * kCountCols, col0 = blockIdx.x * width;
  const int ncol = min(width, P - col0) * kM;
  const float col = threadIdx.x < ncol ? F[(size_t)col0 * kM + threadIdx.x]
                                       : 0.0f;   // columns past P: zeros
  load(tile_row(0));
  if (threadIdx.x < width * kM)
    colT[threadIdx.x / kM * kRow + threadIdx.x % kM] = col + 0.0f;
  bool rows_finite = store(tile[0]);
  float fj[kM][kCountCols];   // the thread's columns, in registers
  bool cols_finite = true;
#pragma unroll
  for (int c = 0; c < kCountCols; ++c)
#pragma unroll
    for (int k = 0; k < kRow / 4; ++k) {
      const float4 v4 = reinterpret_cast<const float4*>(
          colT)[(g * kCountCols + c) * (kRow / 4) + k];
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int m = 4 * k; m < 4 * k + 4; ++m)
        if (m < kM) {
          fj[m][c] = v[m - 4 * k];
          cols_finite &= isfinite(v[m - 4 * k]);
        }
    }
  int count[kCountCols];
#pragma unroll
  for (int c = 0; c < kCountCols; ++c) count[c] = 0;
  uint32_t acc[kCountCols / 4] = {};
  for (int n = 0; n < ntiles; ++n) {
    const bool more = n + 1 < ntiles;
    if (more) load(tile_row(n + 1));   // in flight while this one is counted
    const float* t = tile[n & 1];
    const int nt = min(kTile, P - tile_row(n));
    if (rows_finite && cols_finite)
      count_tile<kM, kRow, true>(fj, t, phase, phases, nt, acc);
    else
      count_tile<kM, kRow, false>(fj, t, phase, phases, nt, acc);
    if (n % kCountFlush == kCountFlush - 1 || !more) {
#pragma unroll
      for (int q = 0; q < kCountCols / 4; ++q) {
        const uint32_t w = acc[q] * kInv255;   // four counts of <= 128
#pragma unroll
        for (int k = 0; k < 4; ++k) count[4 * q + k] += (w >> (8 * k)) & 0xFFu;
        acc[q] = 0u;
      }
    }
    // the other buffer was last read before the previous barrier
    if (more) rows_finite = store(tile[(n + 1) & 1]);
  }
  store_counts(count, red, C, P, groups);
}

// One chunk of mc objectives, staged, into the words x of a thread's
// kCountBatch rows of the batch (phase, phase + phases) by its columns.
// kFast: the differences' bits; else the comparisons' word (all ones where
// not a <= b, else 1 where a < b), which x reads the same way: neither is
// ever INT_MIN, nor is an OR of them.
template <bool kFast>
__device__ __forceinline__ void chunk_words(
    uint32_t (&x)[kCountBatch][kCountCols], const float* colT,
    const float* rowT, int stride, int phase, int phases, int mc) {
  for (int m = 0; m < mc; ++m) {
    float b[kCountCols];
#pragma unroll
    for (int k = 0; k < kCountCols / 4; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(
          colT + m * kMaxGroups * kCountLanePad + 4 * k);
      b[4 * k] = v.x, b[4 * k + 1] = v.y;
      b[4 * k + 2] = v.z, b[4 * k + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < kCountBatch; ++k) {
      const float a = rowT[(phase + k * phases) * stride + m];
#pragma unroll
      for (int c = 0; c < kCountCols; ++c) {
        if constexpr (kFast)
          x[k][c] |= (uint32_t)__float_as_int(b[c] - a);
        else
          x[k][c] |= (0u - (uint32_t)!(a <= b[c])) | (uint32_t)(a < b[c]);
      }
    }
  }
}

// M > 8: the block's columns and a batch of kCountBatch * phases rows are
// staged in shared memory, 32 objectives at a time (a group's 8 columns
// padded to 12 floats, a row to mc + 1), and a thread ORs the words of
// every chunk into x for its rows by its columns, counting the rows whose
// x is positive when every chunk is seen. A chunk with a NaN or an
// infinity among its staged values takes the comparisons. Same block and
// grid as above; dynamic shared memory for min(M, 32) objectives of the
// columns and of the batch.
__global__ void __launch_bounds__(kCountThreads)
dominance_counts_chunked_kernel(const float* __restrict__ F,
                                int* __restrict__ C, int P, int M,
                                int groups) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int red[kCountWarps][kMaxGroups * kCountCols];
  const int mmax = min(M, kChunkM);
  const int g = threadIdx.x % groups;
  const int phase = threadIdx.x / groups, phases = kCountThreads / groups;
  const int batch = kCountBatch * phases;
  const int width = groups * kCountCols, col0 = blockIdx.x * width;
  float* colT = smem;                  // mmax x kMaxGroups * kCountLanePad
  float* rowT = smem + mmax * kMaxGroups * kCountLanePad;   // batch rows
  int count[kCountCols];
#pragma unroll
  for (int c = 0; c < kCountCols; ++c) count[c] = 0;
  for (int b0 = 0; b0 < P; b0 += batch) {
    uint32_t x[kCountBatch][kCountCols];
#pragma unroll
    for (int k = 0; k < kCountBatch; ++k)
#pragma unroll
      for (int c = 0; c < kCountCols; ++c) x[k][c] = 0u;
    for (int m0 = 0; m0 < M; m0 += kChunkM) {
      const int mc = min(kChunkM, M - m0), stride = mc + 1;
      __syncthreads();  // every thread is done with the previous chunk
      bool finite = true;
      for (int e = threadIdx.x; e < width * mc; e += kCountThreads) {
        const int c = e / mc, m = e - c * mc;
        const float v =
            col0 + c < P ? F[(size_t)(col0 + c) * M + m0 + m] + 0.0f : 0.0f;
        colT[m * kMaxGroups * kCountLanePad + (c / kCountCols) *
             kCountLanePad + c % kCountCols] = v;
        finite &= isfinite(v);
      }
      for (int e = threadIdx.x; e < batch * mc; e += kCountThreads) {
        const int r = e / mc, m = e - r * mc;
        const float v =
            b0 + r < P ? F[(size_t)(b0 + r) * M + m0 + m] + 0.0f : 0.0f;
        rowT[r * stride + m] = v;
        finite &= isfinite(v);
      }
      const float* cg = colT + g * kCountLanePad;
      if (__syncthreads_and(finite))
        chunk_words<true>(x, cg, rowT, stride, phase, phases, mc);
      else
        chunk_words<false>(x, cg, rowT, stride, phase, phases, mc);
    }
#pragma unroll
    for (int k = 0; k < kCountBatch; ++k)
      if (b0 + phase + k * phases < P)
#pragma unroll
        for (int c = 0; c < kCountCols; ++c)
          count[c] += (0u - x[k][c]) >> 31;
  }
  store_counts(count, red, C, P, groups);
}

}  // namespace

// F: (P, M) float32, contiguous, on the device. C: (P,) int32: every entry
// is written once and none is read. The kernel and grid are the host's
// (kernels/dominance.py: dominance_counts_grid): `blocks` of `cols` columns,
// for kCountsBallot (P <= 1,024) 4 or 8, for kCountsTiles 8, 16 or 32; a
// grid that does not cover P exactly is refused. One launch on `stream`,
// nothing allocated; returns cudaGetLastError().
extern "C" int repro_dominance_counts(const void* F, void* C, int P, int M,
                                      int kernel, int blocks, int cols,
                                      void* stream) {
  if (P <= 0 || M <= 0 || cols <= 0 || blocks != (P + cols - 1) / cols)
    return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(F);
  int* c = static_cast<int*>(C);
  cudaStream_t s = (cudaStream_t)stream;
  if (kernel == kCountsBallot) {
    if (P > kBallotRows) return (int)cudaErrorInvalidValue;
    if (cols == 4)
      launch_ballot<4>(f, c, P, M, blocks, s);
    else if (cols == 8)
      launch_ballot<8>(f, c, P, M, blocks, s);
    else
      return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  const int groups = cols / kCountCols;
  if (kernel != kCountsTiles || cols % kCountCols ||
      (groups != 1 && groups != 2 && groups != 4))
    return (int)cudaErrorInvalidValue;
  switch (M) {
#define REPRO_COUNTS(kM)                                                  \
  case kM:                                                                \
    dominance_counts_kernel<kM><<<blocks, kCountThreads, 0, s>>>(f, c, P, \
                                                                 groups); \
    break;
    REPRO_COUNTS(1) REPRO_COUNTS(2) REPRO_COUNTS(3) REPRO_COUNTS(4)
    REPRO_COUNTS(5) REPRO_COUNTS(6) REPRO_COUNTS(7) REPRO_COUNTS(8)
#undef REPRO_COUNTS
    default: {
      static int smem_allowed = 48 * 1024;
      const int mmax = M < kChunkM ? M : kChunkM;
      const int smem = (int)sizeof(float) *
                       (mmax * kMaxGroups * kCountLanePad +
                        kCountBatch * kCountThreads / groups * (mmax + 1));
      const cudaError_t e = repro_async::allow_smem(
          dominance_counts_chunked_kernel, smem, &smem_allowed);
      if (e != cudaSuccess) return (int)e;
      dominance_counts_chunked_kernel<<<blocks, kCountThreads, smem, s>>>(
          f, c, P, M, groups);
    }
  }
  return (int)cudaGetLastError();
}

// F: (P, M) float32, contiguous, on the device. D: (P, P) uint8, contiguous,
// 16-byte aligned. The grid is the host's (kernels/dominance.py:
// dominance_grid): the columns in `strips` of 512, the rows in `splits` runs
// of `rows_per_split`; a grid that does not cover P exactly is refused.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError().
extern "C" int repro_dominance_matrix(const void* F, void* D, int P, int M,
                                      int strips, int splits,
                                      int rows_per_split, void* stream) {
  if (P <= 0 || M <= 0 || rows_per_split <= 0 ||
      strips != (P + kStrip - 1) / kStrip ||
      splits != (P + rows_per_split - 1) / rows_per_split || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(strips, splits);
  const float* f = static_cast<const float*>(F);
  uint8_t* d = static_cast<uint8_t*>(D);
  const int r = rows_per_split;
  cudaStream_t s = (cudaStream_t)stream;
  switch (M) {
    case 1: return launch_matrix<1>(f, d, P, M, r, grid, s);
    case 2: return launch_matrix<2>(f, d, P, M, r, grid, s);
    case 3: return launch_matrix<3>(f, d, P, M, r, grid, s);
    case 4: return launch_matrix<4>(f, d, P, M, r, grid, s);
    case 5: return launch_matrix<5>(f, d, P, M, r, grid, s);
    case 6: return launch_matrix<6>(f, d, P, M, r, grid, s);
    case 7: return launch_matrix<7>(f, d, P, M, r, grid, s);
    case 8: return launch_matrix<8>(f, d, P, M, r, grid, s);
    default:
      return M <= kChunkM ? launch_matrix<0>(f, d, P, M, r, grid, s)
                          : launch_matrix_chunked(f, d, P, M, r, grid, s);
  }
}
