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

// Byte q of the result is 1 where y[q]'s sign bit is set, else 0: `prmt`
// with a selector nibble of 8 + i copies the sign of byte i into all eight
// bits, so two permutes take the top bytes' signs of y[0], y[1] and of
// y[2], y[3], a third joins them, and the mask keeps one bit a byte.
__device__ __forceinline__ uint32_t pack_signs(const uint32_t (&y)[4]) {
  uint32_t lo, hi, s;
  asm("prmt.b32 %0, %1, %2, 0x00FB;" : "=r"(lo) : "r"(y[0]), "r"(y[1]));
  asm("prmt.b32 %0, %1, %2, 0x00FB;" : "=r"(hi) : "r"(y[2]), "r"(y[3]));
  asm("prmt.b32 %0, %1, %2, 0x5410;" : "=r"(s) : "r"(lo), "r"(hi));
  return s & 0x01010101u;
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
// P = 4096, M = 3. In practice it is latency: few rows per thread, one
// dependent shared-memory load per objective.
//
// What the design does about it: one thread per column j holds F[j] in
// registers (the objective loop is unrolled, to M itself for M <= 8 and to
// 32 with a guard above, so the row stays in registers and the loop has no
// branch where it matters) and counts its dominators in a register; past
// 32 objectives (dominance_counts_chunked_kernel) it holds 32 at a time
// and keeps bits across the chunks.
// Each block of kCountThreads columns walks its share of the i rows in
// tiles of at most kCountTileI staged in shared memory (contiguous rows,
// read by every thread as a broadcast). The TPU grid's sequential i axis
// becomes that loop. A thread's row loop waits on a shared-memory load per
// objective, so the card needs many warps in flight: the i rows are split
// over gridDim.y blocks, in shares of a multiple of 32 rows, for about two
// blocks per SM in all, and the partial counts meet in one integer
// atomicAdd per column and block (the sum of integers is exact in any
// order). With one split the count is stored directly.
constexpr int kCountThreads = 128;
constexpr int kCountTileI = 256;
constexpr int kCountRowStep = 32;   // the rows of a split: a multiple of it

template <int kM>   // kM = M for 1 <= M <= 8; 0 for 9 <= M <= kChunkM
__global__ void __launch_bounds__(kCountThreads)
dominance_counts_kernel(const float* __restrict__ F, int* __restrict__ C,
                        int P, int M_any, int rows_per_split) {
  constexpr int kUnroll = kM > 0 ? kM : kChunkM;
  const int M = kM > 0 ? kM : M_any;
  __shared__ float fi[kCountTileI * kChunkM];
  const int j = blockIdx.x * kCountThreads + threadIdx.x;
  float fj[kUnroll];
#pragma unroll
  for (int m = 0; m < kUnroll; ++m)
    fj[m] = (j < P && m < M) ? F[(size_t)j * M + m] : 0.0f;
  const int i_begin = blockIdx.y * rows_per_split;
  const int i_end = min(P, i_begin + rows_per_split);
  int count = 0;
  for (int i0 = i_begin; i0 < i_end; i0 += kCountTileI) {
    const int ni = min(kCountTileI, i_end - i0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < ni * M; e += kCountThreads)
      fi[e] = F[(size_t)i0 * M + e];
    __syncthreads();
    if (j >= P) continue;
    for (int il = 0; il < ni; ++il) {
      bool le = true, lt = false;
#pragma unroll
      for (int m = 0; m < kUnroll; ++m) {
        if (kM > 0 || m < M) {
          const float a = fi[il * M + m];
          le &= a <= fj[m];
          lt |= a < fj[m];
        }
      }
      count += (le && lt) ? 1 : 0;
    }
  }
  if (j >= P) return;
  if (gridDim.y == 1)
    C[j] = count;
  else if (count)
    atomicAdd(&C[j], count);
}

// M > kChunkM: a thread holds kChunkM objectives of its column at a time,
// and for each row of the tile one bit of "all <=" and one of "any <"
// across the chunks, counted when every chunk is seen. Same block and grid
// as above.
__global__ void __launch_bounds__(kCountThreads)
dominance_counts_chunked_kernel(const float* __restrict__ F,
                                int* __restrict__ C, int P, int M,
                                int rows_per_split) {
  constexpr int kWords = kCountTileI / 32;   // a tile's rows, as bits
  __shared__ float fi[kCountTileI * kChunkM];
  const int j = blockIdx.x * kCountThreads + threadIdx.x;
  const int i_begin = blockIdx.y * rows_per_split;
  const int i_end = min(P, i_begin + rows_per_split);
  int count = 0;
  for (int i0 = i_begin; i0 < i_end; i0 += kCountTileI) {
    const int ni = min(kCountTileI, i_end - i0);
    uint32_t le[kWords], lt[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) le[w] = ~0u, lt[w] = 0u;
    for (int m0 = 0; m0 < M; m0 += kChunkM) {
      const int mc = min(kChunkM, M - m0);
      float fj[kChunkM];
#pragma unroll
      for (int m = 0; m < kChunkM; ++m)
        fj[m] = (j < P && m < mc) ? F[(size_t)j * M + m0 + m] : 0.0f;
      __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < ni * mc; e += kCountThreads) {
        const int il = e / mc, m = e - il * mc;
        fi[e] = F[(size_t)(i0 + il) * M + m0 + m];
      }
      __syncthreads();
      if (j >= P) continue;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        uint32_t e_bits = le[w], t_bits = lt[w];
        for (int b = 0; b < 32 && w * 32 + b < ni; ++b) {
          const float* a = fi + (w * 32 + b) * mc;
          bool l = true, t = false;
#pragma unroll
          for (int m = 0; m < kChunkM; ++m) {
            if (m < mc) {
              l &= a[m] <= fj[m];
              t |= a[m] < fj[m];
            }
          }
          e_bits &= ~((uint32_t)!l << b);
          t_bits |= (uint32_t)t << b;
        }
        le[w] = e_bits, lt[w] = t_bits;
      }
    }
    // rows past ni never set an "any <" bit
#pragma unroll
    for (int w = 0; w < kWords; ++w) count += __popc(le[w] & lt[w]);
  }
  if (j >= P) return;
  if (gridDim.y == 1)
    C[j] = count;
  else if (count)
    atomicAdd(&C[j], count);
}

template <int kM>
void launch_counts(const float* F, int* C, int P, int M, int rows, dim3 grid,
                   cudaStream_t s) {
  dominance_counts_kernel<kM><<<grid, kCountThreads, 0, s>>>(F, C, P, M,
                                                             rows);
}

}  // namespace

// F: (P, M) float32, contiguous, on the device. C: (P,) int32. Launches on
// `stream` (after zeroing C when the i rows are split), allocates nothing,
// and returns cudaGetLastError().
extern "C" int repro_dominance_counts(const void* F, void* C, int P, int M,
                                      void* stream) {
  if (P <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int col_blocks = (P + kCountThreads - 1) / kCountThreads;
  // about two blocks per SM in all, each split a multiple of 32 rows
  const int want = (2 * 132 + col_blocks - 1) / col_blocks;
  const int per = (P + want - 1) / want;
  const int rows = ((per + kCountRowStep - 1) / kCountRowStep) * kCountRowStep;
  const int splits = (P + rows - 1) / rows;
  if (splits > 1) {
    cudaError_t e = cudaMemsetAsync(C, 0, sizeof(int) * (size_t)P, s);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(col_blocks, splits);
  const float* f = static_cast<const float*>(F);
  int* c = static_cast<int*>(C);
  switch (M) {
    case 1: launch_counts<1>(f, c, P, M, rows, grid, s); break;
    case 2: launch_counts<2>(f, c, P, M, rows, grid, s); break;
    case 3: launch_counts<3>(f, c, P, M, rows, grid, s); break;
    case 4: launch_counts<4>(f, c, P, M, rows, grid, s); break;
    case 5: launch_counts<5>(f, c, P, M, rows, grid, s); break;
    case 6: launch_counts<6>(f, c, P, M, rows, grid, s); break;
    case 7: launch_counts<7>(f, c, P, M, rows, grid, s); break;
    case 8: launch_counts<8>(f, c, P, M, rows, grid, s); break;
    default:
      if (M <= kChunkM)
        launch_counts<0>(f, c, P, M, rows, grid, s);
      else
        dominance_counts_chunked_kernel<<<grid, kCountThreads, 0, s>>>(
            f, c, P, M, rows);
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
