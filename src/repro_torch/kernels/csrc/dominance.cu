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
// is negligible beside it, and the 2*P*P*M comparisons run far below the
// card's f32 rate. At P = 4096 the write is 16 MiB, about 5 us at 3.35 TB/s.
//
// What the design does about it:
//   * a 2-D grid of 64x64 output tiles, 256 threads a block; each block stages
//     its 64 i-rows and its 64 j-rows of F in shared memory once, so F is read
//     from device memory twice per tile and never per comparison;
//   * the j-rows are stored transposed (objective-major), so a thread reads
//     its four consecutive j values of one objective as one float4;
//   * each thread produces 4 consecutive j outputs of a row and writes them
//     as one 32-bit store: a warp writes 64 contiguous bytes of each of two
//     rows, so the write that bounds the kernel is coalesced. Where a row's
//     start is not 4-byte aligned (P not a multiple of 4) or the run crosses
//     the ragged edge, the thread writes single bytes instead;
//   * the ragged edge is masked in the kernel: rows and columns past P are
//     never written, and no padding of F is needed.
// It is a first, simple kernel; a faster one (wider stores, one block per SM
// walking many tiles) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // output tile is kTile x kTile
constexpr int kVec = 4;          // consecutive j outputs per thread
constexpr int kThreadsX = kTile / kVec;  // 16
constexpr int kThreadsY = 16;
constexpr int kMaxM = 32;        // objectives; checked by the wrapper

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
dominance_matrix_kernel(const float* __restrict__ F, uint8_t* __restrict__ D,
                        int P, int M) {
  __shared__ float fi[kTile][kMaxM + 1];             // row-major i-rows
  __shared__ __align__(16) float fjT[kMaxM][kTile];  // objective-major j-rows

  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int n_threads = kThreadsX * kThreadsY;

  for (int e = tid; e < kTile * M; e += n_threads) {
    const int r = e / M;
    const int m = e - r * M;
    const int gi = i0 + r;
    const int gj = j0 + r;
    fi[r][m] = gi < P ? F[(size_t)gi * M + m] : 0.0f;
    fjT[m][r] = gj < P ? F[(size_t)gj * M + m] : 0.0f;
  }
  __syncthreads();

  const int jl = threadIdx.x * kVec;
  const int gj = j0 + jl;
  if (gj >= P) return;

  for (int il = threadIdx.y; il < kTile; il += kThreadsY) {
    const int gi = i0 + il;
    if (gi >= P) break;
    bool le[kVec] = {true, true, true, true};
    bool lt[kVec] = {false, false, false, false};
    for (int m = 0; m < M; ++m) {
      const float a = fi[il][m];
      const float4 b = *reinterpret_cast<const float4*>(&fjT[m][jl]);
      le[0] &= a <= b.x; lt[0] |= a < b.x;
      le[1] &= a <= b.y; lt[1] |= a < b.y;
      le[2] &= a <= b.z; lt[2] |= a < b.z;
      le[3] &= a <= b.w; lt[3] |= a < b.w;
    }
    uint8_t* out = D + (size_t)gi * P + gj;
    if (gj + kVec <= P && (reinterpret_cast<uintptr_t>(out) & 3u) == 0) {
      uint32_t word = 0;
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        word |= (uint32_t)(le[v] && lt[v]) << (8 * v);
      *reinterpret_cast<uint32_t*>(out) = word;
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        if (gj + v < P) out[v] = (uint8_t)(le[v] && lt[v]);
    }
  }
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
// kMaxM with a guard above, so the row stays in registers and the loop has
// no branch where it matters) and counts its dominators in a register.
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

template <int kM>   // kM = M for 1 <= M <= 8; 0 for any M up to kMaxM
__global__ void __launch_bounds__(kCountThreads)
dominance_counts_kernel(const float* __restrict__ F, int* __restrict__ C,
                        int P, int M_any, int rows_per_split) {
  constexpr int kUnroll = kM > 0 ? kM : kMaxM;
  const int M = kM > 0 ? kM : M_any;
  __shared__ float fi[kCountTileI * kMaxM];
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
  if (P <= 0 || M <= 0 || M > kMaxM) return (int)cudaErrorInvalidValue;
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
    default: launch_counts<0>(f, c, P, M, rows, grid, s);
  }
  return (int)cudaGetLastError();
}

// F: (P, M) float32, contiguous, on the device. D: (P, P) uint8, contiguous.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError().
extern "C" int repro_dominance_matrix(const void* F, void* D, int P, int M,
                                      void* stream) {
  if (P <= 0 || M <= 0 || M > kMaxM) return (int)cudaErrorInvalidValue;
  const int nb = (P + kTile - 1) / kTile;
  dim3 grid(nb, nb);
  dim3 block(kThreadsX, kThreadsY);
  dominance_matrix_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(F), static_cast<uint8_t*>(D), P, M);
  return (int)cudaGetLastError();
}
