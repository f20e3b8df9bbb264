// Pareto dominance matrix for NSGA-II survival selection, for Hopper (sm_90a).
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

}  // namespace

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
