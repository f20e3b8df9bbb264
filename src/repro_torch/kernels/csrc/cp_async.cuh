// 16-byte asynchronous copies from device memory to shared memory
// (`cp.async.cg`, sm_80 and later), shared by the bf16 flash kernel
// (flash_attention.cu) and the split decode kernel (split_decode.cuh), and
// `allow_smem`, which every launch that stages more than 48 KB of shared
// memory calls (flash, split decode and the dominance kernels).
//
// A copy with src_bytes = 0 reads nothing and writes 16 zero bytes: the
// kernels use it for rows past their limit (kv_len, S, prefix_len) and for
// head-dim padding, so those rows are never loaded from device memory and
// whatever the memory holds there (stale rows, NaN) never reaches shared
// memory. `src` must then still be a valid pointer; the kernels pass the
// tile's first row. Source and destination must be 16-byte aligned, which
// the Python wrappers check before they launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_async {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Raise a kernel's dynamic shared memory limit to `bytes` (once per kernel
// and size) so that a launch above the 48 KB default is not refused.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes, int* done) {
  if (bytes <= *done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done = bytes;
  return e;
}

}  // namespace repro_async
