// Shared helpers of the hand-written kernels: launch geometry and the
// plain C calling convention (pointers as void*, an is_double flag, the
// stream last, cudaGetLastError() returned as int).
#pragma once
#include <cuda_runtime.h>

namespace fesom {

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

// Dynamic shared memory above 48 KB has to be asked for; a refusal (more
// than the card gives a block) is returned and surfaces in the wrapper.
// The runtime also keeps a refusal as its last error: it is taken off
// here, or the next launch's check would report it again.
template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// cp.async: one 4- or 8-byte value from global to shared memory without
// passing through a register; the copies of a stage form one group.
template <typename T>
__device__ __forceinline__ void cp_async(T* smem_dst, const T* gmem_src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte values");
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem_src), "n"(static_cast<int>(sizeof(T)))
               : "memory");
}
// cp.async of one 16-byte line (both addresses 16-byte aligned), past L1.
__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A packed table word: index | lo << 16 | hi << 24 (mesh/cluster.py).
__device__ __forceinline__ int word_index(unsigned w) { return w & 0xFFFFu; }
__device__ __forceinline__ bool word_covers(unsigned w, int level) {
  return level >= static_cast<int>((w >> 16) & 0xFFu) &&
         level < static_cast<int>(w >> 24);
}

constexpr int kStages = 3;  // planes in flight per block (cp.async ring)

}  // namespace fesom
