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

}  // namespace fesom
