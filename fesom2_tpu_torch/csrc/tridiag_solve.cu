// tridiag_solve: batched Thomas algorithm over vertical columns,
// tridiag(a, b, c) x = d with a sub-, b main- and c super-diagonal along
// the level axis of [B, L, X] arrays.
//
// Replaces fesom2_tpu/core/ops.py:389 tridiag_solve (two lax.scans over
// the level axis).  Forward: m = b - cp_prev * a, cp = c / m,
// dp = (d - dp_prev * a) / m; backward: x = dp - cp * x_next, from
// cp_prev = dp_prev = x_next = 0: the same divisions in the same order as
// the scan.  a, b, c ([L, X]) are shared by the B right-hand sides: u and
// v of one column system, or tracers that share one diffusivity.
//
// Bound on the card: bytes.  Each column reads 4 L values and writes 2 L
// values (cp into a scratch array, dp then x into the output), with a
// handful of flops and 2 divisions per level; the column sweep is
// sequential.  Design: one thread per column (b, x); at level l a warp
// reads 32 consecutive columns, so every load and store is contiguous in
// the [L, X] layout.
#include "common.cuh"

namespace {

template <typename T>
__global__ void tridiag_solve_kernel(const T* __restrict__ a,
                                     const T* __restrict__ b,
                                     const T* __restrict__ c,
                                     const T* __restrict__ d, int batch,
                                     int levels, int cols, T* __restrict__ cp,
                                     T* __restrict__ x) {
  long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= static_cast<long long>(batch) * cols) return;
  long long bb = idx / cols;
  long long col = idx - bb * cols;
  long long plane = static_cast<long long>(levels) * cols;
  long long off = bb * plane + col;
  T cp_prev = T(0);
  T dp_prev = T(0);
  for (int l = 0; l < levels; ++l) {
    long long i = static_cast<long long>(l) * cols;
    T al = a[col + i];
    T m = b[col + i] - cp_prev * al;
    T cpl = c[col + i] / m;
    T dpl = (d[off + i] - dp_prev * al) / m;
    cp[off + i] = cpl;
    x[off + i] = dpl;
    cp_prev = cpl;
    dp_prev = dpl;
  }
  T x_next = T(0);
  for (int l = levels - 1; l >= 0; --l) {
    long long i = static_cast<long long>(l) * cols;
    T xl = x[off + i] - cp[off + i] * x_next;
    x[off + i] = xl;
    x_next = xl;
  }
}

template <typename T>
void launch(const void* a, const void* b, const void* c, const void* d,
            int batch, int levels, int cols, void* cp, void* x,
            cudaStream_t stream) {
  long long n = static_cast<long long>(batch) * cols;
  if (n == 0) return;
  tridiag_solve_kernel<T><<<fesom::blocks_for(n), fesom::kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const T*>(d), batch,
      levels, cols, static_cast<T*>(cp), static_cast<T*>(x));
}

}  // namespace

extern "C" int fesom_tridiag_solve(const void* a, const void* b, const void* c,
                                   const void* d, int batch, int levels,
                                   int cols, void* cp, void* x, int is_double,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    launch<double>(a, b, c, d, batch, levels, cols, cp, x, s);
  else
    launch<float>(a, b, c, d, batch, levels, cols, cp, x, s);
  return fesom::last_error();
}
