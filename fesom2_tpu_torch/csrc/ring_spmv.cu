// ring_spmv: the SSH operator in node-ring form,
// y[n] = sum_k vals[k, n] * x[cols[k, n]], summed in the fixed order
// k = 0..Kr-1 (padded slots point at n itself with a zero value).
//
// Replaces fesom2_tpu/core/ssh.py:209-215 (RingOperator.__call__: one
// packed jnp.take over the [Kr, N] ring plus a sum; the 2-row stacked
// operand there is a TPU gather workaround and has no counterpart here).
//
// Bound on the card: bytes and latency.  Each node reads Kr (about 7)
// column indices and values, contiguous across nodes, and gathers Kr
// entries of x, which stays in L2 (368 KB in f64 at 46,000 nodes); one
// apply moves about 12 * Kr * N bytes, 3.9 MB at 46,000 nodes, so at this
// size the launch and the CG loop around it cost more than the traffic.
// Design: one thread per node, the k loop inside the thread, no atomics, so
// the result is deterministic and, with products rounded on their own
// (-fmad=false), bit-equal to the plain version's loop.  A column outside
// [0, N) is never read: it makes y[n] NaN.
#include "common.cuh"

namespace {

template <typename T>
__global__ void ring_spmv_kernel(const int* __restrict__ cols,
                                 const T* __restrict__ vals,
                                 const T* __restrict__ x, int kr, int n_nodes,
                                 T* __restrict__ y) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  T acc = T(0);
  bool bad = false;
  for (int k = 0; k < kr; ++k) {
    long long s = static_cast<long long>(k) * n_nodes + n;
    int c = cols[s];
    if (c < 0 || c >= n_nodes) {
      bad = true;
      continue;
    }
    acc += vals[s] * x[c];
  }
  y[n] = bad ? T(__longlong_as_double(0x7ff8000000000000LL)) : acc;
}

template <typename T>
void launch(const void* cols, const void* vals, const void* x, int kr, int n,
            void* y, cudaStream_t stream) {
  if (n == 0) return;
  ring_spmv_kernel<T><<<fesom::blocks_for(n), fesom::kThreads, 0, stream>>>(
      static_cast<const int*>(cols), static_cast<const T*>(vals),
      static_cast<const T*>(x), kr, n, static_cast<T*>(y));
}

}  // namespace

// cols [Kr, N] i32, vals [Kr, N], x [N], y [N]; vals, x, y of one dtype.
extern "C" int fesom_ring_spmv(const void* cols, const void* vals,
                               const void* x, int kr, int n, void* y,
                               int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    launch<double>(cols, vals, x, kr, n, y, s);
  else
    launch<float>(cols, vals, x, kr, n, y, s);
  return fesom::last_error();
}
