// ring_spmv: the SSH operator in node-ring form,
// y[n] = sum_k vals[k, n] * x[cols[k, n]], summed in the fixed order
// k = 0..Kr-1 (padded slots point at n itself with a zero value).
//
// Replaces fesom2_tpu/core/ssh.py:209-215 (RingOperator.__call__: one
// packed jnp.take over the [Kr, N] ring plus a sum; the 2-row stacked
// operand there is a TPU gather workaround and has no counterpart here).
//
// Bound on the card: bytes.  One apply reads the [Kr, N] column indices
// and values once (12 * Kr * N bytes in float64: 13.7 MB on the level-7
// globe's ALE ring, Kr = 10) and x, and writes y.  In the CG loop the
// tables come from device memory: between two applies the block
// preconditioner streams its inverses (482 MB on that globe) through L2.
// What a thread has to hide is therefore the latency of device memory,
// twice over: the table loads, then the gathers of x they point at.
//
// Design: one thread per node, no atomics.  Kr is a template parameter for
// the rings the repository's meshes give (8: the zstar channels' ALE ring,
// e.g. 46,000 nodes; 10: the level-7 globe's), so that a thread issues all
// of its 2 Kr table loads before the first gather and then all Kr gathers
// before the first add.  The tables are read with streaming, evict-first
// loads (ld.global.cs): each word is read once, and x, which every apply
// gathers from, keeps its place in L2.  One generic kernel serves any other
// Kr up to kMaxRing, eight slots at a time in the same order.  The sum
// starts from 0 and adds the slots in order with each product rounded on
// its own (-fmad=false), so it is bit-equal to the plain version's loop.
// A column outside [0, N) is never read: it makes y[n] NaN.
#include "common.cuh"

namespace {

constexpr int kMaxRing = 64;  // the generic kernel's largest Kr
constexpr int kChunk = 8;     // slots the generic kernel has in flight

template <typename T>
__device__ __forceinline__ T quiet_nan() {
  return T(__longlong_as_double(0x7ff8000000000000LL));
}

// Slots [k0, k0 + KN) of node n, KN known: loads, then gathers, then adds.
template <typename T, int KN>
__device__ __forceinline__ void ring_slots(const int* __restrict__ cols,
                                           const T* __restrict__ vals,
                                           const T* __restrict__ x, int k0,
                                           int n_nodes, int n, T& acc,
                                           bool& bad) {
  int c[KN];
  T v[KN];
#pragma unroll
  for (int k = 0; k < KN; ++k) {
    const long long s = static_cast<long long>(k0 + k) * n_nodes + n;
    c[k] = __ldcs(cols + s);
    v[k] = __ldcs(vals + s);
  }
  T g[KN];
#pragma unroll
  for (int k = 0; k < KN; ++k) {
    const bool ok = c[k] >= 0 && c[k] < n_nodes;
    bad |= !ok;
    g[k] = __ldg(x + (ok ? c[k] : n));
  }
#pragma unroll
  for (int k = 0; k < KN; ++k) acc += v[k] * g[k];
}

template <typename T, int KR>
__global__ void ring_spmv_fixed_kernel(const int* __restrict__ cols,
                                       const T* __restrict__ vals,
                                       const T* __restrict__ x, int n_nodes,
                                       T* __restrict__ y) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  T acc = T(0);
  bool bad = false;
  ring_slots<T, KR>(cols, vals, x, 0, n_nodes, n, acc, bad);
  y[n] = bad ? quiet_nan<T>() : acc;
}

template <typename T>
__global__ void ring_spmv_any_kernel(const int* __restrict__ cols,
                                     const T* __restrict__ vals,
                                     const T* __restrict__ x, int kr,
                                     int n_nodes, T* __restrict__ y) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  T acc = T(0);
  bool bad = false;
  int k0 = 0;
  for (; k0 + kChunk <= kr; k0 += kChunk)
    ring_slots<T, kChunk>(cols, vals, x, k0, n_nodes, n, acc, bad);
  for (; k0 < kr; ++k0)
    ring_slots<T, 1>(cols, vals, x, k0, n_nodes, n, acc, bad);
  y[n] = bad ? quiet_nan<T>() : acc;
}

template <typename T>
int launch(const void* cols, const void* vals, const void* x, int kr, int n,
           void* y, cudaStream_t stream) {
  if (kr < 1 || kr > kMaxRing) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int* c = static_cast<const int*>(cols);
  const T* v = static_cast<const T*>(vals);
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  const unsigned blocks = fesom::blocks_for(n);
  switch (kr) {
    case 8:
      ring_spmv_fixed_kernel<T, 8><<<blocks, fesom::kThreads, 0, stream>>>(
          c, v, xs, n, ys);
      break;
    case 10:
      ring_spmv_fixed_kernel<T, 10><<<blocks, fesom::kThreads, 0, stream>>>(
          c, v, xs, n, ys);
      break;
    default:
      ring_spmv_any_kernel<T><<<blocks, fesom::kThreads, 0, stream>>>(
          c, v, xs, kr, n, ys);
  }
  return fesom::last_error();
}

}  // namespace

// cols [Kr, N] i32, vals [Kr, N], x [N], y [N]; vals, x, y of one dtype;
// 1 <= Kr <= 64, else cudaErrorInvalidValue and nothing launched.
extern "C" int fesom_ring_spmv(const void* cols, const void* vals,
                               const void* x, int kr, int n, void* y,
                               int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) return launch<double>(cols, vals, x, kr, n, y, s);
  return launch<float>(cols, vals, x, kr, n, y, s);
}
