// node_edge_reduce: signed sum of edge fluxes over each node's incident
// edges, out[r, n] = sum_k sign[n, k] * flux[r, node_edges[n, k]].
//
// Replaces fesom2_tpu/core/ops.py:154 edge_divergence and, with pair=1,
// ops.py:227 edge_signed_reduce2 (the FCT plus/minus sums from one pass:
// plus = sum max(v, 0), minus = sum min(v, 0)).  On the JAX side both are
// XLA-lowered gathers over the [N, KE] incidence tables.
//
// Bound on the card: bytes and latency.  Each output reads KE = 6 index
// and sign entries and gathers KE irregular flux values; there are two
// flops per gathered value.  Design: one thread per (row, node), threads
// of a warp on consecutive nodes of one row, so the index/sign reads and
// the output write are contiguous and the flux gathers of a row stay in
// L2 (one row of fluxes is Ed values, 69 KB in f64 at 8,575 edges).  The
// slots are summed in the fixed order k = 0..KE-1, with no atomics, so the
// result is deterministic.  Padded slots (-1) are skipped before the read.
#include "common.cuh"

namespace {

template <typename T, bool PAIR>
__global__ void node_edge_reduce_kernel(
    const T* __restrict__ flux, int rows, int n_edges,
    const int* __restrict__ node_edges, const T* __restrict__ sign,
    int n_nodes, int ke, T* __restrict__ out0, T* __restrict__ out1) {
  long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * n_nodes) return;
  int r = static_cast<int>(idx / n_nodes);
  int n = static_cast<int>(idx - static_cast<long long>(r) * n_nodes);
  const T* f = flux + static_cast<long long>(r) * n_edges;
  T acc = T(0);
  T acc_minus = T(0);
  for (int k = 0; k < ke; ++k) {
    int e = node_edges[n * ke + k];
    if (e < 0) continue;
    T v = f[e] * sign[n * ke + k];
    if (PAIR) {
      acc += v > T(0) ? v : T(0);
      acc_minus += v < T(0) ? v : T(0);
    } else {
      acc += v;
    }
  }
  out0[idx] = acc;
  if (PAIR) out1[idx] = acc_minus;
}

template <typename T>
void launch(const void* flux, int rows, int n_edges, const void* node_edges,
            const void* sign, int n_nodes, int ke, void* out0, void* out1,
            int pair, cudaStream_t stream) {
  long long n = static_cast<long long>(rows) * n_nodes;
  if (n == 0) return;
  unsigned int grid = fesom::blocks_for(n);
  if (pair) {
    node_edge_reduce_kernel<T, true><<<grid, fesom::kThreads, 0, stream>>>(
        static_cast<const T*>(flux), rows, n_edges,
        static_cast<const int*>(node_edges), static_cast<const T*>(sign),
        n_nodes, ke, static_cast<T*>(out0), static_cast<T*>(out1));
  } else {
    node_edge_reduce_kernel<T, false><<<grid, fesom::kThreads, 0, stream>>>(
        static_cast<const T*>(flux), rows, n_edges,
        static_cast<const int*>(node_edges), static_cast<const T*>(sign),
        n_nodes, ke, static_cast<T*>(out0), nullptr);
  }
}

}  // namespace

extern "C" int fesom_node_edge_reduce(const void* flux, int rows, int n_edges,
                                      const void* node_edges, const void* sign,
                                      int n_nodes, int ke, void* out0,
                                      void* out1, int pair, int is_double,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    launch<double>(flux, rows, n_edges, node_edges, sign, n_nodes, ke, out0,
                   out1, pair, s);
  else
    launch<float>(flux, rows, n_edges, node_edges, sign, n_nodes, ke, out0,
                  out1, pair, s);
  return fesom::last_error();
}

extern "C" const char* fesom_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
