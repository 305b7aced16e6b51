// elem_to_node_mean: area-weighted mean of an element field over each
// node's adjacent elements, per level:
//   out[r, l, n] = sum_k w * x[r, l, e_k] / max(sum_k w, 1e-30),
//   w = elem_area[e_k] * layer_mask[l, e_k]   (mask optional).
//
// Replaces fesom2_tpu/core/ops.py:328 elem_to_node_mean (respect_levels
// on: mask given; off: mask null) and ops.py:372 elem_to_node_mean_flat
// (levels = 1, mask null; its denominator is a sum of positive areas, so
// the 1e-30 floor never binds).  On the JAX side an XLA-lowered gather
// over the [N, K] nod_in_elem table.
//
// Bound on the card: bytes and latency.  Each output gathers K = 6
// irregular element values plus their areas and mask bytes for about 3
// flops each.  Design: one thread per (row, level, node), threads of a
// warp on consecutive nodes, so the table reads and the output write are
// contiguous and a level's element row (E values) is reused from L2 by
// the whole warp.  Slots are summed in the order k = 0..K-1 with no
// atomics; padded slots (-1) are skipped before the read.
#include "common.cuh"

namespace {

template <typename T>
__global__ void elem_to_node_mean_kernel(
    const T* __restrict__ x, int rows, int levels, int n_elems,
    const int* __restrict__ nod_in_elem, int n_nodes, int k_max,
    const T* __restrict__ elem_area, const bool* __restrict__ layer_mask,
    T* __restrict__ out) {
  long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  long long total = static_cast<long long>(rows) * levels * n_nodes;
  if (idx >= total) return;
  long long rl = idx / n_nodes;
  int n = static_cast<int>(idx - rl * n_nodes);
  int l = static_cast<int>(rl % levels);
  const T* xr = x + rl * n_elems;
  const bool* m = layer_mask ? layer_mask + static_cast<long long>(l) * n_elems
                             : nullptr;
  T num = T(0);
  T den = T(0);
  for (int k = 0; k < k_max; ++k) {
    int e = nod_in_elem[n * k_max + k];
    if (e < 0) continue;
    if (m && !m[e]) continue;
    T w = elem_area[e];
    num += xr[e] * w;
    den += w;
  }
  out[idx] = num / (den > T(1e-30) ? den : T(1e-30));
}

template <typename T>
void launch(const void* x, int rows, int levels, int n_elems,
            const void* nod_in_elem, int n_nodes, int k_max,
            const void* elem_area, const void* layer_mask, void* out,
            cudaStream_t stream) {
  long long n = static_cast<long long>(rows) * levels * n_nodes;
  if (n == 0) return;
  elem_to_node_mean_kernel<T>
      <<<fesom::blocks_for(n), fesom::kThreads, 0, stream>>>(
          static_cast<const T*>(x), rows, levels, n_elems,
          static_cast<const int*>(nod_in_elem), n_nodes, k_max,
          static_cast<const T*>(elem_area),
          static_cast<const bool*>(layer_mask), static_cast<T*>(out));
}

}  // namespace

extern "C" int fesom_elem_to_node_mean(const void* x, int rows, int levels,
                                       int n_elems, const void* nod_in_elem,
                                       int n_nodes, int k_max,
                                       const void* elem_area,
                                       const void* layer_mask, void* out,
                                       int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    launch<double>(x, rows, levels, n_elems, nod_in_elem, n_nodes, k_max,
                   elem_area, layer_mask, out, s);
  else
    launch<float>(x, rows, levels, n_elems, nod_in_elem, n_nodes, k_max,
                  elem_area, layer_mask, out, s);
  return fesom::last_error();
}
