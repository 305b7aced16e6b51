// elem_contrib_to_nodes: the FEM node assembly,
// out[r, n] = sum_k nie[n, k] >= 0 ? contrib[r, idx(n, k)] : 0, summed in
// the fixed order k = 0..K-1, where nie = nod_in_elem [N, K] names the
// elements around node n, slot = nod_in_elem_slot [N, K] the node's own
// vertex number in each, and idx = e * 3 + slot for contrib [R, E, 3] or
// slot * E + e for contrib [R, 3, E] (vertex-major).
//
// Replaces fesom2_tpu/core/ops.py:262-313 (_masked_gather_sum,
// elem_contrib_to_nodes, elem_contrib_to_nodes_3e: one jnp.take over the
// transposed [K, N] tables plus a masked sum; its chunking over K and the
// transposed tables are TPU layout and have no counterpart here).
//
// Bound on the card: bytes.  A call reads 3 E values a row, of which each
// is used once, and two int32 tables; on the sea-ice path R is 1 to 6 and
// the mesh a few hundred thousand elements, a few MB that stay in L2, so
// the launch costs as much as the traffic.  Design: one thread per (row,
// node), the k loop inside the thread, a padded slot (-1) never read, no
// atomics: deterministic and bit-equal to the plain version's loop.  An
// element or slot outside its range is never read: it makes out NaN.
#include "common.cuh"

namespace {

template <typename T>
__global__ void elem_contrib_to_nodes_kernel(
    const T* __restrict__ contrib, int rows, int n_elems,
    const int* __restrict__ nie, const int* __restrict__ nie_slot,
    int n_nodes, int k_max, int vertex_major, T* __restrict__ out) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(rows) * n_nodes) return;
  int r = static_cast<int>(i / n_nodes);
  int n = static_cast<int>(i - static_cast<long long>(r) * n_nodes);
  const T* row = contrib + static_cast<long long>(r) * 3 * n_elems;
  const int* ne = nie + static_cast<long long>(n) * k_max;
  const int* ns = nie_slot + static_cast<long long>(n) * k_max;
  T acc = T(0);
  bool bad = false;
  for (int k = 0; k < k_max; ++k) {
    int e = ne[k];
    if (e < 0) continue;
    int s = ns[k];
    if (e >= n_elems || s < 0 || s > 2) {
      bad = true;
      continue;
    }
    long long idx = vertex_major ? static_cast<long long>(s) * n_elems + e
                                 : static_cast<long long>(e) * 3 + s;
    acc += row[idx];
  }
  out[i] = bad ? T(__longlong_as_double(0x7ff8000000000000LL)) : acc;
}

template <typename T>
void launch(const void* contrib, int rows, int n_elems, const void* nie,
            const void* nie_slot, int n_nodes, int k_max, int vertex_major,
            void* out, cudaStream_t stream) {
  long long n = static_cast<long long>(rows) * n_nodes;
  if (n == 0) return;
  elem_contrib_to_nodes_kernel<T>
      <<<fesom::blocks_for(n), fesom::kThreads, 0, stream>>>(
          static_cast<const T*>(contrib), rows, n_elems,
          static_cast<const int*>(nie), static_cast<const int*>(nie_slot),
          n_nodes, k_max, vertex_major, static_cast<T*>(out));
}

}  // namespace

// contrib [rows, E, 3] (vertex_major = 0) or [rows, 3, E] (1);
// nod_in_elem, nod_in_elem_slot [N, K] i32; out [rows, N].
extern "C" int fesom_elem_contrib_to_nodes(
    const void* contrib, int rows, int n_elems, const void* nod_in_elem,
    const void* nod_in_elem_slot, int n_nodes, int k_max, int vertex_major,
    void* out, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    launch<double>(contrib, rows, n_elems, nod_in_elem, nod_in_elem_slot,
                   n_nodes, k_max, vertex_major, out, s);
  else
    launch<float>(contrib, rows, n_elems, nod_in_elem, nod_in_elem_slot,
                  n_nodes, k_max, vertex_major, out, s);
  return fesom::last_error();
}
