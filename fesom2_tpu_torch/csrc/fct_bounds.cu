// fct_bounds: the admissible increments of the Zalesak FCT limiter
// (steps a1-a3, vlimit = 1), for T stacked tracers on [T, L, N]:
//   a1  node bounds   tmax = max(lo, ttf), tmin = min(lo, ttf) on wet
//                     cells, -1e3 / +1e3 elsewhere;
//   a2  element max/min over the 3 vertices (-1e3 / +1e3 on dry layers);
//   a3  cluster max/min over the node's adjacent elements (padded slots
//       give -1e3 / +1e3), widened by the layers above and below on
//       interior layers 1..nlevels_node-3;
//   inc_max = vmax - lo, inc_min = vmin - lo on wet cells, 0 elsewhere.
//
// Replaces fesom2_tpu/core/tracers.py:584-618 (the a1-a3 part of
// fct_limiter), which the JAX package runs as XLA-lowered gathers with
// the min side negated and stacked onto the max side.  Here max and min
// are carried side by side; the results are the same values exactly.
//
// Bound on the card: bytes and latency (gathers and compares only; no
// rounding happens apart from the final subtraction).  A NaN input
// propagates to the same outputs as in the plain version.  Design: two
// launches.  The element pass has one thread per (tracer, level, element)
// and writes the element bounds into wrapper-allocated scratch.  The node
// pass has one thread per (tracer, node) column and walks the levels top
// down with a rolling window of three cluster bounds, so the +-1 layer
// rule needs no third pass.  Threads of a warp sit on consecutive
// entities, so table reads and output writes are contiguous.  Padded
// slots (-1) are never read.
#include "common.cuh"

namespace {

// max/min that carry a NaN operand through, as torch.maximum/minimum and
// jnp.maximum/minimum do, so a blown-up state stays NaN on the card too.
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T vmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}

template <typename T>
__global__ void fct_elem_bounds_kernel(
    const T* __restrict__ ttf, const T* __restrict__ lo, int ntr, int levels,
    int n_nodes, int n_elems, const bool* __restrict__ node_layer_mask,
    const bool* __restrict__ elem_layer_mask,
    const int* __restrict__ elem_nodes, T* __restrict__ tep_max,
    T* __restrict__ tep_min) {
  const T big = T(1e3);
  long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  long long total = static_cast<long long>(ntr) * levels * n_elems;
  if (idx >= total) return;
  long long tl = idx / n_elems;
  int e = static_cast<int>(idx - tl * n_elems);
  int l = static_cast<int>(tl % levels);
  T emax = -big;
  T emin = big;
  if (elem_layer_mask[static_cast<long long>(l) * n_elems + e]) {
    const T* lo_r = lo + tl * n_nodes;
    const T* tt_r = ttf + tl * n_nodes;
    const bool* nm = node_layer_mask + static_cast<long long>(l) * n_nodes;
    for (int v = 0; v < 3; ++v) {
      int n = elem_nodes[e * 3 + v];
      T mx = -big;
      T mn = big;
      if (nm[n]) {
        mx = vmax(lo_r[n], tt_r[n]);
        mn = vmin(lo_r[n], tt_r[n]);
      }
      emax = v == 0 ? mx : vmax(emax, mx);
      emin = v == 0 ? mn : vmin(emin, mn);
    }
  }
  tep_max[idx] = emax;
  tep_min[idx] = emin;
}

template <typename T>
__device__ __forceinline__ void cluster(const T* __restrict__ tep_max,
                                        const T* __restrict__ tep_min,
                                        const int* __restrict__ nie, int k_max,
                                        T* cmax, T* cmin) {
  const T big = T(1e3);
  T mx = -big;
  T mn = big;
  for (int k = 0; k < k_max; ++k) {
    int e = nie[k];
    T vx = e >= 0 ? tep_max[e] : -big;
    T vn = e >= 0 ? tep_min[e] : big;
    mx = k == 0 ? vx : vmax(mx, vx);
    mn = k == 0 ? vn : vmin(mn, vn);
  }
  *cmax = mx;
  *cmin = mn;
}

template <typename T>
__global__ void fct_node_bounds_kernel(
    const T* __restrict__ lo, int ntr, int levels, int n_nodes, int n_elems,
    const bool* __restrict__ node_layer_mask,
    const int* __restrict__ nod_in_elem, int k_max,
    const int* __restrict__ nlevels_node, const T* __restrict__ tep_max,
    const T* __restrict__ tep_min, T* __restrict__ inc_max,
    T* __restrict__ inc_min) {
  long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= static_cast<long long>(ntr) * n_nodes) return;
  long long t = idx / n_nodes;
  int n = static_cast<int>(idx - t * n_nodes);
  const int* nie = nod_in_elem + static_cast<long long>(n) * k_max;
  int last_interior = nlevels_node[n] - 3;
  long long tplane_e = t * levels * static_cast<long long>(n_elems);
  long long tplane_n = t * levels * static_cast<long long>(n_nodes);

  T cur_max, cur_min;
  cluster(tep_max + tplane_e, tep_min + tplane_e, nie, k_max, &cur_max,
          &cur_min);
  T up_max = cur_max;
  T up_min = cur_min;
  for (int l = 0; l < levels; ++l) {
    T dn_max = cur_max;
    T dn_min = cur_min;
    if (l + 1 < levels) {
      long long o = tplane_e + static_cast<long long>(l + 1) * n_elems;
      cluster(tep_max + o, tep_min + o, nie, k_max, &dn_max, &dn_min);
    }
    bool interior = l >= 1 && l <= last_interior;
    T bmax = interior ? vmax(cur_max, vmax(up_max, dn_max)) : cur_max;
    T bmin = interior ? vmin(cur_min, vmin(up_min, dn_min)) : cur_min;
    long long o = tplane_n + static_cast<long long>(l) * n_nodes + n;
    bool wet = node_layer_mask[static_cast<long long>(l) * n_nodes + n];
    inc_max[o] = wet ? bmax - lo[o] : T(0);
    inc_min[o] = wet ? bmin - lo[o] : T(0);
    up_max = cur_max;
    up_min = cur_min;
    cur_max = dn_max;
    cur_min = dn_min;
  }
}

template <typename T>
void launch(const void* ttf, const void* lo, int ntr, int levels, int n_nodes,
            int n_elems, const void* node_layer_mask,
            const void* elem_layer_mask, const void* elem_nodes,
            const void* nod_in_elem, int k_max, const void* nlevels_node,
            void* tep_max, void* tep_min, void* inc_max, void* inc_min,
            cudaStream_t stream) {
  long long ne = static_cast<long long>(ntr) * levels * n_elems;
  long long nn = static_cast<long long>(ntr) * n_nodes;
  if (ne == 0 || nn == 0) return;
  fct_elem_bounds_kernel<T><<<fesom::blocks_for(ne), fesom::kThreads, 0,
                              stream>>>(
      static_cast<const T*>(ttf), static_cast<const T*>(lo), ntr, levels,
      n_nodes, n_elems, static_cast<const bool*>(node_layer_mask),
      static_cast<const bool*>(elem_layer_mask),
      static_cast<const int*>(elem_nodes), static_cast<T*>(tep_max),
      static_cast<T*>(tep_min));
  fct_node_bounds_kernel<T><<<fesom::blocks_for(nn), fesom::kThreads, 0,
                              stream>>>(
      static_cast<const T*>(lo), ntr, levels, n_nodes, n_elems,
      static_cast<const bool*>(node_layer_mask),
      static_cast<const int*>(nod_in_elem), k_max,
      static_cast<const int*>(nlevels_node), static_cast<const T*>(tep_max),
      static_cast<const T*>(tep_min), static_cast<T*>(inc_max),
      static_cast<T*>(inc_min));
}

}  // namespace

extern "C" int fesom_fct_bounds(const void* ttf, const void* lo, int ntr,
                                int levels, int n_nodes, int n_elems,
                                const void* node_layer_mask,
                                const void* elem_layer_mask,
                                const void* elem_nodes,
                                const void* nod_in_elem, int k_max,
                                const void* nlevels_node, void* tep_max,
                                void* tep_min, void* inc_max, void* inc_min,
                                int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    launch<double>(ttf, lo, ntr, levels, n_nodes, n_elems, node_layer_mask,
                   elem_layer_mask, elem_nodes, nod_in_elem, k_max,
                   nlevels_node, tep_max, tep_min, inc_max, inc_min, s);
  else
    launch<float>(ttf, lo, ntr, levels, n_nodes, n_elems, node_layer_mask,
                  elem_layer_mask, elem_nodes, nod_in_elem, k_max,
                  nlevels_node, tep_max, tep_min, inc_max, inc_min, s);
  return fesom::last_error();
}
