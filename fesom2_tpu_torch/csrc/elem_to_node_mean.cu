// elem_to_node_mean: area-weighted mean of an element field over each
// node's adjacent elements, per level:
//   out[r, l, n] = sum_k w * x[r, l, e_k] / max(sum_k w, 1e-30),
//   w = elem_area[e_k] where e_k is wet on level l (optional), else 0;
// a slot of weight 0 (padded, or dry on the level) contributes nothing.
//
// Replaces fesom2_tpu/core/ops.py:328 elem_to_node_mean (respect_levels
// on or off) and ops.py:372 elem_to_node_mean_flat (levels = 1, no mask;
// its denominator is a sum of positive areas, so the 1e-30 floor never
// binds).  On the JAX side an XLA-lowered gather over the [N, K]
// nod_in_elem table.
//
// Bound on the card: bytes, and in practice the 32-byte sectors its
// gathers pull through L2.  The work is 2 flops per gathered value.  On
// a mesh whose numbering is not local (the code-built globe: a warp's 32
// gathers of one slot hit 31 sectors) every gathered value costs a whole
// sector.  The first design (one thread per (row, level, node), K
// dependent gathers of index, mask byte, area and value behind two
// branches) ran an order above its byte bound, as slow in float32 as in
// float64 and no faster with the mask off.
//
// Design of the layered kernel.  What is constant down a column is read
// once: a block owns a tile of consecutive nodes and a run of levels, and
// keeps per (slot, node) the weight and one packed word (index into the
// tile's element list, wet range lo..hi) in shared memory, so the level
// mask is two integer compares and no area or mask is gathered again.
// The values are gathered once per tile, not once per slot: the tile's
// sorted list of distinct elements (mesh/cluster.py, built at setup; the
// globe's element ids around a tile are not contiguous, so a list, not a
// window) is staged plane by plane ((level, row) pairs) into a ring of
// kStages shared-memory buffers with cp.async, two planes ahead of the
// one being reduced; elements shared by nodes of the tile and values
// sharing a sector are fetched once.  Threads then gather from shared
// memory and sum the slots in the order k = 0..K-1, without atomics.
//
// The flat form (one plane, no level mask: nothing constant to reuse)
// keeps the first design, one thread per output, behind an entry of its
// own (fesom_elem_to_node_mean_flat).
#include "common.cuh"

namespace {

template <typename T>
__global__ void elem_to_node_mean_flat_kernel(
    const T* __restrict__ x, int rows, int n_elems,
    const int* __restrict__ nod_in_elem, int n_nodes, int k_max,
    const T* __restrict__ elem_area, T* __restrict__ out) {
  long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  long long total = static_cast<long long>(rows) * n_nodes;
  if (idx >= total) return;
  long long r = idx / n_nodes;
  int n = static_cast<int>(idx - r * n_nodes);
  const T* xr = x + r * n_elems;
  T num = T(0);
  T den = T(0);
  for (int k = 0; k < k_max; ++k) {
    int e = nod_in_elem[n * k_max + k];
    if (e < 0) continue;
    T w = elem_area[e];
    num += xr[e] * w;
    den += w;
  }
  out[idx] = num / (den > T(1e-30) ? den : T(1e-30));
}

// Shared memory of the tiled kernel, in this order: the value ring
// [kStages][u_max] T, the weights [K][tile] T, the packed slot words
// [K][tile], the tile's element list [u_max].
template <typename T>
size_t tiled_shared_bytes(int tile, int k_max, int u_max) {
  return static_cast<size_t>(fesom::kStages) * u_max * sizeof(T) +
         static_cast<size_t>(k_max) * tile * (sizeof(T) + sizeof(unsigned)) +
         static_cast<size_t>(u_max) * sizeof(int);
}

template <typename T>
__global__ void elem_to_node_mean_tiled_kernel(
    const T* __restrict__ x, int rows, int levels, int n_elems, int n_nodes,
    int k_max, const unsigned* __restrict__ slot, const T* __restrict__ weight,
    const int* __restrict__ tile_ptr, const int* __restrict__ tile_elems,
    int u_max, int level_chunk, int respect_levels, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const int tile = blockDim.x;
  const int tid = threadIdx.x;
  T* ring = reinterpret_cast<T*>(shared_raw);
  T* w_s = ring + static_cast<size_t>(fesom::kStages) * u_max;
  unsigned* slot_s = reinterpret_cast<unsigned*>(w_s + k_max * tile);
  int* elems_s = reinterpret_cast<int*>(slot_s + k_max * tile);

  const int n = blockIdx.x * tile + tid;
  const bool live = n < n_nodes;
  const int l0 = blockIdx.y * level_chunk;
  const int l1 = min(levels, l0 + level_chunk);
  const int first = tile_ptr[blockIdx.x];
  const int u = tile_ptr[blockIdx.x + 1] - first;
  const int planes = (l1 - l0) * rows;

  for (int k = 0; k < k_max; ++k) {
    long long o = static_cast<long long>(k) * n_nodes + n;
    slot_s[k * tile + tid] = live ? slot[o] : 0u;
    w_s[k * tile + tid] = live ? weight[o] : T(0);
  }
  for (int i = tid; i < u; i += tile) elems_s[i] = tile_elems[first + i];
  __syncthreads();

  // plane p of the block is (level l0 + p / rows, row p % rows)
  auto stage = [&](int p) {
    if (p < planes) {
      int l = l0 + p / rows;
      int r = p - (p / rows) * rows;
      const T* src = x + (static_cast<long long>(r) * levels + l) * n_elems;
      T* dst = ring + static_cast<size_t>(p % fesom::kStages) * u_max;
      for (int i = tid; i < u; i += tile)
        fesom::cp_async(dst + i, src + elems_s[i]);
    }
    fesom::cp_async_commit();
  };
  stage(0);
  stage(1);
  for (int p = 0; p < planes; ++p) {
    // every group but the newest has landed: plane p is in its buffer
    fesom::cp_async_wait<fesom::kStages - 2>();
    __syncthreads();
    // all threads have left plane p - 1, whose buffer plane p + 2 takes
    stage(p + 2);
    if (!live) continue;
    const T* val = ring + static_cast<size_t>(p % fesom::kStages) * u_max;
    int l = l0 + p / rows;
    int r = p - (p / rows) * rows;
    T num = T(0);
    T den = T(0);
    for (int k = 0; k < k_max; ++k) {
      unsigned s = slot_s[k * tile + tid];
      T w = w_s[k * tile + tid];
      if (respect_levels && !fesom::word_covers(s, l)) w = T(0);
      T v = val[fesom::word_index(s)];
      num += w != T(0) ? v * w : T(0);
      den += w;
    }
    out[(static_cast<long long>(r) * levels + l) * n_nodes + n] =
        num / (den > T(1e-30) ? den : T(1e-30));
  }
}

template <typename T>
cudaError_t launch_flat(const void* x, int rows, int n_elems,
                        const void* nod_in_elem, int n_nodes, int k_max,
                        const void* elem_area, void* out,
                        cudaStream_t stream) {
  long long n = static_cast<long long>(rows) * n_nodes;
  if (n == 0) return cudaSuccess;
  elem_to_node_mean_flat_kernel<T>
      <<<fesom::blocks_for(n), fesom::kThreads, 0, stream>>>(
          static_cast<const T*>(x), rows, n_elems,
          static_cast<const int*>(nod_in_elem), n_nodes, k_max,
          static_cast<const T*>(elem_area), static_cast<T*>(out));
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_tiled(const void* x, int rows, int levels, int n_elems,
                         int n_nodes, int k_max, const void* slot,
                         const void* weight, const void* tile_ptr,
                         const void* tile_elems, int tile, int u_max,
                         int level_chunk, int respect_levels, void* out,
                         cudaStream_t stream) {
  long long n = static_cast<long long>(rows) * levels * n_nodes;
  if (n == 0) return cudaSuccess;
  if (tile < 32 || tile > 1024 || level_chunk < 1 || u_max < 1)
    return cudaErrorInvalidValue;
  size_t bytes = tiled_shared_bytes<T>(tile, k_max, u_max);
  cudaError_t err =
      fesom::allow_shared(elem_to_node_mean_tiled_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n_nodes + tile - 1) / tile,
            (levels + level_chunk - 1) / level_chunk);
  elem_to_node_mean_tiled_kernel<T><<<grid, tile, bytes, stream>>>(
      static_cast<const T*>(x), rows, levels, n_elems, n_nodes, k_max,
      static_cast<const unsigned*>(slot), static_cast<const T*>(weight),
      static_cast<const int*>(tile_ptr), static_cast<const int*>(tile_elems),
      u_max, level_chunk, respect_levels, static_cast<T*>(out));
  return cudaSuccess;
}

}  // namespace

// A layered field x [rows, levels, E] on the tile tables (slot, weight
// [K, N]; tile_ptr, tile_elems): tile nodes and level_chunk levels per
// block; respect_levels = 0 ignores the wet ranges.
extern "C" int fesom_elem_to_node_mean(
    const void* x, int rows, int levels, int n_elems, int n_nodes, int k_max,
    const void* slot, const void* weight, const void* tile_ptr,
    const void* tile_elems, int tile, int u_max, int level_chunk,
    int respect_levels, void* out, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_double
          ? launch_tiled<double>(x, rows, levels, n_elems, n_nodes, k_max,
                                 slot, weight, tile_ptr, tile_elems, tile,
                                 u_max, level_chunk, respect_levels, out, s)
          : launch_tiled<float>(x, rows, levels, n_elems, n_nodes, k_max, slot,
                                weight, tile_ptr, tile_elems, tile, u_max,
                                level_chunk, respect_levels, out, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return fesom::last_error();
}

// Flat fields x [rows, E] on nod_in_elem [N, K] and elem_area [E].
extern "C" int fesom_elem_to_node_mean_flat(
    const void* x, int rows, int n_elems, const void* nod_in_elem,
    int n_nodes, int k_max, const void* elem_area, void* out, int is_double,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_double ? launch_flat<double>(x, rows, n_elems, nod_in_elem, n_nodes,
                                      k_max, elem_area, out, s)
                : launch_flat<float>(x, rows, n_elems, nod_in_elem, n_nodes,
                                     k_max, elem_area, out, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return fesom::last_error();
}
