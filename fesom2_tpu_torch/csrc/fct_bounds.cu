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
// Bound on the card: bytes (compares only; the one rounding is the final
// subtraction), and in practice the 32-byte sectors its gathers pull
// through L2: on a mesh whose numbering is not local every gathered
// value costs a whole sector.  The first design ran two launches, an
// element pass that wrote two [T, L, E] scratch arrays (as many bytes as
// the function's own inputs and outputs) and a node pass of T x N threads
// that walked the levels with 2 K scratch gathers each: thin, and 24
// times over the byte bound.
//
// Design: one fused launch, no scratch.  The cluster bound of node n on
// level l is the max/min of max(lo, ttf) / min(lo, ttf) over the
// neighbour nodes of n (itself and the other vertices of its elements)
// that are wet on l and share an element wet on l with n; where a slot
// is padded, an element dry or a vertex dry, the filler -1e3 / +1e3
// joins in, as in a1-a3.  Which neighbours count on which levels is a
// level range per (node, neighbour), built once on the host
// (mesh/cluster.py): about 7 entries per node in place of 2 K scratch
// gathers over 3-vertex elements.  A block owns a tile of consecutive
// nodes, one tracer and a run of levels plus one level of halo on each
// side.  It stages lo and ttf of the tile's distinct neighbour nodes,
// level by level, into a ring of kStages shared-memory buffers with
// cp.async, two levels ahead of the one being reduced; each thread owns
// one node, reduces its entries from shared memory and carries a rolling
// window of three cluster bounds down the column, so the +-1 layer rule
// needs no second pass.  max and min carry a NaN through, so the result
// equals the plain version bit for bit.
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

// Shared memory, in this order: the rings of lo and of ttf
// [kStages][u_max] T each, the packed neighbour words [M][tile], the
// tile's neighbour node list [u_max].
template <typename T>
size_t shared_bytes(int tile, int m_max, int u_max) {
  return 2 * static_cast<size_t>(fesom::kStages) * u_max * sizeof(T) +
         static_cast<size_t>(m_max) * tile * sizeof(unsigned) +
         static_cast<size_t>(u_max) * sizeof(int);
}

template <typename T>
__global__ void fct_bounds_kernel(
    const T* __restrict__ ttf, const T* __restrict__ lo, int levels,
    int n_nodes, int m_max, const unsigned* __restrict__ slot,
    const unsigned* __restrict__ node_info,
    const int* __restrict__ nlevels_node, const int* __restrict__ tile_ptr,
    const int* __restrict__ tile_nodes, int u_max, int level_chunk, int chunks,
    T* __restrict__ inc_max, T* __restrict__ inc_min) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const T big = T(1e3);
  const int tile = blockDim.x;
  const int tid = threadIdx.x;
  T* lo_ring = reinterpret_cast<T*>(shared_raw);
  T* tt_ring = lo_ring + static_cast<size_t>(fesom::kStages) * u_max;
  unsigned* slot_s = reinterpret_cast<unsigned*>(
      tt_ring + static_cast<size_t>(fesom::kStages) * u_max);
  int* nodes_s = reinterpret_cast<int*>(slot_s + m_max * tile);

  const int n = blockIdx.x * tile + tid;
  const bool live = n < n_nodes;
  const int t = blockIdx.y / chunks;
  const int l0 = (blockIdx.y - t * chunks) * level_chunk;
  const int l1 = min(levels, l0 + level_chunk);
  // the levels read: the block's own and one above and below
  const int la = max(l0 - 1, 0);
  const int lb = min(l1 + 1, levels);
  const int first = tile_ptr[blockIdx.x];
  const int u = tile_ptr[blockIdx.x + 1] - first;
  const long long plane0 = static_cast<long long>(t) * levels * n_nodes;

  for (int j = 0; j < m_max; ++j)
    slot_s[j * tile + tid] =
        live ? slot[static_cast<long long>(j) * n_nodes + n] : 0u;
  for (int i = tid; i < u; i += tile) nodes_s[i] = tile_nodes[first + i];
  __syncthreads();

  auto stage = [&](int l) {
    if (l < lb) {
      long long o = plane0 + static_cast<long long>(l) * n_nodes;
      size_t b = static_cast<size_t>(l % fesom::kStages) * u_max;
      for (int i = tid; i < u; i += tile) {
        fesom::cp_async(lo_ring + b + i, lo + o + nodes_s[i]);
        fesom::cp_async(tt_ring + b + i, ttf + o + nodes_s[i]);
      }
    }
    fesom::cp_async_commit();
  };

  unsigned info = live ? node_info[n] : 0u;
  const int full_lo = info & 0xFFu, full_hi = (info >> 8) & 0xFFu;
  const int wet_lo = (info >> 16) & 0xFFu, wet_hi = info >> 24;
  const int last_interior = live ? nlevels_node[n] - 3 : -1;
  const int self = fesom::word_index(slot_s[tid]);  // entry 0 is the node

  // write level l from the cluster bounds above, on and below it
  auto emit = [&](int l, T up_max, T up_min, T cur_max, T cur_min, T dn_max,
                  T dn_min, T lo_self) {
    bool interior = l >= 1 && l <= last_interior;
    T bmax = interior ? vmax(cur_max, vmax(up_max, dn_max)) : cur_max;
    T bmin = interior ? vmin(cur_min, vmin(up_min, dn_min)) : cur_min;
    bool wet = l >= wet_lo && l < wet_hi;
    long long o = plane0 + static_cast<long long>(l) * n_nodes + n;
    inc_max[o] = wet ? bmax - lo_self : T(0);
    inc_min[o] = wet ? bmin - lo_self : T(0);
  };

  T up_max = -big, up_min = big, cur_max = -big, cur_min = big;
  T lo_cur = T(0);
  stage(la);
  stage(la + 1);
  for (int l = la; l < lb; ++l) {
    // every group but the newest has landed: level l is in its buffers
    fesom::cp_async_wait<fesom::kStages - 2>();
    __syncthreads();
    // all threads have left level l - 1, whose buffers level l + 2 takes
    stage(l + 2);
    if (!live) continue;
    size_t b = static_cast<size_t>(l % fesom::kStages) * u_max;
    const T* lo_s = lo_ring + b;
    const T* tt_s = tt_ring + b;
    // on the full levels no filler joins in: start from the node itself
    const bool full = l >= full_lo && l < full_hi;
    T dn_max = -big;
    T dn_min = big;
    for (int j = 0; j < m_max; ++j) {
      unsigned s = slot_s[j * tile + tid];
      int i = fesom::word_index(s);
      T a = lo_s[i];
      T c = tt_s[i];
      if (fesom::word_covers(s, l)) {
        T vx = vmax(a, c);
        T vn = vmin(a, c);
        bool start = full && j == 0;
        dn_max = start ? vx : vmax(dn_max, vx);
        dn_min = start ? vn : vmin(dn_min, vn);
      }
    }
    T lo_dn = lo_s[self];
    // level l - 1 has its three bounds now
    if (l - 1 >= l0)
      emit(l - 1, up_max, up_min, cur_max, cur_min, dn_max, dn_min, lo_cur);
    up_max = cur_max;
    up_min = cur_min;
    cur_max = dn_max;
    cur_min = dn_min;
    lo_cur = lo_dn;
  }
  // the bottom level of the column has nothing below it (never interior)
  if (live && lb == l1)
    emit(l1 - 1, up_max, up_min, cur_max, cur_min, cur_max, cur_min, lo_cur);
}

template <typename T>
cudaError_t launch(const void* ttf, const void* lo, int ntr, int levels,
                   int n_nodes, int m_max, const void* slot,
                   const void* node_info, const void* nlevels_node,
                   const void* tile_ptr, const void* tile_nodes, int tile,
                   int u_max, int level_chunk, void* inc_max, void* inc_min,
                   cudaStream_t stream) {
  if (static_cast<long long>(ntr) * levels * n_nodes == 0) return cudaSuccess;
  if (tile < 32 || tile > 1024 || level_chunk < 1 || u_max < 1 || m_max < 1)
    return cudaErrorInvalidValue;
  size_t bytes = shared_bytes<T>(tile, m_max, u_max);
  cudaError_t err = fesom::allow_shared(fct_bounds_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  int chunks = (levels + level_chunk - 1) / level_chunk;
  dim3 grid((n_nodes + tile - 1) / tile, ntr * chunks);
  fct_bounds_kernel<T><<<grid, tile, bytes, stream>>>(
      static_cast<const T*>(ttf), static_cast<const T*>(lo), levels, n_nodes,
      m_max, static_cast<const unsigned*>(slot),
      static_cast<const unsigned*>(node_info),
      static_cast<const int*>(nlevels_node), static_cast<const int*>(tile_ptr),
      static_cast<const int*>(tile_nodes), u_max, level_chunk, chunks,
      static_cast<T*>(inc_max), static_cast<T*>(inc_min));
  return cudaSuccess;
}

}  // namespace

// ttf, lo, inc_max, inc_min [ntr, levels, N]; slot [M, N], node_info [N],
// tile_ptr and tile_nodes as mesh/cluster.py packs them; tile nodes and
// level_chunk levels per block.
extern "C" int fesom_fct_bounds(const void* ttf, const void* lo, int ntr,
                                int levels, int n_nodes, int m_max,
                                const void* slot, const void* node_info,
                                const void* nlevels_node, const void* tile_ptr,
                                const void* tile_nodes, int tile, int u_max,
                                int level_chunk, void* inc_max, void* inc_min,
                                int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_double ? launch<double>(ttf, lo, ntr, levels, n_nodes, m_max, slot,
                                 node_info, nlevels_node, tile_ptr, tile_nodes,
                                 tile, u_max, level_chunk, inc_max, inc_min, s)
                : launch<float>(ttf, lo, ntr, levels, n_nodes, m_max, slot,
                                node_info, nlevels_node, tile_ptr, tile_nodes,
                                tile, u_max, level_chunk, inc_max, inc_min, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return fesom::last_error();
}
