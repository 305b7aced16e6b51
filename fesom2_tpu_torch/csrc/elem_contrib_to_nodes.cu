// elem_contrib_to_nodes: the FEM node assembly,
// out[r, n] = sum_k contrib[r, idx(n, k)] over the used slots k of node n,
// added in the fixed order k = 0..K-1, where the k-th element e around node
// n and the node's own vertex number s in it come packed in one word of the
// static table elem_slot [K, N] (mesh/cluster.py): e * 3 + s, -1 in a
// padded slot.  idx = e * 3 + s, the word itself, for contrib [R, E, 3];
// idx = s * E + e for contrib [R, 3, E] (vertex-major).
//
// Replaces fesom2_tpu/core/ops.py:262-313 (_masked_gather_sum,
// elem_contrib_to_nodes, elem_contrib_to_nodes_3e: one jnp.take over the
// transposed [K, N] tables plus a masked sum; its chunking over K is TPU
// layout and has no counterpart here).
//
// Bound on the card: bytes, and in practice the latency of scattered
// sector reads.  Each contribution is read once and added once.  The first
// design ran one thread per (row, node), so every row read the node's K
// element indices and K vertex numbers again from two [N, K] tables, 48
// bytes a node a row against 24 to 48 bytes of contributions; and the sea
// ice made eleven calls a coupled step of one to six rows each.
//
// Design (the pattern of node_edge_reduce): a thread owns one node and a
// run of rows (a block: 256 consecutive nodes; the grid's second axis: the
// runs).  It reads its K slot words once, into registers; a warp's reads of
// one slot are contiguous.  It then walks its rows kUnroll at a time with
// all kUnroll x K gathers issued before the first sum, so that several
// rows' reads are in flight per thread.  On the level-7 globe a thread
// walking all rows of a call measured fastest over the coupled step's
// calls (mesh/cluster.py: ASSEMBLY_TARGET_BLOCKS); runs of two rows were
// as fast only for the nine-row float64 call.  The slots are summed in
// the order k = 0..K-1 from 0, with no atomics: deterministic and
// bit-equal to the first design and to the plain version.  A padded slot
// is never read; a word past the contributions (e >= E) is never read and
// makes out NaN.  The slots a thread holds are a template parameter (6,
// what a triangulation's interior nodes have, or kMaxSlots; slots past K
// hold -1); above kMaxSlots the words are read again for every row.
#include "common.cuh"

namespace {

constexpr int kUnroll = 2;      // rows whose gathers are in flight together
constexpr int kBlocksPerSM = 4; // resident blocks the register count allows
constexpr int kMaxSlots = 8;    // largest K held in registers

template <typename T>
__device__ __forceinline__ T quiet_nan() {
  return T(__longlong_as_double(0x7ff8000000000000LL));
}

// The offset in a row of contrib that a slot word names: -1 for a padded
// slot, -2 for a word past the row (never read).
template <bool VERTEX_MAJOR>
__device__ __forceinline__ int slot_offset(int word, int n_elems) {
  if (word < 0) return -1;
  if (word >= 3 * n_elems) return -2;
  if (!VERTEX_MAJOR) return word;
  int e = word / 3;
  return (word - 3 * e) * n_elems + e;
}

template <typename T, bool VERTEX_MAJOR, int K>
__global__ void __launch_bounds__(fesom::kThreads, kBlocksPerSM)
elem_contrib_to_nodes_kernel(
    const T* __restrict__ contrib, int rows, int n_elems,
    const int* __restrict__ elem_slot, int n_nodes, int k_max, int row_chunk,
    T* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  const int r0 = blockIdx.y * row_chunk;
  const int r1 = min(rows, r0 + row_chunk);
  const long long stride = 3LL * n_elems;
  int off[K];
  bool bad = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int word = k < k_max ? elem_slot[static_cast<long long>(k) * n_nodes + n]
                         : -1;
    off[k] = slot_offset<VERTEX_MAJOR>(word, n_elems);
    bad |= off[k] == -2;
  }

  int r = r0;
  for (; r + kUnroll <= r1; r += kUnroll) {
    T v[kUnroll][K];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* row = contrib + (r + u) * stride;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (off[k] >= 0) v[u][k] = row[off[k]];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (off[k] >= 0) acc += v[u][k];
      out[static_cast<long long>(r + u) * n_nodes + n] =
          bad ? quiet_nan<T>() : acc;
    }
  }
  for (; r < r1; ++r) {
    const T* row = contrib + r * stride;
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (off[k] >= 0) acc += row[off[k]];
    out[static_cast<long long>(r) * n_nodes + n] = bad ? quiet_nan<T>() : acc;
  }
}

// Any K: the same walk with the slot words read again for each row.
template <typename T, bool VERTEX_MAJOR>
__global__ void elem_contrib_to_nodes_loop_kernel(
    const T* __restrict__ contrib, int rows, int n_elems,
    const int* __restrict__ elem_slot, int n_nodes, int k_max, int row_chunk,
    T* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  const int r0 = blockIdx.y * row_chunk;
  const int r1 = min(rows, r0 + row_chunk);
  for (int r = r0; r < r1; ++r) {
    const T* row = contrib + r * 3LL * n_elems;
    T acc = T(0);
    bool bad = false;
    for (int k = 0; k < k_max; ++k) {
      int o = slot_offset<VERTEX_MAJOR>(
          elem_slot[static_cast<long long>(k) * n_nodes + n], n_elems);
      if (o >= 0) acc += row[o];
      bad |= o == -2;
    }
    out[static_cast<long long>(r) * n_nodes + n] = bad ? quiet_nan<T>() : acc;
  }
}

template <typename T, bool VERTEX_MAJOR>
void launch_form(const T* contrib, int rows, int n_elems, const int* elem_slot,
                 int n_nodes, int k_max, int row_chunk, T* out,
                 cudaStream_t stream) {
  dim3 grid(fesom::blocks_for(n_nodes), (rows + row_chunk - 1) / row_chunk);
  if (k_max <= 6)
    elem_contrib_to_nodes_kernel<T, VERTEX_MAJOR, 6>
        <<<grid, fesom::kThreads, 0, stream>>>(contrib, rows, n_elems,
                                               elem_slot, n_nodes, k_max,
                                               row_chunk, out);
  else if (k_max <= kMaxSlots)
    elem_contrib_to_nodes_kernel<T, VERTEX_MAJOR, kMaxSlots>
        <<<grid, fesom::kThreads, 0, stream>>>(contrib, rows, n_elems,
                                               elem_slot, n_nodes, k_max,
                                               row_chunk, out);
  else
    elem_contrib_to_nodes_loop_kernel<T, VERTEX_MAJOR>
        <<<grid, fesom::kThreads, 0, stream>>>(contrib, rows, n_elems,
                                               elem_slot, n_nodes, k_max,
                                               row_chunk, out);
}

template <typename T>
void launch(const void* contrib, int rows, int n_elems, const void* elem_slot,
            int n_nodes, int k_max, int row_chunk, int vertex_major,
            void* out, cudaStream_t stream) {
  const T* c = static_cast<const T*>(contrib);
  const int* s = static_cast<const int*>(elem_slot);
  T* o = static_cast<T*>(out);
  if (vertex_major)
    launch_form<T, true>(c, rows, n_elems, s, n_nodes, k_max, row_chunk, o,
                         stream);
  else
    launch_form<T, false>(c, rows, n_elems, s, n_nodes, k_max, row_chunk, o,
                          stream);
}

}  // namespace

// contrib [rows, E, 3] (vertex_major = 0) or [rows, 3, E] (1); elem_slot
// [K, N] i32 (mesh/cluster.py); out [rows, N]; row_chunk rows per thread.
extern "C" int fesom_elem_contrib_to_nodes(
    const void* contrib, int rows, int n_elems, const void* elem_slot,
    int n_nodes, int k_max, int row_chunk, int vertex_major, void* out,
    int is_double, void* stream) {
  if (rows == 0 || n_nodes == 0) return fesom::last_error();
  if (row_chunk < 1 || k_max < 0 || n_elems < 0 || n_elems > 0x7fffffff / 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    launch<double>(contrib, rows, n_elems, elem_slot, n_nodes, k_max,
                   row_chunk, vertex_major, out, s);
  else
    launch<float>(contrib, rows, n_elems, elem_slot, n_nodes, k_max,
                  row_chunk, vertex_major, out, s);
  return fesom::last_error();
}
