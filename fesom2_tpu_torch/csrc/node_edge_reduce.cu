// node_edge_reduce: signed sum of edge fluxes over each node's incident
// edges, out[r, n] = sum_k sign[n, k] * flux[r, node_edges[n, k]].
//
// Replaces fesom2_tpu/core/ops.py:154 edge_divergence and, with pair=1,
// ops.py:227 edge_signed_reduce2 (the FCT plus/minus sums from one pass:
// plus = sum max(v, 0), minus = sum min(v, 0)).  On the JAX side both are
// XLA-lowered gathers over the [N, KE] incidence tables.
//
// Bound on the card: bytes, and in practice the latency of scattered
// 32-byte sector reads.  There are two flops per gathered value.  The first
// design ran one thread per (row, node), so every row of a [2, 47, Ed] call
// read the node's KE indices and KE signs again: 94 x N x KE x 12 bytes of
// table reads for a table of N x KE x 12.
//
// Design: a thread owns one node and a run of rows (a block: 256
// consecutive nodes; the grid's second axis: the runs).  It reads its KE
// slot words once, into registers, from the static table edge_slot [KE, N]
// (mesh/cluster.py: edge << 1 | (sign < 0), -1 in a padded slot; a warp's
// reads of one slot are contiguous), then walks its rows kUnroll at a time
// with all kUnroll x KE gathers issued before the first sum, so that
// several rows' sector reads are in flight per thread.  What is left is
// latency, so warps in flight count for more than rows per thread: two
// rows at a time within 64 registers (four blocks an SM) and short runs
// (mesh/cluster.py: ROW_TARGET_BLOCKS) measured fastest on the level-7
// globe; four rows at a time were slower in float64, eight much slower.
// The sign is +1 or -1, so sign * v is v or -v to the bit, and the low bit
// of the word picks it.  The gathers go through L1 directly: on a mesh
// numbered along a space-filling curve a tile's edges of one row lie in a
// few hundred sectors that its eight warps share, and staging them in
// shared memory would move no fewer (chip_smoke.py phase 3 prints the
// count).  The slots are summed in the fixed order k = 0..KE-1, with no
// atomics, so the result is deterministic and bit-equal to the first
// design's.  Padded slots are skipped before the read.  The slots a thread
// holds are a template parameter (6, what a triangulation's interior nodes
// have, or kMaxSlots; slots past KE hold -1); above kMaxSlots the words are
// read again for every row.  A one-row call is one thread per node.
#include "common.cuh"

namespace {

constexpr int kUnroll = 2;     // rows whose gathers are in flight together
constexpr int kBlocksPerSM = 4; // resident blocks the register count allows
constexpr int kMaxSlots = 8;   // largest KE held in registers

template <typename T>
__device__ __forceinline__ T signed_value(const T* __restrict__ row, int word) {
  T v = row[word >> 1];
  return (word & 1) ? -v : v;
}

template <typename T, bool PAIR>
__device__ __forceinline__ void add_term(T v, T& plus, T& minus) {
  if (PAIR) {
    plus += v > T(0) ? v : T(0);
    minus += v < T(0) ? v : T(0);
  } else {
    plus += v;
  }
}

template <typename T, bool PAIR, int KE>
__global__ void __launch_bounds__(fesom::kThreads, kBlocksPerSM)
node_edge_reduce_kernel(
    const T* __restrict__ flux, int rows, int n_edges,
    const int* __restrict__ edge_slot, int n_nodes, int ke, int row_chunk,
    T* __restrict__ out0, T* __restrict__ out1) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  const int r0 = blockIdx.y * row_chunk;
  const int r1 = min(rows, r0 + row_chunk);
  int word[KE];
#pragma unroll
  for (int k = 0; k < KE; ++k)
    word[k] = k < ke ? edge_slot[static_cast<long long>(k) * n_nodes + n] : -1;

  int r = r0;
  for (; r + kUnroll <= r1; r += kUnroll) {
    T v[kUnroll][KE];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* row = flux + static_cast<long long>(r + u) * n_edges;
#pragma unroll
      for (int k = 0; k < KE; ++k)
        if (word[k] >= 0) v[u][k] = signed_value(row, word[k]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      T plus = T(0);
      T minus = T(0);
#pragma unroll
      for (int k = 0; k < KE; ++k)
        if (word[k] >= 0) add_term<T, PAIR>(v[u][k], plus, minus);
      long long o = static_cast<long long>(r + u) * n_nodes + n;
      out0[o] = plus;
      if (PAIR) out1[o] = minus;
    }
  }
  for (; r < r1; ++r) {
    const T* row = flux + static_cast<long long>(r) * n_edges;
    T plus = T(0);
    T minus = T(0);
#pragma unroll
    for (int k = 0; k < KE; ++k)
      if (word[k] >= 0)
        add_term<T, PAIR>(signed_value(row, word[k]), plus, minus);
    long long o = static_cast<long long>(r) * n_nodes + n;
    out0[o] = plus;
    if (PAIR) out1[o] = minus;
  }
}

// Any KE: the same walk with the slot words read again for each row.
template <typename T, bool PAIR>
__global__ void node_edge_reduce_loop_kernel(
    const T* __restrict__ flux, int rows, int n_edges,
    const int* __restrict__ edge_slot, int n_nodes, int ke, int row_chunk,
    T* __restrict__ out0, T* __restrict__ out1) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  const int r0 = blockIdx.y * row_chunk;
  const int r1 = min(rows, r0 + row_chunk);
  for (int r = r0; r < r1; ++r) {
    const T* row = flux + static_cast<long long>(r) * n_edges;
    T plus = T(0);
    T minus = T(0);
    for (int k = 0; k < ke; ++k) {
      int word = edge_slot[static_cast<long long>(k) * n_nodes + n];
      if (word >= 0) add_term<T, PAIR>(signed_value(row, word), plus, minus);
    }
    long long o = static_cast<long long>(r) * n_nodes + n;
    out0[o] = plus;
    if (PAIR) out1[o] = minus;
  }
}

template <typename T, bool PAIR>
void launch_form(const T* flux, int rows, int n_edges, const int* edge_slot,
                 int n_nodes, int ke, int row_chunk, T* out0, T* out1,
                 cudaStream_t stream) {
  dim3 grid(fesom::blocks_for(n_nodes), (rows + row_chunk - 1) / row_chunk);
  if (ke <= 6)
    node_edge_reduce_kernel<T, PAIR, 6><<<grid, fesom::kThreads, 0, stream>>>(
        flux, rows, n_edges, edge_slot, n_nodes, ke, row_chunk, out0, out1);
  else if (ke <= kMaxSlots)
    node_edge_reduce_kernel<T, PAIR, kMaxSlots>
        <<<grid, fesom::kThreads, 0, stream>>>(flux, rows, n_edges, edge_slot,
                                               n_nodes, ke, row_chunk, out0,
                                               out1);
  else
    node_edge_reduce_loop_kernel<T, PAIR>
        <<<grid, fesom::kThreads, 0, stream>>>(flux, rows, n_edges, edge_slot,
                                               n_nodes, ke, row_chunk, out0,
                                               out1);
}

template <typename T>
void launch(const void* flux, int rows, int n_edges, const void* edge_slot,
            int n_nodes, int ke, int row_chunk, void* out0, void* out1,
            int pair, cudaStream_t stream) {
  if (pair)
    launch_form<T, true>(static_cast<const T*>(flux), rows, n_edges,
                         static_cast<const int*>(edge_slot), n_nodes, ke,
                         row_chunk, static_cast<T*>(out0),
                         static_cast<T*>(out1), stream);
  else
    launch_form<T, false>(static_cast<const T*>(flux), rows, n_edges,
                          static_cast<const int*>(edge_slot), n_nodes, ke,
                          row_chunk, static_cast<T*>(out0), nullptr, stream);
}

}  // namespace

// flux [rows, Ed], edge_slot [KE, N] (mesh/cluster.py), out0 (and out1 with
// pair) [rows, N]; row_chunk rows per thread.
extern "C" int fesom_node_edge_reduce(const void* flux, int rows, int n_edges,
                                      const void* edge_slot, int n_nodes,
                                      int ke, int row_chunk, void* out0,
                                      void* out1, int pair, int is_double,
                                      void* stream) {
  if (rows == 0 || n_nodes == 0) return fesom::last_error();
  if (row_chunk < 1 || ke < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    launch<double>(flux, rows, n_edges, edge_slot, n_nodes, ke, row_chunk,
                   out0, out1, pair, s);
  else
    launch<float>(flux, rows, n_edges, edge_slot, n_nodes, ke, row_chunk,
                  out0, out1, pair, s);
  return fesom::last_error();
}

extern "C" const char* fesom_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
