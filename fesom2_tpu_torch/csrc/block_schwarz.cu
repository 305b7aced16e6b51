// block_schwarz: the two-level additive Schwarz preconditioner of the SSH
// CG solve, y = sum_b R_b^T inv_b R_b r + R_0^T inv_0 R_0 r, in three
// launches:
//
//   1. local solves, one CUDA block per Schwarz block b: gather r into the
//      block's K overlapping nodes (block_ids, -1 = padding, read as 0),
//      multiply by its [K, K] inverse, write yb[b, :]; the same block also
//      sums r over its own (non-overlapping) nodes, r0[b], for the coarse
//      level;
//   2. the coarse solve y0 = coarse_inv @ r0, one warp per row;
//   3. the combine, one thread per node n: the node's block copies summed
//      through node_slots in fixed slot order (no atomics), plus
//      y0[coarse_part[n]].
//
// Replaces fesom2_tpu/core/ssh.py:429-454 (BlockSchwarz.__call__: jnp.take
// gathers, a batched einsum on the TPU's MXU, a gather-based combine and
// the coarse matvec; the 2-row stacked gathers there are a TPU workaround).
//
// Bound on the card: reading inv_blocks, once per apply.  On the
// 46,000-node channel it is 180 blocks of 336 x 336 float64 (K padded),
// 163 MB, which does not fit the 50 MB L2, so every apply streams it from
// device memory: 48.5 us at 3.35 TB/s is the floor of one
// preconditioner apply, and of one CG iteration.  Everything else (r, yb,
// the index tables, the 180 x 180 coarse inverse) is a few MB.  Design:
// launch 1 stages the block's gathered residual in shared memory (K values)
// and gives each row of the inverse to one warp, whose lanes read the row
// with contiguous, coalesced loads and reduce it with warp shuffles; 16
// warps per block keep enough loads in flight.  Launches 2 and 3 are small.
// All index tables are checked on the host when the preconditioner is
// built; the kernels still skip any index outside its table rather than
// read it.
#include "common.cuh"

namespace {

constexpr int kSolveThreads = 512;

template <typename T>
__device__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void local_solve_kernel(const T* __restrict__ r, int n_nodes,
                                   const int* __restrict__ block_ids,
                                   const T* __restrict__ inv, int K,
                                   const int* __restrict__ coarse_ids, int kc,
                                   T* __restrict__ yb, T* __restrict__ r0) {
  extern __shared__ unsigned char smem[];
  T* rb = reinterpret_cast<T*>(smem);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int l = threadIdx.x; l < K; l += blockDim.x) {
    int id = block_ids[static_cast<long long>(b) * K + l];
    rb[l] = (id >= 0 && id < n_nodes) ? r[id] : T(0);
  }
  if (warp == 0) {
    T s = T(0);
    for (int j = lane; j < kc; j += 32) {
      int id = coarse_ids[static_cast<long long>(b) * kc + j];
      if (id >= 0 && id < n_nodes) s += r[id];
    }
    s = warp_sum(s);
    if (lane == 0) r0[b] = s;
  }
  __syncthreads();
  const T* ib = inv + static_cast<long long>(b) * K * K;
  for (int k = warp; k < K; k += n_warps) {
    const T* row = ib + static_cast<long long>(k) * K;
    T s = T(0);
    for (int l = lane; l < K; l += 32) s += row[l] * rb[l];
    s = warp_sum(s);
    if (lane == 0) yb[static_cast<long long>(b) * K + k] = s;
  }
}

template <typename T>
__global__ void coarse_solve_kernel(const T* __restrict__ coarse_inv,
                                    const T* __restrict__ r0, int nb,
                                    T* __restrict__ y0) {
  const int lane = threadIdx.x & 31;
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i >= nb) return;
  const T* row = coarse_inv + static_cast<long long>(i) * nb;
  T s = T(0);
  for (int j = lane; j < nb; j += 32) s += row[j] * r0[j];
  s = warp_sum(s);
  if (lane == 0) y0[i] = s;
}

template <typename T>
__global__ void combine_kernel(const T* __restrict__ yb, long long n_flat,
                               const int* __restrict__ node_slots,
                               const bool* __restrict__ node_valid, int S,
                               const T* __restrict__ y0, int nb,
                               const int* __restrict__ coarse_part,
                               int n_nodes, T* __restrict__ y) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  T acc = T(0);
  for (int s = 0; s < S; ++s) {
    long long q = static_cast<long long>(n) * S + s;
    int f = node_slots[q];
    if (node_valid[q] && f >= 0 && f < n_flat) acc += yb[f];
  }
  int p = coarse_part[n];
  y[n] = acc + ((p >= 0 && p < nb) ? y0[p] : T(0));
}

template <typename T>
int launch(const void* r, int n, const void* block_ids, const void* inv,
           int nb, int K, const void* node_slots, const void* node_valid,
           int S, const void* coarse_ids, int kc, const void* coarse_inv,
           const void* coarse_part, void* yb, void* r0, void* y0, void* y,
           cudaStream_t stream) {
  if (n == 0 || nb == 0) return fesom::last_error();
  local_solve_kernel<T><<<nb, kSolveThreads, K * sizeof(T), stream>>>(
      static_cast<const T*>(r), n, static_cast<const int*>(block_ids),
      static_cast<const T*>(inv), K, static_cast<const int*>(coarse_ids), kc,
      static_cast<T*>(yb), static_cast<T*>(r0));
  int err = fesom::last_error();
  if (err) return err;
  coarse_solve_kernel<T><<<(nb * 32 + fesom::kThreads - 1) / fesom::kThreads,
                           fesom::kThreads, 0, stream>>>(
      static_cast<const T*>(coarse_inv), static_cast<const T*>(r0), nb,
      static_cast<T*>(y0));
  err = fesom::last_error();
  if (err) return err;
  combine_kernel<T><<<fesom::blocks_for(n), fesom::kThreads, 0, stream>>>(
      static_cast<const T*>(yb), static_cast<long long>(nb) * K,
      static_cast<const int*>(node_slots),
      static_cast<const bool*>(node_valid), S, static_cast<const T*>(y0), nb,
      static_cast<const int*>(coarse_part), n, static_cast<T*>(y));
  return fesom::last_error();
}

}  // namespace

// r [N]; block_ids [nb, K] i32; inv [nb, K, K]; node_slots [N, S] i32 and
// node_valid [N, S] bool; coarse_ids [nb, Kc] i32; coarse_inv [nb, nb];
// coarse_part [N] i32; scratch yb [nb, K], r0 [nb], y0 [nb]; out y [N].
// K * sizeof(T) must fit in 48 KB of shared memory (the wrapper checks).
extern "C" int fesom_block_schwarz(const void* r, int n, const void* block_ids,
                                   const void* inv, int nb, int K,
                                   const void* node_slots,
                                   const void* node_valid, int S,
                                   const void* coarse_ids, int kc,
                                   const void* coarse_inv,
                                   const void* coarse_part, void* yb, void* r0,
                                   void* y0, void* y, int is_double,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(r, n, block_ids, inv, nb, K, node_slots, node_valid,
                          S, coarse_ids, kc, coarse_inv, coarse_part, yb, r0,
                          y0, y, s);
  return launch<float>(r, n, block_ids, inv, nb, K, node_slots, node_valid, S,
                       coarse_ids, kc, coarse_inv, coarse_part, yb, r0, y0, y,
                       s);
}
