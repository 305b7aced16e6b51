// block_schwarz: the two-level additive Schwarz preconditioner of the SSH
// CG solve, y = sum_b R_b^T inv_b R_b r + R_0^T inv_0 R_0 r, in two
// launches:
//
//   1. local solves over row tiles of the packed inverses: one CUDA block
//      per tile (a run of rows of one Schwarz block b), which copies the
//      tile's rows and gathers r into the block's n_b overlapping nodes in
//      shared memory and writes yb[row] = inv_b[row, :] . r_b for its rows;
//      the first tile of each block (the tile table puts them first) also
//      sums r over the block's own nodes, r0[b], and counts itself on an
//      integer counter; once all have, the coarse solve y0 = coarse_inv @
//      r0 is done in chunks of 8 rows (a warp a row) that CUDA blocks
//      claim on a second counter as they start, while their tile's copy is
//      in flight (a launch of its own in the first design): any block that
//      finds r0 complete takes one chunk, and the block that completed it
//      takes chunks until none is left;
//   2. the combine, one thread per node n: the node's block copies summed
//      through its packed slots in fixed slot order, plus y0[coarse_part[n]];
//      it sets the counters back to 0 for the next apply.
// No float atomics: every sum is formed in one fixed order.
//
// Replaces fesom2_tpu/core/ssh.py:429-454 (BlockSchwarz.__call__: jnp.take
// gathers, a batched einsum on the TPU's MXU, a gather-based combine and
// the coarse matvec; the 2-row stacked gathers there are a TPU workaround).
//
// Bound on the card: reading the blocks' inverses once per apply.  The
// level-7 globe's 445 blocks hold 281 to 368 nodes; their own entries are
// 378 MB in float64 (the [445, 368, 368] padding would add 104 MB), which
// does not fit the 50 MB L2, so every apply streams them from device
// memory: about 115 us at 3.35 TB/s.  Everything else (r, yb, the index
// tables, the 445 x 445 coarse inverse) is a few MB.  Design
// (core/ssh.py: pack_block_schwarz builds the layout and the tiles):
//   - the inverses are packed block after block, each block's n_b rows at
//     a stride of n_b rounded up to 4 elements (zeros between), so no
//     padded row or column is read and every row starts 16-byte aligned;
//   - a block's rows are cut into tiles (at most 24 rows and 96 KB), as
//     even as the block allows, one CUDA block each: some 6,200 equal
//     pieces of work for 132 SMs, so the blocks' unequal sizes leave no
//     tail wave;
//   - a tile's rows are one contiguous run of the packed array: one thread
//     asks for all of it with one bulk copy (cp.async.bulk, the TMA unit)
//     into shared memory, completed on an mbarrier, so the whole tile is
//     in flight at once without a register per byte, while the block
//     gathers its residual (n_b values) into shared memory beside it;
//   - a warp then sums 4 rows at once from shared memory, each lane 16
//     bytes (double2 / float4) of each row a step, and reduces the 4 sums
//     with the same warp-shuffle tree, row by row;
//   - every row's sum is formed in one fixed order (lane l takes the
//     vectors l, l + 32, l + 64, ... in turn, then the shuffle tree), and
//     so is every coarse row's, so an apply gives the same bits on every
//     run;
//   - the coarse solve (445 x 445 on the globe, 1.6 MB) runs in 56 chunks
//     once the first tiles are done, a few percent into the launch, beside
//     the streaming tiles rather than as a launch of its own.
// All index tables are checked on the host when the preconditioner is
// built and packed; the kernels still skip any index outside its table
// rather than read it.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;         // warps of a tile's CUDA block
constexpr int kRowsPerWarp = 4;   // rows a warp sums at once
constexpr int kTileThreads = 32 * kWarps;
constexpr int kAlign = 4;         // row stride: a multiple of 4 elements
constexpr int kBarBytes = 16;     // the mbarrier's slot in shared memory
constexpr int kCoarseLoads = 4;   // a lane's loads in flight, coarse rows

// 16 bytes of T: the vector a lane reads of a row
template <typename T>
struct Vec;
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int width = 2;
  static __device__ __forceinline__ double dot(double2 a, double2 x,
                                               double acc) {
    acc += a.x * x.x;
    acc += a.y * x.y;
    return acc;
  }
};
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int width = 4;
  static __device__ __forceinline__ float dot(float4 a, float4 x,
                                              float acc) {
    acc += a.x * x.x;
    acc += a.y * x.y;
    acc += a.z * x.z;
    acc += a.w * x.w;
    return acc;
  }
};

template <typename T>
__device__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, its completion counted on mbarrier `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(d),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wait_phase0(unsigned bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}

// a tile's rows (shared memory, `stride` apart) times the block's residual
// rb: warp w sums rows 4w .. 4w + 3, then 4w + 32 .., 4 at once, into
// out[row]
template <typename T>
__device__ __forceinline__ void tile_rows(const T* rb, const T* rows_s,
                                          int stride, int rows, T* out) {
  using V = typename Vec<T>::type;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const V* rv = reinterpret_cast<const V*>(rb);
  const int nvec = stride / Vec<T>::width;
  for (int g = warp * kRowsPerWarp; g < rows; g += kWarps * kRowsPerWarp) {
    const int nr = min(kRowsPerWarp, rows - g);  // the same in the warp
    const V* row = reinterpret_cast<const V*>(rows_s) +
                   static_cast<long long>(g) * nvec;
    T acc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) acc[i] = T(0);
    for (int v = lane; v < nvec; v += 32) {
      const V x = rv[v];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        if (i < nr) acc[i] = Vec<T>::dot(row[i * nvec + v], x, acc[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        acc[i] += __shfl_down_sync(0xffffffffu, acc[i], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        if (i < nr) out[g + i] = acc[i];
    }
  }
}

// coarse rows chunk * kWarps + w of y0 = coarse_inv @ r0, warp w one;
// r0 read past L1 (other blocks wrote it)
template <typename T>
__device__ void coarse_chunk(const T* __restrict__ coarse_inv, const T* r0,
                             int nb, int chunk, T* __restrict__ y0) {
  const int lane = threadIdx.x & 31;
  const int q = chunk * kWarps + (threadIdx.x >> 5);
  if (q >= nb) return;
  const T* row = coarse_inv + static_cast<long long>(q) * nb;
  T s = T(0);
  // kCoarseLoads loads of the row and of r0 in flight per lane; the zeros
  // past nb add nothing
  for (int j0 = lane; j0 < nb; j0 += 32 * kCoarseLoads) {
    T a[kCoarseLoads], x[kCoarseLoads];
#pragma unroll
    for (int i = 0; i < kCoarseLoads; ++i) {
      const int j = j0 + 32 * i;
      a[i] = j < nb ? row[j] : T(0);
      x[i] = j < nb ? __ldcg(r0 + j) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kCoarseLoads; ++i) s += a[i] * x[i];
  }
  s = warp_sum(s);
  if (lane == 0) y0[q] = s;
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    schwarz_local_kernel(const T* __restrict__ r, int n_nodes,
                         const int* __restrict__ tiles, int nb,
                         const int* __restrict__ row_off,
                         const long long* __restrict__ inv_off,
                         const int* __restrict__ ids,
                         const T* __restrict__ inv, int max_stride,
                         int max_tile, const int* __restrict__ coarse_ids,
                         int kc, const T* __restrict__ coarse_inv,
                         int* __restrict__ counter, T* __restrict__ yb,
                         T* r0, T* __restrict__ y0) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int completer;  // this block wrote the last r0[b]
  __shared__ int chunk;      // the coarse chunk this block took, or -1
  T* rb = reinterpret_cast<T*>(smem + kBarBytes);
  T* rows_s = rb + max_stride;
  const unsigned bar = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int* tile = tiles + 3 * static_cast<long long>(blockIdx.x);
  const int b = tile[0], first = tile[1];
  if (b < 0 || b >= nb) return;
  const int base = row_off[b];
  const int n = row_off[b + 1] - base;
  const int stride = (n + kAlign - 1) / kAlign * kAlign;
  const int rows = max(0, min(tile[2], n - first));
  const bool fits = stride <= max_stride && rows * stride <= max_tile;
  const unsigned bytes =
      fits ? static_cast<unsigned>(rows * stride * sizeof(T)) : 0u;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0 && bytes) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_load(rows_s,
              inv + inv_off[b] + static_cast<long long>(first) * stride,
              bytes, bar);
  }
  for (int l = threadIdx.x; l < min(stride, max_stride); l += blockDim.x) {
    const int id = l < n ? ids[base + l] : -1;
    rb[l] = (id >= 0 && id < n_nodes) ? r[id] : T(0);
  }
  if (warp == kWarps - 1) {  // the block's coarse sum, on its first tile
    T s = T(0);
    if (first == 0) {
      for (int j = lane; j < kc; j += 32) {
        const int id = coarse_ids[static_cast<long long>(b) * kc + j];
        if (id >= 0 && id < n_nodes) s += r[id];
      }
      s = warp_sum(s);
    }
    // the coarse chunks: counter[0] counts the r0[b] written (each fenced
    // before it counted), counter[1] the chunks taken; the check's reads
    // overlap the tile's copy and gather
    const int n_chunks = (nb + kWarps - 1) / kWarps;
    volatile int* done = counter;
    if (lane == 0) {
      int last = 0;
      if (first == 0) {
        r0[b] = s;
        __threadfence();
        last = atomicAdd(counter, 1) == nb - 1;
      }
      completer = last;
      chunk = (last || done[0] == nb) && done[1] < n_chunks
                  ? atomicAdd(counter + 1, 1)
                  : -1;
    }
  }
  __syncthreads();
  // a chunk taken is done while the tile's copy is in flight; the block
  // that completed r0 takes chunks until none is left
  while (chunk >= 0 && chunk < (nb + kWarps - 1) / kWarps) {
    __threadfence();
    coarse_chunk<T>(coarse_inv, r0, nb, chunk, y0);
    __syncthreads();
    if (threadIdx.x == 0) chunk = completer ? atomicAdd(counter + 1, 1) : -1;
    __syncthreads();
  }
  if (bytes) {
    wait_phase0(bar);
    tile_rows<T>(rb, rows_s, stride, rows, yb + base + first);
  }
}

template <typename T>
__global__ void schwarz_combine_kernel(const T* __restrict__ yb, int n_rows,
                                       const int* __restrict__ node_slots,
                                       int S, const T* __restrict__ y0,
                                       int nb,
                                       const int* __restrict__ coarse_part,
                                       int* __restrict__ counter,
                                       int n_nodes, T* __restrict__ y) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n == 0) counter[0] = counter[1] = 0;  // the local launch is done
  if (n >= n_nodes) return;
  T acc = T(0);
  for (int s = 0; s < S; ++s) {
    const int f = node_slots[static_cast<long long>(n) * S + s];
    if (f >= 0 && f < n_rows) acc += yb[f];
  }
  const int p = coarse_part[n];
  y[n] = acc + ((p >= 0 && p < nb) ? y0[p] : T(0));
}

template <typename T>
int launch(const void* r, int n, const void* tiles, int n_tiles,
           const void* row_off, const void* inv_off, const void* ids,
           const void* inv, int nb, int max_rows, int max_tile,
           const void* node_slots, int S, const void* coarse_ids, int kc,
           const void* coarse_inv, const void* coarse_part, void* counter,
           void* yb, int n_rows, void* r0, void* y0, void* y,
           cudaStream_t stream) {
  if (n == 0) return fesom::last_error();
  const bool local = nb > 0 && n_tiles > 0;
  if (local) {
    const int max_stride = (max_rows + kAlign - 1) / kAlign * kAlign;
    const size_t smem =
        kBarBytes + static_cast<size_t>(max_stride + max_tile) * sizeof(T);
    cudaError_t err_s = fesom::allow_shared(schwarz_local_kernel<T>, smem);
    if (err_s != cudaSuccess) return static_cast<int>(err_s);
    schwarz_local_kernel<T><<<n_tiles, kTileThreads, smem, stream>>>(
        static_cast<const T*>(r), n, static_cast<const int*>(tiles), nb,
        static_cast<const int*>(row_off),
        static_cast<const long long*>(inv_off),
        static_cast<const int*>(ids), static_cast<const T*>(inv), max_stride,
        max_tile, static_cast<const int*>(coarse_ids), kc,
        static_cast<const T*>(coarse_inv), static_cast<int*>(counter),
        static_cast<T*>(yb), static_cast<T*>(r0), static_cast<T*>(y0));
    const int err = fesom::last_error();
    if (err) return err;
  }
  schwarz_combine_kernel<T><<<fesom::blocks_for(n), fesom::kThreads, 0,
                              stream>>>(
      static_cast<const T*>(yb), n_rows, static_cast<const int*>(node_slots),
      S, static_cast<const T*>(y0), local ? nb : 0,
      static_cast<const int*>(coarse_part), static_cast<int*>(counter), n,
      static_cast<T*>(y));
  return fesom::last_error();
}

}  // namespace

// r [N]; the packed preconditioner (core/ssh.py: PackedSchwarz): tiles
// [n_tiles, 3] i32 (block, first row in it, rows; each block's first tile
// before any block's second), row_off [nb + 1] i32, inv_off [nb] i64, ids
// [n_rows] i32 (-1 = none, read as 0), inv (block b's n_b rows of stride
// round_up(n_b, 4) from inv_off[b], 16-byte aligned), max_rows = max n_b,
// max_tile = max rows * stride of a tile (the shared memory a tile takes,
// with its residual: 16 + (round_up(max_rows, 4) + max_tile) * sizeof(T)
// bytes), node_slots [N, S] i32 (a row, -1 = none); coarse_ids [nb, Kc]
// i32, coarse_inv [nb, nb], coarse_part [N] i32; counter [2] i32, 0 between
// applies; scratch yb [n_rows], r0 [nb], y0 [nb]; out y [N].
extern "C" int fesom_block_schwarz(const void* r, int n, const void* tiles,
                                   int n_tiles, const void* row_off,
                                   const void* inv_off, const void* ids,
                                   const void* inv, int nb, int max_rows,
                                   int max_tile, const void* node_slots,
                                   int S, const void* coarse_ids, int kc,
                                   const void* coarse_inv,
                                   const void* coarse_part, void* counter,
                                   void* yb, int n_rows, void* r0, void* y0,
                                   void* y, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(r, n, tiles, n_tiles, row_off, inv_off, ids, inv,
                          nb, max_rows, max_tile, node_slots, S, coarse_ids,
                          kc, coarse_inv, coarse_part, counter, yb, n_rows,
                          r0, y0, y, s);
  return launch<float>(r, n, tiles, n_tiles, row_off, inv_off, ids, inv, nb,
                       max_rows, max_tile, node_slots, S, coarse_ids, kc,
                       coarse_inv, coarse_part, counter, yb, n_rows, r0, y0,
                       y, s);
}
