// tridiag_solve: batched Thomas algorithm over vertical columns,
// tridiag(a, b, c) x = d with a sub-, b main- and c super-diagonal along
// the level axis; a, b, c are [L, X], d and x [B, L, X].
//
// Replaces fesom2_tpu/core/ops.py:389 tridiag_solve (two lax.scans over
// the level axis).  Forward: m = b - cp_prev * a, cp = c / m,
// dp = (d - dp_prev * a) / m; backward: x = dp - cp * x_next, from
// cp_prev = dp_prev = x_next = 0: the same divisions in the same order as
// the scan and as tridiag_solve_plain, so the result is bit-equal to the
// plain version.  The B right-hand sides share a, b, c (u and v of one
// column system, or tracers that share one diffusivity).
//
// Bound on the card: bytes, (3 + 2B) L values per column: a, b, c and d
// read once, x written once.  The first design (one thread per
// (right-hand side, column)) read a, b, c once per right-hand side, built
// m and c / m as often, and sent cp and dp through device memory and
// back: about 2.6x the bound in bytes, and a load that waited on every
// level.
//
// Design: a block owns a tile of consecutive columns (256 bytes a row:
// 32 in float64, 64 in float32), a lane each, in 1 + B roles of one or
// two warps.  The forward sweep is a chain of divisions down each column,
// and a division's latency, not bytes, bound a design that ran the B + 1
// chains of a column in one thread (a division is a branch-guarded
// sequence, so they issued one after another).  So role 0 stages a, b
// and c into shared memory with cp.async, every level at once in kChunks
// groups (a role's copies of one level are 256 contiguous bytes), and
// computes the pivots m = b - cp_prev a and cp = c / m once for all
// right-hand sides, chunk by chunk, over b and c, handing each chunk on
// through a named barrier; role j + 1 follows one chunk behind with its
// own chain dp = (d - dp_prev a) / m, then sweeps back up and writes x
// straight to device memory, a warp's stores contiguous.  m, cp and dp
// never leave the SM.  Shared memory per column limits the tiles an SM
// holds, so for columns of up to kMaxRegLevels levels (the model's) role
// j + 1 loads its d straight into registers, all levels at once, and
// keeps dp there (its loops unrolled, chunks of fixed size): 3 L values a
// column (36 KB a block for L = 47 in float64) against 3 + B when d is
// staged and dp kept in shared memory, as for deeper columns.
#include "common.cuh"

namespace {

// a tile's row: 256 bytes, 32 float64 or 64 float32 columns, a lane each;
// a role (the pivots, or one right-hand side) is one or two whole warps
constexpr int kRowBytes = 256;
template <typename T>
constexpr int kCols = kRowBytes / static_cast<int>(sizeof(T));
static_assert(kCols<double> % 32 == 0, "a role is whole warps");
constexpr int kChunks = 4;  // cp.async groups and named barriers a column

// wait until at most n of this thread's cp.async groups are pending
__device__ __forceinline__ void wait_pending(int n) {
  static_assert(kChunks == 4, "one case per pending count");
  switch (n) {
    case 3: fesom::cp_async_wait<3>(); break;
    case 2: fesom::cp_async_wait<2>(); break;
    case 1: fesom::cp_async_wait<1>(); break;
    default: fesom::cp_async_wait<0>(); break;
  }
}

// named barriers 1..kChunks, one per chunk, over all threads of the block
__device__ __forceinline__ void chunk_arrive(int q, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(q + 1), "r"(threads) : "memory");
}
__device__ __forceinline__ void chunk_sync(int q, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(q + 1), "r"(threads) : "memory");
}

// kRegLevels > 0: a right-hand side's role loads its d straight into
// registers and keeps dp there (columns of up to kRegLevels levels);
// 0: d is staged and dp kept in shared memory, for deeper columns.
template <typename T, int kRegLevels>
__global__ void tridiag_solve_kernel(const T* __restrict__ a,
                                     const T* __restrict__ b,
                                     const T* __restrict__ c,
                                     const T* __restrict__ d, int batch,
                                     int levels, int cols,
                                     T* __restrict__ x) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  constexpr int C = kCols<T>;
  const int L = levels;
  T* sa = reinterpret_cast<T*>(shared_raw);  // [L][C]
  T* sb = sa + L * C;                         // b, then m
  T* sc = sb + L * C;                         // c, then cp
  T* sd = sc + L * C;                         // [B][L][C]: d, then dp
  const int t = threadIdx.x % C;
  const int role = threadIdx.x / C;           // 0: pivots; j + 1: rhs j
  const int threads = blockDim.x;
  const long long col = static_cast<long long>(blockIdx.x) * C + t;
  const bool active = col < cols;
  const long long plane = static_cast<long long>(L) * cols;
  // levels a chunk: fixed in the register form, so that its unrolled
  // loops meet the chunk boundaries at compile time
  constexpr int kRegChunk = kRegLevels / kChunks;
  static_assert(kRegLevels % kChunks == 0, "whole chunks");
  const int chunk = kRegLevels > 0 ? kRegChunk : (L + kChunks - 1) / kChunks;
  const int j = role > 0 ? role - 1 : 0;
  T* sdj = sd + j * L * C;
  const T* dj = d + j * plane;
  T* xj = x + j * plane;

  // each role stages what it sweeps: role 0 a, b, c; role j + 1 d[j]
  // where dp lives in shared memory
  if (role == 0 || kRegLevels == 0) {
    for (int q = 0; q < kChunks; ++q) {
      const int l1 = min(L, (q + 1) * chunk);
      if (active) {
        for (int l = q * chunk; l < l1; ++l) {
          const long long g = static_cast<long long>(l) * cols + col;
          const int s = l * C + t;
          if (role == 0) {
            fesom::cp_async(sa + s, a + g);
            fesom::cp_async(sb + s, b + g);
            fesom::cp_async(sc + s, c + g);
          } else {
            fesom::cp_async(sdj + s, dj + g);
          }
        }
      }
      fesom::cp_async_commit();
    }
  }

  if (role == 0) {
    // the pivots m = b - cp_prev * a and cp = c / m, once for all rhs;
    // each chunk is handed on through its barrier
    T cp_prev = T(0);
    for (int q = 0; q < kChunks; ++q) {
      wait_pending(kChunks - 1 - q);
      const int l1 = min(L, (q + 1) * chunk);
      if (active) {
        for (int l = q * chunk; l < l1; ++l) {
          const int s = l * C + t;
          const T m = sb[s] - cp_prev * sa[s];
          const T cpl = sc[s] / m;
          sb[s] = m;
          sc[s] = cpl;
          cp_prev = cpl;
        }
      }
      chunk_arrive(q, threads);
    }
    return;
  }
  // rhs j: dp = (d - dp_prev * a) / m down the column, chunk by chunk
  // behind the pivots, then x = dp - cp * x_next back up
  T dp_prev = T(0);
  T x_next = T(0);
  if constexpr (kRegLevels > 0) {
    T dp[kRegLevels];
#pragma unroll
    for (int l = 0; l < kRegLevels; ++l)
      dp[l] = active && l < L ? dj[static_cast<long long>(l) * cols + col]
                              : T(0);
#pragma unroll
    for (int l = 0; l < kRegLevels; ++l) {
      if (l % kRegChunk == 0) chunk_sync(l / kRegChunk, threads);
      if (active && l < L) {
        const int s = l * C + t;
        dp[l] = (dp[l] - dp_prev * sa[s]) / sb[s];
        dp_prev = dp[l];
      }
    }
    if (!active) return;
#pragma unroll
    for (int l = kRegLevels - 1; l >= 0; --l) {
      if (l < L) {
        const T xl = dp[l] - sc[l * C + t] * x_next;
        xj[static_cast<long long>(l) * cols + col] = xl;
        x_next = xl;
      }
    }
  } else {
    for (int q = 0; q < kChunks; ++q) {
      wait_pending(kChunks - 1 - q);
      chunk_sync(q, threads);
      const int l1 = min(L, (q + 1) * chunk);
      if (active) {
        for (int l = q * chunk; l < l1; ++l) {
          const int s = l * C + t;
          const T dpl = (sdj[s] - dp_prev * sa[s]) / sb[s];
          sdj[s] = dpl;
          dp_prev = dpl;
        }
      }
    }
    if (!active) return;
    for (int l = L - 1; l >= 0; --l) {
      const int s = l * C + t;
      const T xl = sdj[s] - sc[s] * x_next;
      xj[static_cast<long long>(l) * cols + col] = xl;
      x_next = xl;
    }
  }
}

template <typename T, int kRegLevels>
cudaError_t launch_levels(const void* a, const void* b, const void* c,
                          const void* d, int batch, int levels, int cols,
                          void* x, cudaStream_t stream) {
  constexpr int C = kCols<T>;
  const size_t bytes = static_cast<size_t>(3 + (kRegLevels ? 0 : batch)) *
                       levels * C * sizeof(T);
  cudaError_t err =
      fesom::allow_shared(tridiag_solve_kernel<T, kRegLevels>, bytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((cols + C - 1) / C);
  tridiag_solve_kernel<T, kRegLevels>
      <<<grid, C * (1 + batch), bytes, stream>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<const T*>(c), static_cast<const T*>(d), batch, levels,
          cols, static_cast<T*>(x));
  return cudaSuccess;
}

// the model's columns (47 layers, 48 interfaces) take the register form
constexpr int kMaxRegLevels = 48;

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* c, const void* d,
                   int batch, int levels, int cols, void* x,
                   cudaStream_t stream) {
  constexpr int C = kCols<T>;
  if (batch == 0 || levels == 0 || cols == 0) return cudaSuccess;
  if (batch < 0 || levels < 0 || cols < 0 || C * (1 + batch) > 1024)
    return cudaErrorInvalidValue;
  if (levels <= kMaxRegLevels)
    return launch_levels<T, kMaxRegLevels>(a, b, c, d, batch, levels, cols,
                                           x, stream);
  return launch_levels<T, 0>(a, b, c, d, batch, levels, cols, x, stream);
}

}  // namespace

extern "C" int fesom_tridiag_solve(const void* a, const void* b, const void* c,
                                   const void* d, int batch, int levels,
                                   int cols, void* x, int is_double,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_double ? launch<double>(a, b, c, d, batch, levels, cols, x, s)
                : launch<float>(a, b, c, d, batch, levels, cols, x, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return fesom::last_error();
}
