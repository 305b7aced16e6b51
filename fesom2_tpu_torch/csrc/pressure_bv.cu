// pressure_bv: equation of state, hydrostatic pressure, Brunt-Vaisala
// frequency, the buoyancy difference to the surface and the mixed-layer
// depth of each node column.
//
// Replaces fesom2_tpu/core/eos.py:88-175 pressure_bv.  A column's
// surface is its top row u = ulevels - 1: 0 in open ocean, below it under
// an ice-shelf cavity, where the rows above u are dry.  The EoS is the
// split form
// rho = (b0 + z (bpz + z bpz2)) rhopot / (b0 + z (bpz + z bpz2) + 0.1 z sef)
// of Jackett & McDougall (eos_kind 1, sef = 1) or the linear forms
// (b0 = 1, bpz = bpz2 = 0, sef = 0): the general one (eos_kind 0) and the
// soufflet channel's (eos_kind 2).  Per column n with top row u and nln
// levels (wet layers u <= k < nln-1):
//   rho[k]   = rho_eos(k, Z[k]) - rho_ref[k]         (wet k, else 0)
//   hp[k]    = -Z[u] rho[u] g + sum_{j=u+1..k} g/2 (rho h[j-1] + rho h[j])
//   bv[i]    = -g (rho(i-1 at zbar[i]) - rho(i at zbar[i])) / (Z[i-1]-Z[i])
//              / rho0, bv[u] = bv[u+1], bv[nln-1] = bv[nln-2], 0 above u
//   dbsfc[k] = -g (rho_srf(Z[k]) - rho_full[k]) / rho_full[k], with the
//              top water's coefficients at depth Z[k]; bottom copied
//   mld2     = Z[first k > u with rhopot[k] - rhopot[u] > 0.125, or the
//              bottom layer; u + 1 if none]
// Every product and sum is taken in the order of the plain torch version
// (eos.pressure_bv_plain), and the pressure is summed down the column in
// level order, as torch.cumsum does, so kernel and plain agree to
// rounding.
//
// Bound on the card: bytes (6 values a wet cell read, 4 a cell written),
// with about 165 flops a wet cell under the byte bound.  The first design
// (one thread per column walking its 47 levels) ran at 2.9x the bound:
// 3,564 warps on 132 SMs, each thread one chain of loads, JM polynomials
// and divisions.
//
// Design: a block owns a tile of 32 consecutive nodes over all levels;
// threadIdx.x is the node, so a warp's copies and stores at one level are
// 32 contiguous values.  Down the column ceil(L / kCells) threads each
// take a run of kCells consecutive levels.  Each thread stages its cells'
// inputs into shared memory with cp.async, all at once (dry cells are not
// read, except level u + 1 of a one-layer column, whose N^2 the surface
// copy reads, as in the plain version).  Pass 1, every cell in parallel: the
// EoS components once, rho, rho * h for the pressure sum, and the cell's
// densities at its upper and lower interface (N^2 at the interface
// between k-1 and k needs k-1's components at zbar[k], which cell k-1
// evaluates, so no component is evaluated twice), written over the
// inputs they consumed; the top cell puts its components in shared
// memory.  Pass 2, after a barrier, every cell: dbsfc with the surface
// water's components, N^2 from the two interface densities, the bottom
// and surface copies written by the thread that holds the value (each
// output row has one writer), and each run's first level crossing the
// MLD criterion; meanwhile the last run's thread sums the pressure down
// its column in level order.  After a second barrier that thread takes
// the first MLD level over the runs.  Registers (64 a thread in float64:
// 2 blocks of 384 threads an SM) and shared memory (6 L + 5 values a
// node, 74 KB a block for L = 47 in float64: 3 blocks) limit the blocks an
// SM holds; each thread's cells run one after another, about 7 divisions
// and a sqrt each.  L may reach 32 kCells levels (1,024 threads).
#include "common.cuh"

namespace {

template <typename T>
struct Eos {
  T b0, bpz, bpz2, rhopot;
};

template <typename T>
__device__ Eos<T> eos_components(T t, T s, int kind, T rho0) {
  Eos<T> e;
  if (kind == 1) {
    T ss = sqrt(s < T(0) ? T(0) : s);  // clamp_min: a NaN stays NaN
    e.b0 = (T(19092.56) + t * (T(209.8925) + t * (T(-3.041638) +
            t * (T(-1.852732e-3) + t * T(-1.361629e-5))))) +
           s * ((T(104.4077) + t * (T(-6.500517) + t * (T(0.1553190) +
                 t * T(2.326469e-4)))) +
                ss * (T(-5.587545) + t * (T(0.7390729) +
                      t * T(-1.909078e-2))));
    e.bpz = (T(-4.721788e-1) + t * (T(-1.028859e-2) + t * (T(2.512549e-4) +
             t * T(5.939910e-7)))) +
            s * ((T(1.571896e-2) + t * (T(2.598241e-4) +
                  t * T(-7.267926e-6))) + ss * T(-2.042967e-3));
    e.bpz2 = (T(1.045941e-5) + t * (T(-5.782165e-10) + t * T(1.296821e-7))) +
             s * (T(-2.595994e-7) + t * (T(-1.248266e-9) +
                  t * T(-3.508914e-9)));
    e.rhopot = (T(999.842594) + t * (T(6.793952e-2) + t * (T(-9.095290e-3) +
                t * (T(1.001685e-4) + t * (T(-1.120083e-6) +
                t * T(6.536332e-9)))))) +
               s * (((T(0.824493) + t * (T(-4.08990e-3) + t * (T(7.64380e-5) +
                      t * (T(-8.24670e-7) + t * T(5.38750e-9))))) +
                     ss * (T(-5.72466e-3) + t * (T(1.02270e-4) +
                           t * T(-1.65460e-6)))) +
                    s * T(4.8314e-4));
  } else {
    e.b0 = T(1);
    e.bpz = T(0);
    e.bpz2 = T(0);
    if (kind == 2)
      e.rhopot = rho0 - (T(0.00025) * (t - T(10.0))) * rho0;
    else
      e.rhopot = (rho0 + T(0.8) * (s - T(34.0))) - T(0.2) * (t - T(20.0));
  }
  return e;
}

// in-situ density of the water with components e at depth z
template <typename T>
__device__ T insitu(const Eos<T>& e, T z, T sef) {
  T bulk = e.b0 + z * (e.bpz + z * e.bpz2);
  return bulk * e.rhopot / (bulk + T(0.1) * z * sef);
}

constexpr int kTile = 32;   // nodes per block: threadIdx.x
constexpr int kCells = 4;   // consecutive levels per thread: threadIdx.y

template <typename T>
__global__ void __launch_bounds__(1024) pressure_bv_kernel(
    const T* __restrict__ tt, const T* __restrict__ ss,
    const T* __restrict__ Z3, const T* __restrict__ zb3,
    const T* __restrict__ hnode, const T* __restrict__ dref,
    const int* __restrict__ nlevels, const int* __restrict__ ulevels, int nl,
    int cols, int kind, T g, T rho0,
    T* __restrict__ rho_out, T* __restrict__ hp_out, T* __restrict__ bv_out,
    T* __restrict__ db_out, T* __restrict__ mld2) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const int L = nl - 1;
  const int runs = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // the tile's inputs, [L][kTile] each; pass 1 writes over what it has
  // read: t -> the density at the upper interface, s -> at the lower
  // one, h -> rho * h, rho_ref -> rho_full
  T* sT = reinterpret_cast<T*>(shared_raw);
  T* sS = sT + L * kTile;
  T* sZ = sS + L * kTile;
  T* sH = sZ + L * kTile;
  T* sR = sH + L * kTile;
  T* sZb = sR + L * kTile;      // interfaces 0..L-1
  T* e0_s = sZb + L * kTile;    // [4][kTile]: the top cell's components
  T* base_s = e0_s + 4 * kTile; // [kTile]: -Z[u] rho[u] g
  int* mld_s = reinterpret_cast<int*>(base_s + kTile);  // [runs][kTile]
  const int n = blockIdx.x * kTile + tx;
  const bool active = n < cols;
  const long long N = cols;
  const int nln1 = active ? nlevels[n] - 1 : 0;  // below the last wet layer
  const int u = active ? ulevels[n] - 1 : 0;     // the top (wet) layer
  const int k0 = ty * kCells;
  const T sef = kind == 1 ? T(1) : T(0);
  const T mg = -g;
  const T half_g = T(0.5) * g;  // the constant 0.5 * g, rounded once
  constexpr int kNone = 1 << 30;

  // stage the cells this thread owns; dry cells are not read, except
  // level u + 1 of a one-layer column (its N^2 is the surface copy's)
  if (active) {
    for (int i = 0; i < kCells; ++i) {
      const int k = k0 + i;
      if (k >= L) break;
      const long long idx = k * N + n;
      const int s = k * kTile + tx;
      const bool wet = k >= u && k < nln1;
      if (wet || k == u + 1) {
        fesom::cp_async(sT + s, tt + idx);
        fesom::cp_async(sS + s, ss + idx);
        fesom::cp_async(sZ + s, Z3 + idx);
        if (k > u) fesom::cp_async(sZb + s, zb3 + idx);
      }
      if (wet) {
        fesom::cp_async(sH + s, hnode + idx);
        fesom::cp_async(sR + s, dref + idx);
      }
    }
  }
  fesom::cp_async_commit();
  fesom::cp_async_wait<0>();
  __syncthreads();

  // pass 1: each cell on its own
  T rhopot[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = k0 + i;
    rhopot[i] = T(0);
    if (active && k < L) {
      const int s = k * kTile + tx;
      const bool wet = k >= u && k < nln1;
      T rho = T(0);
      if (wet || k == u + 1) {
        const T z = sZ[s];
        const Eos<T> e = eos_components(sT[s], sS[s], kind, rho0);
        rhopot[i] = e.rhopot;
        T rhoh = T(0);
        if (wet) {
          const T dr = sR[s];
          rho = insitu(e, z, sef) - dr;
          rhoh = rho * sH[s];
          sR[s] = rho + dr;
        }
        sH[s] = rhoh;
        // densities at the upper interface (N^2 at interface k) and at
        // the lower one (N^2 at interface k + 1)
        if (k > u) sT[s] = insitu(e, sZb[s], sef);
        if (k + 1 < L && k >= u && (k + 1 < nln1 || k == u))
          sS[s] = insitu(e, sZb[s + kTile], sef);
        if (k == u) {
          e0_s[tx] = e.b0;
          e0_s[kTile + tx] = e.bpz;
          e0_s[2 * kTile + tx] = e.bpz2;
          e0_s[3 * kTile + tx] = e.rhopot;
          base_s[tx] = ((-z) * rho) * g;
        }
      }
      rho_out[k * N + n] = rho;
    }
  }
  __syncthreads();

  if (active) {
    // the last run sums the pressure down the column, in level order
    if (ty == runs - 1) {
      const T base = base_s[tx];
      T hsum = T(0);
      for (int k = 0; k < L; ++k) {
        T hp = T(0);
        if (k >= u && k < nln1) {
          if (k > u)
            hsum = hsum + half_g * (sH[(k - 1) * kTile + tx] +
                                    sH[k * kTile + tx]);
          hp = base + hsum;
        }
        hp_out[k * N + n] = hp;
      }
    }
    // pass 2
    Eos<T> e0;
    e0.b0 = e0_s[tx];
    e0.bpz = e0_s[kTile + tx];
    e0.bpz2 = e0_s[2 * kTile + tx];
    e0.rhopot = e0_s[3 * kTile + tx];
    int mld = kNone;
#pragma unroll
    for (int i = 0; i < kCells; ++i) {
      const int k = k0 + i;
      if (k < L) {
        const int s = k * kTile + tx;
        const long long idx = k * N + n;
        const bool wet = k >= u && k < nln1;
        // buoyancy difference to the top water brought to depth z;
        // row nln-1 copies row nln-2 and is written by its thread
        T db = T(0);
        if (wet) {
          const T rho_full = sR[s];
          db = mg * (insitu(e0, sZ[s], sef) - rho_full) /
               (rho_full == T(0) ? T(1) : rho_full);
        }
        if (k != nln1) db_out[idx] = db;
        if (k + 1 == nln1) db_out[idx + N] = db;
        else if (k == L - 1) db_out[idx + N] = T(0);
        // N^2 at interface k (between layers k-1 and k); each row of
        // bv_out has one writer: row k that of level k, but the top row u
        // (the copy of interface u + 1, written by level u + 1 or, where
        // u + 1 is the bottom interface L, 0 by level u), the bottom
        // copy nln - 1 (written by the level above, unless that is u) and
        // row L (by level L - 1)
        T bv = T(0);
        if (k > u && (wet || k == u + 1)) {
          const T dz_inv = T(1) / (sZ[s - kTile] - sZ[s]);
          bv = mg * dz_inv * (sS[s - kTile] - sT[s]) / rho0;
        }
        if (k == u + 1) bv_out[idx - N] = bv;  // the top copies interface u+1
        if (k == u && u + 1 == L) bv_out[idx] = T(0);
        if (k != u && (k != nln1 || k == u + 1)) bv_out[idx] = bv;
        if (k > u && k + 1 == nln1) bv_out[idx + N] = bv;
        else if (k == L - 1) bv_out[idx + N] = T(0);
        // mixed-layer depth: the first level that crosses the criterion
        if (k > u && mld == kNone &&
            (!wet || (rhopot[i] - e0.rhopot) > T(0.125)))
          mld = k;
      }
    }
    mld_s[ty * kTile + tx] = mld;
  }
  __syncthreads();
  if (active && ty == runs - 1) {
    int first = 0;
    for (int r = 0; r < runs; ++r) {
      const int m = mld_s[r * kTile + tx];
      if (m != kNone) {
        first = m;
        break;
      }
    }
    mld2[n] = Z3[(first > u + 1 ? first : u + 1) * N + n];
  }
}

template <typename T>
cudaError_t launch(const void* t, const void* s, const void* Z3,
                   const void* zb3, const void* hnode, const void* dref,
                   const void* nlevels, const void* ulevels, int nl,
                   int cols, int kind, double g, double rho0, void* rho,
                   void* hp, void* bv, void* db, void* mld2,
                   cudaStream_t stream) {
  const int L = nl - 1;
  if (cols == 0) return cudaSuccess;
  const int runs = (L + kCells - 1) / kCells;
  if (L < 1 || cols < 0 || runs * kTile > 1024) return cudaErrorInvalidValue;
  const size_t bytes =
      static_cast<size_t>(6 * L + 5) * kTile * sizeof(T) +
      static_cast<size_t>(runs) * kTile * sizeof(int);
  cudaError_t err = fesom::allow_shared(pressure_bv_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((cols + kTile - 1) / kTile);
  pressure_bv_kernel<T><<<grid, dim3(kTile, runs), bytes, stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(s),
      static_cast<const T*>(Z3), static_cast<const T*>(zb3),
      static_cast<const T*>(hnode), static_cast<const T*>(dref),
      static_cast<const int*>(nlevels), static_cast<const int*>(ulevels), nl,
      cols, kind, static_cast<T>(g),
      static_cast<T>(rho0), static_cast<T*>(rho), static_cast<T*>(hp),
      static_cast<T*>(bv), static_cast<T*>(db), static_cast<T*>(mld2));
  return cudaSuccess;
}

}  // namespace

extern "C" int fesom_pressure_bv(const void* t, const void* s, const void* Z3,
                                 const void* zb3, const void* hnode,
                                 const void* dref, const void* nlevels,
                                 const void* ulevels, int nl, int cols,
                                 int kind, double g, double rho0,
                                 void* rho, void* hp, void* bv, void* db,
                                 void* mld2, int is_double, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_double ? launch<double>(t, s, Z3, zb3, hnode, dref, nlevels,
                                 ulevels, nl, cols, kind, g, rho0, rho, hp,
                                 bv, db, mld2, st)
                : launch<float>(t, s, Z3, zb3, hnode, dref, nlevels, ulevels,
                                nl, cols, kind, g, rho0, rho, hp, bv, db,
                                mld2, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return fesom::last_error();
}
