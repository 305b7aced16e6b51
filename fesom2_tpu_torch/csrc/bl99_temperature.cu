// bl99_temperature_solve: the BL99 (Bitz & Lipscomb 1999) temperature
// solve of Icepack's vertical thermodynamics, every sweep of its iteration
// and the final fluxes, in one cooperative launch.
//
// Replaces fesom2_tpu/ice/icepack/thermo_vertical.py:142-316
// (temperature_solve): a lax.while_loop whose body (534 jaxpr equations a
// sweep) rebuilds the conductive couplings and the surface-flux
// linearisation, assembles the 1 + nslyr + nilyr row system with the
// melting branch, runs the Thomas solve, clamps the iterates and updates
// the melting state.  No TPU kernel: the JAX package left the loop to XLA.
// The plain version is ice/icepack/thermo_vertical.py:
// temperature_solve_plain, a loop of torch ops that reads each sweep's
// error on the host.
//
// The stopping rule is JAX's, global: the loop runs while
//   i < 100 and (err > 5e-4 or i < niter_therm),
// err the largest finite |Tsf_new - Tsf| of the sweep over every column
// (columns without ice too: they are solved with hi clamped to 0.01).  So
// every column sweeps the same number of times as in the JAX package and
// the plain version.  A column's sweeps depend on its own data alone; only
// the count is global.
//
// Layout: one thread a (category, node) column, col = c * N + node, walked
// grid-stride over the resident grid (cooperative launch); a thread keeps
// its columns for the whole launch, so only it reads and writes their
// iterate (Tsf, the ice temperatures, the melting flag).
//
// Design: the sweeps run in chunks of at most 16 sweeps, and a column
// stays in registers for a whole chunk.  Per chunk a thread takes each of
// its columns once: it reads the inputs and computes what no sweep changes
// (dzi, dzs, the snow capacity and couplings, cs and ce, fswsfc + emiss
// flw, the balance at Tsf = 0 with its pow and exp), reads the iterate the
// chunk starts from, runs the chunk's sweeps in registers (the profiles
// and iabs read again each sweep, from L1), keeping each sweep's largest
// |dTsf| in shared memory, and stores the iterate (and the snow
// temperatures) once.  At the end of the chunk each block folds its
// maxima into the sweeps' slots (atomicMax on the bits of the non-negative
// float: an unsigned image that keeps the order), one grid barrier, and
// every thread reads the slots and finds, alike, the first sweep of the
// chunk at which the loop above stops.  None: the next chunk starts from
// the stored iterate.  One: the sweeps of the chunk after it were
// speculative and are dropped; a final pass restarts each column from the
// iterate the chunk began with (two scratch buffers alternate), reruns
// the sweeps up to the stop (none where the stop ends the chunk) and
// writes the outputs and the fluxes.  A chunk's length follows the slots:
// the first runs up to niter_therm sweeps (the loop cannot stop before),
// each later one as many as the decay of the last two maxima, taken as
// geometric, needs to reach the tolerance (at most 16; `chunk` where the
// maxima do not fall), so that the stop tends to end a chunk.  Each sweep
// is the same function of the same column data as the loop's, so the
// results are the loop's whatever the chunks, and the slots hold the same
// maxima; a maximum does not depend on the order of the atomics, so the
// result is deterministic.

// Within a sweep the Thomas elimination is fused into the assembly: each
// row is eliminated as it is built, the couplings computed as the rows
// need them, and only the cp and dp rows are kept.  Per-layer constants
// (0.09 S or beta S, Lfresh Tm, Tm - 1e-6) sit in shared memory.
//
// Every product, quotient and sum is taken in the plain version's order,
// with each Python constant rounded to the working type where torch
// rounds it (a constant folded in Python first is folded here in double
// first), each product rounded on its own (-fmad=false), minima and maxima
// propagating NaN as torch.clamp does, a Python number divided by a
// tensor as torch's reciprocal-then-multiply, a tensor divided by a Python
// number as torch does on the CPU (a true quotient; torch on CUDA
// multiplies by the reciprocal, which may round an ulp apart).  exp and pow are CUDA's, not
// correctly rounded, so the kernel matches the plain version to rounding
// (1e-12 of max|plain| in float64, 1e-5 in float32) and, where no column
// sits on the stopping threshold, in its sweep count.  A value computed
// once instead of once a sweep is the same value, so the outputs equal
// those of the first design (one grid barrier a sweep, every input read
// again each sweep) bit for bit.
//
// Bound on the card: operations.  The function reads hi, hs, Tsf0,
// fswsfc, the initial profiles and iabs a column and five node rows, and
// writes 15 values and a flag a column: at ncat = 5 on the level-7 globe
// (570,165 columns) some 150 MB in float64, 45 us at 3.35 TB/s.  The
// arithmetic is 209 floating operations a column and sweep at
// nilyr = nslyr = 4 (temperature_solve_work itemises them), some 64 us in
// float64 at 18 sweeps.  This design moves some 230 B a column a chunk
// (inputs, the iterate in and out, the snow temperatures out) instead of
// some 250 B a sweep, crosses a grid barrier a chunk, and does no more
// sweeps than the loop where the stop ends a chunk (else the speculative
// tail of the last chunk and its rerun); its time is the sweeps' float64
// divisions (38 a sweep), pow and exp.  Two blocks an SM in float64 and
// three in float32: more resident blocks (the Thomas rows in shared
// memory, or registers capped with spills) measured slower.
#include <cooperative_groups.h>

#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kMaxLayers = 16;
constexpr int kMaxChunk = 16;        // sweeps a chunk, at most
constexpr int kNitMax = 100;         // Icepack's maxiter
constexpr double kErrMax = 5e-4;     // Icepack's Tsf_errmax [C]
enum { kBubbly = 0, kMU71 = 1 };

// constants of fesom2_tpu_torch/ice/icepack/constants.py
constexpr double rhoi = 917.0, rhos = 330.0, cp_ice = 2106.0,
                 cp_air = 1005.0, Lfresh = 3.34e5, Lvap = 2.501e6,
                 Lsub = Lfresh + Lvap, kice0 = 2.03,
                 beta_mu71 = 0.13, stefan_boltzmann = 567.0e-10,
                 Tffresh = 273.15, rhoair = 1.3, hs_min = 1.0e-4,
                 qqqice = 11221.8, TTTice = 5897.8;
constexpr double Ch_ice = 1.75e-3, Ce_ice = 1.75e-3;

template <typename T>
struct Params {
  const T *hi, *hs, *Tsf0, *Tsn0, *Tin0, *fswsfc, *iabs;  // columns
  const T *flw, *Tair, *shum, *wind, *Tbot;               // [N]
  const T *shcoef, *lhcoef;                               // [ncat, N] or null
  const double* layers;                                   // [2, nilyr]
  T *Tsf, *Tsn, *Tin;                                     // the iterate
  unsigned char* melting;
  T *fsurf, *fcondtop, *fcondbot, *fsens, *flat, *flwout;
  int* niter;
  unsigned long long* slots;                              // [kNitMax]
  T* state;   // two iterate buffers, each Tsf [cols], melting as 0 or 1
              // [cols] and Tin [ncat, nilyr, N]
  int ncat, n_nodes, nilyr, nslyr, niter_therm, chunk;
  T dt, emiss, t_floor;
  double ksno_d, emiss_d;   // as Python holds them, for constants folded
};

// torch.clamp_min / clamp_max: NaN stays NaN
template <typename T>
__device__ __forceinline__ T cmax(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
__device__ __forceinline__ T cmin(T x, T hi) { return x > hi ? hi : x; }

// the order-preserving unsigned image of a non-negative float
__device__ __forceinline__ unsigned long long bits_of(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(x));
}
__device__ __forceinline__ unsigned long long bits_of(float x) {
  return static_cast<unsigned long long>(__float_as_uint(x));
}
template <typename T>
__device__ __forceinline__ T from_bits(unsigned long long b);
template <>
__device__ __forceinline__ double from_bits<double>(unsigned long long b) {
  return __longlong_as_double(static_cast<long long>(b));
}
template <>
__device__ __forceinline__ float from_bits<float>(unsigned long long b) {
  return __uint_as_float(static_cast<unsigned>(b));
}

// surface_fluxes: fsurf and its derivative, and the three fluxes; A is
// fswsfc + emiss flw, the first partial sum of fsurf
template <typename T>
struct Surface {
  T fsurf, dfsurf, fsens, flat, flwout;
};

template <typename T>
__device__ __forceinline__ Surface<T> surface(T Tsf, T A, T Tair, T shum,
                                              T cs, T ce, double emiss_d) {
  Surface<T> s;
  const T TK = Tsf + T(Tffresh);
  s.flwout = T(-emiss_d * stefan_boltzmann) * pow(TK, T(4));
  const T dflw = T(-4.0 * emiss_d * stefan_boltzmann) * ((TK * TK) * TK);
  s.fsens = cs * (Tair - Tsf);
  const T dfsens = -cs;
  // _qsat_ice: -TTTice / (Tsf + Tffresh) is a scalar over a tensor
  const T qs = T(qqqice / rhoair) *
               exp((T(1) / (Tsf + T(Tffresh))) * T(-TTTice));
  s.flat = ce * (shum - qs);
  const T dflat = (((-ce) * qs) * T(TTTice)) / (TK * TK);
  s.fsurf = ((A + s.flwout) + s.fsens) + s.flat;
  s.dfsurf = (dflw + dfsens) + dflat;
  return s;
}

// conductivity_ice; kS is 0.09 S (bubbly) or beta_mu71 S (MU71)
template <typename T, int C>
__device__ __forceinline__ T conductivity(T Tk, T kS) {
  const T Ts = cmin(Tk, T(-0.01));
  T k;
  if (C == kMU71)
    k = T(kice0) + kS / Ts;
  else
    k = (T(2.11) - T(0.011) * Ts) + kS / Ts;
  return cmax(k, T(0.1 * kice0));
}

// per-layer constants, shared by the block
template <typename T>
struct Layers {
  T kS[kMaxLayers], LTm[kMaxLayers], Tmax[kMaxLayers];
};

// what no sweep changes, of one column (its profiles and iabs are read
// again each sweep, from L1: a thread rereads its column within the chunk)
template <typename T>
struct Column {
  T dzi, dzs, ks_dzi, c_sfc_snow, c_snow_snow, cap_snow;
  T A, cs, ce, Tair, shum, Tbot, fs0;
  const T *Tsn0, *Tin0, *iabs;   // the column's first layer; layers N apart
  bool snow_on;
};

template <typename T>
__device__ __forceinline__ void load_column(const Params<T>& p, long long col,
                                            long long c, long long i, int ni,
                                            int ns, Column<T>& q) {
  const long long N = p.n_nodes;
  const T hi = __ldg(p.hi + col), hs = __ldg(p.hs + col);
  q.dzi = cmax(hi, T(0.01)) / T(ni);
  q.snow_on = hs >= T(hs_min);
  q.dzs = cmax(hs, T(hs_min)) / T(ns);
  q.cap_snow = q.snow_on ? (T(rhos * cp_ice) * q.dzs) / p.dt : T(1e-6);
  // 2 ks / dzs and ks / dzs: a Python number over a tensor
  q.c_sfc_snow = (T(1) / q.dzs) * T(2.0 * p.ksno_d);
  q.c_snow_snow = (T(1) / q.dzs) * T(p.ksno_d);
  q.ks_dzi = T(p.ksno_d) * q.dzi;
  const T wind = __ldg(p.wind + i);
  q.cs = p.shcoef ? __ldg(p.shcoef + col) : T(rhoair * cp_air * Ch_ice) * wind;
  q.ce = p.lhcoef ? __ldg(p.lhcoef + col) : T(rhoair * Lsub * Ce_ice) * wind;
  q.Tair = __ldg(p.Tair + i);
  q.shum = __ldg(p.shum + i);
  q.Tbot = __ldg(p.Tbot + i);
  q.A = __ldg(p.fswsfc + col) + p.emiss * __ldg(p.flw + i);
  q.fs0 = surface(T(0), q.A, q.Tair, q.shum, q.cs, q.ce, p.emiss_d).fsurf;
  q.Tsn0 = p.Tsn0 + c * ns * N + i;
  q.Tin0 = p.Tin0 + c * ni * N + i;
  q.iabs = p.iabs + c * ni * N + i;
}

// One sweep of a column: the rows assembled and eliminated in order, the
// back substitution, the clamps and the melting update.  Updates the
// iterate (Tsf, Tin, melting), writes the snow temperatures to Tsn and
// returns |Tsf_new - Tsf|.
template <typename T, int C, int kI, int kS>
__device__ __forceinline__ T sweep(const Column<T>& q, const Layers<T>& L,
                                   long long N, int ni, int ns, T two_ks,
                                   T dt, T t_floor, double emiss_d, T& Tsf,
                                   T* Tin, bool& melting, T* Tsn) {
  constexpr int kM = 1 + kI + kS;
  T ki[kI];
#pragma unroll
  for (int k = 0; k < kI; ++k)
    if (k < ni) ki[k] = conductivity<T, C>(Tin[k], L.kS[k]);
  const T k_direct = (T(2) * ki[0]) / q.dzi;
  const T series_off = T(ns + 1) * k_direct;
  const T Cs0 = q.snow_on ? q.c_sfc_snow : series_off;

  T cp[kM], dp[kM];
  // surface row
  if (melting) {
    cp[0] = T(0);   // 0 / 1
    dp[0] = T(0);
  } else {
    const Surface<T> sf = surface(Tsf, q.A, q.Tair, q.shum, q.cs, q.ce,
                                  emiss_d);
    const T diag = Cs0 - sf.dfsurf;
    cp[0] = (-Cs0) / diag;
    dp[0] = (sf.fsurf - sf.dfsurf * Tsf) / diag;
  }
  // snow rows: Cs[j] and Cs[j + 1] couple row 1 + j to its neighbours
  T cl = Cs0;
#pragma unroll
  for (int j = 0; j < kS; ++j)
    if (j < ns) {
      const int r = 1 + j;
      T cr;
      if (j + 1 < ns)
        cr = q.snow_on ? q.c_snow_snow : series_off;
      else
        cr = q.snow_on ? (two_ks * ki[0]) / (ki[0] * q.dzs + q.ks_dzi)
                       : series_off;
      const T diag = (q.cap_snow + cl) + cr;
      const T sub = -cl;
      const T den = diag - sub * cp[r - 1];
      cp[r] = (-cr) / den;
      dp[r] = (q.cap_snow * __ldg(q.Tsn0 + j * N) - sub * dp[r - 1]) / den;
      cl = cr;
    }
  // ice rows; the last couples to the bottom through K_bot
#pragma unroll
  for (int k = 0; k < kI; ++k)
    if (k < ni) {
      const int r = 1 + ns + k;
      const bool last = k == ni - 1;
      const int k1 = k + 1 < kI ? k + 1 : k;   // k + 1 where not last
      const T cr = last ? (T(2) * ki[k]) / q.dzi
                        : ((T(2) * ki[k]) * ki[k1]) /
                              (q.dzi * (ki[k] + ki[k1]));
      const T Tin_init = __ldg(q.Tin0 + k * N);
      const T Tprod = cmin(Tin[k], t_floor) * cmin(Tin_init, t_floor);
      const T cap = T(rhoi) * (T(cp_ice) - L.LTm[k] / Tprod);
      const T a = (cap * q.dzi) / dt;
      const T diag = (a + cl) + cr;
      const T sub = -cl;
      T rhs = a * Tin_init + __ldg(q.iabs + k * N);
      if (last) rhs = rhs + cr * q.Tbot;
      const T den = diag - sub * cp[r - 1];
      if (!last) cp[r] = (-cr) / den;
      dp[r] = (rhs - sub * dp[r - 1]) / den;
      cl = cr;
    }
  // back substitution: dp becomes the solution
  const int m = 1 + ns + ni;
#pragma unroll
  for (int j = kM - 2; j >= 0; --j)
    if (j < m - 1) dp[j] = dp[j] - cp[j] * dp[j + 1];

  // clamps
#pragma unroll
  for (int j = 0; j < kS; ++j)
    if (j < ns) Tsn[j] = cmin(cmax(dp[1 + j], T(-100)), T(0));
#pragma unroll
  for (int k = 0; k < kI; ++k)
    if (k < ni) Tin[k] = cmin(cmax(dp[1 + ns + k], T(-100)), L.Tmax[k]);
  // melting-state update
  const T fct0 = Cs0 * (T(0) - dp[1]);
  const bool melt_next = melting ? (q.fs0 > fct0) : (dp[0] > T(0));
  const T Tsf_new = melt_next ? T(0) : cmin(cmax(dp[0], T(-100)), T(0));
  const T dT = fabs(Tsf_new - Tsf);
  Tsf = Tsf_new;
  melting = melt_next;
  return dT;
}

// iterate buffer b (1 or 2): Tsf, then the flags, then Tin
template <typename T>
__device__ __forceinline__ T* iterate(const Params<T>& p, int b) {
  return p.state + static_cast<long long>(b - 1) * (2 + p.nilyr) *
                       p.n_nodes * p.ncat;
}

// the iterate a pass starts from: 0 the initial state, else buffer `from`
// (written earlier in the launch by this thread)
template <typename T, int kI>
__device__ __forceinline__ void load_state(const Params<T>& p, int from,
                                           long long col, long long c,
                                           long long i, int ni, T& Tsf,
                                           T* Tin, bool& melting) {
  const long long N = p.n_nodes;
  const long long cols = N * p.ncat;
  const T* b = from ? iterate(p, from) : nullptr;
  Tsf = from ? b[col] : __ldg(p.Tsf0 + col);
  melting = from ? b[cols + col] != T(0) : false;
#pragma unroll
  for (int k = 0; k < kI; ++k)
    if (k < ni) {
      const long long idx = (c * ni + k) * N + i;
      Tin[k] = from ? b[2 * cols + idx] : __ldg(p.Tin0 + idx);
    }
}

template <typename T, int kI>
__device__ __forceinline__ void store_state(const Params<T>& p, int to,
                                            long long col, long long c,
                                            long long i, int ni, T Tsf,
                                            const T* Tin, bool melting) {
  const long long N = p.n_nodes;
  const long long cols = N * p.ncat;
  T* b = iterate(p, to);
  b[col] = Tsf;
  b[cols + col] = melting ? T(1) : T(0);
#pragma unroll
  for (int k = 0; k < kI; ++k)
    if (k < ni) b[2 * cols + (c * ni + k) * N + i] = Tin[k];
}

// The next chunk's length, at k0 sweeps taken: up to niter_therm sweeps
// (no stop before), then as many as the decay of the last two sweeps'
// maxima e0 > e1 > 0, taken as geometric, needs to reach the tolerance
// (a stop at the chunk's end reruns nothing; a chunk that ends short only
// costs a pass), else `chunk`.  Every thread computes it alike.
__device__ __forceinline__ int next_chunk(int k0, int niter_therm, int chunk,
                                          double e0, double e1) {
  int len = chunk;
  if (k0 + 1 < niter_therm) {
    len = niter_therm - k0;
  } else if (k0 >= 2 && e1 > 0.0 && e0 > e1) {
    const double m = ceil(log(kErrMax / e1) / log(e1 / e0));
    len = m < 1.0 ? 1 : m > kMaxChunk ? kMaxChunk : static_cast<int>(m);
  }
  len = len < kMaxChunk ? len : kMaxChunk;
  return len < kNitMax - k0 ? len : kNitMax - k0;
}

template <typename T, int NI>
struct MinBlocks {  // resident blocks an SM the registers are cut for
  static constexpr int value = NI > 0 ? (sizeof(T) == 8 ? 2 : 3) : 1;
};

template <typename T, int C, int NI, int NS>
__global__ void __launch_bounds__(kBlock, (MinBlocks<T, NI>::value))
    bl99_kernel(Params<T> p) {
  constexpr int kI = NI > 0 ? NI : kMaxLayers;
  constexpr int kS = NS > 0 ? NS : kMaxLayers;
  const int ni = NI > 0 ? NI : p.nilyr;
  const int ns = NS > 0 ? NS : p.nslyr;
  const long long N = p.n_nodes;
  const long long cols = N * p.ncat;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  const long long first = static_cast<long long>(blockIdx.x) * kBlock +
                          threadIdx.x;
  const int tid = threadIdx.x;
  const double emiss_d = p.emiss_d;
  const T two_ks = T(2.0 * p.ksno_d);
  cg::grid_group grid = cg::this_grid();
  __shared__ Layers<T> L;
  __shared__ T s_err[kMaxChunk][kBlock];          // a thread's sweep maxima
  __shared__ T s_warp[kMaxChunk][kBlock / 32];

  for (int k = tid; k < ni; k += kBlock) {
    const T S = T(p.layers[k]), Tm = T(p.layers[ni + k]);
    L.kS[k] = (C == kMU71 ? T(beta_mu71) : T(0.09)) * S;
    L.LTm[k] = T(Lfresh) * Tm;
    L.Tmax[k] = Tm - T(1e-6);
  }
  __syncthreads();

  // the chunks: a chunk reads the iterate from `from` (0: the initial
  // state; then the two buffers in turn) and writes it to `to`
  int k0 = 0, from = 0, to = 1, len = 0, stop = -1;
  double e0 = 0.0, e1 = 0.0;   // the maxima of the last two sweeps
  while (true) {
    len = next_chunk(k0, p.niter_therm, p.chunk, e0, e1);
    for (int j = 0; j < len; ++j) s_err[j][tid] = T(0);
    for (long long col = first; col < cols; col += stride) {
      const long long c = col / N, i = col - c * N;
      Column<T> q;
      load_column(p, col, c, i, ni, ns, q);
      T Tsf, Tin[kI], Tsn[kS];
      bool melting;
      load_state<T, kI>(p, from, col, c, i, ni, Tsf, Tin, melting);
      for (int j = 0; j < len; ++j) {
        const T dT = sweep<T, C, kI, kS>(q, L, N, ni, ns, two_ks, p.dt,
                                         p.t_floor, emiss_d, Tsf, Tin,
                                         melting, Tsn);
        if (isfinite(dT) && dT > s_err[j][tid]) s_err[j][tid] = dT;
      }
      store_state<T, kI>(p, to, col, c, i, ni, Tsf, Tin, melting);
#pragma unroll
      for (int j = 0; j < kS; ++j)
        if (j < ns) p.Tsn[(c * ns + j) * N + i] = Tsn[j];
    }
    // the block's maximum of each sweep into the sweep's slot
    for (int j = 0; j < len; ++j) {
      T local = s_err[j][tid];
      for (int o = 16; o > 0; o >>= 1) {
        const T other = __shfl_down_sync(0xffffffffu, local, o);
        if (other > local) local = other;
      }
      if ((tid & 31) == 0) s_warp[j][tid >> 5] = local;
    }
    __syncthreads();
    if (tid < len) {
      T b = s_warp[tid][0];
      for (int w = 1; w < kBlock / 32; ++w)
        if (s_warp[tid][w] > b) b = s_warp[tid][w];
      atomicMax(p.slots + k0 + tid, bits_of(b));
    }
    grid.sync();
    // the loop's rule after each sweep of the chunk
    for (int j = 0; j < len; ++j) {
      const int it = k0 + j + 1;   // sweeps taken
      const double err = static_cast<double>(
          from_bits<T>(__ldcg(p.slots + k0 + j)));
      if (!(it < kNitMax && (err > kErrMax || it < p.niter_therm))) {
        stop = k0 + j;
        break;
      }
      e0 = e1;
      e1 = err;
    }
    if (stop >= 0) break;
    k0 += len;
    from = to;
    to = 3 - to;
  }
  if (first == 0) *p.niter = stop + 1;

  // the final pass: the iterate at the stop (rerun from the chunk's start
  // where the stop falls inside the chunk), into the outputs, and the
  // fluxes at the final state
  const int rerun = stop - k0 + 1 == len ? 0 : stop - k0 + 1;
  const int src = rerun ? from : to;
  for (long long col = first; col < cols; col += stride) {
    const long long c = col / N, i = col - c * N;
    Column<T> q;
    load_column(p, col, c, i, ni, ns, q);
    T Tsf, Tin[kI], Tsn[kS];
    bool melting;
    load_state<T, kI>(p, src, col, c, i, ni, Tsf, Tin, melting);
    for (int j = 0; j < rerun; ++j)
      sweep<T, C, kI, kS>(q, L, N, ni, ns, two_ks, p.dt, p.t_floor, emiss_d,
                          Tsf, Tin, melting, Tsn);
    if (rerun) {
#pragma unroll
      for (int j = 0; j < kS; ++j)
        if (j < ns) p.Tsn[(c * ns + j) * N + i] = Tsn[j];
    } else {
      Tsn[0] = p.Tsn[(c * ns) * N + i];
    }
    p.Tsf[col] = Tsf;
    p.melting[col] = melting ? 1 : 0;
#pragma unroll
    for (int k = 0; k < kI; ++k)
      if (k < ni) p.Tin[(c * ni + k) * N + i] = Tin[k];
    const T ki0 = conductivity<T, C>(Tin[0], L.kS[0]);
    const T kib = conductivity<T, C>(Tin[ni - 1], L.kS[ni - 1]);
    const T Cs0 = q.snow_on ? q.c_sfc_snow
                            : T(ns + 1) * ((T(2) * ki0) / q.dzi);
    const T K_bot = (T(2) * kib) / q.dzi;
    const Surface<T> sf = surface(Tsf, q.A, q.Tair, q.shum, q.cs, q.ce,
                                  emiss_d);
    p.fsurf[col] = sf.fsurf;
    p.fsens[col] = sf.fsens;
    p.flat[col] = sf.flat;
    p.flwout[col] = sf.flwout;
    p.fcondtop[col] = Cs0 * (Tsf - Tsn[0]);
    p.fcondbot[col] = K_bot * (q.Tbot - Tin[ni - 1]);
  }
}

template <typename T, int C, int NI, int NS>
cudaError_t plan_of(long long cols, int* grid, int* per_sm) {
  int sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, bl99_kernel<T, C, NI, NS>, kBlock, 0);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  long long want = (cols + kBlock - 1) / kBlock;
  long long most = static_cast<long long>(*per_sm) * sms;
  *grid = static_cast<int>(want < most ? (want > 0 ? want : 1) : most);
  return cudaSuccess;
}

template <typename T, int C, int NI, int NS>
int launch(Params<T> p, cudaStream_t stream) {
  int grid = 0, per_sm = 0;
  cudaError_t err = plan_of<T, C, NI, NS>(
      static_cast<long long>(p.ncat) * p.n_nodes, &grid, &per_sm);
  if (err == cudaSuccess) {
    void* args[] = {&p};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(bl99_kernel<T, C, NI, NS>), dim3(grid),
        dim3(kBlock), args, 0, stream);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return fesom::last_error();
}

template <typename T, int C>
int by_layers(Params<T> p, cudaStream_t stream) {
  if (p.nilyr == 4 && p.nslyr == 4) return launch<T, C, 4, 4>(p, stream);
  return launch<T, C, 0, 0>(p, stream);
}

template <typename T>
int run(void* const* ptr, int ncat, int n_nodes, int nilyr, int nslyr,
        int niter_therm, int conduct, int chunk, double dt, double ksno,
        double emiss, double t_floor, cudaStream_t stream) {
  if (nilyr < 1 || nslyr < 1 || nilyr > kMaxLayers || nslyr > kMaxLayers ||
      chunk < 1 || chunk > kMaxChunk)
    return cudaErrorInvalidValue;
  Params<T> p{};
  p.hi = static_cast<const T*>(ptr[0]);
  p.hs = static_cast<const T*>(ptr[1]);
  p.Tsf0 = static_cast<const T*>(ptr[2]);
  p.Tsn0 = static_cast<const T*>(ptr[3]);
  p.Tin0 = static_cast<const T*>(ptr[4]);
  p.fswsfc = static_cast<const T*>(ptr[5]);
  p.iabs = static_cast<const T*>(ptr[6]);
  p.flw = static_cast<const T*>(ptr[7]);
  p.Tair = static_cast<const T*>(ptr[8]);
  p.shum = static_cast<const T*>(ptr[9]);
  p.wind = static_cast<const T*>(ptr[10]);
  p.Tbot = static_cast<const T*>(ptr[11]);
  p.shcoef = static_cast<const T*>(ptr[12]);
  p.lhcoef = static_cast<const T*>(ptr[13]);
  p.layers = static_cast<const double*>(ptr[14]);
  p.Tsf = static_cast<T*>(ptr[15]);
  p.Tsn = static_cast<T*>(ptr[16]);
  p.Tin = static_cast<T*>(ptr[17]);
  p.melting = static_cast<unsigned char*>(ptr[18]);
  p.fsurf = static_cast<T*>(ptr[19]);
  p.fcondtop = static_cast<T*>(ptr[20]);
  p.fcondbot = static_cast<T*>(ptr[21]);
  p.fsens = static_cast<T*>(ptr[22]);
  p.flat = static_cast<T*>(ptr[23]);
  p.flwout = static_cast<T*>(ptr[24]);
  p.niter = static_cast<int*>(ptr[25]);
  p.slots = static_cast<unsigned long long*>(ptr[26]);
  p.state = static_cast<T*>(ptr[27]);
  p.ncat = ncat;
  p.n_nodes = n_nodes;
  p.nilyr = nilyr;
  p.nslyr = nslyr;
  p.niter_therm = niter_therm;
  p.chunk = chunk;
  p.dt = T(dt);
  p.emiss = T(emiss);
  p.ksno_d = ksno;
  p.emiss_d = emiss;
  p.t_floor = T(t_floor);
  if (static_cast<long long>(ncat) * n_nodes == 0) {
    // nothing to solve: JAX's loop still counts its sweeps on an empty
    // maximum (0), so it stops at niter_therm (at least 1, at most 100)
    const int n = niter_therm < 1 ? 1 : niter_therm < kNitMax ? niter_therm
                                                              : kNitMax;
    cudaMemcpyAsync(p.niter, &n, sizeof(int), cudaMemcpyHostToDevice, stream);
    return fesom::last_error();
  }
  return conduct == kMU71 ? by_layers<T, kMU71>(p, stream)
                          : by_layers<T, kBubbly>(p, stream);
}

}  // namespace

// The BL99 solve of ncat * n_nodes columns.  Inputs hi, hs, Tsf0, fswsfc
// [ncat, N], Tsn0 [ncat, nslyr, N], Tin0, iabs [ncat, nilyr, N], flw, Tair,
// shum, wind, Tbot [N], shcoef, lhcoef [ncat, N] or null, layers [2, nilyr]
// float64 (salinity, melting temperature); outputs Tsf, Tsn, Tin, melting
// (uint8), fsurf, fcondtop, fcondbot, fsens, flat, flwout, niter (int32);
// scratch: slots [100] uint64 zeroed, state [2 (2 + nilyr) ncat N];
// conduct 0 bubbly, 1 MU71; chunk 1..16: the sweeps between grid barriers
// where the error's decay does not set them.
extern "C" int fesom_bl99_temperature_solve(
    void* hi, void* hs, void* Tsf0, void* Tsn0, void* Tin0, void* fswsfc,
    void* iabs, void* flw, void* Tair, void* shum, void* wind, void* Tbot,
    void* shcoef, void* lhcoef, void* layers, void* Tsf, void* Tsn, void* Tin,
    void* melting, void* fsurf, void* fcondtop, void* fcondbot, void* fsens,
    void* flat, void* flwout, void* niter, void* slots, void* state,
    int ncat, int n_nodes, int nilyr, int nslyr, int niter_therm,
    int conduct, int chunk, double dt, double ksno, double emiss,
    int is_double, void* stream) {
  void* const ptr[] = {hi,     hs,      Tsf0,    Tsn0,     Tin0,     fswsfc,
                       iabs,   flw,     Tair,    shum,     wind,     Tbot,
                       shcoef, lhcoef,  layers,  Tsf,      Tsn,      Tin,
                       melting, fsurf,  fcondtop, fcondbot, fsens,   flat,
                       flwout, niter,   slots,   state};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return run<double>(ptr, ncat, n_nodes, nilyr, nslyr, niter_therm,
                       conduct, chunk, dt, ksno, emiss, -1e-3, s);
  return run<float>(ptr, ncat, n_nodes, nilyr, nslyr, niter_therm, conduct,
                    chunk, dt, ksno, emiss, -0.05, s);
}

// The launch the kernel makes for n_cols columns at nilyr = nslyr = 4
// (bubbly): out[0..3] = grid, block, resident blocks an SM, registers a
// thread (out: host int32 [4]).
extern "C" int fesom_bl99_plan(int n_cols, int is_double, void* out) {
  int grid = 0, per_sm = 0;
  cudaError_t err =
      is_double ? plan_of<double, kBubbly, 4, 4>(n_cols, &grid, &per_sm)
                : plan_of<float, kBubbly, 4, 4>(n_cols, &grid, &per_sm);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  int* o = static_cast<int*>(out);
  o[0] = grid;
  o[1] = kBlock;
  o[2] = per_sm;
  cudaFuncAttributes attr{};
  err = is_double
            ? cudaFuncGetAttributes(&attr, bl99_kernel<double, kBubbly, 4, 4>)
            : cudaFuncGetAttributes(&attr, bl99_kernel<float, kBubbly, 4, 4>);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  o[3] = attr.numRegs;
  return cudaSuccess;
}
