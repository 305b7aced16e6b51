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
// the plain version.  Each block takes the maximum over its columns, one
// thread a block folds it into the sweep's own slot with atomicMax on the
// bits of the non-negative float (an unsigned image that keeps the order),
// and a grid barrier (cooperative_groups' grid.sync) separates the sweeps;
// then every thread reads the slot and decides alike.  The slots are zeroed
// by the wrapper before the launch, one per sweep, so no slot is reset
// while another block reads it; a maximum does not depend on the order of
// the atomics, so the result is deterministic.  After the loop the same
// launch writes the fluxes at the final state and the sweep count (a
// device int): the step reads nothing back.
//
// Layout: one thread a (category, node) column, col = c * N + node, walked
// grid-stride: the grid is what the card keeps resident (cooperative
// launch), and a thread keeps its columns for the whole launch, so the
// iterate (Tsf, the snow and ice temperatures, the melting flag) lives in
// the output buffers between sweeps, written and read by its own thread
// only.  A column's unknowns, couplings and the Thomas coefficients are
// per-thread arrays (registers at the default nilyr = nslyr = 4, a
// template instance; other layer counts up to 16 take the generic
// instance, whose arrays sit in local memory).
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
// sits on the stopping threshold, in its sweep count.
//
// Bound on the card: bytes and the barriers.  A launch reads hi, hs,
// Tsf0, fswsfc, the initial profiles and iabs a column and five node rows,
// and writes 15 values and a flag a column: at ncat = 5 on the level-7
// globe (570,165 columns) some 150 MB in float64, 45 us at 3.35 TB/s.
// The arithmetic is 209 floating operations a column and sweep at
// nilyr = nslyr = 4 (temperature_solve_work itemises them from this
// body), some 64 us in float64 at 18 sweeps: it binds.  Each sweep also
// reads and writes the iterate (9 values a column) and crosses one grid
// barrier.
#include <cooperative_groups.h>

#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kMaxLayers = 16;
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
  int ncat, n_nodes, nilyr, nslyr, niter_therm;
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

// surface_fluxes: fsurf and its derivative, and the three fluxes
template <typename T>
struct Surface {
  T fsurf, dfsurf, fsens, flat, flwout;
};

template <typename T>
__device__ __forceinline__ Surface<T> surface(T Tsf, T fswsfc, T flw, T Tair,
                                              T shum, T cs, T ce, T emiss,
                                              double emiss_d) {
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
  s.fsurf = (((fswsfc + emiss * flw) + s.flwout) + s.fsens) + s.flat;
  s.dfsurf = (dflw + dfsens) + dflat;
  return s;
}

// conductivity_ice
template <typename T, int C>
__device__ __forceinline__ T conductivity(T Tk, T S) {
  const T Ts = cmin(Tk, T(-0.01));
  T k;
  if (C == kMU71)
    k = T(kice0) + (T(beta_mu71) * S) / Ts;
  else
    k = (T(2.11) - T(0.011) * Ts) + (T(0.09) * S) / Ts;
  return cmax(k, T(0.1 * kice0));
}

// The couplings C[j] (row j to row j + 1) and K_bot of a column.
template <typename T, int C, int NI, int NS>
__device__ __forceinline__ void couplings(const T* Tin, const T* sal, int ni,
                                          int ns, bool snow_on, T dzi, T dzs,
                                          double ks, T* Cs, T& K_bot) {
  T ki[NI > 0 ? NI : kMaxLayers];
#pragma unroll
  for (int k = 0; k < (NI > 0 ? NI : kMaxLayers); ++k)
    if (k < ni) ki[k] = conductivity<T, C>(Tin[k], sal[k]);
  const T k_direct = (T(2) * ki[0]) / dzi;
  // 2 ks / dzs and ks / dzs: a Python number over a tensor
  const T c_sfc_snow = (T(1) / dzs) * T(2.0 * ks);
  const T c_snow_snow = (T(1) / dzs) * T(ks);
  const T c_snow_ice = (T(2.0 * ks) * ki[0]) / (ki[0] * dzs + T(ks) * dzi);
  const T series_off = T(ns + 1) * k_direct;
  Cs[0] = snow_on ? c_sfc_snow : series_off;
#pragma unroll
  for (int j = 1; j < (NS > 0 ? NS : kMaxLayers); ++j)
    if (j < ns) Cs[j] = snow_on ? c_snow_snow : series_off;
  Cs[ns] = snow_on ? c_snow_ice : series_off;
#pragma unroll
  for (int k = 0; k + 1 < (NI > 0 ? NI : kMaxLayers); ++k)
    if (k + 1 < ni)
      Cs[ns + 1 + k] = ((T(2) * ki[k]) * ki[k + 1]) / (dzi * (ki[k] + ki[k + 1]));
  K_bot = (T(2) * ki[ni - 1]) / dzi;
}

template <typename T, int C, int NI, int NS>
__global__ void __launch_bounds__(kBlock) bl99_kernel(Params<T> p) {
  constexpr int kI = NI > 0 ? NI : kMaxLayers;
  constexpr int kS = NS > 0 ? NS : kMaxLayers;
  constexpr int kM = 1 + kI + kS;
  const int ni = NI > 0 ? NI : p.nilyr;
  const int ns = NS > 0 ? NS : p.nslyr;
  const int m = 1 + ns + ni;
  const long long N = p.n_nodes;
  const long long cols = N * p.ncat;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const double emiss_d = p.emiss_d;
  const double ks = p.ksno_d;
  cg::grid_group grid = cg::this_grid();
  __shared__ T warp_max[kBlock / 32];

  T sal[kI], Tm[kI];
#pragma unroll
  for (int k = 0; k < kI; ++k)
    if (k < ni) {
      sal[k] = T(p.layers[k]);
      Tm[k] = T(p.layers[ni + k]);
    }

  // the iterate starts at the initial state, not melting
  for (long long col = first; col < cols; col += stride) {
    const long long c = col / N, i = col - c * N;
    p.Tsf[col] = p.Tsf0[col];
    p.melting[col] = 0;
    for (int j = 0; j < ns; ++j)
      p.Tsn[(c * ns + j) * N + i] = p.Tsn0[(c * ns + j) * N + i];
    for (int k = 0; k < ni; ++k)
      p.Tin[(c * ni + k) * N + i] = p.Tin0[(c * ni + k) * N + i];
  }

  int it = 0;
  double err = INFINITY;
  while (it < kNitMax && (err > kErrMax || it < p.niter_therm)) {
    T local = T(0);
    for (long long col = first; col < cols; col += stride) {
      const long long c = col / N, i = col - c * N;
      const T hi = p.hi[col], hs = p.hs[col];
      const T his = cmax(hi, T(0.01));
      const T dzi = his / T(ni);
      const bool snow_on = hs >= T(hs_min);
      const T dzs = cmax(hs, T(hs_min)) / T(ns);
      const T cap_snow = snow_on ? (T(rhos * cp_ice) * dzs) / p.dt : T(1e-6);
      const T flw = p.flw[i], Tair = p.Tair[i], shum = p.shum[i];
      const T wind = p.wind[i], Tbot = p.Tbot[i], fsw = p.fswsfc[col];
      const T cs = p.shcoef ? p.shcoef[col]
                            : T(rhoair * cp_air * Ch_ice) * wind;
      const T ce = p.lhcoef ? p.lhcoef[col]
                            : T(rhoair * Lsub * Ce_ice) * wind;

      T Tsn_init[kS], Tin_init[kI], Tin[kI], iabs[kI];
#pragma unroll
      for (int j = 0; j < kS; ++j)
        if (j < ns) Tsn_init[j] = p.Tsn0[(c * ns + j) * N + i];
#pragma unroll
      for (int k = 0; k < kI; ++k)
        if (k < ni) {
          Tin_init[k] = p.Tin0[(c * ni + k) * N + i];
          Tin[k] = p.Tin[(c * ni + k) * N + i];
          iabs[k] = p.iabs[(c * ni + k) * N + i];
        }
      const T Tsf = p.Tsf[col];
      const bool melting = p.melting[col] != 0;

      T Cs[kM], K_bot;
      couplings<T, C, NI, NS>(Tin, sal, ni, ns, snow_on, dzi, dzs, ks, Cs,
                              K_bot);
      const Surface<T> sf = surface(Tsf, fsw, flw, Tair, shum, cs, ce,
                                    p.emiss, emiss_d);
      T sub[kM], diag[kM], sup[kM], rhs[kM];
      // surface row
      const T free_diag = Cs[0] - sf.dfsurf;
      const T free_rhs = sf.fsurf - sf.dfsurf * Tsf;
      sub[0] = T(0);
      diag[0] = melting ? T(1) : free_diag;
      sup[0] = melting ? T(0) : -Cs[0];
      rhs[0] = melting ? T(0) : free_rhs;
      // snow rows
#pragma unroll
      for (int j = 0; j < kS; ++j)
        if (j < ns) {
          const int r = 1 + j;
          diag[r] = (cap_snow + Cs[r - 1]) + Cs[r];
          sub[r] = -Cs[r - 1];
          sup[r] = -Cs[r];
          rhs[r] = cap_snow * Tsn_init[j];
        }
      // ice rows
#pragma unroll
      for (int k = 0; k < kI; ++k)
        if (k < ni) {
          const int r = 1 + ns + k;
          const T Tprod = cmin(Tin[k], p.t_floor) * cmin(Tin_init[k], p.t_floor);
          const T cap = T(rhoi) * (T(cp_ice) - (T(Lfresh) * Tm[k]) / Tprod);
          const T a = (cap * dzi) / p.dt;
          const bool last = k == ni - 1;
          const T cl = Cs[r - 1];
          const T cr = last ? K_bot : Cs[r];
          diag[r] = (a + cl) + cr;
          sub[r] = -cl;
          rhs[r] = a * Tin_init[k] + iabs[k];
          if (last) {
            rhs[r] = rhs[r] + K_bot * Tbot;
            sup[r] = T(0);
          } else {
            sup[r] = -cr;
          }
        }
      // Thomas solve, in place: sup becomes cp, rhs becomes dp, then x
      sup[0] = sup[0] / diag[0];
      rhs[0] = rhs[0] / diag[0];
#pragma unroll
      for (int j = 1; j < kM; ++j)
        if (j < m) {
          const T den = diag[j] - sub[j] * sup[j - 1];
          sup[j] = sup[j] / den;
          rhs[j] = (rhs[j] - sub[j] * rhs[j - 1]) / den;
        }
#pragma unroll
      for (int j = kM - 2; j >= 0; --j)
        if (j < m - 1) rhs[j] = rhs[j] - sup[j] * rhs[j + 1];

      // clamps, stored
#pragma unroll
      for (int j = 0; j < kS; ++j)
        if (j < ns)
          p.Tsn[(c * ns + j) * N + i] = cmin(cmax(rhs[1 + j], T(-100)), T(0));
#pragma unroll
      for (int k = 0; k < kI; ++k)
        if (k < ni)
          p.Tin[(c * ni + k) * N + i] =
              cmin(cmax(rhs[1 + ns + k], T(-100)), Tm[k] - T(1e-6));
      // melting-state update
      const Surface<T> s0 = surface(T(0), fsw, flw, Tair, shum, cs, ce,
                                    p.emiss, emiss_d);
      const T fct0 = Cs[0] * (T(0) - rhs[1]);
      const bool melt_next = melting ? (s0.fsurf > fct0) : (rhs[0] > T(0));
      const T Tsf_new = melt_next ? T(0) : cmin(cmax(rhs[0], T(-100)), T(0));
      p.Tsf[col] = Tsf_new;
      p.melting[col] = melt_next ? 1 : 0;
      const T dT = fabs(Tsf_new - Tsf);
      if (isfinite(dT) && dT > local) local = dT;
    }
    // the block's maximum into this sweep's slot, then the grid barrier
    for (int o = 16; o > 0; o >>= 1) {
      const T other = __shfl_down_sync(0xffffffffu, local, o);
      if (other > local) local = other;
    }
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = local;
    __syncthreads();
    if (threadIdx.x == 0) {
      T b = warp_max[0];
      for (int w = 1; w < kBlock / 32; ++w)
        if (warp_max[w] > b) b = warp_max[w];
      atomicMax(p.slots + it, bits_of(b));
    }
    grid.sync();
    err = static_cast<double>(from_bits<T>(__ldcg(p.slots + it)));
    ++it;
  }
  if (first == 0) *p.niter = it;

  // the fluxes at the final state
  for (long long col = first; col < cols; col += stride) {
    const long long c = col / N, i = col - c * N;
    const T hi = p.hi[col], hs = p.hs[col];
    const T dzi = cmax(hi, T(0.01)) / T(ni);
    const bool snow_on = hs >= T(hs_min);
    const T dzs = cmax(hs, T(hs_min)) / T(ns);
    const T wind = p.wind[i];
    const T cs = p.shcoef ? p.shcoef[col] : T(rhoair * cp_air * Ch_ice) * wind;
    const T ce = p.lhcoef ? p.lhcoef[col] : T(rhoair * Lsub * Ce_ice) * wind;
    T Tin[kI];
#pragma unroll
    for (int k = 0; k < kI; ++k)
      if (k < ni) Tin[k] = p.Tin[(c * ni + k) * N + i];
    T Cs[kM], K_bot;
    couplings<T, C, NI, NS>(Tin, sal, ni, ns, snow_on, dzi, dzs, ks, Cs,
                            K_bot);
    const T Tsf = p.Tsf[col];
    const Surface<T> sf = surface(Tsf, p.fswsfc[col], p.flw[i], p.Tair[i],
                                  p.shum[i], cs, ce, p.emiss, emiss_d);
    p.fsurf[col] = sf.fsurf;
    p.fsens[col] = sf.fsens;
    p.flat[col] = sf.flat;
    p.flwout[col] = sf.flwout;
    p.fcondtop[col] = Cs[0] * (Tsf - p.Tsn[(c * ns) * N + i]);
    p.fcondbot[col] = K_bot * (p.Tbot[i] - Tin[ni - 1]);
  }
}

template <typename T, int C, int NI, int NS>
cudaError_t plan_of(long long cols, int* grid) {
  int per_sm = 0, sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bl99_kernel<T, C, NI, NS>, kBlock, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  long long want = (cols + kBlock - 1) / kBlock;
  long long most = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<int>(want < most ? (want > 0 ? want : 1) : most);
  return cudaSuccess;
}

template <typename T, int C, int NI, int NS>
int launch(Params<T> p, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = plan_of<T, C, NI, NS>(
      static_cast<long long>(p.ncat) * p.n_nodes, &grid);
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
        int niter_therm, int conduct, double dt, double ksno, double emiss,
        double t_floor, cudaStream_t stream) {
  if (nilyr < 1 || nslyr < 1 || nilyr > kMaxLayers || nslyr > kMaxLayers)
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
  p.ncat = ncat;
  p.n_nodes = n_nodes;
  p.nilyr = nilyr;
  p.nslyr = nslyr;
  p.niter_therm = niter_therm;
  p.dt = T(dt);
  p.emiss = T(emiss);
  p.ksno_d = ksno;
  p.emiss_d = emiss;
  p.t_floor = T(t_floor);
  if (static_cast<long long>(ncat) * n_nodes == 0) {
    // nothing to solve: JAX's loop still counts its sweeps on an empty
    // maximum (0), so it stops at niter_therm
    const int n = niter_therm < kNitMax ? niter_therm : kNitMax;
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
// (uint8), fsurf, fcondtop, fcondbot, fsens, flat, flwout, niter (int32),
// slots [100] uint64 zeroed; conduct 0 bubbly, 1 MU71.
extern "C" int fesom_bl99_temperature_solve(
    void* hi, void* hs, void* Tsf0, void* Tsn0, void* Tin0, void* fswsfc,
    void* iabs, void* flw, void* Tair, void* shum, void* wind, void* Tbot,
    void* shcoef, void* lhcoef, void* layers, void* Tsf, void* Tsn, void* Tin,
    void* melting, void* fsurf, void* fcondtop, void* fcondbot, void* fsens,
    void* flat, void* flwout, void* niter, void* slots, int ncat, int n_nodes,
    int nilyr, int nslyr, int niter_therm, int conduct, double dt,
    double ksno, double emiss, int is_double, void* stream) {
  void* const ptr[] = {hi,     hs,     Tsf0,    Tsn0,     Tin0,     fswsfc,
                       iabs,   flw,    Tair,    shum,     wind,     Tbot,
                       shcoef, lhcoef, layers,  Tsf,      Tsn,      Tin,
                       melting, fsurf, fcondtop, fcondbot, fsens,   flat,
                       flwout, niter,  slots};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return run<double>(ptr, ncat, n_nodes, nilyr, nslyr, niter_therm,
                       conduct, dt, ksno, emiss, -1e-3, s);
  return run<float>(ptr, ncat, n_nodes, nilyr, nslyr, niter_therm, conduct,
                    dt, ksno, emiss, -0.05, s);
}

// The launch the kernel makes for n_cols columns at nilyr = nslyr = 4
// (bubbly): out[0..1] = grid, block (out: host int32 [2]).
extern "C" int fesom_bl99_plan(int n_cols, int is_double, void* out) {
  int grid = 0;
  cudaError_t err = is_double
                        ? plan_of<double, kBubbly, 4, 4>(n_cols, &grid)
                        : plan_of<float, kBubbly, 4, 4>(n_cols, &grid);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  int* o = static_cast<int*>(out);
  o[0] = grid;
  o[1] = kBlock;
  return cudaSuccess;
}
