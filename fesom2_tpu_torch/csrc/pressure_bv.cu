// pressure_bv: equation of state, hydrostatic pressure, Brunt-Vaisala
// frequency, the buoyancy difference to the surface and the mixed-layer
// depth of each node column, in one sweep down the column.
//
// Replaces fesom2_tpu/core/eos.py:88-175 pressure_bv (without cavities:
// the surface row is row 0).  The EoS is the split form
// rho = (b0 + z (bpz + z bpz2)) rhopot / (b0 + z (bpz + z bpz2) + 0.1 z sef)
// of Jackett & McDougall (eos_kind 1, sef = 1) or the linear forms
// (b0 = 1, bpz = bpz2 = 0, sef = 0): the general one (eos_kind 0) and the
// soufflet channel's (eos_kind 2).  Per column n with nln levels:
//   rho[k]   = rho_eos(k, Z[k]) - rho_ref[k]            (k < nln-1, else 0)
//   hp[k]    = -Z[0] rho[0] g + sum_{j=1..k} g/2 (rho h[j-1] + rho h[j])
//   bv[i]    = -g (rho(i-1 at zbar[i]) - rho(i at zbar[i])) / (Z[i-1]-Z[i])
//              / rho0, bv[0] = bv[1], bv[nln-1] = bv[nln-2]
//   dbsfc[k] = -g (rho_srf(Z[k]) - rho_full[k]) / rho_full[k], with the
//              surface water's coefficients at depth Z[k]; bottom copied
//   mld2     = Z[first k >= 1 with rhopot[k] - rhopot[0] > 0.125, or the
//              bottom layer; 1 if none]
// Every product and sum is taken in the order of the plain torch version
// (eos.pressure_bv_plain), and the pressure is summed down the column in
// level order, as torch.cumsum does, so kernel and plain agree to
// rounding.
//
// Bound on the card: bytes.  Each column reads 6 values per level and
// writes 4, with about 60 flops per level for the JM polynomials.
// Design: one thread per node column, as tridiag_solve; at each level a
// warp reads 32 consecutive nodes of the [L, N] arrays, so every load and
// store is contiguous.  Below the bottom the inputs are zero or pinned
// and the outputs are written as zeros.
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

template <typename T>
__global__ void pressure_bv_kernel(
    const T* __restrict__ tt, const T* __restrict__ ss,
    const T* __restrict__ Z3, const T* __restrict__ zb3,
    const T* __restrict__ hnode, const T* __restrict__ dref,
    const int* __restrict__ nlevels, int nl, int cols, int kind, T g, T rho0,
    T* __restrict__ rho_out, T* __restrict__ hp_out, T* __restrict__ bv_out,
    T* __restrict__ db_out, T* __restrict__ mld2) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= cols) return;
  const long long N = cols;
  const int L = nl - 1;
  const int nln = nlevels[n];
  const T sef = kind == 1 ? T(1) : T(0);
  const T mg = -g;
  const T half_g = T(0.5) * g;  // the constant 0.5 * g, rounded once

  Eos<T> e0 = eos_components(tt[n], ss[n], kind, rho0);
  Eos<T> eprev = e0;
  T rhoh_prev = T(0);   // rho * h of the layer above
  T hsum = T(0);        // running sum of the pressure increments
  T hp_base = T(0);
  T bv1 = T(0);         // bv at interface 1, copied to the surface
  T bv_prev = T(0);     // the final value of the interface above
  T db_last = T(0);     // dbsfc of the last wet layer
  int mld_idx = 0;
  for (int k = 0; k < L; ++k) {
    const long long i = k * N + n;
    const bool wet = k < nln - 1;
    const T z = Z3[i];
    Eos<T> e = k == 0 ? e0 : eos_components(tt[i], ss[i], kind, rho0);
    // density anomaly
    T rho = wet ? insitu(e, z, sef) - dref[i] : T(0);
    rho_out[i] = rho;
    // hydrostatic pressure
    T rhoh = rho * hnode[i];
    if (k == 0) {
      hp_base = ((-z) * rho) * g;
    } else {
      hsum = hsum + half_g * (rhoh_prev + rhoh);
    }
    rhoh_prev = rhoh;
    hp_out[i] = wet ? hp_base + hsum : T(0);
    // buoyancy difference to the surface water brought to depth z
    T rho_full = rho + dref[i];
    T db = mg * (insitu(e0, z, sef) - rho_full) /
           (rho_full == T(0) ? T(1) : rho_full);
    db = wet ? db : T(0);
    if (k <= nln - 1) db_out[i] = (k == nln - 1) ? db_last : db;
    else db_out[i] = T(0);
    if (wet) db_last = db;
    // Brunt-Vaisala frequency at interface k (between layers k-1 and k)
    if (k >= 1) {
      const T zi = zb3[i];
      T ru = insitu(eprev, zi, sef);
      T rd = insitu(e, zi, sef);
      T dz_inv = T(1) / (Z3[i - N] - z);
      T bv = mg * dz_inv * (ru - rd) / rho0;
      if (k == 1) bv1 = bv;
      T out;
      if (k <= nln - 1) out = (k == nln - 1) ? bv_prev : bv;
      else out = T(0);
      bv_out[i] = out;
      bv_prev = out;
    }
    // mixed-layer depth: the first level that crosses the criterion
    if (k >= 1 && mld_idx == 0 &&
        (!wet || (e.rhopot - e0.rhopot) > T(0.125)))
      mld_idx = k;
    eprev = e;
  }
  // interface 0 copies interface 1; the last interface (k = L) exists
  // only as the bottom copy of a full column
  bv_out[n] = bv1;
  if (nln - 1 == 1) bv_out[N + n] = bv1;  // the bottom copies row 0
  const long long iL = L * N + n;
  bv_out[iL] = (nln - 1 == L) ? bv_prev : T(0);
  db_out[iL] = (nln - 1 == L) ? db_last : T(0);
  mld2[n] = Z3[(mld_idx > 1 ? mld_idx : 1) * N + n];
}

template <typename T>
void launch(const void* t, const void* s, const void* Z3, const void* zb3,
            const void* hnode, const void* dref, const void* nlevels, int nl,
            int cols, int kind, double g, double rho0, void* rho, void* hp,
            void* bv, void* db, void* mld2, cudaStream_t stream) {
  if (cols == 0) return;
  pressure_bv_kernel<T><<<fesom::blocks_for(cols), fesom::kThreads, 0,
                          stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(s),
      static_cast<const T*>(Z3), static_cast<const T*>(zb3),
      static_cast<const T*>(hnode), static_cast<const T*>(dref),
      static_cast<const int*>(nlevels), nl, cols, kind, static_cast<T>(g),
      static_cast<T>(rho0), static_cast<T*>(rho), static_cast<T*>(hp),
      static_cast<T*>(bv), static_cast<T*>(db), static_cast<T*>(mld2));
}

}  // namespace

extern "C" int fesom_pressure_bv(const void* t, const void* s, const void* Z3,
                                 const void* zb3, const void* hnode,
                                 const void* dref, const void* nlevels, int nl,
                                 int cols, int kind, double g, double rho0,
                                 void* rho, void* hp, void* bv, void* db,
                                 void* mld2, int is_double, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    launch<double>(t, s, Z3, zb3, hnode, dref, nlevels, nl, cols, kind, g,
                   rho0, rho, hp, bv, db, mld2, st);
  else
    launch<float>(t, s, Z3, zb3, hnode, dref, nlevels, nl, cols, kind, g,
                  rho0, rho, hp, bv, db, mld2, st);
  return fesom::last_error();
}
