// kpp_column: the column part of the K-Profile Parameterization (Large et
// al. 1994, FESOM's tuning) for each node column, in three sweeps down the
// column: interior mixing, boundary-layer depth, boundary-layer profile.
//
// Replaces fesom2_tpu/core/mixing/kpp.py:161-365, everything in
// oce_mixing_kpp up to and including the combine (ref
// oce_ale_mixing_kpp.F90: ri_iwmix :732-844, ddmix :857-934, bldepth
// :479-661, wscale :664-729, blmix_kpp :936-1122, enhance :1129-1190).
// The JAX code states the level searches as masked argmax reductions; a
// thread per column states them as loops:
//   1. viscA, diffK (and diffS with double diffusion) from the shear
//      Richardson number at each interior interface, with the surface and
//      bottom copies, written into the outputs as scratch;
//   2. the bulk Richardson number Rib down the column; kbl = the first
//      interface with Rib > Ricr (else the bottom); hbl interpolated
//      there, limited by the Ekman and Monin-Obukhov depths when the
//      surface buoyancy forcing Bo > 0; kbl again as the first interface
//      below hbl; the interior coefficients and their gradients at kn
//      (blmix's matching) and the values at kbl-1 (enhance);
//   3. the shape-function profile above kbl, enhanced at kbl-1, combined
//      with the interior values (max), and the nonlocal coefficient.
// Every product, quotient and sum is taken in the order of the plain
// torch version (kpp.kpp_column_plain); minima and maxima propagate NaN as
// torch.minimum / torch.maximum do; pow(x, 0.25), pow(x, 1/3) and
// pow(x, 4) are pow, as torch's ** is, and x**3 is (x*x)*x, as torch
// computes it.  So kbl, the first crossing and every value agree with the
// plain version to rounding.
//
// Bound on the card: the divisions and pow calls (wscale at every
// interface, three times per column) and the column's latency; the
// inputs are about 12 values per level.  Design: one thread per node
// column; at each level a warp reads 32 consecutive nodes of the [L, N]
// arrays, so every load and store is contiguous.  No shared memory; the
// outputs hold the interior coefficients between the sweeps.
#include <math.h>

#include "common.cuh"

namespace {

template <typename T>
__device__ T max_nan(T a, T b) {
  if (isnan(a) || isnan(b)) return a + b;
  return a > b ? a : b;
}

template <typename T>
__device__ T min_nan(T a, T b) {
  if (isnan(a) || isnan(b)) return a + b;
  return a < b ? a : b;
}

// torch.sign: -1, 0 or 1, NaN for NaN
template <typename T>
__device__ T sign_of(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}

constexpr double kEpsKpp = 0.1, kVonk = 0.4, kConc1 = 5.0;
constexpr double kConam = 1.257, kConcm = 8.380, kConc2 = 16.0;
constexpr double kZetam = -0.2;
constexpr double kConas = -28.86, kConcs = 98.96, kConc3 = 16.0;
constexpr double kZetas = -1.0;
constexpr double kCekman = 0.7, kCmonob = 1.0, kRiinfty = 0.8;

// turbulent velocity scales (wm, ws), LMD94 eq. B1
template <typename T>
__device__ void wscale(T zehat, T us, T eps, T* wm, T* ws) {
  const T vonk = T(kVonk);
  T u3 = us * us * us;
  T zeta = zehat / (u3 + eps);
  T stable_wm = vonk * us / (T(1) + T(kConc1) * zeta);
  if (zehat >= T(0)) {
    *wm = stable_wm;
    *ws = stable_wm;
    return;
  }
  if (zeta > T(kZetam))
    *wm = vonk * us * pow(fabs(T(1) - T(kConc2) * zeta), T(0.25));
  else
    *wm = vonk * pow(fabs(T(kConam) * u3 - T(kConcm) * zehat),
                     T(1.0 / 3.0));
  if (zeta > T(kZetas))
    *ws = vonk * us * sqrt(fabs(T(1) - T(kConc3) * zeta));
  else
    *ws = vonk * pow(fabs(T(kConas) * u3 - T(kConcs) * zehat),
                     T(1.0 / 3.0));
}

struct Params {
  int nl, cols, dd;
  double Ricr, Vtc, cg, visc_sh_limit, A_ver, diff_sh_limit, K_ver, eps;
};

template <typename T>
__global__ void kpp_column_kernel(
    const T* __restrict__ un, const T* __restrict__ vn,
    const T* __restrict__ bv, const T* __restrict__ dbsfc,
    const T* __restrict__ zb3, const T* __restrict__ Z3,
    const T* __restrict__ hnode, const T* __restrict__ alpha,
    const T* __restrict__ beta, const T* __restrict__ tt,
    const T* __restrict__ ss, const T* __restrict__ ustar_in,
    const T* __restrict__ Bo_in, const T* __restrict__ fcor,
    const int* __restrict__ nlevels, Params p, T* __restrict__ viscA,
    T* __restrict__ Kv, T* __restrict__ Kv_s, T* __restrict__ nonloc) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.cols) return;
  const long long N = p.cols;
  const int nl = p.nl;
  const int nln = nlevels[n];
  const bool dd = p.dd != 0;
  const T eps = T(p.eps);
  const T vonk = T(kVonk);
  const T eps_kpp = T(kEpsKpp);
  auto at = [&](int k) { return k * N + n; };

  // ---- 1. interior mixing (ri_iwmix, ddmix) ------------------------------
  // raw interface values r(k), k = 1..nl-2; row 0 copies row 1, the bottom
  // interface nln-1 copies nln-2, rows below are zero
  auto raw = [&](int k, T* visc, T* diff) {
    if (k < 1 || k > nl - 2) {
      *visc = T(0);
      *diff = T(0);
      return;
    }
    T dz = Z3[at(k - 1)] - Z3[at(k)];
    T dz_inv = T(1) / (dz == T(0) ? T(1) : dz);
    T du = (un[at(k - 1)] - un[at(k)]) * dz_inv;
    T dv = (vn[at(k - 1)] - vn[at(k)]) * dz_inv;
    T shear = du * du + dv * dv;
    T b = bv[at(k)];
    T Ri = (b < T(0) ? T(0) : b) / (shear + eps);
    T ratio = (Ri < T(0) ? T(0) : Ri) / T(kRiinfty);
    ratio = ratio > T(1) ? T(1) : ratio;
    T f = T(1) - ratio * ratio;
    T frit = f * f * f;
    *visc = T(p.visc_sh_limit) * frit + T(p.A_ver);
    *diff = T(p.diff_sh_limit) * frit + T(p.K_ver);
  };
  {
    T v1, d1;
    raw(1, &v1, &d1);
    T vprev = T(0), dprev = T(0);
    for (int k = 0; k < nl; ++k) {
      T v, d;
      if (k > nln - 1) {
        v = T(0);
        d = T(0);
      } else if (k == nln - 1 && k >= 1) {
        v = vprev;
        d = dprev;
      } else if (k == 0) {
        v = v1;
        d = d1;
      } else {
        raw(k, &v, &d);
      }
      viscA[at(k)] = v;
      Kv[at(k)] = d;
      vprev = v;
      dprev = d;
    }
  }
  if (dd) {
    // double diffusion on the interior interfaces 1..nln-2, then the
    // surface and bottom copies again
    const T Rrho0 = T(1.9), dsfmax = T(1.0e-4);
    T t1 = T(0), s1 = T(0), tprev = T(0), sprev = T(0);
    for (int k = 0; k < nl; ++k) {
      T d = Kv[at(k)];
      T addT = T(0), addS = T(0);
      if (k >= 1 && k <= nln - 2) {
        T aDT = alpha[at(k - 1)] * (tt[at(k - 1)] - tt[at(k)]);
        T bDS = beta[at(k - 1)] * (ss[at(k - 1)] - ss[at(k)]);
        T bsafe = bDS == T(0) ? T(1) : bDS;
        if ((aDT > bDS) && (bDS > T(0))) {
          T Rf = aDT / bsafe;
          Rf = Rf > Rrho0 ? Rrho0 : Rf;
          T q = T(1) - (Rf - T(1)) / T(1.9 - 1.0);
          q = dsfmax * q * q * q;
          addT = T(0.7) * q;
          addS = q;
        }
        if ((aDT < T(0)) && (aDT > bDS)) {
          T Rs = aDT / bsafe;
          T ddc = T(1.5e-6 * 0.909) *
                  exp(T(4.6) * exp(T(-0.54) * (T(1) / Rs - T(1))));
          T pr = Rs > T(0.5) ? (T(1.85) - T(0.85) / Rs) * Rs : T(0.15) * Rs;
          addT = addT + ddc;
          addS = addS + pr * ddc;
        }
      }
      T dT = d + addT;
      T dS = d + addS;
      if (k == 1) {
        t1 = dT;
        s1 = dS;
      }
      if (k == nln - 1 && k >= 1) {
        dT = tprev;
        dS = sprev;
      }
      if (k > nln - 1) {
        dT = T(0);
        dS = T(0);
      }
      Kv[at(k)] = dT;
      Kv_s[at(k)] = dS;
      tprev = dT;
      sprev = dS;
    }
    Kv[at(0)] = t1;
    Kv_s[at(0)] = s1;
    if (nln - 1 == 1) {
      Kv[at(1)] = t1;
      Kv_s[at(1)] = s1;
    }
  }

  // ---- 2. boundary-layer depth (bldepth) ---------------------------------
  const T ustar = ustar_in[n];
  const T Bo = Bo_in[n];
  const T stable = T(0.5) + T(0.5) * sign_of(Bo);
  const T sigma0 = stable + (T(1) - stable) * eps_kpp;
  const T u0 = un[n], v0 = vn[n];
  const T Ricr = T(p.Ricr);
  auto dvsq = [&](int k) {
    if (k == 0) return T(0);
    T ui = k <= nl - 2 ? T(0.5) * (un[at(k - 1)] + un[at(k)]) : un[at(nl - 2)];
    T vi = k <= nl - 2 ? T(0.5) * (vn[at(k - 1)] + vn[at(k)]) : vn[at(nl - 2)];
    T du = u0 - ui, dv = v0 - vi;
    return du * du + dv * dv;
  };
  auto rib = [&](int k) {
    T zb = fabs(zb3[at(k)]);
    T zehat = vonk * sigma0 * zb * Bo;
    T wm, ws;
    wscale(zehat, ustar, eps, &wm, &ws);
    T Vtsq = zb * ws * sqrt(fabs(bv[at(k)])) * T(p.Vtc);
    T dv2 = k == nln - 1 ? dvsq(nln - 2) : dvsq(k);
    return zb * dbsfc[at(k)] / (dv2 + Vtsq + eps);
  };
  int kbl = nln - 1;
  bool has = false;
  T rib_prev = T(0), rib_k = T(0), rib_km1 = T(0);
  for (int k = 1; k <= nln - 1; ++k) {
    T r = rib(k);
    if (r > Ricr) {
      kbl = k;
      has = true;
      rib_k = r;
      rib_km1 = k == 1 ? T(0) : rib_prev;
      break;
    }
    rib_prev = r;
  }
  auto zb = [&](int k) { return fabs(zb3[at(k)]); };
  T hbl;
  if (has) {
    T zk = zb(kbl), zkm1 = zb(kbl - 1 > 0 ? kbl - 1 : 0);
    hbl = zkm1 + (zk - zkm1) * (Ricr - rib_km1) / (rib_k - rib_km1 + eps);
  } else {
    hbl = zb(nln - 1);
  }
  // Ekman / Monin-Obukhov limits
  T fabs_f = fabs(fcor[n]);
  T hekman = T(kCekman) * ustar / max_nan(fabs_f, eps);
  T hmonob = T(kCmonob) * (ustar * ustar * ustar) / vonk / (Bo + eps);
  T hlimit = stable * min_nan(hekman, hmonob);
  if (Bo > T(0)) {
    hbl = min_nan(hbl, hlimit);
    hbl = max_nan(hbl, zb(1));
  }
  // kbl: the first interface deeper than hbl
  kbl = nln - 1;
  for (int k = 1; k <= nln - 1; ++k) {
    if (zb(k) > hbl) {
      kbl = k;
      break;
    }
  }
  const int kblm1 = kbl - 1 > 0 ? kbl - 1 : 0;
  T dzup_k = zb(kbl) - zb(kblm1);
  const T caseA = T(0.5) + T(0.5) * sign_of(zb(kbl) - T(0.5) * dzup_k - hbl);

  // blmix: matching of the interior coefficients at kn
  auto h = [&](int k) { return k < nln - 1 ? hnode[at(k)] : T(0); };
  auto dthick = [&](int k) {
    T d;
    if (k == nln - 1) d = T(0.5) * h(nln - 2 > 0 ? nln - 2 : 0);
    else if (k == 0) d = T(0.5) * h(0);
    else if (k <= nl - 2) d = T(0.5) * (h(k - 1) + h(k));
    else d = T(0);
    return d < T(1e-12) ? T(1e-12) : d;
  };
  const T sigma_h = stable + (T(1) - stable) * eps_kpp;
  T wm_h, ws_h;
  wscale(vonk * sigma_h * hbl * Bo, ustar, eps, &wm_h, &ws_h);
  int kn = caseA > T(0.5) ? kbl - 1 : kbl;
  kn = kn < nln - 2 ? kn : nln - 2;
  const int knm1 = kn - 1 > 0 ? kn - 1 : 0;
  const int knp1 = kn + 1 < nln - 1 ? kn + 1 : nln - 1;
  const T delhat = fabs(Z3[at(kn < nl - 2 ? kn : nl - 2)]) - hbl;
  const T dth_kn = dthick(kn), dth_knp1 = dthick(knp1);
  const T R = T(1) - delhat / dth_kn;
  auto interp = [&](const T* col, T* pp, T* hc) {
    T ckn = col[at(kn)];
    T dvdzup = (col[at(knm1)] - ckn) / dth_kn;
    T dvdzdn = (ckn - col[at(knp1)]) / dth_knp1;
    *pp = T(0.5) * ((T(1) - R) * (dvdzup + fabs(dvdzup)) +
                    R * (dvdzdn + fabs(dvdzdn)));
    *hc = ckn + *pp * delhat;
  };
  T viscp, visch, diftp, difth, difsp = T(0), difsh = T(0);
  interp(viscA, &viscp, &visch);
  interp(Kv, &diftp, &difth);
  if (dd) interp(Kv_s, &difsp, &difsh);
  const T u4 = pow(ustar, T(4));
  const T f1 = stable * T(kConc1) * Bo / (u4 + eps);
  const T gat1m = visch / (hbl + eps) / (wm_h + eps);
  const T dat1m = min_nan(-viscp / (wm_h + eps) + f1 * visch, T(0));
  const T gat1t = difth / (hbl + eps) / (ws_h + eps);
  const T dat1t = min_nan(-diftp / (ws_h + eps) + f1 * difth, T(0));
  const T gat1s = difsh / (hbl + eps) / (ws_h + eps);
  const T dat1s = min_nan(-difsp / (ws_h + eps) + f1 * difsh, T(0));

  // enhance: the values at kbl-1
  const T sig_k = zb(kblm1) / (hbl + eps);
  const T sigma_k = stable * sig_k + (T(1) - stable) * min_nan(sig_k, eps_kpp);
  T wm_k, ws_k;
  wscale(vonk * sigma_k * hbl * Bo, ustar, eps, &wm_k, &ws_k);
  const T a1k = sig_k - T(2), a2k = T(3) - T(2) * sig_k, a3k = sig_k - T(1);
  auto dkm1 = [&](T w, T gat1, T dat1) {
    T G = a1k + a2k * gat1 + a3k * dat1;
    return hbl * w * sig_k * (T(1) + sig_k * G);
  };
  const T dkm1_m = dkm1(wm_k, gat1m, dat1m);
  const T dkm1_t = dkm1(ws_k, gat1t, dat1t);
  const T dkm1_s = dkm1(ws_k, gat1s, dat1s);
  const int k_enh = kblm1;
  const T zk0 = zb3[at(k_enh)];
  const T zk1 = zb3[at(k_enh + 1 < nl - 1 ? k_enh + 1 : nl - 1)];
  const T delta = (hbl + zk0) / (zk0 - zk1 == T(0) ? T(1) : zk0 - zk1);
  auto enhance = [&](T interior, T bl, T dk) {
    T dkmp5 = caseA * interior + (T(1) - caseA) * bl;
    T dstar = (T(1) - delta) * (T(1) - delta) * dk + delta * delta * dkmp5;
    return (T(1) - delta) * interior + delta * dstar;
  };

  // ---- 3. profile, enhancement and combine --------------------------------
  const T cg = T(p.cg);
  for (int k = 0; k < nl; ++k) {
    const bool lm = k <= nln - 1;
    const bool in_bl = k >= 1 && k < kbl && lm;
    const T sig = fabs(Z3[at(k < nl - 2 ? k : nl - 2)]) / (hbl + eps);
    const T sigma_i = stable * sig + (T(1) - stable) * min_nan(sig, eps_kpp);
    T wm_i, ws_i;
    wscale(vonk * sigma_i * hbl * Bo, ustar, eps, &wm_i, &ws_i);
    const T a1 = sig - T(2), a2 = T(3) - T(2) * sig, a3 = sig - T(1);
    auto blmc = [&](T w, T gat1, T dat1) {
      T G = a1 + a2 * gat1 + a3 * dat1;
      return in_bl ? hbl * w * sig * (T(1) + sig * G) : T(0);
    };
    T bm = blmc(wm_i, gat1m, dat1m);
    T bt = blmc(ws_i, gat1t, dat1t);
    T bs = dd ? blmc(ws_i, gat1s, dat1s) : T(0);
    T gh = in_bl ? (T(1) - stable) * cg / (ws_i * hbl + eps) : T(0);
    const T vA = viscA[at(k)];
    const T dK = Kv[at(k)];
    const T dS = dd ? Kv_s[at(k)] : T(0);
    if (k == k_enh) {
      bm = enhance(vA, bm, dkm1_m);
      bt = enhance(dK, bt, dkm1_t);
      if (dd) bs = enhance(dS, bs, dkm1_s);
      gh = (T(1) - caseA) * gh;
    }
    viscA[at(k)] = in_bl ? max_nan(vA, bm) : vA;
    Kv[at(k)] = lm ? (in_bl ? max_nan(dK, bt) : dK) : T(0);
    if (dd) Kv_s[at(k)] = lm ? (in_bl ? max_nan(dS, bs) : dS) : T(0);
    T nlc = gh * bt;
    nlc = nlc > T(1) ? T(1) : nlc;
    nonloc[at(k)] = (k >= 1 && k < nln - 1) ? nlc : T(0);
  }
}

template <typename T>
void launch(const void* un, const void* vn, const void* bv, const void* db,
            const void* zb3, const void* Z3, const void* hnode,
            const void* alpha, const void* beta, const void* tt,
            const void* ss, const void* ustar, const void* Bo,
            const void* fcor, const void* nlevels, const Params& p,
            void* viscA, void* Kv, void* Kv_s, void* nonloc,
            cudaStream_t stream) {
  if (p.cols == 0) return;
  kpp_column_kernel<T><<<fesom::blocks_for(p.cols), fesom::kThreads, 0,
                         stream>>>(
      static_cast<const T*>(un), static_cast<const T*>(vn),
      static_cast<const T*>(bv), static_cast<const T*>(db),
      static_cast<const T*>(zb3), static_cast<const T*>(Z3),
      static_cast<const T*>(hnode), static_cast<const T*>(alpha),
      static_cast<const T*>(beta), static_cast<const T*>(tt),
      static_cast<const T*>(ss), static_cast<const T*>(ustar),
      static_cast<const T*>(Bo), static_cast<const T*>(fcor),
      static_cast<const int*>(nlevels), p, static_cast<T*>(viscA),
      static_cast<T*>(Kv), static_cast<T*>(Kv_s), static_cast<T*>(nonloc));
}

}  // namespace

extern "C" int fesom_kpp_column(
    const void* un, const void* vn, const void* bv, const void* db,
    const void* zb3, const void* Z3, const void* hnode, const void* alpha,
    const void* beta, const void* tt, const void* ss, const void* ustar,
    const void* Bo, const void* fcor, const void* nlevels, int nl, int cols,
    int dd, double Ricr, double Vtc, double cg, double visc_sh_limit,
    double A_ver, double diff_sh_limit, double K_ver, double eps, void* viscA,
    void* Kv, void* Kv_s, void* nonloc, int is_double, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p{nl, cols, dd, Ricr, Vtc, cg, visc_sh_limit, A_ver, diff_sh_limit,
           K_ver, eps};
  if (is_double)
    launch<double>(un, vn, bv, db, zb3, Z3, hnode, alpha, beta, tt, ss, ustar,
                   Bo, fcor, nlevels, p, viscA, Kv, Kv_s, nonloc, st);
  else
    launch<float>(un, vn, bv, db, zb3, Z3, hnode, alpha, beta, tt, ss, ustar,
                  Bo, fcor, nlevels, p, viscA, Kv, Kv_s, nonloc, st);
  return fesom::last_error();
}
