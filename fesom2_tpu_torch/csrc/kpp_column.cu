// kpp_column: the column part of the K-Profile Parameterization (Large et
// al. 1994, FESOM's tuning) for each node column: interior mixing,
// boundary-layer depth, boundary-layer profile.
//
// Replaces fesom2_tpu/core/mixing/kpp.py:161-365, everything in
// oce_mixing_kpp up to and including the combine (ref
// oce_ale_mixing_kpp.F90: ri_iwmix :732-844, ddmix :857-934, bldepth
// :479-661, wscale :664-729, blmix_kpp :936-1122, enhance :1129-1190).
// The JAX code states the level searches as masked argmax reductions;
// here they are a shared-memory minimum over the levels (the first
// crossing) and a short scan (the second kbl).
//
// Every product, quotient and sum is taken in the order of the plain
// torch version (kpp.kpp_column_plain); minima and maxima propagate NaN as
// torch.minimum / torch.maximum do; pow(x, 0.25), pow(x, 1/3) and
// pow(x, 4) are pow, as torch's ** is, and x**3 is (x*x)*x, as torch
// computes it.  So kbl, the first crossing and every value agree with the
// plain version to rounding, and with the first design of this kernel
// (one thread walking each column three times) bit for bit.
//
// Bound on the card: bytes (7 values a wet cell read, 11 with double
// diffusion; 3 or 4 outputs [nl, N] written), with about 200 flops a wet
// cell under the byte bound.  The first design ran at 3.5 to 4x its
// bound: 100 registers a thread in float64 (16 warps an SM), three
// branchy sweeps down the column with few loads in flight, the interior
// coefficients written to the outputs and read back (1.6x the bound's
// bytes), and the velocity scales evaluated at every level.
//
// Design (as pressure_bv's): a block owns a tile of kTile consecutive
// node columns over all levels; threadIdx.x is the column, so a warp's
// copies and stores at one level are contiguous, and the kRows threads of
// a column take the levels ty, ty + kRows, ... (the wet levels sit at the
// top, so this spreads them evenly).  The tile's wet cells are staged
// into shared memory with cp.async, all at once (dry cells are not read,
// except layer 1 of a one-layer column, whose interior mixing the plain
// version takes from layer 1).  Then, with a barrier between phases:
//   (a, b) every cell: the interior mixing from the shear Richardson
//      number (and double diffusion), written over N^2, which only this
//      cell reads, and the bulk Richardson number, written over dbsfc;
//      the first interface with Rib > Ricr is a shared-memory atomicMin;
//      the row of threads that has no cell at the surface takes the
//      column's surface terms (ustar^4, the Ekman and Monin-Obukhov
//      limit);
//   (c1) one thread a column: hbl, the second kbl, the matching level kn
//      and what blmix and enhance need of them;
//   (c2) a warp each: the two velocity scales at hbl and at kbl-1, and the
//      interior coefficients and their gradients at kn;
//   (c3) a warp each: blmix's matching coefficients and enhance's value
//      at kbl-1, for momentum, heat and salt;
//   (d) every cell: the shape-function profile (the velocity scales only
//      inside the boundary layer), the enhancement at kbl-1, the combine
//      with the interior values (max) and the nonlocal coefficient, each
//      output written once; the rows from kbl down need only the interior
//      values and kbl, so they are written right after (c1), and their
//      stores leave while (c2) and (c3) run; the boundary layer's rows
//      follow (c3).
// The surface and bottom copies of the interior values are read from the
// row they copy.  kTile is 32 columns (256-byte rows in float64), 16 in
// float64 with double diffusion, whose four more layer fields would
// otherwise leave one block an SM.  Two blocks an SM in float64 (80
// registers, 106 KB of shared memory a block at nl = 48), three in
// float32.  Columns must hold at least one wet layer (nlevels >= 2).
//
// What binds it (NVIDIA H100 80GB HBM3, 700 W, level-7 globe, nl = 48,
// double diffusion off; scripts/kpp_variants.py): 226 us of device time
// in float64 against the bound's 112, 104 in float32 against 56; with
// phase (a, b) cut out 192 and 89, with phases (c1) to (c3) cut out 196
// and 91.  What stays is the staging and the stores, which the two or
// three resident blocks of an SM overlap with each other's compute only
// in part.  Phase (c) on one thread a column (this kernel's first form)
// left its whole chain of divisions and pow exposed; neither a second
// staging group, a persistent grid with each block's next tile
// prefetched into L2, nor blocks of 128, 256 or 512 threads did better.
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

// turbulent velocity scales, LMD94 eq. B1: wm and ws each on its own (the
// bulk Richardson number needs ws alone; phase (c) evaluates the two on
// different warps); the same expressions as the plain version's _wscale
template <typename T>
__device__ T wscale_m(T zehat, T us, T eps) {
  const T vonk = T(kVonk);
  T u3 = us * us * us;
  T zeta = zehat / (u3 + eps);
  if (zehat >= T(0)) return vonk * us / (T(1) + T(kConc1) * zeta);
  if (zeta > T(kZetam))
    return vonk * us * pow(fabs(T(1) - T(kConc2) * zeta), T(0.25));
  return vonk * pow(fabs(T(kConam) * u3 - T(kConcm) * zehat), T(1.0 / 3.0));
}

template <typename T>
__device__ T wscale_s(T zehat, T us, T eps) {
  const T vonk = T(kVonk);
  T u3 = us * us * us;
  T zeta = zehat / (u3 + eps);
  if (zehat >= T(0)) return vonk * us / (T(1) + T(kConc1) * zeta);
  if (zeta > T(kZetas)) return vonk * us * sqrt(fabs(T(1) - T(kConc3) * zeta));
  return vonk * pow(fabs(T(kConas) * u3 - T(kConcs) * zehat), T(1.0 / 3.0));
}

struct Params {
  int nl, cols, dd;
  double Ricr, Vtc, cg, visc_sh_limit, A_ver, diff_sh_limit, K_ver, eps;
};

constexpr int kThreadsPerBlock = 384;
constexpr int kNone = 1 << 30;
// per-column values, [kScalars][kTile] in shared memory: the surface
// forcing, what phase (a, b) and (c1) find, the velocity scales and the
// interpolated interior coefficients of (c2), the matching of (c3)
enum Scalar {
  kUstar, kBo, kF1, kHlimit,
  kHbl, kCaseA, kDelhat, kR, kDthKn, kDthKnp1, kSigK, kSigmaK, kDelta,
  kWmH, kWsH, kWmK, kWsK, kViscP, kViscH, kDiftP, kDiftH, kDifsP, kDifsH,
  kGat1m, kDat1m, kGat1t, kDat1t, kGat1s, kDat1s, kDkm1m, kDkm1t, kDkm1s,
  kScalars
};
constexpr int kInts = 3;   // first crossing, kbl, kn

// Shared memory of a tile: the field arrays first ([levels][kTile] each),
// then the per-column values and ints.
template <typename T>
size_t shared_bytes(int nl, int tile, bool dd) {
  const int L = nl - 1;
  const int rows = 4 * L + 4 * nl + (dd ? 4 * L + nl : 0) + kScalars;
  return static_cast<size_t>(rows) * tile * sizeof(T) +
         static_cast<size_t>(kInts) * tile * sizeof(int);
}

template <typename T, int kTile>
__global__ void __launch_bounds__(kThreadsPerBlock, sizeof(T) == 4 ? 3 : 2)
    kpp_column_kernel(
    const T* __restrict__ un, const T* __restrict__ vn,
    const T* __restrict__ bv, const T* __restrict__ dbsfc,
    const T* __restrict__ zb3, const T* __restrict__ Z3,
    const T* __restrict__ hnode, const T* __restrict__ alpha,
    const T* __restrict__ beta, const T* __restrict__ tt,
    const T* __restrict__ ss, const T* __restrict__ ustar_in,
    const T* __restrict__ Bo_in, const T* __restrict__ fcor,
    const int* __restrict__ nlevels, Params p, T* __restrict__ viscA,
    T* __restrict__ Kv, T* __restrict__ Kv_s, T* __restrict__ nonloc) {
  constexpr int kRows = kThreadsPerBlock / kTile;
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const int nl = p.nl, L = nl - 1;
  const bool dd = p.dd != 0;
  // layer fields [L][kTile]; interface fields [nl][kTile]: N^2 becomes
  // viscA's interior value, dbsfc the bulk Richardson number, sK (and sKs)
  // the interior diffusivity (of salt)
  T* sU = reinterpret_cast<T*>(shared_raw);
  T* sV = sU + L * kTile;
  T* sZ = sV + L * kTile;
  T* sH = sZ + L * kTile;
  T* sB = sH + L * kTile;
  T* sD = sB + nl * kTile;
  T* sZb = sD + nl * kTile;
  T* sK = sZb + nl * kTile;
  T* sKs = sK + nl * kTile;                  // dd only, as the four below
  T* sA = sKs + (dd ? nl : 0) * kTile;
  T* sBe = sA + (dd ? L : 0) * kTile;
  T* sT = sBe + (dd ? L : 0) * kTile;
  T* sS = sT + (dd ? L : 0) * kTile;
  T* sc = sS + (dd ? L : 0) * kTile;         // [kScalars][kTile]
  int* cross_s = reinterpret_cast<int*>(sc + kScalars * kTile);
  int* kbl_s = cross_s + kTile;
  int* kn_s = kbl_s + kTile;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n = blockIdx.x * kTile + tx;
  const bool active = n < p.cols;
  const long long N = p.cols;
  const int nln = active ? nlevels[n] : 0;
  const int nln1 = nln - 1;                  // wet layers; bottom interface
  const T eps = T(p.eps);
  const T vonk = T(kVonk);
  const T eps_kpp = T(kEpsKpp);
  const T Ricr = T(p.Ricr);
  auto S = [&](int k) { return k * kTile + tx; };

  // ---- staging ------------------------------------------------------------
  if (active) {
    for (int k = ty; k < nl; k += kRows) {
      const long long g = k * N + n;
      const int s = S(k);
      if (k < L && (k < nln1 || k == 1)) {
        fesom::cp_async(sU + s, un + g);
        fesom::cp_async(sV + s, vn + g);
        fesom::cp_async(sZ + s, Z3 + g);
        if (k < nln1) fesom::cp_async(sH + s, hnode + g);
        if (dd && k < nln1) {
          fesom::cp_async(sA + s, alpha + g);
          fesom::cp_async(sBe + s, beta + g);
          fesom::cp_async(sT + s, tt + g);
          fesom::cp_async(sS + s, ss + g);
        }
      }
      if (k <= nln1) {
        fesom::cp_async(sB + s, bv + g);
        fesom::cp_async(sD + s, dbsfc + g);
        fesom::cp_async(sZb + s, zb3 + g);
      }
    }
    if (ty == 0) {
      sc[kUstar * kTile + tx] = ustar_in[n];
      sc[kBo * kTile + tx] = Bo_in[n];
      cross_s[tx] = kNone;
    }
  }
  fesom::cp_async_commit();
  fesom::cp_async_wait<0>();
  __syncthreads();

  const T ustar = active ? sc[kUstar * kTile + tx] : T(0);
  const T Bo = active ? sc[kBo * kTile + tx] : T(0);
  const T stable = T(0.5) + T(0.5) * sign_of(Bo);
  // the interior value of row k after the surface and bottom copies
  const int kbot = nln1 - 1 > 1 ? nln1 - 1 : 1;   // the row the bottom copies
  auto interior = [&](const T* a, int k) {
    if (k > nln1) return T(0);
    const int src = k == 0 ? 1 : (k == nln1 ? kbot : k);
    return a[S(src)];
  };

  // ---- (a, b) interior mixing and bulk Richardson number, every cell ------
  if (active) {
    const T sigma0 = stable + (T(1) - stable) * eps_kpp;
    const T u0 = sU[S(0)], v0 = sV[S(0)];
    auto dvsq = [&](int k) {
      if (k == 0) return T(0);
      T ui = T(0.5) * (sU[S(k - 1)] + sU[S(k)]);
      T vi = T(0.5) * (sV[S(k - 1)] + sV[S(k)]);
      T du = u0 - ui, dv = v0 - vi;
      return du * du + dv * dv;
    };
    if (ty == 0) {
      // the surface terms of blmix and of the Ekman / Monin-Obukhov limits
      const T u4 = pow(ustar, T(4));
      sc[kF1 * kTile + tx] = stable * T(kConc1) * Bo / (u4 + eps);
      T hekman = T(kCekman) * ustar / max_nan(fabs(fcor[n]), eps);
      T hmonob = T(kCmonob) * (ustar * ustar * ustar) / vonk / (Bo + eps);
      sc[kHlimit * kTile + tx] = stable * min_nan(hekman, hmonob);
    }
    for (int k = ty > 0 ? ty : kRows; k <= nln1 || k <= kbot; k += kRows) {
      const T b = sB[S(k)];
      if (k <= kbot) {
        // ri_iwmix at interior interface k (row 0 and the bottom copy it)
        T visc = T(0), diff = T(0);
        if (k <= nl - 2) {
          T dz = sZ[S(k - 1)] - sZ[S(k)];
          T dz_inv = T(1) / (dz == T(0) ? T(1) : dz);
          T du = (sU[S(k - 1)] - sU[S(k)]) * dz_inv;
          T dv = (sV[S(k - 1)] - sV[S(k)]) * dz_inv;
          T shear = du * du + dv * dv;
          T Ri = (b < T(0) ? T(0) : b) / (shear + eps);
          T ratio = (Ri < T(0) ? T(0) : Ri) / T(kRiinfty);
          ratio = ratio > T(1) ? T(1) : ratio;
          T f = T(1) - ratio * ratio;
          T frit = f * f * f;
          visc = T(p.visc_sh_limit) * frit + T(p.A_ver);
          diff = T(p.diff_sh_limit) * frit + T(p.K_ver);
        }
        if (dd) {
          // ddmix on the interior interfaces 1..nln-2
          const T Rrho0 = T(1.9), dsfmax = T(1.0e-4);
          T addT = T(0), addS = T(0);
          if (k <= nln1 - 1) {
            T aDT = sA[S(k - 1)] * (sT[S(k - 1)] - sT[S(k)]);
            T bDS = sBe[S(k - 1)] * (sS[S(k - 1)] - sS[S(k)]);
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
              T pr = Rs > T(0.5) ? (T(1.85) - T(0.85) / Rs) * Rs
                                 : T(0.15) * Rs;
              addT = addT + ddc;
              addS = addS + pr * ddc;
            }
          }
          sKs[S(k)] = diff + addS;
          diff = diff + addT;
        }
        sK[S(k)] = diff;
        sB[S(k)] = visc;     // N^2 at k is read by this cell only
      }
      if (k <= nln1) {
        // bldepth: the bulk Richardson number at interface k
        T zb = fabs(sZb[S(k)]);
        T zehat = vonk * sigma0 * zb * Bo;
        T ws = wscale_s(zehat, ustar, eps);
        T Vtsq = zb * ws * sqrt(fabs(b)) * T(p.Vtc);
        T dv2 = k == nln1 ? dvsq(nln1 - 1) : dvsq(k);
        T rib = zb * sD[S(k)] / (dv2 + Vtsq + eps);
        sD[S(k)] = rib;
        if (rib > Ricr) atomicMin(&cross_s[tx], k);
      }
    }
  }
  __syncthreads();

  // ---- (c1) boundary-layer depth, one thread a column -------------------
  T* c = sc + tx;   // this column's values, c[i * kTile]
  auto zb = [&](int k) { return fabs(sZb[S(k)]); };
  auto h = [&](int k) { return k < nln1 ? sH[S(k)] : T(0); };
  auto dthick = [&](int k) {
    T d;
    if (k == nln1) d = T(0.5) * h(nln1 - 1 > 0 ? nln1 - 1 : 0);
    else if (k == 0) d = T(0.5) * h(0);
    else if (k <= nl - 2) d = T(0.5) * (h(k - 1) + h(k));
    else d = T(0);
    return d < T(1e-12) ? T(1e-12) : d;
  };
  if (active && ty == 0) {
    const int first = cross_s[tx];
    const bool has = first != kNone;
    int kbl = has ? first : nln1;
    T hbl;
    if (has) {
      const T rib_k = sD[S(kbl)];
      const T rib_km1 = kbl == 1 ? T(0) : sD[S(kbl - 1)];
      T zk = zb(kbl), zkm1 = zb(kbl - 1 > 0 ? kbl - 1 : 0);
      hbl = zkm1 + (zk - zkm1) * (Ricr - rib_km1) / (rib_k - rib_km1 + eps);
    } else {
      hbl = zb(nln1);
    }
    if (Bo > T(0)) {
      hbl = min_nan(hbl, c[kHlimit * kTile]);
      hbl = max_nan(hbl, zb(1));
    }
    // kbl: the first interface deeper than hbl
    kbl = nln1;
    for (int k = 1; k <= nln1; ++k) {
      if (zb(k) > hbl) {
        kbl = k;
        break;
      }
    }
    const int kblm1 = kbl - 1 > 0 ? kbl - 1 : 0;
    T dzup_k = zb(kbl) - zb(kblm1);
    const T caseA = T(0.5) + T(0.5) * sign_of(zb(kbl) - T(0.5) * dzup_k - hbl);
    // blmix's matching level kn
    int kn = caseA > T(0.5) ? kbl - 1 : kbl;
    kn = kn < nln1 - 1 ? kn : nln1 - 1;
    const int knp1 = kn + 1 < nln1 ? kn + 1 : nln1;
    const T delhat = fabs(sZ[S(kn < nl - 2 ? kn : nl - 2)]) - hbl;
    const T dth_kn = dthick(kn);
    // enhance's values at kbl-1
    const T sig_k = zb(kblm1) / (hbl + eps);
    const T zk0 = sZb[S(kblm1)];
    const T zk1 = sZb[S(kblm1 + 1 < nl - 1 ? kblm1 + 1 : nl - 1)];
    c[kHbl * kTile] = hbl;
    c[kCaseA * kTile] = caseA;
    c[kDelhat * kTile] = delhat;
    c[kR * kTile] = T(1) - delhat / dth_kn;
    c[kDthKn * kTile] = dth_kn;
    c[kDthKnp1 * kTile] = dthick(knp1);
    c[kSigK * kTile] = sig_k;
    c[kSigmaK * kTile] =
        stable * sig_k + (T(1) - stable) * min_nan(sig_k, eps_kpp);
    c[kDelta * kTile] = (hbl + zk0) / (zk0 - zk1 == T(0) ? T(1) : zk0 - zk1);
    kbl_s[tx] = kbl;
    kn_s[tx] = kn;
  }
  __syncthreads();

  // ---- (d) profile, enhancement and combine: one output row of a column --
  const T hbl = active ? c[kHbl * kTile] : T(0);
  const T caseA = active ? c[kCaseA * kTile] : T(0);
  const T delta = active ? c[kDelta * kTile] : T(0);
  const int kbl = active ? kbl_s[tx] : 0;
  const int k_enh = kbl - 1 > 0 ? kbl - 1 : 0;
  const T cg = T(p.cg);
  auto enhance = [&](T interior_k, T bl, T dk) {
    T dkmp5 = caseA * interior_k + (T(1) - caseA) * bl;
    T dstar = (T(1) - delta) * (T(1) - delta) * dk + delta * delta * dkmp5;
    return (T(1) - delta) * interior_k + delta * dstar;
  };
  // rows k >= kbl read only the interior values; the others also what
  // (c2) and (c3) find
  auto out_row = [&](int k) {
    const bool lm = k <= nln1;
    const bool in_bl = k >= 1 && k < kbl && lm;
    T bm = T(0), bt = T(0), bs = T(0), gh = T(0);
    if (in_bl) {
      const T sig = fabs(sZ[S(k < nl - 2 ? k : nl - 2)]) / (hbl + eps);
      const T sigma_i = stable * sig + (T(1) - stable) * min_nan(sig, eps_kpp);
      const T zehat = vonk * sigma_i * hbl * Bo;
      const T wm_i = wscale_m(zehat, ustar, eps);
      const T ws_i = wscale_s(zehat, ustar, eps);
      const T a1 = sig - T(2), a2 = T(3) - T(2) * sig, a3 = sig - T(1);
      auto blmc = [&](T w, T gat1, T dat1) {
        T G = a1 + a2 * gat1 + a3 * dat1;
        return hbl * w * sig * (T(1) + sig * G);
      };
      bm = blmc(wm_i, c[kGat1m * kTile], c[kDat1m * kTile]);
      bt = blmc(ws_i, c[kGat1t * kTile], c[kDat1t * kTile]);
      if (dd) bs = blmc(ws_i, c[kGat1s * kTile], c[kDat1s * kTile]);
      gh = (T(1) - stable) * cg / (ws_i * hbl + eps);
    }
    const T vA = interior(sB, k);
    const T dK = interior(sK, k);
    const T dS = dd ? interior(sKs, k) : T(0);
    if (k == k_enh) {
      bm = enhance(vA, bm, c[kDkm1m * kTile]);
      bt = enhance(dK, bt, c[kDkm1t * kTile]);
      if (dd) bs = enhance(dS, bs, c[kDkm1s * kTile]);
      gh = (T(1) - caseA) * gh;
    }
    const long long g = k * N + n;
    viscA[g] = in_bl ? max_nan(vA, bm) : vA;
    Kv[g] = lm ? (in_bl ? max_nan(dK, bt) : dK) : T(0);
    if (dd) Kv_s[g] = lm ? (in_bl ? max_nan(dS, bs) : dS) : T(0);
    T nlc = gh * bt;
    nlc = nlc > T(1) ? T(1) : nlc;
    nonloc[g] = (k >= 1 && k < nln1) ? nlc : T(0);
  };
  // ---- (d1) the rows below the boundary layer, every cell ----------------
  // (their stores leave while the warps of (c2) and (c3) work)
  if (active)
    for (int k = ty; k < nl; k += kRows)
      if (k >= kbl) out_row(k);

  // ---- (c2) velocity scales and interior coefficients at kn, a warp each --
  // (with 16-column tiles a warp holds two rows of threads: the even one
  // works)
  constexpr int kRowsPerWarp = 32 / kTile;
  if (active && ty % kRowsPerWarp == 0 && ty / kRowsPerWarp < 7) {
    const int kn = kn_s[tx];
    const int knm1 = kn - 1 > 0 ? kn - 1 : 0;
    const int knp1 = kn + 1 < nln1 ? kn + 1 : nln1;
    auto interp = [&](const T* a, int pi, int hi) {
      const T R = c[kR * kTile], delhat = c[kDelhat * kTile];
      T ckn = interior(a, kn);
      T dvdzup = (interior(a, knm1) - ckn) / c[kDthKn * kTile];
      T dvdzdn = (ckn - interior(a, knp1)) / c[kDthKnp1 * kTile];
      T pp = T(0.5) * ((T(1) - R) * (dvdzup + fabs(dvdzup)) +
                       R * (dvdzdn + fabs(dvdzdn)));
      c[pi * kTile] = pp;
      c[hi * kTile] = ckn + pp * delhat;
    };
    const T sigma_h = stable + (T(1) - stable) * eps_kpp;
    const T zehat_h = vonk * sigma_h * hbl * Bo;
    const T zehat_k = vonk * c[kSigmaK * kTile] * hbl * Bo;
    switch (ty / kRowsPerWarp) {
      case 0: c[kWmH * kTile] = wscale_m(zehat_h, ustar, eps); break;
      case 1: c[kWsH * kTile] = wscale_s(zehat_h, ustar, eps); break;
      case 2: c[kWmK * kTile] = wscale_m(zehat_k, ustar, eps); break;
      case 3: c[kWsK * kTile] = wscale_s(zehat_k, ustar, eps); break;
      case 4: interp(sB, kViscP, kViscH); break;
      case 5: interp(sK, kDiftP, kDiftH); break;
      default:
        if (dd) interp(sKs, kDifsP, kDifsH);
        break;
    }
  }
  __syncthreads();

  // ---- (c3) blmix's matching coefficients and enhance's dkm1 --------------
  if (active && ty % kRowsPerWarp == 0 && ty / kRowsPerWarp < (dd ? 3 : 2)) {
    const T sig_k = c[kSigK * kTile];
    const T a1k = sig_k - T(2), a2k = T(3) - T(2) * sig_k, a3k = sig_k - T(1);
    const T f1 = c[kF1 * kTile];
    // coefficient x: ty row 0 momentum (wm), 1 heat, 2 salt (ws)
    const int x = ty / kRowsPerWarp;
    const T w_h = c[(x == 0 ? kWmH : kWsH) * kTile];
    const T w_k = c[(x == 0 ? kWmK : kWsK) * kTile];
    const T cp = c[(x == 0 ? kViscP : x == 1 ? kDiftP : kDifsP) * kTile];
    const T ch = c[(x == 0 ? kViscH : x == 1 ? kDiftH : kDifsH) * kTile];
    const T gat1 = ch / (hbl + eps) / (w_h + eps);
    const T dat1 = min_nan(-cp / (w_h + eps) + f1 * ch, T(0));
    T G = a1k + a2k * gat1 + a3k * dat1;
    c[(kGat1m + 2 * x) * kTile] = gat1;
    c[(kDat1m + 2 * x) * kTile] = dat1;
    c[(kDkm1m + x) * kTile] = hbl * w_k * sig_k * (T(1) + sig_k * G);
  }
  __syncthreads();
  if (!active) return;

  // ---- (d2) the boundary layer's rows -----------------------------------
  for (int k = ty; k < kbl; k += kRows) out_row(k);
}

template <typename T, int kTile>
cudaError_t launch_tile(const void* un, const void* vn, const void* bv,
                        const void* db, const void* zb3, const void* Z3,
                        const void* hnode, const void* alpha,
                        const void* beta, const void* tt, const void* ss,
                        const void* ustar, const void* Bo, const void* fcor,
                        const void* nlevels, const Params& p, void* viscA,
                        void* Kv, void* Kv_s, void* nonloc,
                        cudaStream_t stream) {
  const size_t bytes = shared_bytes<T>(p.nl, kTile, p.dd != 0);
  cudaError_t err = fesom::allow_shared(kpp_column_kernel<T, kTile>, bytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((p.cols + kTile - 1) / kTile);
  kpp_column_kernel<T, kTile>
      <<<grid, dim3(kTile, kThreadsPerBlock / kTile), bytes, stream>>>(
          static_cast<const T*>(un), static_cast<const T*>(vn),
          static_cast<const T*>(bv), static_cast<const T*>(db),
          static_cast<const T*>(zb3), static_cast<const T*>(Z3),
          static_cast<const T*>(hnode), static_cast<const T*>(alpha),
          static_cast<const T*>(beta), static_cast<const T*>(tt),
          static_cast<const T*>(ss), static_cast<const T*>(ustar),
          static_cast<const T*>(Bo), static_cast<const T*>(fcor),
          static_cast<const int*>(nlevels), p, static_cast<T*>(viscA),
          static_cast<T*>(Kv), static_cast<T*>(Kv_s),
          static_cast<T*>(nonloc));
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* un, const void* vn, const void* bv,
                   const void* db, const void* zb3, const void* Z3,
                   const void* hnode, const void* alpha, const void* beta,
                   const void* tt, const void* ss, const void* ustar,
                   const void* Bo, const void* fcor, const void* nlevels,
                   const Params& p, void* viscA, void* Kv, void* Kv_s,
                   void* nonloc, cudaStream_t stream) {
  if (p.cols == 0) return cudaSuccess;
  if (p.nl < 2 || p.cols < 0) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 8) {
    if (p.dd)
      return launch_tile<T, 16>(un, vn, bv, db, zb3, Z3, hnode, alpha, beta,
                                tt, ss, ustar, Bo, fcor, nlevels, p, viscA,
                                Kv, Kv_s, nonloc, stream);
  }
  return launch_tile<T, 32>(un, vn, bv, db, zb3, Z3, hnode, alpha, beta, tt,
                            ss, ustar, Bo, fcor, nlevels, p, viscA, Kv, Kv_s,
                            nonloc, stream);
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
  cudaError_t err =
      is_double
          ? launch<double>(un, vn, bv, db, zb3, Z3, hnode, alpha, beta, tt,
                           ss, ustar, Bo, fcor, nlevels, p, viscA, Kv, Kv_s,
                           nonloc, st)
          : launch<float>(un, vn, bv, db, zb3, Z3, hnode, alpha, beta, tt, ss,
                          ustar, Bo, fcor, nlevels, p, viscA, Kv, Kv_s,
                          nonloc, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return fesom::last_error();
}
