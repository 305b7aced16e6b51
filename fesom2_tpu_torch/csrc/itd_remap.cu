// itd_remap: Icepack's ice-thickness-distribution remap, the linear
// remapping of Lipscomb (2001) followed by the rebin, or the rebin alone,
// on the packed category state of one node a thread.
//
// Replaces fesom2_tpu/ice/icepack/itd.py:167-271 (linear_itd, 1,691
// jaxpr equations, and rebin, 939): static Python loops over the category
// boundaries of fully vectorised [N] arithmetic, which XLA fuses on the
// TPU and which would be some 2,600 small launches a call as eager torch.
// No TPU kernel: the JAX package left them to XLA.  The plain versions are
// ice/icepack/itd.py: linear_itd and rebin (itd_remap_plain on the pack).
//
// The state is pack [ncat, R, N]: rows a, v, vs, Tsf, the nilyr ice and
// nslyr snow enthalpies, the ka area-weighted tracers (ta) and the rest
// volume-weighted (tv); a count of 0 reads nothing.  With `linear` set the
// thread first displaces the category boundaries with the growth since
// aicen_init, vicen_init [ncat, N], fits g(h) = g0 + g1 (h - hL) in each
// category over its displaced support, and moves the area and volume
// between neighbours across each fixed boundary (_transfer: the
// extensive rows move, the intensive rows mix into the receiver with the
// receiver's old weight); then, or alone, the rebin shifts whole
// categories whose mean thickness left their bounds, upwards then
// downwards.  The categories are walked in the plain version's order and
// every operation is written in its order of operations (a product, sum,
// quotient or select at a time, -fmad=false, NaN propagating through
// minima and maxima as torch.minimum / maximum do, the bounds rounded to
// the working type first), so kernel and plain agree bit for bit: a
// select that flipped would move ice between categories.
//
// The pack is updated in place: each thread reads and writes only its own
// node's column of rows (stride N between rows, so a warp's accesses to a
// row are contiguous).
//
// Bound on the card: bytes.  The pack is read and written once (and
// aicen_init, vicen_init read): 2 x 5 x 12 + 10 values a node at the
// default ncat 5, nilyr = nslyr = 4, some 116 MB in float64 on the
// level-7 globe, 35 us at 3.35 TB/s; the arithmetic is a few hundred
// operations a node.  The rows of a category are reread by each transfer
// it takes part in; they stay in L1 and L2.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kMaxCat = 8;
constexpr double kPuny = 1.0e-11;
constexpr double kThird = 1.0 / 3.0;   // itd.THIRD: x / 3 as x * (1/3)

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {   // torch.maximum
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {   // torch.minimum
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}
template <typename T>
__device__ __forceinline__ T cmax(T x, T lo) { return x < lo ? lo : x; }

template <typename T>
struct Node {
  T* p;            // pack + node
  long long n;     // N, the stride between rows
  int rows, nilyr, nslyr, ka;
  __device__ T& at(int c, int r) const {
    return p[(static_cast<long long>(c) * rows + r) * n];
  }
};

template <typename T>
__device__ __forceinline__ T thick(T a, T v) {
  return a > T(kPuny) ? v / cmax(a, T(kPuny)) : T(0);
}

// _mix: dst takes dw of src into its weight w
template <typename T>
__device__ __forceinline__ T mix(T dst, T w, T src, T dw) {
  const T wt = w + dw;
  return wt > T(kPuny) ? (dst * w + src * dw) / cmax(wt, T(kPuny)) : dst;
}

// _transfer: (da, dv) from category cn into cm
template <typename T>
__device__ void transfer(const Node<T>& s, int cn, int cm, T da, T dv) {
  const T a_n = s.at(cn, 0), v_n = s.at(cn, 1), vs_n = s.at(cn, 2);
  const T a_m = s.at(cm, 0), v_m = s.at(cm, 1), vs_m = s.at(cm, 2);
  da = tmin(cmax(da, T(0)), a_n * T(1.0 - kPuny));
  dv = tmin(cmax(dv, T(0)), v_n * T(1.0 - kPuny));
  const bool ok = (a_n > T(kPuny)) && (v_n > T(kPuny));
  da = ok ? da : T(0);
  dv = ok ? dv : T(0);
  const T fa = da / cmax(a_n, T(kPuny));
  const T dvs = vs_n * fa;
  s.at(cm, 3) = mix(s.at(cm, 3), a_m, s.at(cn, 3), da);
  int r = 4;
  for (int l = 0; l < s.nilyr; ++l, ++r)
    s.at(cm, r) = mix(s.at(cm, r), v_m, s.at(cn, r), dv);
  for (int l = 0; l < s.nslyr; ++l, ++r)
    s.at(cm, r) = mix(s.at(cm, r), vs_m, s.at(cn, r), dvs);
  for (int k = 0; k < s.ka; ++k, ++r)
    s.at(cm, r) = mix(s.at(cm, r), a_m, s.at(cn, r), da);
  for (; r < s.rows; ++r)
    s.at(cm, r) = mix(s.at(cm, r), v_m, s.at(cn, r), dv);
  s.at(cn, 0) = a_n - da;
  s.at(cn, 1) = v_n - dv;
  s.at(cn, 2) = vs_n - dvs;
  s.at(cm, 0) = a_m + da;
  s.at(cm, 1) = v_m + dv;
  s.at(cm, 2) = vs_m + dvs;
}

template <typename T>
struct Fit {
  T g0, g1, hL, hR;
};

// _fit_line
template <typename T>
__device__ __forceinline__ Fit<T> fit_line(T a, T hice, T hL, T hR) {
  T eta = hice - hL;
  T w = hR - hL;
  hR = eta < w * T(kThird) ? hL + T(3) * eta : hR;
  hL = eta > (T(2) * w) * T(kThird) ? hR - T(3) * (hR - hice) : hL;
  w = hR - hL;
  eta = hice - hL;
  const bool ok = (a > T(kPuny)) && (w > T(kPuny));
  const T ws = cmax(w, T(kPuny));
  Fit<T> f;
  f.g0 = ok ? (a / ws) * (T(4) - (T(6) * eta) / ws) : T(0);
  f.g1 = ok ? ((T(6) * a) / (ws * ws)) * ((T(2) * eta) / ws - T(1)) : T(0);
  f.hL = hL;
  f.hR = hR;
  return f;
}

// _integrate_g: (da, dv) of g over [x0, x1] within [hL, hR]
template <typename T>
__device__ __forceinline__ void integrate(const Fit<T>& f, T x0, T x1, T& da,
                                          T& dv) {
  const T e0 = tmin(tmax(x0, f.hL), f.hR) - f.hL;
  T e1 = tmin(tmax(x1, f.hL), f.hR) - f.hL;
  e1 = tmax(e1, e0);
  const T d2 = e1 * e1 - e0 * e0;
  da = f.g0 * (e1 - e0) + (T(0.5) * f.g1) * d2;
  dv = (f.hL * da + (T(0.5) * f.g0) * d2) +
       (f.g1 * ((e1 * e1) * e1 - (e0 * e0) * e0)) * T(kThird);
  da = cmax(da, T(0));
  dv = cmax(dv, T(0));
}

template <typename T>
__global__ void __launch_bounds__(fesom::kThreads)
    itd_remap_kernel(T* pack, const T* a_init, const T* v_init,
                     const double* hin_max, int ncat, int rows, int n_nodes,
                     int nilyr, int nslyr, int ka, int linear) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n_nodes) return;
  const Node<T> s{pack + i, n_nodes, rows, nilyr, nslyr, ka};
  T hb[kMaxCat + 1];
  for (int n = 0; n <= ncat; ++n) hb[n] = T(hin_max[n]);

  if (linear) {
    T h_init[kMaxCat], h_now[kMaxCat], dh[kMaxCat], hbnew[kMaxCat + 1];
    bool has_init[kMaxCat];
    for (int n = 0; n < ncat; ++n) {
      const T ai = a_init[static_cast<long long>(n) * n_nodes + i];
      const T vi = v_init[static_cast<long long>(n) * n_nodes + i];
      const T a = s.at(n, 0);
      h_init[n] = thick(ai, vi);
      h_now[n] = thick(a, s.at(n, 1));
      has_init[n] = ai > T(kPuny);
      dh[n] = (has_init[n] && a > T(kPuny)) ? h_now[n] - h_init[n] : T(0);
    }
    hbnew[0] = T(0);
    hbnew[ncat] = T(hin_max[ncat]);
    for (int n = 1; n < ncat; ++n) {
      const int lo = n - 1, hi = n;
      const T dspan = h_init[hi] - h_init[lo];
      const bool big = fabs(dspan) > T(kPuny);
      const T slope = big ? (dh[hi] - dh[lo]) / (big ? dspan : T(1)) : T(0);
      const T disp_both = dh[lo] + slope * (hb[n] - h_init[lo]);
      const T disp = (has_init[lo] && has_init[hi])
                         ? disp_both
                         : (has_init[lo] ? dh[lo]
                                         : (has_init[hi] ? dh[hi] : T(0)));
      hbnew[n] = tmin(tmax(hb[n] + disp,
                           hb[n - 1] * T(1.0 + kPuny) + T(kPuny)),
                      hb[n + 1] * T(1.0 - kPuny));
    }
    Fit<T> fits[kMaxCat];
    for (int n = 0; n < ncat; ++n)
      fits[n] = fit_line(s.at(n, 0), h_now[n], hbnew[n], hbnew[n + 1]);
    for (int n = 1; n < ncat; ++n) {
      const T bnd = hb[n];
      const bool moved_up = hbnew[n] > bnd;
      T da_up, dv_up, da_dn, dv_dn;
      integrate(fits[n - 1], bnd, hbnew[n], da_up, dv_up);
      integrate(fits[n], hbnew[n], bnd, da_dn, dv_dn);
      da_up = moved_up ? da_up : T(0);
      dv_up = moved_up ? dv_up : T(0);
      da_dn = moved_up ? T(0) : da_dn;
      dv_dn = moved_up ? T(0) : dv_dn;
      transfer(s, n - 1, n, da_up, dv_up);
      transfer(s, n, n - 1, da_dn, dv_dn);
    }
  }
  // rebin: up, then down
  for (int n = 0; n < ncat - 1; ++n) {
    const T a = s.at(n, 0), v = s.at(n, 1);
    const bool move = thick(a, v) > hb[n + 1];
    transfer(s, n, n + 1, move ? a : T(0), move ? v : T(0));
  }
  for (int n = ncat - 1; n > 0; --n) {
    const T a = s.at(n, 0), v = s.at(n, 1);
    const bool move = thick(a, v) < hb[n];
    transfer(s, n, n - 1, move ? a : T(0), move ? v : T(0));
  }
}

template <typename T>
int run(void* pack, const void* a_init, const void* v_init,
        const double* hin_max, int ncat, int rows, int n_nodes, int nilyr,
        int nslyr, int ka, int linear, cudaStream_t stream) {
  if (ncat < 1 || ncat > kMaxCat || rows < 4 + nilyr + nslyr + ka ||
      (linear && (a_init == nullptr || v_init == nullptr)))
    return cudaErrorInvalidValue;
  if (n_nodes == 0) return cudaSuccess;
  itd_remap_kernel<T><<<fesom::blocks_for(n_nodes), fesom::kThreads, 0,
                        stream>>>(static_cast<T*>(pack),
                                  static_cast<const T*>(a_init),
                                  static_cast<const T*>(v_init), hin_max,
                                  ncat, rows, n_nodes, nilyr, nslyr, ka,
                                  linear);
  return fesom::last_error();
}

}  // namespace

// The remap (linear != 0) and the rebin of pack [ncat, rows, N] in place;
// aicen_init, vicen_init [ncat, N] (read with linear only); hin_max
// [ncat + 1] float64 on the card.
extern "C" int fesom_itd_remap(void* pack, const void* aicen_init,
                               const void* vicen_init, const void* hin_max,
                               int ncat, int rows, int n_nodes, int nilyr,
                               int nslyr, int ka, int linear, int is_double,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* hb = static_cast<const double*>(hin_max);
  if (is_double)
    return run<double>(pack, aicen_init, vicen_init, hb, ncat, rows, n_nodes,
                       nilyr, nslyr, ka, linear, s);
  return run<float>(pack, aicen_init, vicen_init, hb, ncat, rows, n_nodes,
                    nilyr, nslyr, ka, linear, s);
}
