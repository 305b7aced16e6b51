// dens_moc_bin: the density-space MOC binning of diag_dens_moc, one
// thread an element, the layers in ascending order.
//
// Replaces no TPU kernel: fesom2_tpu/core/diagnostics.py:159-253
// (diag_dens_moc) builds an overlap tensor ov [nl-1, S, E] of every layer's
// density interval with every density class and contracts it with
// einsum('lse,le->se'), which XLA fuses on the TPU.  As eager torch the
// chain holds several [nl-1, S, E] intermediates at once: 46 x 89 x 225,854
// = 924.6 M values on the level-7 globe, 7.4 GB each in float64.  Here
// nothing of that shape is formed.  The plain version is
// core/diagnostics.py: dens_moc_bin_plain (the JAX chain, over chunks of
// elements).
//
// For element e and each active layer l (ulevels-1 <= l < nlevels-1) the
// thread takes the layer's interval [dmin, dmax] of the interface
// densities dens[l], dens[l + 1], finds by bisection the first class s
// whose upper edge mid(s, s+1) lies above dmin and walks the contiguous
// run of classes whose lower edge mid(s-1, s) lies below dmax: only they
// overlap the interval (the classes before and after it have an overlap
// of 0 in the plain version, which adds nothing).  wsum is the sum of the
// run's overlaps in ascending class order; where wsum > 1e-10 the weights
// are ov / wsum, else the layer's whole weight goes to the class nearest
// the interval's mid point (the first on a tie, as argmin picks it; a NaN
// interval goes to class 0, as argmin over NaNs does).  The thread adds
// w * udz, w * vdz, w * vol, w * (-zmid) and w into its element's column
// of the five outputs [5, S, E]: std_dens_UDZ, VDZ, VOL, Z and W.  udz =
// (u + fer_u) helem, vdz = (v + fer_v) helem, vol = helem * elem_area,
// zmid the layer's mid depth from the running sum of helem.  Every
// operation is the plain version's, in its order, with -fmad=false; only
// the sum over layers runs in another order than the plain einsum's.
//
// A thread owns its element's outputs: no atomics.  It writes its 5 S
// zeros first, then adds the few classes each layer touches (they stay in
// L1 and L2 between layers).
//
// Bound on the card: bytes.  Each active layer's helem, u, v (fer_u,
// fer_v) and upper interface density are read once, one more density row
// under an element's last active layer, and the five [S, E] outputs
// written once: on the level-7 globe (8.5 M active layers of 46 x 225,854,
// 89 classes) the 445 output rows outweigh the reads some three to one,
// 1.08 GB in float64, 0.32 ms at 3.35 TB/s (core/diagnostics.py:
// dens_moc_bin_work counts them).  A layer's arithmetic is some ten
// operations and some thirteen for each class of its run.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kMaxClasses = 128;

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {  // torch.maximum
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {  // torch.minimum
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}
// clamp(x, min=0) of the overlap
template <typename T>
__device__ __forceinline__ T clip0(T x) { return x < T(0) ? T(0) : x; }

template <typename T>
__global__ void __launch_bounds__(fesom::kThreads)
    dens_moc_bin_kernel(const T* __restrict__ dens,
                        const T* __restrict__ helem,
                        const T* __restrict__ u, const T* __restrict__ v,
                        const T* __restrict__ fer_u,
                        const T* __restrict__ fer_v,
                        const T* __restrict__ elem_area,
                        const int* __restrict__ ulevels,
                        const int* __restrict__ nlevels,
                        const T* __restrict__ bins, T* __restrict__ out,
                        int nl, int n_elems, int n_classes) {
  __shared__ T s_bin[kMaxClasses], s_lo[kMaxClasses], s_hi[kMaxClasses];
  for (int s = threadIdx.x; s < n_classes; s += blockDim.x) {
    s_bin[s] = bins[s];
    s_lo[s] = s == 0 ? T(-1e30) : T(0.5) * (bins[s - 1] + bins[s]);
    s_hi[s] = s == n_classes - 1 ? T(1e30) : T(0.5) * (bins[s] + bins[s + 1]);
  }
  __syncthreads();
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= n_elems) return;
  const long long E = n_elems;
  const long long plane = static_cast<long long>(n_classes) * E;
  T* o_udz = out + e;
  T* o_vdz = o_udz + plane;
  T* o_vol = o_vdz + plane;
  T* o_z = o_vol + plane;
  T* o_w = o_z + plane;
  for (int s = 0; s < n_classes; ++s) {
    const long long k = s * E;
    o_udz[k] = T(0);
    o_vdz[k] = T(0);
    o_vol[k] = T(0);
    o_z[k] = T(0);
    o_w[k] = T(0);
  }
  const int l0 = max(ulevels[e] - 1, 0);
  const int l1 = min(nlevels[e] - 1, nl - 1);
  const T area = elem_area[e];
  T depth = T(0);
  T dtop = l0 < l1 ? dens[l0 * E + e] : T(0);
  for (int l = l0; l < l1; ++l) {
    const long long i = l * E + e;
    const T h = helem[i];
    depth = depth + h;
    const T zmid = depth - h / T(2);
    const T uu = fer_u != nullptr ? u[i] + fer_u[i] : u[i];
    const T vv = fer_v != nullptr ? v[i] + fer_v[i] : v[i];
    const T x_udz = uu * h;
    const T x_vdz = vv * h;
    const T x_vol = h * area;
    const T x_z = -zmid;
    const T dbot = dens[i + E];
    const T dmin = tmin(dtop, dbot);
    const T dmax = tmax(dtop, dbot);
    dtop = dbot;
    // the run [a, b) of classes that can overlap [dmin, dmax]
    int a = 0, b = n_classes;
    if (dmin == dmin && dmax == dmax) {
      int hi = n_classes;
      while (a < hi) {
        const int m = (a + hi) >> 1;
        if (s_hi[m] > dmin)
          hi = m;
        else
          a = m + 1;
      }
      b = a;
      while (b < n_classes && s_lo[b] < dmax) ++b;
    } else {
      b = 0;  // NaN: wsum is NaN in the plain version, the weight nearest
    }
    T wsum = T(0);
    for (int s = a; s < b; ++s)
      wsum = wsum + clip0(tmin(dmax, s_hi[s]) - tmax(dmin, s_lo[s]));
    if (b > a && wsum > T(1e-10)) {
      const T den = tmax(wsum, T(1e-30));
      for (int s = a; s < b; ++s) {
        const T w = clip0(tmin(dmax, s_hi[s]) - tmax(dmin, s_lo[s])) / den;
        const long long k = s * E;
        o_udz[k] = o_udz[k] + w * x_udz;
        o_vdz[k] = o_vdz[k] + w * x_vdz;
        o_vol[k] = o_vol[k] + w * x_vol;
        o_z[k] = o_z[k] + w * x_z;
        o_w[k] = o_w[k] + w;
      }
    } else {
      // the nearest class to the interval's mid point (argmin, first on
      // a tie; a NaN mid point compares false everywhere and stays at 0)
      const T dmid = T(0.5) * (dmin + dmax);
      int best = 0;
      T dbest = fabs(s_bin[0] - dmid);
      for (int s = 1; s < n_classes; ++s) {
        const T d = fabs(s_bin[s] - dmid);
        if (d < dbest) {
          dbest = d;
          best = s;
        }
      }
      const long long k = best * E;
      o_udz[k] = o_udz[k] + x_udz;
      o_vdz[k] = o_vdz[k] + x_vdz;
      o_vol[k] = o_vol[k] + x_vol;
      o_z[k] = o_z[k] + x_z;
      o_w[k] = o_w[k] + T(1);
    }
  }
}

template <typename T>
int run(const void* dens, const void* helem, const void* u, const void* v,
        const void* fer_u, const void* fer_v, const void* elem_area,
        const int* ulevels, const int* nlevels, const void* bins, void* out,
        int nl, int n_elems, int n_classes, cudaStream_t stream) {
  if (n_classes < 1 || n_classes > kMaxClasses || nl < 2)
    return cudaErrorInvalidValue;
  if (n_elems == 0) return cudaSuccess;
  dens_moc_bin_kernel<T><<<fesom::blocks_for(n_elems), fesom::kThreads, 0,
                           stream>>>(
      static_cast<const T*>(dens), static_cast<const T*>(helem),
      static_cast<const T*>(u), static_cast<const T*>(v),
      static_cast<const T*>(fer_u), static_cast<const T*>(fer_v),
      static_cast<const T*>(elem_area), ulevels, nlevels,
      static_cast<const T*>(bins), static_cast<T*>(out), nl, n_elems,
      n_classes);
  return fesom::last_error();
}

}  // namespace

// dens [nl, E], helem, u, v [nl-1, E], fer_u, fer_v [nl-1, E] or null,
// elem_area [E], ulevels, nlevels [E] int32 (1-based), bins [S] ascending,
// out [5, S, E] (written whole).
extern "C" int fesom_dens_moc_bin(const void* dens, const void* helem,
                                  const void* u, const void* v,
                                  const void* fer_u, const void* fer_v,
                                  const void* elem_area, const void* ulevels,
                                  const void* nlevels, const void* bins,
                                  void* out, int nl, int n_elems,
                                  int n_classes, int is_double,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ul = static_cast<const int*>(ulevels);
  const int* nlv = static_cast<const int*>(nlevels);
  if (is_double)
    return run<double>(dens, helem, u, v, fer_u, fer_v, elem_area, ul, nlv,
                       bins, out, nl, n_elems, n_classes, s);
  return run<float>(dens, helem, u, v, fer_u, fer_v, elem_area, ul, nlv, bins,
                    out, nl, n_elems, n_classes, s);
}
