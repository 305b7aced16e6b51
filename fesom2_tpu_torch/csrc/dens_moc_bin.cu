// dens_moc_bin: the density-space MOC binning of diag_dens_moc, one
// thread an element, the layers in ascending order, each output stored
// once.
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
// densities dens[l], dens[l + 1], finds the first class s whose upper edge
// mid(s, s+1) lies above dmin (walking from the layer above's) and walks
// the contiguous run of classes whose lower edge mid(s-1, s) lies below
// dmax: only they
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
// Design: a thread owns its element's outputs (no atomics), and every
// output is stored exactly once, the 32 lanes of a warp storing the same
// class row of 32 neighbouring elements together (coalesced; no output is
// read).  Two passes over the element's layers:
//  1. the span pass reads the densities and helem (kAhead layers' loads
//     in flight together), finds each layer's classes, and records for
//     each chunk of kChunk classes the first and last layer that sends
//     weight into it and the running depth before the first (shared
//     memory, a slot per thread and chunk);
//  2. the chunk loop, the same for every lane (warp-uniform): for each
//     chunk the warp walks the union of the layers its lanes' slots name
//     (every load one row of 32 neighbouring elements), a lane working
//     only on its own (none where the chunk lies outside its span); it
//     sums the chunk's 5 x kChunk values in registers, in ascending layer
//     order from 0, as the first design summed them in device memory, and
//     stores them; a chunk no layer meets stores its zeros.
// A layer is read once in the span pass and once for each chunk its
// classes meet (the elements' spans are 58 classes wide at the median on
// the level-7 globe, a layer's run 2.35), its overlaps summed only where
// it meets the chunk.  Four classes a chunk keep three blocks an SM
// resident in both types (eight ran as fast in float64, and 25 % slower
// in float32 at two blocks).  Each class receives the same terms in
// the same order as in the first design (a zero fill, then one
// read-modify-write a layer), so the outputs are its outputs bit for
// bit.
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
constexpr int kChunk = 4;            // classes summed in registers at once
constexpr int kBlock = 256;
constexpr int kAhead = 8;            // layers read ahead in the span pass
constexpr unsigned kNoLayer = 0xFFFF;  // a chunk's slot before any layer
constexpr int kMaxLayerRow = 0xFFFF;

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

// The classes [a, b) a layer's interval [dmin, dmax] sends weight to:
// its run, where its overlaps' sum wsum > 1e-10 (wide), else the one
// class nearest its mid point.  a is the first class whose upper edge lies
// above dmin, b the first class from a whose lower edge does not lie below
// dmax (a = b = 0 for a NaN interval).  a is found by a walk from `hint`
// (the classes ascend with depth, so the layer above's a is seldom more
// than a class away); the bisection of the first design found the same
// first class of an ascending array.  Where dmax - dmin > 1e-9 the run
// covers the interval with pieces each rounded once, so wsum > 1e-10 for
// sure and it is not summed here (the caller sums it where it needs the
// weights); else wsum decides, as in the first design.
template <typename T>
struct Classes {
  int a, b;
  bool wide;
};

template <typename T>
__device__ __forceinline__ T overlap(T dmin, T dmax, const T* s_lo,
                                     const T* s_hi, int s) {
  return clip0(tmin(dmax, s_hi[s]) - tmax(dmin, s_lo[s]));
}

template <typename T>
__device__ __forceinline__ Classes<T> classes_of(T dmin, T dmax,
                                                 const T* s_bin,
                                                 const T* s_lo,
                                                 const T* s_hi, int S,
                                                 int& hint) {
  Classes<T> r;
  int a = 0, b = 0;
  if (dmin == dmin && dmax == dmax) {
    a = hint;
    while (a > 0 && s_hi[a - 1] > dmin) --a;
    while (a < S && !(s_hi[a] > dmin)) ++a;
    b = a;
    while (b < S && s_lo[b] < dmax) ++b;
    hint = a < S ? a : S - 1;
  }
  r.wide = b > a && dmax - dmin > T(1e-9);
  if (!r.wide) {
    T wsum = T(0);
    for (int s = a; s < b; ++s)
      wsum = wsum + overlap(dmin, dmax, s_lo, s_hi, s);
    r.wide = b > a && wsum > T(1e-10);
  }
  if (r.wide) {
    r.a = a;
    r.b = b;
  } else {
    // the nearest class to the interval's mid point (argmin, first on
    // a tie; a NaN mid point compares false everywhere and stays at 0)
    const T dmid = T(0.5) * (dmin + dmax);
    int best = 0;
    T dbest = fabs(s_bin[0] - dmid);
    for (int s = 1; s < S; ++s) {
      const T d = fabs(s_bin[s] - dmid);
      if (d < dbest) {
        dbest = d;
        best = s;
      }
    }
    r.a = best;
    r.b = best + 1;
  }
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kBlock, 3)
    dens_moc_bin_kernel(const T* __restrict__ dens,
                        const T* __restrict__ helem,
                        const T* __restrict__ u, const T* __restrict__ v,
                        const T* __restrict__ fer_u,
                        const T* __restrict__ fer_v,
                        const T* __restrict__ elem_area,
                        const int* __restrict__ ulevels,
                        const int* __restrict__ nlevels,
                        const T* __restrict__ bins, T* __restrict__ out,
                        int nl, int n_elems, int S) {
  __shared__ T s_bin[kMaxClasses], s_lo[kMaxClasses], s_hi[kMaxClasses];
  // per chunk and thread: the running depth before the chunk's first
  // layer [Q][kBlock], and first | last << 16 of its layers [Q][kBlock]
  extern __shared__ __align__(16) unsigned char s_raw[];
  const int Q = (S + kChunk - 1) / kChunk;
  const int tid = threadIdx.x;
  T* s_depth = reinterpret_cast<T*>(s_raw);
  unsigned* s_range = reinterpret_cast<unsigned*>(s_depth + Q * kBlock);
  for (int s = tid; s < S; s += kBlock) {
    s_bin[s] = bins[s];
    s_lo[s] = s == 0 ? T(-1e30) : T(0.5) * (bins[s - 1] + bins[s]);
    s_hi[s] = s == S - 1 ? T(1e30) : T(0.5) * (bins[s] + bins[s + 1]);
  }
  for (int q = 0; q < Q; ++q) s_range[q * kBlock + tid] = kNoLayer;
  __syncthreads();
  // lanes past the last element stay in the loop below (the chunks are
  // walked by every lane alike) and store nothing
  const long long e = static_cast<long long>(blockIdx.x) * kBlock + tid;
  const bool valid = e < n_elems;
  const long long E = n_elems;
  int l0 = 0, l1 = 0;
  T area = T(0);
  if (valid) {
    l0 = max(ulevels[e] - 1, 0);
    l1 = min(nlevels[e] - 1, nl - 1);
    area = elem_area[e];
  }

  // 1. the span pass, the loads of kAhead layers in flight together
  {
    T depth = T(0);
    int hint = 0;
    T dtop = l0 < l1 ? dens[l0 * E + e] : T(0);
    for (int lb = l0; lb < l1; lb += kAhead) {
      T d[kAhead], h[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j)
        if (lb + j < l1) {
          d[j] = dens[(lb + j + 1) * E + e];
          h[j] = helem[(lb + j) * E + e];
        }
#pragma unroll
      for (int j = 0; j < kAhead; ++j)
        if (lb + j < l1) {
          const int l = lb + j;
          const Classes<T> c = classes_of(tmin(dtop, d[j]), tmax(dtop, d[j]),
                                          s_bin, s_lo, s_hi, S, hint);
          dtop = d[j];
          for (int q = c.a / kChunk; q <= (c.b - 1) / kChunk; ++q) {
            unsigned* slot = s_range + q * kBlock + tid;
            if ((*slot & 0xFFFFu) == kNoLayer) {
              s_depth[q * kBlock + tid] = depth;
              *slot = l;
            }
            *slot = (*slot & 0xFFFFu) | (static_cast<unsigned>(l) << 16);
          }
          depth = depth + h[j];
        }
    }
  }

  // 2. the chunks of classes
  const long long plane = static_cast<long long>(S) * E;
  for (int q = 0; q < Q; ++q) {
    const int c0 = q * kChunk;
    T acc[5][kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
#pragma unroll
      for (int k = 0; k < 5; ++k) acc[k][j] = T(0);
    const unsigned range = s_range[q * kBlock + tid];
    const bool mine = range != kNoLayer;
    const int lf = mine ? static_cast<int>(range & 0xFFFFu) : kMaxLayerRow;
    const int ll = mine ? static_cast<int>(range >> 16) : -1;
    // the warp walks the union of its lanes' layers together, so that each
    // load is one row of 32 neighbouring elements; a lane works on its own
    const int wf = __reduce_min_sync(0xffffffffu, lf);
    const int wl = __reduce_max_sync(0xffffffffu, ll);
    T depth = mine ? s_depth[q * kBlock + tid] : T(0);
    int hint = c0 < S ? c0 : S - 1;
    for (int l = wf; l <= wl; ++l) {
      if (l < lf || l > ll) continue;
      const long long i = l * E + e;
      const T h = helem[i];
      depth = depth + h;
      const T dtop = dens[i], dbot = dens[i + E];
      const T dmin = tmin(dtop, dbot);
      const T dmax = tmax(dtop, dbot);
      const Classes<T> c = classes_of(dmin, dmax, s_bin, s_lo, s_hi, S,
                                      hint);
      if (c.b <= c0 || c.a >= c0 + kChunk) continue;
      const T zmid = depth - h / T(2);
      const T uu = fer_u != nullptr ? u[i] + fer_u[i] : u[i];
      const T vv = fer_v != nullptr ? v[i] + fer_v[i] : v[i];
      const T x_udz = uu * h;
      const T x_vdz = vv * h;
      const T x_vol = h * area;
      const T x_z = -zmid;
      if (c.wide) {
        T wsum = T(0);
        for (int s = c.a; s < c.b; ++s)
          wsum = wsum + overlap(dmin, dmax, s_lo, s_hi, s);
        const T den = tmax(wsum, T(1e-30));
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int s = c0 + j;
          if (s >= c.a && s < c.b) {
            const T w = overlap(dmin, dmax, s_lo, s_hi, s) / den;
            acc[0][j] = acc[0][j] + w * x_udz;
            acc[1][j] = acc[1][j] + w * x_vdz;
            acc[2][j] = acc[2][j] + w * x_vol;
            acc[3][j] = acc[3][j] + w * x_z;
            acc[4][j] = acc[4][j] + w;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (c0 + j == c.a) {
            acc[0][j] = acc[0][j] + x_udz;
            acc[1][j] = acc[1][j] + x_vdz;
            acc[2][j] = acc[2][j] + x_vol;
            acc[3][j] = acc[3][j] + x_z;
            acc[4][j] = acc[4][j] + T(1);
          }
      }
    }
    if (valid) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (c0 + j < S) {
          T* o = out + static_cast<long long>(c0 + j) * E + e;
#pragma unroll
          for (int k = 0; k < 5; ++k) o[k * plane] = acc[k][j];
        }
    }
  }
}

template <typename T>
size_t shared_bytes(int S) {
  return static_cast<size_t>((S + kChunk - 1) / kChunk) * kBlock *
         (sizeof(T) + sizeof(unsigned));
}

template <typename T>
int run(const void* dens, const void* helem, const void* u, const void* v,
        const void* fer_u, const void* fer_v, const void* elem_area,
        const int* ulevels, const int* nlevels, const void* bins, void* out,
        int nl, int n_elems, int n_classes, cudaStream_t stream) {
  if (n_classes < 1 || n_classes > kMaxClasses || nl < 2 ||
      nl - 1 >= static_cast<int>(kNoLayer))
    return cudaErrorInvalidValue;
  if (n_elems == 0) return cudaSuccess;
  const size_t smem = shared_bytes<T>(n_classes);
  cudaError_t err = fesom::allow_shared(dens_moc_bin_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid =
      static_cast<unsigned>((static_cast<long long>(n_elems) + kBlock - 1) /
                            kBlock);
  dens_moc_bin_kernel<T><<<grid, kBlock, smem, stream>>>(
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

// The launch dens_moc_bin makes for n_classes classes: out[0..3] = block,
// classes a chunk, chunks, dynamic shared bytes (out: host int32 [4]).
extern "C" int fesom_dens_moc_bin_plan(int n_classes, int is_double,
                                       void* out) {
  int* o = static_cast<int*>(out);
  o[0] = kBlock;
  o[1] = kChunk;
  o[2] = (n_classes + kChunk - 1) / kChunk;
  o[3] = static_cast<int>(is_double ? shared_bytes<double>(n_classes)
                                    : shared_bytes<float>(n_classes));
  return cudaSuccess;
}
