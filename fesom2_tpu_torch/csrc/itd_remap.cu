// itd_remap: Icepack's ice-thickness-distribution remap, the linear
// remapping of Lipscomb (2001) followed by the rebin, or the rebin alone,
// on the category state of 32 nodes a block.
//
// Replaces fesom2_tpu/ice/icepack/itd.py:167-271 (linear_itd, 1,691
// jaxpr equations, and rebin, 939): static Python loops over the category
// boundaries of fully vectorised [N] arithmetic, which XLA fuses on the
// TPU and which would be some 2,600 small launches a call as eager torch.
// No TPU kernel: the JAX package left them to XLA.  The plain version is
// ice/icepack/itd.py: itd_remap_plain (linear_itd, then rebin).
//
// The state comes in as the eight category tensors where they lie: aicen,
// vicen, vsnon, Tsfcn [ncat, N], qin [ncat, nilyr, N], qsn [ncat, nslyr,
// N], the area-weighted tracers ta [ncat, ka, N] and the volume-weighted
// tv [ncat, kv, N] (a count of 0 reads nothing).  It goes out as a fresh
// pack [ncat, rows, N], rows a, v, vs, Tsf, qin, qsn, ta, tv; the inputs
// are not written.
//
// With `linear` set, the category boundaries are displaced with the growth
// since aicen_init, vicen_init [ncat, N], g(h) = g0 + g1 (h - hL) is fitted
// in each category over its displaced support, and area and volume move
// between neighbours across each fixed boundary (_transfer: the extensive
// rows a, v, vs move; every other row mixes into the receiver with the
// receiver's old weight); then, or alone, the rebin shifts whole
// categories whose mean thickness left their bounds, upwards then
// downwards: 4 (ncat - 1) transfers in all, or 2 (ncat - 1).
//
// Bound on the card: bytes.  The inputs are read once and the pack written
// once (and aicen_init, vicen_init read): 2 x 5 x 12 + 10 values a node at
// the default ncat 5, nilyr = nslyr = 4, some 119 MB in float64 on the
// level-7 globe, 35 us at 3.35 TB/s.  The arithmetic is about 3,000
// float64 operations a node with ice (a division a mix).
//
// Design.  Which transfers happen, and their amounts, depend only on the
// rows a, v, vs and the init arrays: that chain is walked once a node,
// and every other row only mixes.  So a block holds 32 nodes, a node a
// lane.  Warp 0 walks the chain (the displaced boundaries, the fits, each
// transfer's clamps) in registers, the categories unrolled over the
// compile-time ncat (one instance each up to kMaxCat), writes a, v, vs
// out, and leaves each transfer's six numbers (the receiver's old a, v, vs
// and the moved da, dv, dvs) in shared memory, [transfer][number][lane].
// The other warps take the remaining rows, each up to kHeld rows at once
// with a row's ncat values in registers: they load them before the block's
// one barrier (while warp 0 walks), then apply the transfers' mixes in the
// chain's order, and store.  A warp reads and writes 32 consecutive nodes
// of one row: every access to device memory is coalesced, and each value
// crosses it once each way.
//
// Most nodes hold no ice (988 of 114,033 on the level-7 globe's Icepack
// step), and warp 0's chain is the block's critical path: some 60
// divisions a node in the remap, each behind its own branch to the
// division's slow path (which a zero numerator, or 0 / 0 in a lane whose
// quotient a select drops, takes), so they do not overlap.  So a warp
// whose 32 nodes all hold at most puny of area in every category walks
// the transfers with amounts of 0 (no donor passes the `ok` guard there,
// whatever the fits ask for) without a division or the init arrays, and
// where no mix can change a value (every receiver's weight plus its share
// at most puny, where the plain version's select returns dst itself) the
// row warps copy their rows.  The warps that walk the full chain are the
// polar ones, which the curve numbers last: the blocks take the node
// groups from the end (kReversed), so those start in the first wave.
//
// Every operation is written in the plain version's order of operations
// (a product, sum, quotient or select at a time, -fmad=false, NaN
// propagating through minima and maxima as torch.minimum / maximum do,
// the bounds rounded to the working type first), and no mix is skipped
// for a zero amount (a mix with dw = 0 returns (dst w) / w, not dst), so
// kernel and plain agree bit for bit: a select that flipped would move
// ice between categories.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kMaxCat = 8;
constexpr int kNodes = 32;    // nodes a block, a node a lane
constexpr int kWarps = 4;     // warp 0 the chain, the rest the rows
// rows a row warp holds in registers at once, float64 and float32 (the
// faster of 1, 2 and 3 in turns on the Icepack step's level-7 inputs)
constexpr int kHeld64 = 2;
constexpr int kHeld32 = 1;
constexpr int kParams = 6;    // a transfer's a_m, v_m, vs_m, da, dv, dvs
// 1: block b takes the b-th node group counted from the end (above)
constexpr int kReversed = 1;
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

// The eight category tensors, each contiguous [ncat, k, N].
template <typename T>
struct Cats {
  const T* p[8];   // aicen, vicen, vsnon, Tsfcn, qin, qsn, ta, tv
  int k[8];        // their rows a category: 1, 1, 1, 1, nilyr, nslyr, ka, kv
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

// _transfer's extensive part, (da, dv) from category cn into cm: updates
// a, v, vs and leaves the six numbers the mixes need at `slot` (lane's
// column of the transfer's [kParams][kNodes] block), then steps it on;
// `still` stays true while no mix of any row can change its value (every
// receiver's weight plus its share at most puny, or NaN: mix returns dst).
// kIdle: every category of the node holds at most puny of area, so no
// donor passes the `ok` guard and da = +0 over a positive denominator:
// fa = +0 without the division.  kWrite: leave the six numbers (not where
// the rows will only be copied).
template <bool kIdle, bool kWrite = true, typename T, int NCAT>
__device__ __forceinline__ void transfer(T (&a)[NCAT], T (&v)[NCAT],
                                         T (&vs)[NCAT], int cn, int cm, T da,
                                         T dv, T*& slot, bool& still) {
  const T a_n = a[cn], v_n = v[cn], vs_n = vs[cn];
  const T a_m = a[cm], v_m = v[cm], vs_m = vs[cm];
  da = tmin(cmax(da, T(0)), a_n * T(1.0 - kPuny));
  dv = tmin(cmax(dv, T(0)), v_n * T(1.0 - kPuny));
  const bool ok = (a_n > T(kPuny)) && (v_n > T(kPuny));
  da = ok ? da : T(0);
  dv = ok ? dv : T(0);
  const T fa = kIdle ? da : da / cmax(a_n, T(kPuny));
  const T dvs = vs_n * fa;
  if (kWrite) {
    slot[0] = a_m;
    slot[kNodes] = v_m;
    slot[2 * kNodes] = vs_m;
    slot[3 * kNodes] = da;
    slot[4 * kNodes] = dv;
    slot[5 * kNodes] = dvs;
  }
  slot += kParams * kNodes;
  still = still && !(a_m + da > T(kPuny)) && !(v_m + dv > T(kPuny)) &&
          !(vs_m + dvs > T(kPuny));
  a[cn] = a_n - da;
  v[cn] = v_n - dv;
  vs[cn] = vs_n - dvs;
  a[cm] = a_m + da;
  v[cm] = v_m + dv;
  vs[cm] = vs_m + dvs;
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

// The transfers of a node whose categories hold at most puny of area:
// the chain's order, amounts of 0.
template <bool kWrite, typename T, int NCAT>
__device__ __forceinline__ void walk_idle(T (&a)[NCAT], T (&v)[NCAT],
                                          T (&vs)[NCAT], int linear, T*& slot,
                                          bool& still) {
  if (linear) {
#pragma unroll
    for (int c = 1; c < NCAT; ++c) {
      transfer<true, kWrite>(a, v, vs, c - 1, c, T(0), T(0), slot, still);
      transfer<true, kWrite>(a, v, vs, c, c - 1, T(0), T(0), slot, still);
    }
  }
#pragma unroll
  for (int c = 0; c < NCAT - 1; ++c)
    transfer<true, kWrite>(a, v, vs, c, c + 1, T(0), T(0), slot, still);
#pragma unroll
  for (int c = NCAT - 1; c > 0; --c)
    transfer<true, kWrite>(a, v, vs, c, c - 1, T(0), T(0), slot, still);
}

// Warp 0: the chain of one node (lane), in the plain version's order;
// writes rows a, v, vs of the pack and the transfers' numbers to `prm`,
// and returns whether no mix of the lane's rows can change a value.
//
// Most nodes hold no ice.  Where every category of every lane of the warp
// holds at most puny of area (NaN fails the test), no transfer passes its
// `ok` guard, so each moves da = dv = +0 whatever amount the boundaries,
// fits and integrals ask for: the warp walks the same transfers with
// amounts of 0 and no division, and reads no init arrays.
template <typename T, int NCAT>
__device__ __forceinline__ bool walk_chain(const Cats<T>& in, T* out,
                                           const T* a_init, const T* v_init,
                                           const double* hin_max, int linear,
                                           T* prm, long long i, bool live,
                                           int rows, long long n) {
  T a[NCAT], v[NCAT], vs[NCAT];
  bool idle = true;
#pragma unroll
  for (int c = 0; c < NCAT; ++c) {
    const long long o = c * n + i;
    a[c] = live ? in.p[0][o] : T(0);
    v[c] = live ? in.p[1][o] : T(0);
    vs[c] = live ? in.p[2][o] : T(0);
    idle = idle && a[c] <= T(kPuny);
  }
  T* slot = prm;
  bool still = true;

  if (__all_sync(0xffffffffu, idle)) {
    // first without the numbers: they are written only where some mix of
    // the warp's rows can change a value
    T a0[NCAT], v0[NCAT], vs0[NCAT];
#pragma unroll
    for (int c = 0; c < NCAT; ++c) {
      a0[c] = a[c];
      v0[c] = v[c];
      vs0[c] = vs[c];
    }
    walk_idle<false>(a, v, vs, linear, slot, still);
    if (!__all_sync(0xffffffffu, still)) {
#pragma unroll
      for (int c = 0; c < NCAT; ++c) {
        a[c] = a0[c];
        v[c] = v0[c];
        vs[c] = vs0[c];
      }
      slot = prm;
      still = true;
      walk_idle<true>(a, v, vs, linear, slot, still);
    }
  } else {
    T hb[NCAT + 1];
#pragma unroll
    for (int c = 0; c <= NCAT; ++c) hb[c] = T(hin_max[c]);
    if (linear) {
      T h_init[NCAT], h_now[NCAT], dh[NCAT], hbnew[NCAT + 1];
      bool has_init[NCAT];
#pragma unroll
      for (int c = 0; c < NCAT; ++c) {
        const long long o = c * n + i;
        const T ai = live ? a_init[o] : T(0);
        const T vi = live ? v_init[o] : T(0);
        h_init[c] = thick(ai, vi);
        h_now[c] = thick(a[c], v[c]);
        has_init[c] = ai > T(kPuny);
        dh[c] = (has_init[c] && a[c] > T(kPuny)) ? h_now[c] - h_init[c]
                                                  : T(0);
      }
      hbnew[0] = T(0);
      hbnew[NCAT] = T(hin_max[NCAT]);
#pragma unroll
      for (int c = 1; c < NCAT; ++c) {
        const int lo = c - 1, hi = c;
        const T dspan = h_init[hi] - h_init[lo];
        const bool big = fabs(dspan) > T(kPuny);
        const T slope =
            big ? (dh[hi] - dh[lo]) / (big ? dspan : T(1)) : T(0);
        const T disp_both = dh[lo] + slope * (hb[c] - h_init[lo]);
        const T disp = (has_init[lo] && has_init[hi])
                           ? disp_both
                           : (has_init[lo] ? dh[lo]
                                           : (has_init[hi] ? dh[hi] : T(0)));
        hbnew[c] = tmin(tmax(hb[c] + disp,
                             hb[c - 1] * T(1.0 + kPuny) + T(kPuny)),
                        hb[c + 1] * T(1.0 - kPuny));
      }
      Fit<T> fits[NCAT];
#pragma unroll
      for (int c = 0; c < NCAT; ++c)
        fits[c] = fit_line(a[c], h_now[c], hbnew[c], hbnew[c + 1]);
#pragma unroll
      for (int c = 1; c < NCAT; ++c) {
        const T bnd = hb[c];
        const bool moved_up = hbnew[c] > bnd;
        T da_up, dv_up, da_dn, dv_dn;
        integrate(fits[c - 1], bnd, hbnew[c], da_up, dv_up);
        integrate(fits[c], hbnew[c], bnd, da_dn, dv_dn);
        da_up = moved_up ? da_up : T(0);
        dv_up = moved_up ? dv_up : T(0);
        da_dn = moved_up ? T(0) : da_dn;
        dv_dn = moved_up ? T(0) : dv_dn;
        transfer<false>(a, v, vs, c - 1, c, da_up, dv_up, slot, still);
        transfer<false>(a, v, vs, c, c - 1, da_dn, dv_dn, slot, still);
      }
    }
    // rebin: up, then down
#pragma unroll
    for (int c = 0; c < NCAT - 1; ++c) {
      const bool move = thick(a[c], v[c]) > hb[c + 1];
      transfer<false>(a, v, vs, c, c + 1, move ? a[c] : T(0),
                      move ? v[c] : T(0), slot, still);
    }
#pragma unroll
    for (int c = NCAT - 1; c > 0; --c) {
      const bool move = thick(a[c], v[c]) < hb[c];
      transfer<false>(a, v, vs, c, c - 1, move ? a[c] : T(0),
                      move ? v[c] : T(0), slot, still);
    }
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < NCAT; ++c) {
      T* o = out + static_cast<long long>(c) * rows * n + i;
      o[0] = a[c];
      o[n] = v[c];
      o[2 * n] = vs[c];
    }
  }
  return still;
}

// kHeld rows of the pack (rows 3 and up) on one lane: their ncat values,
// which of a, v, vs weighs each, and where each lives.
template <typename T, int NCAT>
struct HeldRows {
  static constexpr int kHeld = sizeof(T) == 8 ? kHeld64 : kHeld32;
  T val[kHeld][NCAT];
  int kind[kHeld];       // 0: area (Tsf, ta), 1: volume (qin, tv), 2: snow
  bool used[kHeld];
  int row[kHeld];        // the row in the pack

  // rows 3 + r, r = first, first + step, ... (kHeld of them, below extra)
  __device__ __forceinline__ void load(const Cats<T>& in, int first, int step,
                                       int extra, long long i, bool live,
                                       long long n) {
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
      const int r = first + h * step;
      used[h] = r < extra;
      row[h] = 3 + r;
      // the tensor (Tsfcn, qin, qsn, ta, tv) and its row j
      int j = r, s = 3;
#pragma unroll
      for (int q = 3; q < 7; ++q)
        if (s == q && j >= in.k[q]) {
          j -= in.k[q];
          s = q + 1;
        }
      const T* base = in.p[3];
      int k = 1;
#pragma unroll
      for (int q = 4; q < 8; ++q)
        if (s == q) {
          base = in.p[q];
          k = in.k[q];
        }
      kind[h] = (s == 4 || s == 7) ? 1 : (s == 5 ? 2 : 0);
      if (used[h]) {
        const T* src = base + j * n + i;   // category 0's value
#pragma unroll
        for (int c = 0; c < NCAT; ++c)
          val[h][c] = live ? src[c * k * n] : T(0);
      }
    }
  }

  // the mixes of one transfer (cn into cm), its numbers at `slot`
  __device__ __forceinline__ void apply(const T* slot, int cn, int cm) {
#pragma unroll
    for (int h = 0; h < kHeld; ++h)
      if (used[h])
        val[h][cm] = mix(val[h][cm], slot[kind[h] * kNodes], val[h][cn],
                         slot[(3 + kind[h]) * kNodes]);
  }

  __device__ __forceinline__ void store(T* out, int rows, long long i,
                                        bool live, long long n) const {
#pragma unroll
    for (int h = 0; h < kHeld; ++h)
      if (used[h] && live) {
#pragma unroll
        for (int c = 0; c < NCAT; ++c)
          out[(static_cast<long long>(c) * rows + row[h]) * n + i] =
              val[h][c];
      }
  }
};

template <typename T, int NCAT>
__global__ void __launch_bounds__(kWarps * 32)
    itd_remap_kernel(Cats<T> in, T* out, const T* a_init, const T* v_init,
                     const double* hin_max, int rows, int n_nodes,
                     int linear) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* prm = reinterpret_cast<T*>(smem);   // [transfer][kParams][kNodes]
  __shared__ int rows_still;             // no mix changes a value
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long n = n_nodes;
  const long long group = kReversed ? gridDim.x - 1 - blockIdx.x
                                    : blockIdx.x;
  const long long i = group * kNodes + lane;
  const bool live = i < n;
  // the row warps: 1 .. kWarps - 1 (warp 0 alone when kWarps is 1)
  const int row_warps = kWarps > 1 ? kWarps - 1 : 1;
  const int rw = kWarps > 1 ? warp - 1 : 0;
  const int extra = rows - 3;
  HeldRows<T, NCAT> held;
  if (warp == 0) {
    const bool still = walk_chain<T, NCAT>(in, out, a_init, v_init, hin_max,
                                           linear, prm + lane, i, live, rows,
                                           n);
    const bool all_still = __all_sync(0xffffffffu, still);
    if (lane == 0) rows_still = all_still;
  }
  if (rw >= 0 && kWarps > 1)
    held.load(in, rw, row_warps, extra, i, live, n);
  __syncthreads();
  if (rw < 0) return;
  const bool copy = rows_still;
  const int per_chunk = row_warps * HeldRows<T, NCAT>::kHeld;
  for (int first = rw; first < extra; first += per_chunk) {
    if (first != rw || kWarps == 1)
      held.load(in, first, row_warps, extra, i, live, n);
    if (copy) {
      held.store(out, rows, i, live, n);
      continue;
    }
    const T* slot = prm + lane;
    if (linear) {
#pragma unroll
      for (int c = 1; c < NCAT; ++c) {
        held.apply(slot, c - 1, c);
        slot += kParams * kNodes;
        held.apply(slot, c, c - 1);
        slot += kParams * kNodes;
      }
    }
#pragma unroll
    for (int c = 0; c < NCAT - 1; ++c) {
      held.apply(slot, c, c + 1);
      slot += kParams * kNodes;
    }
#pragma unroll
    for (int c = NCAT - 1; c > 0; --c) {
      held.apply(slot, c, c - 1);
      slot += kParams * kNodes;
    }
    held.store(out, rows, i, live, n);
  }
}

inline int transfers(int ncat, int linear) {
  return (linear ? 4 : 2) * (ncat - 1);
}

template <typename T>
size_t shared_bytes(int ncat, int linear) {
  return static_cast<size_t>(transfers(ncat, linear)) * kParams * kNodes *
         sizeof(T);
}

// The launch at the compile-time ncat that equals the run-time one.
template <typename T, int NCAT = 1>
int launch(int ncat, const Cats<T>& in, T* out, const T* a_init,
           const T* v_init, const double* hin_max, int rows, int n_nodes,
           int linear, cudaStream_t stream) {
  if constexpr (NCAT < kMaxCat) {
    if (ncat != NCAT)
      return launch<T, NCAT + 1>(ncat, in, out, a_init, v_init, hin_max,
                                 rows, n_nodes, linear, stream);
  }
  const unsigned int grid = (static_cast<long long>(n_nodes) + kNodes - 1) /
                            kNodes;
  itd_remap_kernel<T, NCAT><<<grid, kWarps * 32,
                              shared_bytes<T>(NCAT, linear), stream>>>(
      in, out, a_init, v_init, hin_max, rows, n_nodes, linear);
  return fesom::last_error();
}

// The instance for ncat: resident blocks an SM, registers a thread and
// local (stack) bytes a thread, into res[0..2].
template <typename T, int NCAT = 1>
void occupancy(int ncat, int linear, int* res) {
  if constexpr (NCAT < kMaxCat) {
    if (ncat != NCAT) return occupancy<T, NCAT + 1>(ncat, linear, res);
  }
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, itd_remap_kernel<T, NCAT>);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      res, itd_remap_kernel<T, NCAT>, kWarps * 32,
      shared_bytes<T>(NCAT, linear));
  cudaGetLastError();
  res[1] = attr.numRegs;
  res[2] = static_cast<int>(attr.localSizeBytes);
}

template <typename T>
int run(const void* const* cats, void* out, const void* a_init,
        const void* v_init, const double* hin_max, int ncat, int n_nodes,
        int nilyr, int nslyr, int ka, int kv, int linear,
        cudaStream_t stream) {
  if (ncat < 1 || ncat > kMaxCat || nilyr < 0 || nslyr < 0 || ka < 0 ||
      kv < 0 || n_nodes < 0 ||
      (linear && (a_init == nullptr || v_init == nullptr)))
    return cudaErrorInvalidValue;
  if (n_nodes == 0) return cudaSuccess;
  Cats<T> in;
  const int k[8] = {1, 1, 1, 1, nilyr, nslyr, ka, kv};
  for (int s = 0; s < 8; ++s) {
    in.p[s] = static_cast<const T*>(cats[s]);
    in.k[s] = k[s];
  }
  return launch<T>(ncat, in, static_cast<T*>(out),
                   static_cast<const T*>(a_init),
                   static_cast<const T*>(v_init), hin_max,
                   4 + nilyr + nslyr + ka + kv, n_nodes, linear, stream);
}

}  // namespace

// The remap (linear != 0) and the rebin of the category state: aicen,
// vicen, vsnon, Tsfcn [ncat, N], qin [ncat, nilyr, N], qsn [ncat, nslyr,
// N], ta [ncat, ka, N], tv [ncat, kv, N], each contiguous (a null pointer
// where its count is 0), into out [ncat, 4 + nilyr + nslyr + ka + kv, N];
// aicen_init, vicen_init [ncat, N] (read with linear only); hin_max
// [ncat + 1] float64 on the card.
extern "C" int fesom_itd_remap(const void* aicen, const void* vicen,
                               const void* vsnon, const void* tsfcn,
                               const void* qin, const void* qsn,
                               const void* ta, const void* tv, void* out,
                               const void* aicen_init, const void* vicen_init,
                               const void* hin_max, int ncat, int n_nodes,
                               int nilyr, int nslyr, int ka, int kv,
                               int linear, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* cats[8] = {aicen, vicen, vsnon, tsfcn, qin, qsn, ta, tv};
  const double* hb = static_cast<const double*>(hin_max);
  if (is_double)
    return run<double>(cats, out, aicen_init, vicen_init, hb, ncat, n_nodes,
                       nilyr, nslyr, ka, kv, linear, s);
  return run<float>(cats, out, aicen_init, vicen_init, hb, ncat, n_nodes,
                    nilyr, nslyr, ka, kv, linear, s);
}

// The launch fesom_itd_remap makes, into res[6]: blocks, threads a block,
// shared bytes a block, resident blocks an SM, registers and local bytes a
// thread.
extern "C" int fesom_itd_remap_plan(int ncat, int linear, int n_nodes,
                                    int is_double, int* res) {
  if (ncat < 1 || ncat > kMaxCat) return cudaErrorInvalidValue;
  res[0] = static_cast<int>((static_cast<long long>(n_nodes) + kNodes - 1) /
                            kNodes);
  res[1] = kWarps * 32;
  res[2] = static_cast<int>(is_double ? shared_bytes<double>(ncat, linear)
                                      : shared_bytes<float>(ncat, linear));
  if (is_double)
    occupancy<double>(ncat, linear, res + 3);
  else
    occupancy<float>(ncat, linear, res + 3);
  return cudaSuccess;
}
