// mevp_subcycles, evp_subcycles, aevp_subcycles: the whole pseudotime loop
// of a sea-ice EVP rheology, n subcycles, in one cooperative launch.  One
// kernel template, instantiated for each rheology (kEvp, kMevp, kAevp): the
// subcycle's structure is shared, and the rheology picks its constant rows
// and the arithmetic of its two halves.
//
// A subcycle has an element half and a node half, kept side by side here:
//
//   element: gathers u, v at the element's three vertices, forms the strain
//   rates and delta, updates s11, s12, s22 where the element has ice, and
//   forms the stress divergence the element adds to each of its vertices;
//
//   node: sums that divergence over the node's elements through the packed
//   slot table elem_slot [K, N] (word e * 3 + s, -1 padded) in the fixed
//   order k = 0..K-1 (a padded slot is never read), then the node update
//   with the elevation rhs, ocean drag, Coriolis and the coastal boundary
//   condition.
//
// The rheologies (fesom2_tpu/ice/evp.py; the plain versions in ice/evp.py):
//
//   mEVP (whichEVP = 1, mevp_dynamics' subcycle :83-131): the stresses
//   relax with alpha, the velocities with beta towards a point-implicit
//   update from the step's start u0, v0; still where a_ice < 0.01;
//
//   EVP (whichEVP = 0, evp_dynamics' subcycle :194-233): the stresses step
//   explicitly in pseudotime dte towards the viscous-plastic ones with the
//   elastic time ice_dt / 3 (zeta = strength / max(delta, delta_min));
//   the velocities explicitly from the current u, v with drag and Coriolis
//   implicit (turned by theta_io), 0 where a_ice < 0.01;
//
//   aEVP (whichEVP = 2, aevp_dynamics' subcycle :300-338): mEVP with alpha
//   a row per element (det1, det2) and beta a row per node, and no ice
//   mask in the node update.
//
// Replaces the loops of those three functions (about 45 XLA-fused jnp ops a
// subcycle, run as one on-device lax.fori_loop; its unroll factor has no
// counterpart here).  No TPU kernel: the JAX package left the EVP subcycle
// to XLA (SURVEY.md set it aside for a kernel).
//
// Bound on the card: latency.  On the polar caps of the level-7 globe
// (36,153 nodes, 70,523 elements) a subcycle's tables are a few MB and stay
// in L2; the arithmetic of 120 subcycles is about 0.84 GFLOP (25 us in
// float64 at the card's peak) and the bytes each input and output need once
// are 16 MB (5 us).  What costs is the chain of a subcycle: a gather of the
// previous subcycle's velocities from L2, the arithmetic, a write, and a
// barrier across the whole grid, 120 times over.  Two launches a subcycle
// (the first mEVP design) paid a launch and its wrapper for each of them.
//
// Design: one launch runs all n subcycles.  The grid is SMs x the fewest
// blocks an SM that give each thread at most one element, within what
// cudaOccupancyMaxActiveBlocksPerMultiprocessor says an SM keeps resident
// (a barrier costs more the more blocks cross it), so
// cudaLaunchCooperativeKernel accepts it and cooperative_groups'
// grid.sync() separates the dependent phases; a launch the card refuses
// returns its error, and the wrapper raises.  Each block owns a fixed range
// of elements and of nodes and copies their constants (elem_c and node_c
// rows, element nodes, slot words) and the elements' stresses into shared
// memory once, before the first subcycle, where the grid's share fits in a
// block's shared memory; where it does not (the whole globe in float64),
// every thread reads them from device memory, items walked grid-stride.
// A subcycle is the element phase (a thread an element; the stresses stay
// with the element's thread; the divergence goes to fuv [2, 3 E],
// element-major, so that the slot word indexes it), a grid barrier, the
// node phase (u, v written in place) and a grid barrier.  A layout with one
// barrier a subcycle, each node recomputing the stresses of its elements,
// was slower on the H100 in both dtypes (PERF.md, PR 10).
//
// Only u, v and the divergence pass between threads: they are read past L1
// (ld.global.cg) after a barrier, a node's slots eight at a time with all
// their loads in flight before the first add, the adds then in slot order.
// Every operation is written in the plain version's order (ice/evp.py:
// *_stress_plain, *_node_plain) and rounded on its own (-fmad=false, no
// fast math, no flush to zero), so that the has_ice choices and delta +
// delta_min come out as there and one launch gives the bits of n plain
// subcycles.  A node or element index out of range makes the node's
// velocity and the element's stresses NaN, unread.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// the rheologies (ice/evp.py: RHEOLOGY)
enum { kEvp = 0, kMevp = 1, kAevp = 2 };

// rows of elem_c, the first seven shared (ice/evp.py: ELEM_ROWS,
// EVP_ELEM_ROWS, AEVP_ELEM_ROWS)
enum { kDx = 0, kDy = 3, kMeancos = 6 };
// row 7: mEVP's pressure factor, EVP's strength, aEVP's p0; aEVP's det1,
// det2 follow it
enum { kC7 = 7, kDet1 = 8, kDet2 = 9 };
// rows of node_c (NODE_ROWS, AEVP_NODE_ROWS: the same but beta in place of
// the ice mask)
enum {
  kU0 = 0, kV0, kUw, kVw, kMass, kRhsA, kRhsM, kInvThick, kSx, kSy, kBc,
  kRdtCor, kHasN
};
// rows of node_c under EVP (EVP_NODE_ROWS)
enum {
  eUw = 0, eVw, eInvAreaMass, eRhsA, eRhsM, eInvMass, eSx, eSy, eBc, eCor,
  eHasN
};

// Each rheology's row counts, and where its ice area and element ice mask
// sit in elem_c.
template <int R>
struct Rows;
template <>
struct Rows<kMevp> {
  static constexpr int elem = 10, node = 13, ice_area = 8, has_e = 9;
};
template <>
struct Rows<kEvp> {
  static constexpr int elem = 10, node = 11, ice_area = 8, has_e = 9;
};
template <>
struct Rows<kAevp> {
  static constexpr int elem = 12, node = 13, ice_area = 10, has_e = 11;
};

constexpr int kBlock = 256;
constexpr int kSlotChunk = 8;  // slots a node has in flight (K <= 8: all)

template <typename T>
struct Params {
  T* uv;            // [2, N]: in, and the result
  T* sig;           // [3, E]: in, and the result
  T* fuv;           // [2, 3 E] the divergence, element-major
  const int* en;    // [3, E]
  const int* slot;  // [K, N]
  const T* elem_c;  // [Rows<R>::elem, E]
  const T* node_c;  // [Rows<R>::node, N]
  int n_nodes, n_elems, k_max, n_sub;
  int staged;       // constants in shared memory: epb, npb items a block
  int epb, npb;
  // mEVP and aEVP (det1, one_beta, beta: mEVP only)
  T det1, vale, delta_min, rdt, rdt_cd, density_0, one_beta, beta;
  // EVP
  T tevp_inv, dte, det, cd, ax, ay;
};

template <typename T>
__device__ __forceinline__ T quiet_nan() {
  return T(__longlong_as_double(0x7ff8000000000000LL));
}

// The items a thread walks: with staging, a block's own range [base, base +
// count) by threads; without, all items grid-stride.  Item base + l sits at
// l in shared memory, at base + l in device memory.
struct Walk {
  int base, count, start, step;
};

__device__ __forceinline__ Walk walk(int staged, int per_block, int total) {
  Walk w;
  if (staged) {
    w.base = blockIdx.x * per_block;
    w.count = max(0, min(per_block, total - w.base));
    w.start = threadIdx.x;
    w.step = blockDim.x;
  } else {
    w.base = 0;
    w.count = total;
    w.start = blockIdx.x * blockDim.x + threadIdx.x;
    w.step = gridDim.x * blockDim.x;
  }
  return w;
}

// The element half's stress update, in the plain version's order
// (ice/evp.py: mevp_stress_plain, evp_stress_plain, aevp_stress_plain);
// c7 is the element's row 7 (mEVP's pressure factor, EVP's strength,
// aEVP's p0), ec points at its constants (row r at ec[r * es]: aEVP's
// det1, det2).
template <int R, typename T>
__device__ __forceinline__ void stress_update(const Params<T>& p,
                                              const T ue[3], const T ve[3],
                                              const T dx[3], const T dy[3],
                                              T meancos, T c7, const T* ec,
                                              long long es, bool has_ice,
                                              T& s11, T& s12, T& s22) {
  const T vale = p.vale;
  T eps11 = ((dx[0] * ue[0] + dx[1] * ue[1]) + dx[2] * ue[2]) -
            ((ve[0] + ve[1]) + ve[2]) * meancos;
  T eps22 = (dy[0] * ve[0] + dy[1] * ve[1]) + dy[2] * ve[2];
  T eps12 = T(0.5) * ((((dy[0] * ue[0] + dy[1] * ue[1]) + dy[2] * ue[2]) +
                       ((dx[0] * ve[0] + dx[1] * ve[1]) + dx[2] * ve[2])) +
                      ((ue[0] + ue[1]) + ue[2]) * meancos);
  T eps1 = eps11 + eps22;
  T eps2 = eps11 - eps22;
  T delta = sqrt(eps1 * eps1 +
                 vale * (eps2 * eps2 + T(4.0) * (eps12 * eps12)));
  if constexpr (R == kMevp) {
    T pressure = c7 / (delta + p.delta_min);
    if (has_ice) {
      T half_p = T(0.5) * pressure;
      T s12n = p.det1 * s12 + (pressure * eps12) * vale;
      T s11n = p.det1 * s11 + half_p * ((eps1 - delta) + eps2 * vale);
      T s22n = p.det1 * s22 + half_p * ((eps1 - delta) - eps2 * vale);
      s11 = s11n;
      s12 = s12n;
      s22 = s22n;
    }
  } else if constexpr (R == kEvp) {
    const T strength = c7;
    // torch.clamp_min(delta, delta_min): a NaN delta stays NaN
    const T dm = delta < p.delta_min ? p.delta_min : delta;
    T zeta = (strength / dm) * p.tevp_inv;
    T r1 = zeta * eps1 - strength * p.tevp_inv;
    T r2 = (zeta * eps2) * vale;
    T r3 = (zeta * eps12) * vale;
    T si1 = p.det * ((s11 + s22) + p.dte * r1);
    T si2 = p.det * ((s11 - s22) + p.dte * r2);
    if (has_ice) {
      s12 = p.det * (s12 + p.dte * r3);
      s11 = T(0.5) * (si1 + si2);
      s22 = T(0.5) * (si1 - si2);
    }
  } else {
    T pressure = c7 / (delta + p.delta_min);
    T r1 = pressure * (eps1 - delta);
    T r2 = (pressure * eps2) * vale;
    T r3 = (pressure * eps12) * vale;
    const T det1 = ec[kDet1 * es], det2 = ec[kDet2 * es];
    T si1 = det1 * (s11 + s22) + det2 * r1;
    T si2 = det1 * (s11 - s22) + det2 * r2;
    if (has_ice) {
      s12 = det1 * s12 + det2 * r3;
      s11 = T(0.5) * (si1 + si2);
      s22 = T(0.5) * (si1 - si2);
    }
  }
}

// The divergence an element adds to its vertex j (dxj, dyj its gradients).
template <typename T>
__device__ __forceinline__ T share_u(T neg_area, T s11, T s12, T dxj, T dyj,
                                     T meancos) {
  return neg_area * (s11 * dxj + s12 * (dyj + meancos));
}
template <typename T>
__device__ __forceinline__ T share_v(T neg_area, T s11, T s12, T s22, T dxj,
                                     T dyj, T meancos) {
  return neg_area * ((s12 * dxj + s22 * dyj) - s11 * meancos);
}

// The node half's update, in the plain version's order (ice/evp.py:
// mevp_node_plain, evp_node_plain, aevp_node_plain): node constants at
// nc[row * ns], (fu, fv) the summed divergence, (u, v) the node's velocity.
template <int R, typename T>
__device__ __forceinline__ void node_update(const Params<T>& p, const T* nc,
                                            long long ns, T fu, T fv, T u,
                                            T v, bool bad, T& u_out,
                                            T& v_out) {
  if constexpr (R == kEvp) {
    T u_w = nc[eUw * ns], v_w = nc[eVw * ns];
    T iam = nc[eInvAreaMass * ns];
    T inv_mass = nc[eInvMass * ns];
    T bc = nc[eBc * ns];
    bool has_ice = nc[eHasN * ns] > T(0);
    T u_rhs = fu * iam + nc[eRhsA * ns];
    T v_rhs = fv * iam + nc[eRhsM * ns];
    T du = u - u_w, dv = v - v_w;
    T umod = sqrt(du * du + dv * dv);
    T drag = ((p.cd * umod) * p.density_0) * inv_mass;
    T rhsu = u + p.dte * ((drag * (p.ax * u_w - p.ay * v_w) +
                           inv_mass * nc[eSx * ns]) + u_rhs);
    T rhsv = v + p.dte * ((drag * (p.ax * v_w + p.ay * u_w) +
                           inv_mass * nc[eSy * ns]) + v_rhs);
    T r_a = T(1.0) + (p.ax * drag) * p.dte;
    T r_b = p.dte * (nc[eCor * ns] + p.ay * drag);
    T idet = bc / (r_a * r_a + r_b * r_b);
    T u_new = has_ice ? idet * (r_a * rhsu + r_b * rhsv) : T(0);
    T v_new = has_ice ? idet * (r_a * rhsv - r_b * rhsu) : T(0);
    if (bad) u_new = v_new = quiet_nan<T>();
    u_out = u_new;
    v_out = v_new;
  } else {
    T u0 = nc[kU0 * ns], v0 = nc[kV0 * ns];
    T u_w = nc[kUw * ns], v_w = nc[kVw * ns];
    T mass = nc[kMass * ns];
    T inv_thick = nc[kInvThick * ns];
    T bc = nc[kBc * ns];
    T rc = nc[kRdtCor * ns];
    // mEVP's ice mask and number beta, aEVP's beta row (the same row)
    const T row12 = nc[kHasN * ns];
    const bool has_ice = R == kMevp ? row12 > T(0) : true;
    const T beta = R == kMevp ? p.beta : row12;

    T u_rhs = fu * mass + nc[kRhsA * ns];
    T v_rhs = fv * mass + nc[kRhsM * ns];
    T du = u - u_w, dv = v - v_w;
    T umod = sqrt(du * du + dv * dv);
    T drag = ((p.rdt_cd * umod) * p.density_0) * inv_thick;
    T rhsu = ((u0 + drag * u_w) +
              p.rdt * (inv_thick * nc[kSx * ns] + u_rhs)) +
             beta * u;
    T rhsv = ((v0 + drag * v_w) +
              p.rdt * (inv_thick * nc[kSy * ns] + v_rhs)) +
             beta * v;
    T a = (R == kMevp ? p.one_beta : T(1.0) + beta) + drag;
    T det = bc / (a * a + rc * rc);
    T u_new = det * (a * rhsu + rc * rhsv);
    T v_new = det * (a * rhsv - rc * rhsu);
    if (!has_ice) {
      u_new = u;
      v_new = v;
    }
    if (bad) u_new = v_new = quiet_nan<T>();
    if constexpr (R == kMevp) {
      u_out = u_new * bc;
      v_out = v_new * bc;
    } else {
      u_out = u_new;
      v_out = v_new;
    }
  }
}

// Shared memory of a staged block: elem_c rows and the stresses of its epb
// elements, node_c rows of its npb nodes, then the element nodes and the
// slot words.
template <int R, typename T>
size_t staged_bytes(int epb, int npb, int k) {
  return (static_cast<size_t>(epb) * (Rows<R>::elem + 3) +
          static_cast<size_t>(npb) * Rows<R>::node) * sizeof(T) +
         (static_cast<size_t>(epb) * 3 + static_cast<size_t>(npb) * k) *
             sizeof(int);
}

// The kernel's body for rheology R; each rheology has a __global__ of its
// own name below (mevp_subcycles_kernel, evp_subcycles_kernel,
// aevp_subcycles_kernel), so that a profile tells them apart.
template <int R, typename T>
__device__ __forceinline__ void subcycles_body(const Params<T>& p) {
  constexpr int kElemRows = Rows<R>::elem, kNodeRows = Rows<R>::node;
  constexpr int kIceArea = Rows<R>::ice_area, kHasE = Rows<R>::has_e;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int N = p.n_nodes, E = p.n_elems, K = p.k_max;
  const long long E3 = 3LL * E;
  const Walk we = walk(p.staged, p.epb, E), wn = walk(p.staged, p.npb, N);
  const T* ec = p.elem_c;
  const T* nc = p.node_c;
  const int* ei = p.en;
  const int* sl = p.slot;
  T* sg = p.sig;
  long long es = E, ns = N;
  if (p.staged) {
    T* t = reinterpret_cast<T*>(smem);
    T* ec_s = t;
    T* sg_s = ec_s + static_cast<long long>(kElemRows) * p.epb;
    T* nc_s = sg_s + 3LL * p.epb;
    int* ei_s = reinterpret_cast<int*>(nc_s + static_cast<long long>(kNodeRows) * p.npb);
    int* sl_s = ei_s + 3LL * p.epb;
    for (int l = we.start; l < we.count; l += we.step) {
      const int e = we.base + l;
      for (int r = 0; r < kElemRows; ++r)
        ec_s[r * p.epb + l] = p.elem_c[r * static_cast<long long>(E) + e];
      for (int j = 0; j < 3; ++j) {
        ei_s[j * p.epb + l] = p.en[j * static_cast<long long>(E) + e];
        sg_s[j * p.epb + l] = p.sig[j * static_cast<long long>(E) + e];
      }
    }
    for (int l = wn.start; l < wn.count; l += wn.step) {
      const int n = wn.base + l;
      for (int r = 0; r < kNodeRows; ++r)
        nc_s[r * p.npb + l] = p.node_c[r * static_cast<long long>(N) + n];
      for (int k = 0; k < K; ++k)
        sl_s[k * p.npb + l] = p.slot[k * static_cast<long long>(N) + n];
    }
    ec = ec_s;
    nc = nc_s;
    ei = ei_s;
    sl = sl_s;
    sg = sg_s;
    es = p.epb;
    ns = p.npb;
  }
  T* const fu_buf = p.fuv;
  T* const fv_buf = p.fuv + E3;
  const T nan = quiet_nan<T>();
  for (int it = 0; it < p.n_sub; ++it) {
    for (int l = we.start; l < we.count; l += we.step) {
      const int e = we.base + l;
      const long long i = p.staged ? l : e;
      T ue[3], ve[3], dx[3], dy[3];
      bool bad = false;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        int n = ei[j * es + i];
        if (n < 0 || n >= N) {
          bad = true;
          n = 0;
        }
        ue[j] = __ldcg(p.uv + n);
        ve[j] = __ldcg(p.uv + N + n);
        dx[j] = ec[(kDx + j) * es + i];
        dy[j] = ec[(kDy + j) * es + i];
      }
      const T meancos = ec[kMeancos * es + i];
      T s11 = sg[i], s12 = sg[es + i], s22 = sg[2 * es + i];
      stress_update<R>(p, ue, ve, dx, dy, meancos, ec[kC7 * es + i], ec + i,
                       es, ec[kHasE * es + i] > T(0), s11, s12, s22);
      if (bad) s11 = s12 = s22 = nan;
      sg[i] = s11;
      sg[es + i] = s12;
      sg[2 * es + i] = s22;
      const T neg_area = -ec[kIceArea * es + i];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        fu_buf[3LL * e + j] = share_u(neg_area, s11, s12, dx[j], dy[j],
                                      meancos);
        fv_buf[3LL * e + j] = share_v(neg_area, s11, s12, s22, dx[j], dy[j],
                                      meancos);
      }
    }
    grid.sync();
    for (int l = wn.start; l < wn.count; l += wn.step) {
      const int n = wn.base + l;
      const long long i = p.staged ? l : n;
      T fu = T(0), fv = T(0);
      bool bad = false;
      for (int k0 = 0; k0 < K; k0 += kSlotChunk) {
        // the chunk's slot words, then all its gathers, then the adds
        int w[kSlotChunk];
        T a[kSlotChunk], b[kSlotChunk];
#pragma unroll
        for (int j = 0; j < kSlotChunk; ++j) {
          w[j] = k0 + j < K ? sl[(k0 + j) * ns + i] : -1;
          bad |= w[j] >= E3;
          const bool ok = w[j] >= 0 && w[j] < E3;
          a[j] = ok ? __ldcg(fu_buf + w[j]) : T(0);
          b[j] = ok ? __ldcg(fv_buf + w[j]) : T(0);
        }
#pragma unroll
        for (int j = 0; j < kSlotChunk; ++j) {
          if (w[j] >= 0 && w[j] < E3) {
            fu += a[j];
            fv += b[j];
          }
        }
      }
      node_update<R>(p, nc + i, ns, fu, fv, __ldcg(p.uv + n),
                     __ldcg(p.uv + N + n), bad, p.uv[n], p.uv[N + n]);
    }
    if (it + 1 < p.n_sub) grid.sync();
  }
  if (p.staged) {
    for (int l = we.start; l < we.count; l += we.step) {
      const int e = we.base + l;
      for (int j = 0; j < 3; ++j)
        p.sig[j * static_cast<long long>(E) + e] = sg[j * es + l];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
    mevp_subcycles_kernel(Params<T> p) {
  subcycles_body<kMevp>(p);
}
template <typename T>
__global__ void __launch_bounds__(kBlock) evp_subcycles_kernel(Params<T> p) {
  subcycles_body<kEvp>(p);
}
template <typename T>
__global__ void __launch_bounds__(kBlock)
    aevp_subcycles_kernel(Params<T> p) {
  subcycles_body<kAevp>(p);
}

// The __global__ of rheology R.
template <int R, typename T>
auto kernel_of() -> void (*)(Params<T>) {
  if constexpr (R == kMevp)
    return mevp_subcycles_kernel<T>;
  else if constexpr (R == kEvp)
    return evp_subcycles_kernel<T>;
  else
    return aevp_subcycles_kernel<T>;
}

// ---- launch plan ----------------------------------------------------------
struct Plan {
  int grid, staged, epb, npb;
  size_t smem;
};

// The launch: SMs x bps blocks, bps the fewest that give each thread at
// most one element (or all an SM keeps resident), every block resident.  The
// constants are staged where the grid's share of the items fits a block's
// shared memory at bps, else at the next counts up, then down; unstaged
// (read from device memory, grid-stride) where none fits.
template <int R, typename T>
cudaError_t make_plan(int n_nodes, int n_elems, int k_max, Plan* plan) {
  auto kernel = kernel_of<R, T>();
  int dev = 0, sms = 0, optin = 0, occ0 = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ0, kernel, kBlock,
                                                        0);
  if (err != cudaSuccess) return err;
  if (occ0 < 1) return cudaErrorCooperativeLaunchTooLarge;
  // the fewest blocks an SM that give each thread at most one item (the
  // fewer blocks, the cheaper a barrier), then more, then fewer
  const long long items = n_nodes >= n_elems ? n_nodes : n_elems;
  const long long wave = 1LL * sms * kBlock;
  const long long need = items > wave ? (items + wave - 1) / wave : 1;
  const int want = need < occ0 ? static_cast<int>(need) : occ0;
  for (int c = 0; c < occ0; ++c) {
    const int bps = want + c <= occ0 ? want + c : occ0 - c;
    const int grid = sms * bps;
    const int epb = (n_elems + grid - 1) / grid;
    const int npb = (n_nodes + grid - 1) / grid;
    const size_t bytes = staged_bytes<R, T>(epb, npb, k_max);
    if (bytes > static_cast<size_t>(optin)) continue;
    if (fesom::allow_shared(kernel, bytes) != cudaSuccess) continue;
    int occ = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kBlock,
                                                      bytes) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    if (occ >= bps) {
      *plan = Plan{grid, 1, epb, npb, bytes};
      return cudaSuccess;
    }
  }
  *plan = Plan{sms * want, 0, 0, 0, 0};
  return cudaSuccess;
}

template <int R>
cudaError_t plan_of(int n_nodes, int n_elems, int k_max, int is_double,
                    Plan* plan) {
  return is_double ? make_plan<R, double>(n_nodes, n_elems, k_max, plan)
                   : make_plan<R, float>(n_nodes, n_elems, k_max, plan);
}

cudaError_t plan_for(int rheology, int n_nodes, int n_elems, int k_max,
                     int is_double, Plan* plan) {
  switch (rheology) {
    case kEvp:
      return plan_of<kEvp>(n_nodes, n_elems, k_max, is_double, plan);
    case kMevp:
      return plan_of<kMevp>(n_nodes, n_elems, k_max, is_double, plan);
    case kAevp:
      return plan_of<kAevp>(n_nodes, n_elems, k_max, is_double, plan);
  }
  return cudaErrorInvalidValue;
}

// One launch of the rheology's kernel on p (pointers, sizes and scalars
// set; the plan fills the rest).
template <int R, typename T>
int run(Params<T> p, cudaStream_t stream) {
  if (p.n_sub == 0 || p.n_nodes == 0) return cudaSuccess;
  Plan plan;
  cudaError_t err = make_plan<R, T>(p.n_nodes, p.n_elems, p.k_max, &plan);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  p.staged = plan.staged;
  p.epb = plan.epb;
  p.npb = plan.npb;
  void* args[] = {&p};
  auto kernel = kernel_of<R, T>();
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(plan.grid), dim3(kBlock), args,
                                    plan.smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return fesom::last_error();
}

// Params with the pointers and sizes every rheology takes, scalars zero.
template <typename T>
Params<T> params(void* uv, void* sig, void* fuv, const void* en,
                 const void* slot, const void* elem_c, const void* node_c,
                 int n_nodes, int n_elems, int k_max, int n_sub) {
  Params<T> p{};
  p.uv = static_cast<T*>(uv);
  p.sig = static_cast<T*>(sig);
  p.fuv = static_cast<T*>(fuv);
  p.en = static_cast<const int*>(en);
  p.slot = static_cast<const int*>(slot);
  p.elem_c = static_cast<const T*>(elem_c);
  p.node_c = static_cast<const T*>(node_c);
  p.n_nodes = n_nodes;
  p.n_elems = n_elems;
  p.k_max = k_max;
  p.n_sub = n_sub;
  return p;
}

template <typename T>
int run_mevp(void* uv, void* sig, void* fuv, const void* en,
             const void* slot, const void* elem_c, const void* node_c,
             int n_nodes, int n_elems, int k_max, int n_sub, double det1,
             double vale, double delta_min, double rdt, double rdt_cd,
             double density_0, double beta, cudaStream_t stream) {
  Params<T> p = params<T>(uv, sig, fuv, en, slot, elem_c, node_c, n_nodes,
                          n_elems, k_max, n_sub);
  p.det1 = static_cast<T>(det1);
  p.vale = static_cast<T>(vale);
  p.delta_min = static_cast<T>(delta_min);
  p.rdt = static_cast<T>(rdt);
  p.rdt_cd = static_cast<T>(rdt_cd);
  p.density_0 = static_cast<T>(density_0);
  p.one_beta = static_cast<T>(1.0 + beta);
  p.beta = static_cast<T>(beta);
  return run<kMevp, T>(p, stream);
}

template <typename T>
int run_evp(void* uv, void* sig, void* fuv, const void* en,
            const void* slot, const void* elem_c, const void* node_c,
            int n_nodes, int n_elems, int k_max, int n_sub, double vale,
            double delta_min, double tevp_inv, double dte, double det,
            double cd, double density_0, double ax, double ay,
            cudaStream_t stream) {
  Params<T> p = params<T>(uv, sig, fuv, en, slot, elem_c, node_c, n_nodes,
                          n_elems, k_max, n_sub);
  p.vale = static_cast<T>(vale);
  p.delta_min = static_cast<T>(delta_min);
  p.tevp_inv = static_cast<T>(tevp_inv);
  p.dte = static_cast<T>(dte);
  p.det = static_cast<T>(det);
  p.cd = static_cast<T>(cd);
  p.density_0 = static_cast<T>(density_0);
  p.ax = static_cast<T>(ax);
  p.ay = static_cast<T>(ay);
  return run<kEvp, T>(p, stream);
}

template <typename T>
int run_aevp(void* uv, void* sig, void* fuv, const void* en,
             const void* slot, const void* elem_c, const void* node_c,
             int n_nodes, int n_elems, int k_max, int n_sub, double vale,
             double delta_min, double rdt, double rdt_cd, double density_0,
             cudaStream_t stream) {
  Params<T> p = params<T>(uv, sig, fuv, en, slot, elem_c, node_c, n_nodes,
                          n_elems, k_max, n_sub);
  p.vale = static_cast<T>(vale);
  p.delta_min = static_cast<T>(delta_min);
  p.rdt = static_cast<T>(rdt);
  p.rdt_cd = static_cast<T>(rdt_cd);
  p.density_0 = static_cast<T>(density_0);
  return run<kAevp, T>(p, stream);
}

// The latency floor: an empty cooperative kernel that only crosses
// n_barriers grid barriers.
__global__ void __launch_bounds__(kBlock) barrier_kernel(int n_barriers) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n_barriers; ++i) grid.sync();
}

}  // namespace

// n_sub mEVP subcycles.  uv [2, N] and sig [3, E] updated in place; fuv
// [2, 3 E] scratch; en [3, E] i32; elem_slot [K, N] i32; elem_c [10, E];
// node_c [13, N].
extern "C" int fesom_mevp_subcycles(void* uv, void* sig, void* fuv,
                                    const void* en, const void* elem_slot,
                                    const void* elem_c, const void* node_c,
                                    int n_nodes, int n_elems, int k_max,
                                    int n_sub, double det1, double vale,
                                    double delta_min, double rdt,
                                    double rdt_cd, double density_0,
                                    double beta, int is_double,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return run_mevp<double>(uv, sig, fuv, en, elem_slot, elem_c, node_c,
                            n_nodes, n_elems, k_max, n_sub, det1, vale,
                            delta_min, rdt, rdt_cd, density_0, beta, s);
  return run_mevp<float>(uv, sig, fuv, en, elem_slot, elem_c, node_c,
                         n_nodes, n_elems, k_max, n_sub, det1, vale,
                         delta_min, rdt, rdt_cd, density_0, beta, s);
}

// n_sub standard-EVP subcycles: as fesom_mevp_subcycles, with elem_c
// [10, E] and node_c [11, N] of ice/evp.py: evp_setup.
extern "C" int fesom_evp_subcycles(void* uv, void* sig, void* fuv,
                                   const void* en, const void* elem_slot,
                                   const void* elem_c, const void* node_c,
                                   int n_nodes, int n_elems, int k_max,
                                   int n_sub, double vale, double delta_min,
                                   double tevp_inv, double dte, double det,
                                   double cd, double density_0, double ax,
                                   double ay, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return run_evp<double>(uv, sig, fuv, en, elem_slot, elem_c, node_c,
                           n_nodes, n_elems, k_max, n_sub, vale, delta_min,
                           tevp_inv, dte, det, cd, density_0, ax, ay, s);
  return run_evp<float>(uv, sig, fuv, en, elem_slot, elem_c, node_c,
                        n_nodes, n_elems, k_max, n_sub, vale, delta_min,
                        tevp_inv, dte, det, cd, density_0, ax, ay, s);
}

// n_sub adaptive-EVP subcycles: as fesom_mevp_subcycles, with elem_c
// [12, E] and node_c [13, N] of ice/evp.py: aevp_setup.
extern "C" int fesom_aevp_subcycles(void* uv, void* sig, void* fuv,
                                    const void* en, const void* elem_slot,
                                    const void* elem_c, const void* node_c,
                                    int n_nodes, int n_elems, int k_max,
                                    int n_sub, double vale, double delta_min,
                                    double rdt, double rdt_cd,
                                    double density_0, int is_double,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return run_aevp<double>(uv, sig, fuv, en, elem_slot, elem_c, node_c,
                            n_nodes, n_elems, k_max, n_sub, vale, delta_min,
                            rdt, rdt_cd, density_0, s);
  return run_aevp<float>(uv, sig, fuv, en, elem_slot, elem_c, node_c,
                         n_nodes, n_elems, k_max, n_sub, vale, delta_min,
                         rdt, rdt_cd, density_0, s);
}

// The launch the rheology's kernel would make: out[0..3] = grid, block,
// shared bytes a block, 1 if the constants are staged (out: host int32 [4]).
extern "C" int fesom_subcycles_plan(int rheology, int n_nodes, int n_elems,
                                    int k_max, int is_double, void* out) {
  Plan plan;
  cudaError_t err = plan_for(rheology, n_nodes, n_elems, k_max, is_double,
                             &plan);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  int* o = static_cast<int*>(out);
  o[0] = plan.grid;
  o[1] = kBlock;
  o[2] = static_cast<int>(plan.smem);
  o[3] = plan.staged;
  return cudaSuccess;
}

// An empty cooperative kernel on the rheology's grid for these sizes,
// crossing n_barriers grid barriers: the floor the barriers set.
extern "C" int fesom_subcycles_barrier_floor(int rheology, int n_nodes,
                                             int n_elems, int k_max,
                                             int n_barriers, int is_double,
                                             void* stream) {
  Plan plan;
  cudaError_t err = plan_for(rheology, n_nodes, n_elems, k_max, is_double,
                             &plan);
  if (err == cudaSuccess) {
    void* args[] = {&n_barriers};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(barrier_kernel), dim3(plan.grid),
        dim3(kBlock), args, 0, static_cast<cudaStream_t>(stream));
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return fesom::last_error();
}
