// mevp_subcycles: the whole pseudotime loop of the mEVP sea-ice rheology,
// n subcycles, in one cooperative launch.
//
// A subcycle has an element half and a node half, kept side by side here:
//
//   element: gathers u, v at the element's three vertices, forms the strain
//   rates and delta, updates s11, s12, s22 where the element has ice, and
//   forms the stress divergence the element adds to each of its vertices;
//
//   node: sums that divergence over the node's elements through the packed
//   slot table elem_slot [K, N] (word e * 3 + s, -1 padded) in the fixed
//   order k = 0..K-1 (a padded slot is never read), then the point-implicit
//   update with mass, the elevation rhs, ocean drag, Coriolis, the ice mask
//   and the coastal boundary condition.
//
// Replaces the loop fesom2_tpu/ice/evp.py:83-131 (mevp_dynamics' subcycle,
// about 45 XLA-fused jnp ops, run as one on-device lax.fori_loop; its
// unroll factor has no counterpart here).
//
// Bound on the card: latency.  On the polar caps of the level-7 globe
// (36,153 nodes, 70,523 elements) a subcycle's tables are a few MB and stay
// in L2; the arithmetic of 120 subcycles is about 0.84 GFLOP (25 us in
// float64 at the card's peak) and the bytes each input and output need once
// are 16 MB (5 us).  What costs is the chain of a subcycle: a gather of the
// previous subcycle's velocities from L2, the arithmetic, a write, and a
// barrier across the whole grid, 120 times over.  Two launches a subcycle
// (the first design) paid a launch and its wrapper for each of them.
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
// mevp_stress_plain, mevp_node_plain) and rounded on its own (-fmad=false,
// no fast math, no flush to zero), so that the has_ice choices and delta +
// delta_min come out as there and one launch gives the bits of n plain
// subcycles.  A node or element index out of range makes the node's
// velocity and the element's stresses NaN, unread.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// rows of elem_c and node_c (ice/evp.py: ELEM_ROWS, NODE_ROWS)
enum { kDx = 0, kDy = 3, kMeancos = 6, kPfac = 7, kIceArea = 8, kHasE = 9,
       kElemRows = 10 };
enum {
  kU0 = 0, kV0, kUw, kVw, kMass, kRhsA, kRhsM, kInvThick, kSx, kSy, kBc,
  kRdtCor, kHasN, kNodeRows
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
  const T* elem_c;  // [10, E]
  const T* node_c;  // [13, N]
  int n_nodes, n_elems, k_max, n_sub;
  int staged;       // constants in shared memory: epb, npb items a block
  int epb, npb;
  T det1, vale, delta_min, rdt, rdt_cd, density_0, one_beta, beta;
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

// The element half's stress update, in mevp_stress_plain's order.
template <typename T>
__device__ __forceinline__ void stress_update(const Params<T>& p,
                                              const T ue[3], const T ve[3],
                                              const T dx[3], const T dy[3],
                                              T meancos, T pfac, bool has_ice,
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
  T pressure = pfac / (delta + p.delta_min);
  if (has_ice) {
    T half_p = T(0.5) * pressure;
    T s12n = p.det1 * s12 + (pressure * eps12) * vale;
    T s11n = p.det1 * s11 + half_p * ((eps1 - delta) + eps2 * vale);
    T s22n = p.det1 * s22 + half_p * ((eps1 - delta) - eps2 * vale);
    s11 = s11n;
    s12 = s12n;
    s22 = s22n;
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

// The node half's update, in mevp_node_plain's order: node constants at
// nc[row * ns], (fu, fv) the summed divergence, (u, v) the node's velocity.
template <typename T>
__device__ __forceinline__ void node_update(const Params<T>& p, const T* nc,
                                            long long ns, T fu, T fv, T u,
                                            T v, bool bad, T& u_out,
                                            T& v_out) {
  T u0 = nc[kU0 * ns], v0 = nc[kV0 * ns];
  T u_w = nc[kUw * ns], v_w = nc[kVw * ns];
  T mass = nc[kMass * ns];
  T inv_thick = nc[kInvThick * ns];
  T bc = nc[kBc * ns];
  T rc = nc[kRdtCor * ns];
  bool has_ice = nc[kHasN * ns] > T(0);

  T u_rhs = fu * mass + nc[kRhsA * ns];
  T v_rhs = fv * mass + nc[kRhsM * ns];
  T du = u - u_w, dv = v - v_w;
  T umod = sqrt(du * du + dv * dv);
  T drag = ((p.rdt_cd * umod) * p.density_0) * inv_thick;
  T rhsu = ((u0 + drag * u_w) + p.rdt * (inv_thick * nc[kSx * ns] + u_rhs)) +
           p.beta * u;
  T rhsv = ((v0 + drag * v_w) + p.rdt * (inv_thick * nc[kSy * ns] + v_rhs)) +
           p.beta * v;
  T a = p.one_beta + drag;
  T det = bc / (a * a + rc * rc);
  T u_new = det * (a * rhsu + rc * rhsv);
  T v_new = det * (a * rhsv - rc * rhsu);
  if (!has_ice) {
    u_new = u;
    v_new = v;
  }
  if (bad) u_new = v_new = quiet_nan<T>();
  u_out = u_new * bc;
  v_out = v_new * bc;
}

// Shared memory of a staged block: elem_c rows and the stresses of its epb
// elements, node_c rows of its npb nodes, then the element nodes and the
// slot words.
template <typename T>
size_t staged_bytes(int epb, int npb, int k) {
  return (static_cast<size_t>(epb) * (kElemRows + 3) +
          static_cast<size_t>(npb) * kNodeRows) * sizeof(T) +
         (static_cast<size_t>(epb) * 3 + static_cast<size_t>(npb) * k) *
             sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
    mevp_subcycles_kernel(Params<T> p) {
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
      stress_update(p, ue, ve, dx, dy, meancos, ec[kPfac * es + i],
                    ec[kHasE * es + i] > T(0), s11, s12, s22);
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
      node_update(p, nc + i, ns, fu, fv, __ldcg(p.uv + n),
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
template <typename T>
cudaError_t make_plan(int n_nodes, int n_elems, int k_max, Plan* plan) {
  auto kernel = mevp_subcycles_kernel<T>;
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
    const size_t bytes = staged_bytes<T>(epb, npb, k_max);
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

template <typename T>
int run(void* uv, void* sig, void* fuv, const void* en, const void* slot,
        const void* elem_c, const void* node_c, int n_nodes, int n_elems,
        int k_max, int n_sub, double det1, double vale, double delta_min,
        double rdt, double rdt_cd, double density_0, double beta,
        cudaStream_t stream) {
  if (n_sub == 0 || n_nodes == 0) return cudaSuccess;
  Plan plan;
  cudaError_t err = make_plan<T>(n_nodes, n_elems, k_max, &plan);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  Params<T> p{static_cast<T*>(uv), static_cast<T*>(sig),
              static_cast<T*>(fuv), static_cast<const int*>(en),
              static_cast<const int*>(slot), static_cast<const T*>(elem_c),
              static_cast<const T*>(node_c), n_nodes, n_elems, k_max, n_sub,
              plan.staged, plan.epb, plan.npb, static_cast<T>(det1),
              static_cast<T>(vale), static_cast<T>(delta_min),
              static_cast<T>(rdt), static_cast<T>(rdt_cd),
              static_cast<T>(density_0), static_cast<T>(1.0 + beta),
              static_cast<T>(beta)};
  void* args[] = {&p};
  auto kernel = mevp_subcycles_kernel<T>;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(plan.grid), dim3(kBlock), args,
                                    plan.smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return fesom::last_error();
}

// The latency floor: an empty cooperative kernel that only crosses
// n_barriers grid barriers.
__global__ void __launch_bounds__(kBlock) barrier_kernel(int n_barriers) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n_barriers; ++i) grid.sync();
}

}  // namespace

// n_sub subcycles.  uv [2, N] and sig [3, E] updated in place; fuv
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
    return run<double>(uv, sig, fuv, en, elem_slot, elem_c, node_c, n_nodes,
                       n_elems, k_max, n_sub, det1, vale, delta_min, rdt,
                       rdt_cd, density_0, beta, s);
  return run<float>(uv, sig, fuv, en, elem_slot, elem_c, node_c, n_nodes,
                    n_elems, k_max, n_sub, det1, vale, delta_min, rdt, rdt_cd,
                    density_0, beta, s);
}

// The launch mevp_subcycles would make: out[0..3] = grid, block, shared
// bytes a block, 1 if the constants are staged (out: host int32 [4]).
extern "C" int fesom_mevp_subcycles_plan(int n_nodes, int n_elems, int k_max,
                                         int is_double, void* out) {
  Plan plan;
  cudaError_t err = is_double
                        ? make_plan<double>(n_nodes, n_elems, k_max, &plan)
                        : make_plan<float>(n_nodes, n_elems, k_max, &plan);
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

// An empty cooperative kernel on mevp_subcycles' grid for these sizes,
// crossing n_barriers grid barriers: the floor the barriers set.
extern "C" int fesom_mevp_barrier_floor(int n_nodes, int n_elems, int k_max,
                                        int n_barriers, int is_double,
                                        void* stream) {
  Plan plan;
  cudaError_t err = is_double
                        ? make_plan<double>(n_nodes, n_elems, k_max, &plan)
                        : make_plan<float>(n_nodes, n_elems, k_max, &plan);
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
