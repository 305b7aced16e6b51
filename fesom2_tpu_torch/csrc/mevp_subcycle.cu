// mevp_subcycle: one pseudotime iteration of the mEVP sea-ice rheology in
// two kernels.
//
//   mevp_stress, a thread per element: gathers u, v at the element's three
//   vertices, forms the strain rates and delta, updates s11, s12, s22 in
//   place where the element has ice, and writes the stress divergence the
//   element adds to each of its vertices, fuv [2, 3, E] (vertex-major).
//
//   mevp_node, a thread per node: sums fuv over the node's elements through
//   nod_in_elem and nod_in_elem_slot [N, K] in the fixed order k = 0..K-1
//   (a padded slot, -1, is never read), then the point-implicit update with
//   mass, the elevation rhs, ocean drag, Coriolis, the ice mask and the
//   coastal boundary condition, and writes u, v of its own node in place.
//
// Replaces the loop body of fesom2_tpu/ice/evp.py:83-127 (mevp_dynamics'
// subcycle, about 45 XLA-fused jnp ops under lax.fori_loop; its unroll
// factor has no counterpart here).  The element kernel reads only the
// velocities the node kernel of the previous subcycle wrote, and the node
// kernel writes only its own node, so neither needs a second buffer.
//
// Bound on the card: launch latency.  On the polar caps of a global mesh
// the tables of a subcycle are a few MB and stay in L2, and the 240
// launches of a step cost about their latency each; the bytes
// (ice/evp.py:mevp_subcycle_work) would take about a microsecond.  Design:
// the simplest that is right, one thread per item, tables row-major
// [rows, items] so that neighbouring threads read neighbouring words.
// Every operation is written in the plain version's order
// (ice/evp.py:mevp_stress_plain, mevp_node_plain) and rounded on its own
// (-fmad=false, no fast math, no flush to zero), so that the has_ice
// choices and delta + delta_min come out as there.
#include "common.cuh"

namespace {

// rows of elem_c and node_c (ice/evp.py: ELEM_ROWS, NODE_ROWS)
enum { kDx = 0, kDy = 3, kMeancos = 6, kPfac = 7, kIceArea = 8, kHasE = 9 };
enum {
  kU0 = 0, kV0, kUw, kVw, kMass, kRhsA, kRhsM, kInvThick, kSx, kSy, kBc,
  kRdtCor, kHasN
};

template <typename T>
__global__ void mevp_stress_kernel(const T* __restrict__ uv, int n_nodes,
                                   const int* __restrict__ en, int n_elems,
                                   const T* __restrict__ elem_c,
                                   T* __restrict__ sig, T* __restrict__ fuv,
                                   T det1, T vale, T delta_min) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  const long long E = n_elems;
  const T nan = T(__longlong_as_double(0x7ff8000000000000LL));
  T ue[3], ve[3], dx[3], dy[3];
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    int n = en[j * E + e];
    if (n < 0 || n >= n_nodes) {
      bad = true;
      n = 0;
    }
    ue[j] = uv[n];
    ve[j] = uv[static_cast<long long>(n_nodes) + n];
    dx[j] = elem_c[(kDx + j) * E + e];
    dy[j] = elem_c[(kDy + j) * E + e];
  }
  T meancos = elem_c[kMeancos * E + e];
  T pfac = elem_c[kPfac * E + e];
  T ice_area = elem_c[kIceArea * E + e];
  bool has_ice = elem_c[kHasE * E + e] > T(0);
  T s11 = sig[e], s12 = sig[E + e], s22 = sig[2 * E + e];

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
  T pressure = pfac / (delta + delta_min);
  if (has_ice) {
    T half_p = T(0.5) * pressure;
    T s12n = det1 * s12 + (pressure * eps12) * vale;
    T s11n = det1 * s11 + half_p * ((eps1 - delta) + eps2 * vale);
    T s22n = det1 * s22 + half_p * ((eps1 - delta) - eps2 * vale);
    s11 = s11n;
    s12 = s12n;
    s22 = s22n;
  }
  if (bad) s11 = s12 = s22 = nan;
  sig[e] = s11;
  sig[E + e] = s12;
  sig[2 * E + e] = s22;
  T neg_area = -ice_area;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    fuv[j * E + e] = neg_area * (s11 * dx[j] + s12 * (dy[j] + meancos));
    fuv[(3 + j) * E + e] =
        neg_area * ((s12 * dx[j] + s22 * dy[j]) - s11 * meancos);
  }
}

template <typename T>
__global__ void mevp_node_kernel(T* __restrict__ uv, int n_nodes,
                                 const T* __restrict__ fuv, int n_elems,
                                 const int* __restrict__ nie,
                                 const int* __restrict__ nie_slot, int k_max,
                                 const T* __restrict__ node_c, T rdt, T rdt_cd,
                                 T density_0, T one_beta, T beta) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  const long long N = n_nodes, E = n_elems;
  const int* ne = nie + static_cast<long long>(n) * k_max;
  const int* ns = nie_slot + static_cast<long long>(n) * k_max;
  T fu = T(0), fv = T(0);
  bool bad = false;
  for (int k = 0; k < k_max; ++k) {
    int e = ne[k];
    if (e < 0) continue;
    int s = ns[k];
    if (e >= n_elems || s < 0 || s > 2) {
      bad = true;
      continue;
    }
    fu += fuv[s * E + e];
    fv += fuv[(3 + s) * E + e];
  }
  T u = uv[n], v = uv[N + n];
  T u0 = node_c[kU0 * N + n], v0 = node_c[kV0 * N + n];
  T u_w = node_c[kUw * N + n], v_w = node_c[kVw * N + n];
  T mass = node_c[kMass * N + n];
  T inv_thick = node_c[kInvThick * N + n];
  T bc = node_c[kBc * N + n];
  T rc = node_c[kRdtCor * N + n];
  bool has_ice = node_c[kHasN * N + n] > T(0);

  T u_rhs = fu * mass + node_c[kRhsA * N + n];
  T v_rhs = fv * mass + node_c[kRhsM * N + n];
  T du = u - u_w, dv = v - v_w;
  T umod = sqrt(du * du + dv * dv);
  T drag = ((rdt_cd * umod) * density_0) * inv_thick;
  T rhsu = ((u0 + drag * u_w) +
            rdt * (inv_thick * node_c[kSx * N + n] + u_rhs)) + beta * u;
  T rhsv = ((v0 + drag * v_w) +
            rdt * (inv_thick * node_c[kSy * N + n] + v_rhs)) + beta * v;
  T a = one_beta + drag;
  T det = bc / (a * a + rc * rc);
  T u_new = det * (a * rhsu + rc * rhsv);
  T v_new = det * (a * rhsv - rc * rhsu);
  if (!has_ice) {
    u_new = u;
    v_new = v;
  }
  if (bad) u_new = v_new = T(__longlong_as_double(0x7ff8000000000000LL));
  uv[n] = u_new * bc;
  uv[N + n] = v_new * bc;
}

template <typename T>
void launch_stress(void* uv, int n_nodes, const void* en, int n_elems,
                   const void* elem_c, void* sig, void* fuv, double det1,
                   double vale, double delta_min, cudaStream_t stream) {
  if (n_elems == 0) return;
  mevp_stress_kernel<T>
      <<<fesom::blocks_for(n_elems), fesom::kThreads, 0, stream>>>(
          static_cast<const T*>(uv), n_nodes, static_cast<const int*>(en),
          n_elems, static_cast<const T*>(elem_c), static_cast<T*>(sig),
          static_cast<T*>(fuv), static_cast<T>(det1), static_cast<T>(vale),
          static_cast<T>(delta_min));
}

template <typename T>
void launch_node(void* uv, int n_nodes, const void* fuv, int n_elems,
                 const void* nie, const void* nie_slot, int k_max,
                 const void* node_c, double rdt, double rdt_cd,
                 double density_0, double beta, cudaStream_t stream) {
  if (n_nodes == 0) return;
  mevp_node_kernel<T>
      <<<fesom::blocks_for(n_nodes), fesom::kThreads, 0, stream>>>(
          static_cast<T*>(uv), n_nodes, static_cast<const T*>(fuv), n_elems,
          static_cast<const int*>(nie), static_cast<const int*>(nie_slot),
          k_max, static_cast<const T*>(node_c), static_cast<T>(rdt),
          static_cast<T>(rdt_cd), static_cast<T>(density_0),
          static_cast<T>(1.0 + beta), static_cast<T>(beta));
}

}  // namespace

// uv [2, N] read; en [3, E] i32; elem_c [10, E]; sig [3, E] updated in
// place; fuv [2, 3, E] written.
extern "C" int fesom_mevp_stress(void* uv, int n_nodes, const void* en,
                                 int n_elems, const void* elem_c, void* sig,
                                 void* fuv, double det1, double vale,
                                 double delta_min, int is_double,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    launch_stress<double>(uv, n_nodes, en, n_elems, elem_c, sig, fuv, det1,
                          vale, delta_min, s);
  else
    launch_stress<float>(uv, n_nodes, en, n_elems, elem_c, sig, fuv, det1,
                         vale, delta_min, s);
  return fesom::last_error();
}

// uv [2, N] updated in place; fuv [2, 3, E]; nod_in_elem, nod_in_elem_slot
// [N, K] i32; node_c [13, N].
extern "C" int fesom_mevp_node(void* uv, int n_nodes, const void* fuv,
                               int n_elems, const void* nod_in_elem,
                               const void* nod_in_elem_slot, int k_max,
                               const void* node_c, double rdt, double rdt_cd,
                               double density_0, double beta, int is_double,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    launch_node<double>(uv, n_nodes, fuv, n_elems, nod_in_elem,
                        nod_in_elem_slot, k_max, node_c, rdt, rdt_cd,
                        density_0, beta, s);
  else
    launch_node<float>(uv, n_nodes, fuv, n_elems, nod_in_elem,
                       nod_in_elem_slot, k_max, node_c, rdt, rdt_cd,
                       density_0, beta, s);
  return fesom::last_error();
}
