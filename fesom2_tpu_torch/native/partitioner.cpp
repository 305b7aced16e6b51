// Offline mesh partitioner: weighted recursive coordinate bisection with
// Kernighan-Lin boundary refinement on the node graph.
//
// TPU-native replacement for the reference's fort_part.c + vendored METIS
// (reference: src/fort_part.c:47-300, lib/metis-5.1.0): partitions the
// 2D node graph balanced by 2D+3D node weights (PART_WEIGHTED) so each
// device shard owns a contiguous, compact region with small halo cut.
//
// Exposed C ABI (used from Python via ctypes):
//   void fesom_partition(int n, const long* rowptr, const int* colind,
//                        const double* xyz,      // [n*3] unit-sphere coords
//                        const double* weights,  // [n] balance weights
//                        int nparts, int refine_sweeps, int* part);
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Graph {
  int n;
  const int64_t* rowptr;
  const int* colind;
  const double* xyz;
  const double* w;
};

// Split `idx` into two weight-balanced halves along the principal coordinate
// axis (largest extent), returning the boundary position.
static size_t coordinate_split(const Graph& g, std::vector<int>& idx,
                               double target_frac) {
  double mins[3] = {1e300, 1e300, 1e300}, maxs[3] = {-1e300, -1e300, -1e300};
  for (int v : idx) {
    for (int d = 0; d < 3; ++d) {
      double c = g.xyz[3 * v + d];
      mins[d] = std::min(mins[d], c);
      maxs[d] = std::max(maxs[d], c);
    }
  }
  int axis = 0;
  double best = -1;
  for (int d = 0; d < 3; ++d) {
    if (maxs[d] - mins[d] > best) {
      best = maxs[d] - mins[d];
      axis = d;
    }
  }
  std::sort(idx.begin(), idx.end(), [&](int a, int b) {
    return g.xyz[3 * a + axis] < g.xyz[3 * b + axis];
  });
  double total = 0;
  for (int v : idx) total += g.w[v];
  double acc = 0, target = total * target_frac;
  size_t cut = 0;
  for (size_t i = 0; i < idx.size(); ++i) {
    acc += g.w[idx[i]];
    if (acc >= target) {
      cut = i + 1;
      break;
    }
  }
  cut = std::max<size_t>(1, std::min(cut, idx.size() - 1));
  return cut;
}

// Kernighan-Lin-style refinement between two sets: move boundary vertices
// that reduce the edge cut while keeping the weight imbalance under 5%.
static void kl_refine(const Graph& g, std::vector<int8_t>& side,
                      const std::vector<int>& idx, double target_frac,
                      int sweeps) {
  double total = 0;
  for (int v : idx) total += g.w[v];
  double w0 = 0;
  for (int v : idx)
    if (side[v] == 0) w0 += g.w[v];
  const double lo = total * target_frac * 0.95;
  const double hi = total * target_frac * 1.05;

  for (int s = 0; s < sweeps; ++s) {
    bool moved = false;
    for (int v : idx) {
      int same = 0, other = 0;
      for (int64_t e = g.rowptr[v]; e < g.rowptr[v + 1]; ++e) {
        int u = g.colind[e];
        if (side[u] < 0) continue;  // not in this subproblem
        if (side[u] == side[v]) ++same; else ++other;
      }
      if (other > same) {  // gain > 0
        double w0_new = side[v] == 0 ? w0 - g.w[v] : w0 + g.w[v];
        if (w0_new >= lo && w0_new <= hi) {
          side[v] = 1 - side[v];
          w0 = w0_new;
          moved = true;
        }
      }
    }
    if (!moved) break;
  }
}

static void bisect(const Graph& g, std::vector<int>& idx, int p0, int np,
                   int sweeps, int* part) {
  if (np == 1) {
    for (int v : idx) part[v] = p0;
    return;
  }
  int np_left = np / 2;
  double frac = double(np_left) / double(np);
  size_t cut = coordinate_split(g, idx, frac);

  // mark sides (-1 = outside this subproblem) for refinement
  std::vector<int8_t> side(g.n, -1);
  for (size_t i = 0; i < idx.size(); ++i) side[idx[i]] = i < cut ? 0 : 1;
  kl_refine(g, side, idx, frac, sweeps);

  std::vector<int> left, right;
  left.reserve(cut);
  right.reserve(idx.size() - cut);
  for (int v : idx) (side[v] == 0 ? left : right).push_back(v);
  bisect(g, left, p0, np_left, sweeps, part);
  bisect(g, right, p0 + np_left, np - np_left, sweeps, part);
}

}  // namespace

extern "C" void fesom_partition(int n, const int64_t* rowptr,
                                const int* colind, const double* xyz,
                                const double* weights, int nparts,
                                int refine_sweeps, int* part) {
  Graph g{n, rowptr, colind, xyz, weights};
  std::vector<int> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  bisect(g, idx, 0, nparts, refine_sweeps, part);
}

extern "C" int64_t fesom_edge_cut(int n, const int64_t* rowptr,
                                  const int* colind, const int* part) {
  int64_t cut = 0;
  for (int v = 0; v < n; ++v)
    for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e)
      if (part[colind[e]] != part[v]) ++cut;
  return cut / 2;
}
