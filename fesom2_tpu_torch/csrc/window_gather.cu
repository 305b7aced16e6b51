// window_gather: row gather from a per-tile window,
// out[g, t, :] = vals[g, idx[g, t], :], float32.  An index outside [0, W)
// is never read; its output row is NaN, as jnp.take's fill mode gives for
// an index past the end (unlike jnp.take, a negative index is not wrapped).
//
// Replaces scripts/gather_cost_model.py:115-131 (pallas_probe -> kern, the
// Pallas probe of a VMEM-resident window gathered with SMEM indices).
//
// Bound on the card: bytes.  At the probe's shapes (G=512, W=1024, T=256,
// NL=48) each call reads 25 MB of rows and writes 25 MB; there is no
// arithmetic.  The window need not sit in fast memory on this card: a
// gathered row is 192 contiguous bytes, read straight from device memory
// (or L2).  Design: one block per tile g; the block stages idx[g, :] in
// shared memory once, then its threads walk the tile's T x NL/4 float4
// words, neighbouring threads on neighbouring words, so each gathered row
// is read and each output row written with full 16-byte accesses.
#include "common.cuh"

namespace {

__global__ void window_gather_kernel(const float4* __restrict__ vals,
                                     const int* __restrict__ idx, int W,
                                     int T, int nl4,
                                     float4* __restrict__ out) {
  extern __shared__ int sidx[];
  const int g = blockIdx.x;
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    sidx[t] = idx[static_cast<long long>(g) * T + t];
  __syncthreads();
  const float nan = __int_as_float(0x7fc00000);
  const float4 nan4 = make_float4(nan, nan, nan, nan);
  const float4* win = vals + static_cast<long long>(g) * W * nl4;
  float4* o = out + static_cast<long long>(g) * T * nl4;
  for (int e = threadIdx.x; e < T * nl4; e += blockDim.x) {
    int t = e / nl4;
    int c = e - t * nl4;
    int i = sidx[t];
    o[e] = (i >= 0 && i < W) ? win[static_cast<long long>(i) * nl4 + c]
                             : nan4;
  }
}

}  // namespace

// vals [G, W, NL] f32, idx [G, T] i32, out [G, T, NL] f32; NL % 4 == 0 and
// 16-byte aligned rows (the wrapper checks both).
extern "C" int fesom_window_gather(const void* vals, const void* idx, int G,
                                   int W, int T, int NL, void* out,
                                   void* stream) {
  if (G == 0 || T == 0) return fesom::last_error();
  window_gather_kernel<<<G, fesom::kThreads, T * sizeof(int),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(vals), static_cast<const int*>(idx), W, T,
      NL / 4, static_cast<float4*>(out));
  return fesom::last_error();
}
