// onehot_gather: the window gather as a one-hot product,
// out[g] = onehot(idx[g], W) @ vals[g], float32, computed with FP32 FMAs
// in the kernel's own body (no library GEMM, no TF32 tensor-core mma: TF32
// would round vals to 10 mantissa bits, and the result would stop being
// bit-equal to window_gather).  Every product is 0*v or 1*v, so the sum is
// exact and equals the gathered row.  An index outside [0, W) selects no
// row; its output row is set to NaN, as window_gather gives.
//
// Replaces scripts/gather_cost_model.py:148-168 (pallas_probe -> kern2, the
// same gather as a batched one-hot matmul on the TPU's MXU, 8 tiles per
// program).
//
// Bound on the card: FP32 issue rate and shared-memory reads.  At the
// probe's shapes (G=512, W=1024, T=256, NL=48) it is 6.4 G FMA, against
// 25 MB of vals.  A naive kernel would read vals[g] (196 KB a tile) from
// device memory once per output row.  Design: a block owns one tile g,
// 256 outputs t and a group of 16 columns; it stages vals[g] in chunks of
// 256 rows x 16 columns (16 KB) in shared memory, and each thread keeps its
// 16 sums in registers.  For each window row w a thread forms its one-hot
// weight (idx[g,t] == w) once and applies it to the 16 staged values, which
// all threads of a warp read from the same address (a broadcast).
#include "common.cuh"

namespace {

constexpr int kRows = 256;   // window rows staged per chunk
constexpr int kCols = 16;    // columns per block (and sums per thread)

__global__ void onehot_gather_kernel(const float* __restrict__ vals,
                                     const int* __restrict__ idx, int W,
                                     int T, int NL, float* __restrict__ out) {
  __shared__ __align__(16) float chunk[kRows * kCols];
  const int g = blockIdx.x;
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  const int c0 = blockIdx.z * kCols;
  const bool live = t < T;
  const int i = live ? idx[static_cast<long long>(g) * T + t] : -1;
  const float* win = vals + static_cast<long long>(g) * W * NL;

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;

  for (int w0 = 0; w0 < W; w0 += kRows) {
    __syncthreads();
    for (int e = threadIdx.x; e < kRows * kCols; e += blockDim.x) {
      int r = e / kCols;
      int c = e - r * kCols;
      bool in = (w0 + r < W) && (c0 + c < NL);
      chunk[e] = in ? win[static_cast<long long>(w0 + r) * NL + c0 + c]
                    : 0.0f;
    }
    __syncthreads();
    const int rows = min(kRows, W - w0);
    for (int r = 0; r < rows; ++r) {
      const float oh = (i == w0 + r) ? 1.0f : 0.0f;
      const float4* row = reinterpret_cast<const float4*>(chunk + r * kCols);
#pragma unroll
      for (int q = 0; q < kCols / 4; ++q) {
        float4 v = row[q];
        acc[4 * q + 0] = fmaf(oh, v.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(oh, v.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(oh, v.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(oh, v.w, acc[4 * q + 3]);
      }
    }
  }
  if (!live) return;
  const bool valid = i >= 0 && i < W;
  const float nan = __int_as_float(0x7fc00000);
  float* o = out + (static_cast<long long>(g) * T + t) * NL;
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (c0 + j < NL) o[c0 + j] = valid ? acc[j] : nan;
}

}  // namespace

// vals [G, W, NL] f32, idx [G, T] i32, out [G, T, NL] f32.
extern "C" int fesom_onehot_gather(const void* vals, const void* idx, int G,
                                   int W, int T, int NL, void* out,
                                   void* stream) {
  if (G == 0 || T == 0 || NL == 0) return fesom::last_error();
  dim3 grid(G, (T + fesom::kThreads - 1) / fesom::kThreads,
            (NL + kCols - 1) / kCols);
  onehot_gather_kernel<<<grid, fesom::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx), W, T, NL,
      static_cast<float*>(out));
  return fesom::last_error();
}
