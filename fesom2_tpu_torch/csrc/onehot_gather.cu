// onehot_gather: the window gather as a one-hot product on the tensor
// cores, out[g] = onehot(idx[g], W) @ vals[g], float32 in and out, bit-equal
// to window_gather.  An index outside [0, W) selects no row; its output row
// is set to NaN, as window_gather gives.
//
// Replaces scripts/gather_cost_model.py:148-168 (pallas_probe -> kern2, the
// same gather as a batched one-hot matmul on the TPU's MXU, 8 tiles per
// program).  The probe asks whether a gather is cheaper as a product on the
// matrix unit, so the product runs on this card's matrix unit too (wgmma
// m64n144k16, bf16 operands, float32 accumulators), in the kernel's own
// body: no library GEMM.
//
// Exactness.  One bf16 or TF32 product would round vals.  A float32 value
// is the exact sum of three bf16 pieces: hi = v with its low 16 bits cut,
// mid = (v - hi) cut the same way, lo = v - hi - mid; each difference is
// exact in float32 and each piece holds at most 8 significant bits (cutting
// instead of rounding keeps hi finite up to the largest float32).  bf16 was
// taken over TF32 (11 + 11 + 2 bits) because it runs at twice the rate and
// its pieces are plain bit fields.  A product with 1.0 or 0.0 is exact, a
// one-hot row has one 1, and each piece has accumulators of its own (the
// three pieces stand side by side as 3 x 48 columns of one B tile), so an
// accumulator only ever adds zeros to one bf16 value: nothing depends on
// how the tensor core aligns its partial sums.  The pieces are added as
// (hi + mid) + lo in float32, which is exact.  What differs from the
// gather: -0.0 comes out as +0.0 (as from any product form, torch.bmm
// included); a value below 2^-109 in magnitude has bits under bf16's
// smallest subnormal (2^-133) and loses them; a non-finite value turns
// column nl of its whole tile to NaN (0 x inf), as in every product form.
//
// Bound on the card: as a method, 3 x 2 G T W NL operations on the tensor
// cores and all of vals read once; the function it computes is the gather,
// whose byte bound a product cannot reach by design.  Design: a block owns
// one tile g, 256 outputs t (four warpgroups of 64 rows) and 48 columns.
// vals[g] streams from device memory once, in chunks of 64 window rows
// through a 4-deep cp.async ring.  Each chunk is split into the three
// pieces by 384 threads (one takes 8 window rows of a column: a 16-byte row
// of a core matrix in each piece) into one of two B buffers, laid out as
// wgmma reads a K-major operand without swizzle: 8 x 16-byte core matrices,
// the next along n 128 bytes on, the next along k 18 x 128 bytes on.  The
// one-hot operand is never stored: each thread builds its A fragment from
// its two indices by shifts, in the register layout wgmma reads.  The
// asynchronous products of chunk c run while chunk c + 1 is split, and one
// __syncthreads per chunk is all that orders the rings.  (Tried on the
// card and not kept, each slower: mma.sync.m16n8k16 with the B fragments
// read through registers, by a third; one n48 product per piece; chunks of
// 32 rows with the products of two chunks in flight.)
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kGroups = 4;                 // warpgroups per block
constexpr int kThreads = kGroups * 128;
constexpr int kTileT = kGroups * 64;       // outputs t per block
constexpr int kCols = 48;                  // columns per block
constexpr int kPieces = 3;
constexpr int kWide = kPieces * kCols;     // B columns: the pieces side by side
constexpr int kAcc = kWide / 2;            // accumulators per thread (m64nN)
constexpr int kChunk = 64;                 // window rows per stage
constexpr int kSteps = kChunk / 16;        // k16 products per chunk
constexpr int kRawStages = 4;              // cp.async ring depth
constexpr int kBufs = 2;                   // B buffers: one read, one written
constexpr int kKBlockBytes = kWide * 16;   // 8 k of a B tile: kWide / 8 core matrices
constexpr int kStepBytes = 2 * kKBlockBytes;   // one k16 x kWide bf16 B tile
constexpr int kBufBytes = kSteps * kStepBytes;
constexpr int kRawFloats = kChunk * kCols;
constexpr int kCopies = kChunk * (kCols / 4);  // 16-byte copies per chunk
constexpr int kItems = (kChunk / 8) * kCols;   // split items per chunk
constexpr size_t kSharedBytes =
    kRawStages * kRawFloats * sizeof(float) + kBufs * kBufBytes;
static_assert(kWide == 144, "the product below is written for n144");
static_assert(kItems % 32 == 0 && kItems <= kThreads, "whole warps split");

// The shared-memory matrix descriptor of one k16 x kWide B tile at
// ``smem_addr``: start address, leading offset (the next core matrix along
// k), stride offset (the next along n), all in 16-byte units; no swizzle.
__device__ __forceinline__ uint64_t tile_descriptor(unsigned smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(kKBlockBytes >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// d += a (registers, m64k16) x B (shared memory, k16 n144), asynchronous.
__device__ __forceinline__ void wgmma_n144(float (&d)[kAcc],
                                           const unsigned (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, "
      "{%72, %73, %74, %75}, %76, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Registers an asynchronous product reads or writes stay what they are up
// to here: the compiler may not reuse or move them earlier.
__device__ __forceinline__ void keep(unsigned (&a)[kSteps][4]) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[ks][i])::"memory");
}
__device__ __forceinline__ void keep(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The bf16 pair (one-hot at a column, one-hot at the next) of a row whose 1
// stands d16 / 16 columns to the right: 1.0 is 0x3F80, and shl clamps a
// count beyond 31 (a 1 elsewhere; a negative distance) to an empty pair.
__device__ __forceinline__ unsigned onehot_pair(int d16) {
  unsigned pair;
  asm("shl.b32 %0, %1, %2;\n" : "=r"(pair) : "r"(0x3F80u), "r"(d16));
  return pair;
}

__global__ void __launch_bounds__(kThreads, 1)
onehot_gather_kernel(const float* __restrict__ vals,
                     const int* __restrict__ idx, int W, int T, int NL,
                     int vec_ok, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char shared_raw[];
  float* raw = reinterpret_cast<float*>(shared_raw);
  unsigned char* pieces = shared_raw + kRawStages * kRawFloats * sizeof(float);
  const unsigned pieces_addr =
      static_cast<unsigned>(__cvta_generic_to_shared(pieces));

  const int tid = threadIdx.x;
  const int gid = (tid & 31) >> 2;       // the fragment layouts' group
  const int t4 = tid & 3;                // and thread in the group
  const int g = blockIdx.x;
  const int t0 = blockIdx.y * kTileT + (tid >> 5) * 16;   // the warp's rows
  const int c0 = blockIdx.z * kCols;
  const float* win = vals + static_cast<long long>(g) * W * NL;
  const int chunks = (W + kChunk - 1) / kChunk;

  // chunk c into ring slot c % kRawStages, zeros past W and NL
  auto stage = [&](int c) {
    for (int q = tid; c < chunks && q < kCopies; q += kThreads) {
      int row = q / (kCols / 4);
      int col = 4 * (q - row * (kCols / 4));
      int w = c * kChunk + row;
      float* dst = raw + (c % kRawStages) * kRawFloats + row * kCols + col;
      const float* src = win + static_cast<long long>(w) * NL + c0 + col;
      if (w < W && vec_ok && c0 + col + 4 <= NL) {
        fesom::cp_async16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (w < W && c0 + col + e < NL)
            fesom::cp_async(dst + e, src + e);
          else
            dst[e] = 0.0f;
        }
      }
    }
    fesom::cp_async_commit();
  };

  // chunk c split into B buffer c % kBufs: an item is 8 window rows of one
  // column, cut three times, each cut a 16-byte core-matrix row
  auto split = [&](int c) {
    if (tid < kItems) {
      const float* slot = raw + (c % kRawStages) * kRawFloats;
      unsigned char* buf = pieces + (c % kBufs) * kBufBytes;
      int kb = tid / kCols;
      int n = tid - kb * kCols;
      float f[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) f[r] = slot[(kb * 8 + r) * kCols + n];
      unsigned char* dst =
          buf + (kb >> 1) * kStepBytes + (kb & 1) * kKBlockBytes + n * 16;
#pragma unroll
      for (int p = 0; p < kPieces; ++p) {
        unsigned b[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          b[r] = __float_as_uint(f[r]) & 0xFFFF0000u;
          f[r] = f[r] - __uint_as_float(b[r]);
        }
        *reinterpret_cast<uint4*>(dst + p * kCols * 16) =
            make_uint4((b[0] >> 16) | b[1], (b[2] >> 16) | b[3],
                       (b[4] >> 16) | b[5], (b[6] >> 16) | b[7]);
      }
    }
    // the writes above become visible to the tensor cores' reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // this thread's two output rows, gid and gid + 8 of its warp's 16
  int index[2];
  int shift16[2];     // 16 x the distance from the thread's first column
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int t = t0 + h * 8 + gid;
    index[h] = t < T ? idx[static_cast<long long>(g) * T + t] : -1;
    bool valid = index[h] >= 0 && index[h] < W;
    shift16[h] = valid ? 16 * (index[h] - 2 * t4) : -16;
  }

  float acc[kAcc];    // piece p: acc[24 p ..], an m64n48 fragment
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.0f;

  for (int c = 0; c < kRawStages; ++c) stage(c);
  fesom::cp_async_wait<kRawStages - 1>();
  __syncthreads();
  split(0);

  for (int c = 0; c < chunks; ++c) {
    fesom::cp_async_wait<kRawStages - 2>();
    // chunk c + 1 has landed, buffer c % kBufs is written, and every
    // warpgroup's products of chunk c - 1 are complete
    __syncthreads();
    stage(c + kRawStages);
    unsigned a[kSteps][4];
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      int k16 = 16 * (c * kChunk + ks * 16);
      a[ks][0] = onehot_pair(shift16[0] - k16);
      a[ks][1] = onehot_pair(shift16[1] - k16);
      a[ks][2] = onehot_pair(shift16[0] - k16 - 128);
      a[ks][3] = onehot_pair(shift16[1] - k16 - 128);
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const unsigned buf = pieces_addr + (c % kBufs) * kBufBytes;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_n144(acc, a[ks], tile_descriptor(buf + ks * kStepBytes));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (c + 1 < chunks) split(c + 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    keep(a);
    keep(acc);
  }

  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int t = t0 + h * 8 + gid;
    if (t >= T) continue;
    bool valid = index[h] >= 0 && index[h] < W;
    float* o = out + (static_cast<long long>(g) * T + t) * NL;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int col = c0 + j * 8 + 2 * t4 + e;
        int r = 4 * j + 2 * h + e;
        float v = (acc[r] + acc[kAcc / 3 + r]) + acc[2 * (kAcc / 3) + r];
        if (col < NL) o[col] = valid ? v : nan;
      }
  }
}

}  // namespace

// vals [G, W, NL] f32, idx [G, T] i32, out [G, T, NL] f32.
extern "C" int fesom_onehot_gather(const void* vals, const void* idx, int G,
                                   int W, int T, int NL, void* out,
                                   void* stream) {
  if (G == 0 || T == 0 || NL == 0) return fesom::last_error();
  cudaError_t err = fesom::allow_shared(onehot_gather_kernel, kSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies need rows of whole float4s on a 16-byte aligned base
  int vec_ok = NL % 4 == 0 && reinterpret_cast<size_t>(vals) % 16 == 0;
  dim3 grid(G, (T + kTileT - 1) / kTileT, (NL + kCols - 1) / kCols);
  onehot_gather_kernel<<<grid, kThreads, kSharedBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx), W, T, NL,
      vec_ok, static_cast<float*>(out));
  return fesom::last_error();
}
