// Int8 weight-only matrix product for Hopper (sm_90a):
//   out (M, N) = x (M, K) @ (w_q (N, K) int8 * scale (N,))^T, in x's dtype.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   - stablediffusioneo_tpu/ops/pallas/quant.py  _qmm_kernel
//     (launched by quantized_matmul; x (M,K) times w_q (K,N) int8 times a
//     per-column scale (1,N), dequantised in the kernel, fp32 accumulation)
// The port keeps torch's (out, in) weight layout, so w_q is (N, K): each
// output column's K weights are contiguous, which is the column-major B
// operand that mma.sync takes as it is.
//
// Schedule: one block per (BM x BN) output tile; a K loop stages a BK-deep
// slice of x and of w_q through shared memory, the int8 weights converted to
// the operand type as they are stored. The next slice is loaded into
// registers while the current one is multiplied. The TPU kernel held the
// whole K extent of its x and w blocks in VMEM; a Hopper block has at most
// 227 KB of shared memory, so K is walked in slices inside the block.
//
// What bounds it: at the SD-1.5 GEGLU sites (M = 128..8192, K = 320..5120,
// N = 640..10240) the product is compute bound (2*M*N*K FLOPs against
// M*K*2 + N*K + M*N*2 bytes). Two variants:
//   - qmm_mma_kernel (bf16 x): |q| <= 127 is exact in bf16, so x and q go to
//     the tensor cores as they are (mma.sync m16n8k16, fp32 accumulate) and
//     scale[n] multiplies once in the epilogue. The products are exact; the
//     only difference from the Pallas math (x . (q * s) in fp32) is the
//     order of the fp32 sums. Its limits: no cp.async/TMA pipeline and
//     mma.sync instead of wgmma, and few blocks at the small-M sites
//     (M = 128 gives N / 128 blocks).
//   - qmm_fp32_kernel (fp32 x, the exact checks): fp32 FMAs on the CUDA cores
//     from a 4 x 4 register tile per thread, the weights dequantised to
//     q * s in fp32 as they are stored, as the Pallas kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// Tensor-core variant (bf16 x).

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kWarpsM = 2, kWarpsN = 4;       // warp grid over the tile
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWM = kBM / kWarpsM;            // 64 rows per warp
constexpr int kWN = kBN / kWarpsN;            // 32 columns per warp
constexpr int kMI = kWM / 16, kNI = kWN / 8;  // mma tiles per warp
constexpr int kRow = kBK + 8;                 // padded smem row (bf16)
// x: 8-element chunks, w: 16-element chunks, per thread per slice
constexpr int kXChunks = kBM * kBK / 8 / kThreads;
constexpr int kWChunks = kBN * kBK / 16 / kThreads;
static_assert(kXChunks * kThreads * 8 == kBM * kBK, "x slice tiling");
static_assert(kWChunks * kThreads * 16 == kBN * kBK, "w slice tiling");

struct Params {
  const void* x;
  const int8_t* wq;
  const float* scale;
  void* out;
  int m, n, k;
  bool vec;  // 16-byte loads: K % 16 == 0 and aligned base pointers
};

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One slice's loads held in registers between the global read and the
// shared-memory store.
struct Slice {
  uint4 x[kXChunks];  // 8 bf16 each
  uint4 w[kWChunks];  // 16 int8 each
};

__device__ __forceinline__ void load_slice(Slice& sl, const Params& p, int m0,
                                           int n0, int k0) {
  const bf16* x = static_cast<const bf16*>(p.x);
#pragma unroll
  for (int j = 0; j < kXChunks; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const int r = c / (kBK / 8), kk = k0 + (c % (kBK / 8)) * 8;
    const int row = m0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < p.m) {
      const bf16* src = x + (long long)row * p.k + kk;
      if (p.vec && kk + 8 <= p.k) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          e[i] = (kk + i < p.k) ? src[i] : __float2bfloat16_rn(0.f);
      }
    }
    sl.x[j] = v;
  }
#pragma unroll
  for (int j = 0; j < kWChunks; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const int r = c / (kBK / 16), kk = k0 + (c % (kBK / 16)) * 16;
    const int8_t* src = p.wq + (long long)(n0 + r) * p.k + kk;  // N % kBN == 0
    uint4 v = make_uint4(0, 0, 0, 0);
    if (p.vec && kk + 16 <= p.k) {
      v = *reinterpret_cast<const uint4*>(src);
    } else {
      int8_t* e = reinterpret_cast<int8_t*>(&v);
#pragma unroll
      for (int i = 0; i < 16; ++i) e[i] = (kk + i < p.k) ? src[i] : 0;
    }
    sl.w[j] = v;
  }
}

__device__ __forceinline__ void store_slice(const Slice& sl, bf16* xs, bf16* ws) {
#pragma unroll
  for (int j = 0; j < kXChunks; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const int r = c / (kBK / 8), kk = (c % (kBK / 8)) * 8;
    *reinterpret_cast<uint4*>(xs + r * kRow + kk) = sl.x[j];
  }
#pragma unroll
  for (int j = 0; j < kWChunks; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const int r = c / (kBK / 16), kk = (c % (kBK / 16)) * 16;
    const int8_t* e = reinterpret_cast<const int8_t*>(&sl.w[j]);
    uint4 lo, hi;  // int8 -> bf16 is exact for |q| <= 127
    __nv_bfloat162* l2 = reinterpret_cast<__nv_bfloat162*>(&lo);
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&hi);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l2[i] = __floats2bfloat162_rn((float)e[2 * i], (float)e[2 * i + 1]);
      h2[i] = __floats2bfloat162_rn((float)e[8 + 2 * i], (float)e[8 + 2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(ws + r * kRow + kk) = lo;
    *reinterpret_cast<uint4*>(ws + r * kRow + kk + 8) = hi;
  }
}

__global__ void __launch_bounds__(kThreads) qmm_mma_kernel(Params p) {
  // rows padded to kRow = 40 bf16 (20 words): the fragment loads of a warp
  // (8 rows x 4 words) hit 32 distinct banks
  __shared__ __align__(16) bf16 xs[kBM * kRow];
  __shared__ __align__(16) bf16 ws[kBN * kRow];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[kMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  Slice sl;
  load_slice(sl, p, m0, n0, 0);
  for (int k0 = 0; k0 < p.k; k0 += kBK) {
    __syncthreads();  // the previous slice is no longer read
    store_slice(sl, xs, ws);
    __syncthreads();
    if (k0 + kBK < p.k) load_slice(sl, p, m0, n0, k0 + kBK);  // in flight below
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[kMI][4];
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        const bf16* xr = xs + (wm * kWM + i * 16 + g) * kRow + ks * 16 + 2 * t;
        a[i][0] = ld32(xr);
        a[i][1] = ld32(xr + 8 * kRow);
        a[i][2] = ld32(xr + 8);
        a[i][3] = ld32(xr + 8 * kRow + 8);
      }
#pragma unroll
      for (int j = 0; j < kNI; ++j) {
        const bf16* wr = ws + (wn * kWN + j * 8 + g) * kRow + ks * 16 + 2 * t;
        const uint32_t b0 = ld32(wr), b1 = ld32(wr + 8);
#pragma unroll
        for (int i = 0; i < kMI; ++i) mma_16816(acc[i][j], a[i], b0, b1);
      }
    }
  }

  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int j = 0; j < kNI; ++j) {
    const int col = n0 + wn * kWN + j * 8 + 2 * t;
    const float s0 = p.scale[col], s1 = p.scale[col + 1];
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm * kWM + i * 16 + g + 8 * r;
        if (row < p.m)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * p.n + col) =
              __floats2bfloat162_rn(acc[i][j][2 * r] * s0, acc[i][j][2 * r + 1] * s1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core variant (fp32 x).

constexpr int kFB = 64, kFK = 16, kFThreads = 256;  // 64 x 64 tile, 4 x 4 per thread

__global__ void __launch_bounds__(kFThreads) qmm_fp32_kernel(Params p) {
  __shared__ float xs[kFK][kFB + 4];  // x slice, transposed
  __shared__ float ws[kFK][kFB + 4];  // q * s slice, transposed
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kFB, n0 = blockIdx.x * kFB;
  const float* x = static_cast<const float*>(p.x);

  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.k; k0 += kFK) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kFB * kFK / kFThreads; ++j) {
      const int c = threadIdx.x + j * kFThreads;
      const int r = c / kFK, kk = c % kFK;  // 16 neighbouring threads, one row
      const int row = m0 + r, col = n0 + r, kg = k0 + kk;
      xs[kk][r] = (row < p.m && kg < p.k) ? x[(long long)row * p.k + kg] : 0.f;
      ws[kk][r] = (kg < p.k) ? (float)p.wq[(long long)col * p.k + kg] * p.scale[col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(long long)row * p.n + n0 + tx + 16 * j] = acc[i][j];
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out). x (M, K) and w_q (N, K) are
// row-major and contiguous, scale (N,) fp32, out (M, N); N a multiple of 128.
// Returns a cudaError_t (0 = launched).
extern "C" int sdeo_quantized_matmul(const void* x, const void* wq,
                                     const void* scale, void* out, int dtype,
                                     int m, int n, int k, void* stream) {
  if (m < 1 || k < 1 || n < 1 || n % kBN) return (int)cudaErrorInvalidValue;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq)) % 16) == 0;
  Params p{x, static_cast<const int8_t*>(wq), static_cast<const float*>(scale),
           out, m, n, k, aligned && k % 16 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid(n / kBN, (m + kBM - 1) / kBM);
    qmm_mma_kernel<<<grid, kThreads, 0, st>>>(p);
  } else if (dtype == 0) {
    const dim3 grid(n / kFB, (m + kFB - 1) / kFB);
    qmm_fp32_kernel<<<grid, kFThreads, 0, st>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
