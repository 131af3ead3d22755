// Int8 weight-only matrix product for Hopper (sm_90a):
//   out (M, N) = x (M, K) @ (w_q (N, K) int8 * scale (N,))^T, in x's dtype.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   - stablediffusioneo_tpu/ops/pallas/quant.py  _qmm_kernel
//     (launched by quantized_matmul; x (M,K) times w_q (K,N) int8 times a
//     per-column scale (1,N), dequantised in the kernel, fp32 accumulation)
// The port keeps torch's (out, in) weight layout, so w_q is (N, K): each
// output column's K weights are contiguous.
//
// What bounds it: at the SD-1.5 GEGLU sites (M = 128..8192, K = 320..5120,
// N = 640..10240) the product is bound by operations (2*M*N*K against
// M*K*2 + N*K + M*N*2 bytes), so it has to reach the tensor cores at the
// wgmma rate, keep them fed without block barriers, and put enough blocks
// on the 132 SMs at the sites where M is 128 or 512. |q| <= 127 is exact in
// bf16, so for bf16 x the exact bf16 image of q meets x on the tensor cores
// and scale[n] multiplies once in the epilogue; the only difference from
// the Pallas math (x . (q * s) in fp32) is the order of the fp32 sums.
//
// Three variants (`Variant`; the plan is chosen by ops/kernels/quant.py:
// matmul_plan and passed in; an entry refuses a plan that does not fit):
//   - qmm_wgmma_kernel (bf16 x, K a multiple of 16, 16-byte aligned
//     pointers: every main-path site). It computes the tile transposed,
//     out^T = W x^T: the weights are the narrow operand, so they stay int8
//     until they are in registers (half the bytes of their bf16 image in
//     global and shared memory, and no second trip through shared memory),
//     are converted there and go to wgmma as the register (A) operand, 64
//     weight rows a warpgroup; x (M, K) row-major is already the K-major B
//     operand and is read from shared memory by descriptor, as it was
//     copied. A ring of 64-deep K slices is filled by tensor-map (TMA)
//     loads that one thread issues (x in the 128-byte swizzle, w_q as int8
//     rows in the 64-byte swizzle) and handed over by full/empty mbarriers:
//     no block barrier in the K loop, and no thread spends instructions on
//     the copies. The conversion of slice i + 1 runs while the wgmma group
//     of slice i is in flight. Small M: the K slices are split over the
//     blocks of a thread block cluster; every block leaves its fp32 partial
//     tile in its own shared memory and the blocks add them in rank order
//     through distributed shared memory (no atomics: two runs give equal
//     bytes), each block finishing a share of the tile's rows. The
//     transposed tile goes through shared memory in any case, so the stores
//     are 16 bytes a thread along N. What is left between it and its bound:
//     a block's prologue (first loads), products and epilogue run one after
//     the other, overlapped only by the second block of its SM.
//   - qmm_mma_kernel (bf16 x that the wgmma variant does not take: K not a
//     multiple of 16, or unaligned views): mma.sync m16n8k16 from a 128 x 128
//     tile with element loads at the ragged edge. No main-path site runs it.
//   - qmm_fp32_kernel (fp32 x, the exact checks): fp32 FMAs on the CUDA cores
//     from a 4 x 4 register tile per thread, the weights dequantised to
//     q * s in fp32 as they are stored, as the Pallas kernel does.
// Measured times, bounds and the yardsticks: PERF.md section 6.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// mma.sync variant (bf16 x the wgmma variant does not take).

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
  bool vec;  // mma.sync variant: 16-byte loads (K % 16 == 0, aligned pointers)
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

// ---------------------------------------------------------------------------
// wgmma variant (bf16 x, K % 16 == 0, aligned pointers).
//
// A block of NWG warpgroups owns a tile of BN = 64 NWG weight rows (output
// columns) x TM x rows (output rows) and the K slices [blockIdx.z * per,
// ...) of it; warpgroup w multiplies weight rows [64 w, 64 w + 64) against
// the whole x tile as wgmma m64nTMk16. A stage of the ring holds one
// 64-deep slice, placed by two tensor-map (TMA) loads that one thread
// issues: x as TM rows of 128 bytes in the 128-byte swizzle (the K-major B
// operand as it lands), w_q as BN rows of 64 int8 in the 64-byte swizzle (a
// quad's 2-byte fragment loads of 8 rows then fall into 8 distinct 16-byte
// bank groups). Rows past M and columns past K read as zeros. Copies by
// cp.async, 16 bytes a thread, were measured first: at one request a clock
// an SM they took longer than the products.

constexpr int kQK = 64;  // K slice

template <int TM, int NWG, int STAGES>
struct QTile {
  static constexpr int BN = NWG * 64;
  static constexpr int kXBytes = TM * kQK * 2;
  static constexpr int kWBytes = BN * kQK;
  static constexpr int kStage = kXBytes + kWBytes;
  static constexpr int kRing = STAGES * kStage;
  // the fp32 tile out[m][n] of the epilogue, over the ring; the pitch makes
  // a warp's accumulator stores (8 columns x 4 row pairs) hit 32 banks
  static constexpr int kOutPitch = BN + 4;
  static constexpr int kOutBytes = TM * kOutPitch * 4;
  static constexpr int kBody = kRing > kOutBytes ? kRing : kOutBytes;
  // + 1024: the kernel aligns the ring to the swizzle period itself
  static constexpr size_t kBytes = (size_t)kBody + 2 * STAGES * 8 + 1024;
  static_assert(TM % 64 == 0 && TM <= 256 && STAGES >= 3, "tile");
  static_assert(kXBytes % 1024 == 0 && kStage % 1024 == 0 && kBody % 16 == 0, "alignment");
  static_assert(kBytes <= 232448, "tile exceeds the shared memory of one block");
};

// two int8 (the low and high byte of h's low half) -> their exact bf16
// images, packed: q ^ 0x80 = q + 128 as an unsigned byte u; 0x4B000000 | u
// is the float 2^23 + u; minus 2^23 + 128 leaves q.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t h) {
  const uint32_t u = h ^ 0x8080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int TM, int NWG, int STAGES>
__global__ void __launch_bounds__(NWG * 128) qmm_wgmma_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
    Params p, int slices_per_block) {
  using L = QTile<TM, NWG, STAGES>;
  constexpr int kBlock = NWG * 128;
  extern __shared__ unsigned char q_smem_raw[];
  unsigned char* q_smem = q_smem_raw + ((1024 - smem_u32(q_smem_raw) % 1024) % 1024);
  const uint32_t smem0 = smem_u32(q_smem);
  const uint32_t full0 = smem0 + L::kBody, empty0 = full0 + STAGES * 8;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * L::BN;
  const int slice0 = blockIdx.z * slices_per_block;
  const int left = (p.k + kQK - 1) / kQK - slice0;
  const int n_tiles = left < slices_per_block ? (left > 0 ? left : 0) : slices_per_block;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + st * 8, 1);             // the copying thread, with the bytes
      mbar_init(empty0 + st * 8, kBlock / 32);  // every warp is done with the slice
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 copies: slice j into stage j % STAGES, once every warp has
  // released the slice that was there
  auto request = [&](int j) {
    if (j < n_tiles) {
      const int st = j % STAGES;
      if (j >= STAGES) mbar_wait(empty0 + st * 8, (j / STAGES - 1) & 1);
      const uint32_t base = smem0 + st * L::kStage, bar = full0 + st * 8;
      mbar_expect_tx(bar, L::kStage);
      tma_load_2d(base, &x_map, bar, (slice0 + j) * kQK, m0);
      tma_load_2d(base + L::kXBytes, &w_map, bar, (slice0 + j) * kQK, n0);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) request(j);
  }
  __syncwarp();

  // the A fragments of one slice (4 k16 steps): rows g and g + 8 of this
  // warp's 16 weight rows, int8 pairs 2t, 2t + 1 of each 8-deep chunk. Row r
  // holds its 16-byte unit u at u ^ (r / 2 % 4); r / 2 % 4 is g / 2 % 4 for
  // both rows.
  const int w_row = L::kXBytes + (wg * 64 + warp * 16 + g) * kQK + 2 * t;
  const int w_swz = (g >> 1) & 3;
  auto convert = [&](uint32_t (&a)[4][4], int tile) {
    const unsigned char* ws = q_smem + (tile % STAGES) * L::kStage + w_row;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[ks][e] = int8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(
            ws + (e & 1) * 8 * kQK + ((ks ^ w_swz) * 16) + (e >> 1) * 8));
  };

  float acc[TM / 2];
#pragma unroll
  for (int i = 0; i < TM / 2; ++i) acc[i] = 0.f;
  uint32_t a0[4][4], a1[4][4];
  if (n_tiles > 0) {
    mbar_wait(full0, 0);
    convert(a0, 0);
  }
  // slice i multiplies from `cur` while slice i + 1 is converted into `nxt`
  auto step = [&](uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4], int i) {
    const uint32_t xb = smem0 + (i % STAGES) * L::kStage;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs<0>(acc, cur[ks], wgmma_desc_sw128(xb + ks * 32), 1);
    wgmma_commit();
    if (tid == 0) request(i + STAGES - 1);  // into the stage slice i - 1 left
    __syncwarp();
    if (i + 1 < n_tiles) {
      mbar_wait(full0 + ((i + 1) % STAGES) * 8, ((i + 1) / STAGES) & 1);
      convert(nxt, i + 1);
    }
    wgmma_wait();
    if (lane == 0) mbar_arrive(empty0 + (i % STAGES) * 8);
  };
  for (int i = 0; i < n_tiles; i += 2) {
    step(a0, a1, i);
    if (i + 1 < n_tiles) step(a1, a0, i + 1);
  }

  // Epilogue: the warpgroups' transposed accumulators into one fp32 tile
  // out[m][n] over the ring, the cluster's partial tiles added in rank order,
  // scaled, rounded once and stored 16 bytes a thread along N. Block r of
  // the cluster finishes rows [r TM / S, (r + 1) TM / S) of the tile.
  __syncthreads();  // every warpgroup is done with the ring
  float* tile = reinterpret_cast<float*>(q_smem);
  {
    const int nl = wg * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < TM / 8; ++j) {
      float* r0 = tile + (8 * j + 2 * t) * L::kOutPitch + nl;
      r0[0] = acc[4 * j];
      r0[L::kOutPitch] = acc[4 * j + 1];
      r0[8] = acc[4 * j + 2];
      r0[L::kOutPitch + 8] = acc[4 * j + 3];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  if (split > 1) cluster.sync(); else __syncthreads();
  const int rows = TM / split;
  bf16* out = static_cast<bf16*>(p.out);
  for (int it = tid; it < rows * (L::BN / 8); it += kBlock) {
    const int r = rank * rows + it / (L::BN / 8), c8 = (it % (L::BN / 8)) * 8;
    if (m0 + r >= p.m) continue;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    for (int b = 0; b < split; ++b) {
      const float* src = cluster.map_shared_rank(tile, b) + r * L::kOutPitch + c8;
      const float4 u = *reinterpret_cast<const float4*>(src);
      const float4 v = *reinterpret_cast<const float4*>(src + 4);
      lo.x += u.x; lo.y += u.y; lo.z += u.z; lo.w += u.w;
      hi.x += v.x; hi.y += v.y; hi.z += v.z; hi.w += v.w;
    }
    const float4 s0 = *reinterpret_cast<const float4*>(p.scale + n0 + c8);
    const float4 s1 = *reinterpret_cast<const float4*>(p.scale + n0 + c8 + 4);
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
    o2[0] = __floats2bfloat162_rn(lo.x * s0.x, lo.y * s0.y);
    o2[1] = __floats2bfloat162_rn(lo.z * s0.z, lo.w * s0.w);
    o2[2] = __floats2bfloat162_rn(hi.x * s1.x, hi.y * s1.y);
    o2[3] = __floats2bfloat162_rn(hi.z * s1.z, hi.w * s1.w);
    *reinterpret_cast<uint4*>(out + (long long)(m0 + r) * p.n + n0 + c8) = o;
  }
  if (split > 1) cluster.sync();  // no block leaves while its partial tile may still be read
}

// Tensor map of a row-major (rows, cols) matrix read in boxes of box_rows x
// 64 columns; out-of-range elements read as zeros.
bool tile_map(CUtensorMap* map, CUtensorMapDataType type, int elem_size, const void* base,
              int rows, int cols, int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_size};
  const cuuint32_t box[2] = {(cuuint32_t)kQK, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TM, int NWG, int STAGES>
cudaError_t launch_wgmma(const Params& p, int split, cudaStream_t stream) {
  using L = QTile<TM, NWG, STAGES>;
  if (p.n % L::BN || TM % split) return cudaErrorInvalidValue;
  auto kernel = qmm_wgmma_kernel<TM, NWG, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  CUtensorMap x_map, w_map;
  if (!tile_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.x, p.m, p.k, TM,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tile_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.wq, p.n, p.k, L::BN,
                CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  const int slices = (p.k + kQK - 1) / kQK;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.n / L::BN, (p.m + TM - 1) / TM, split);
  config.blockDim = dim3(NWG * 128);
  config.dynamicSmemBytes = L::kBytes;
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = split;  // the K split: one output tile per cluster
  config.attrs = &cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, x_map, w_map, p, (slices + split - 1) / split);
}

bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) % 16) == 0;
}

// The plan is the caller's (ops/kernels/quant.py: matmul_plan); what a
// variant does not take is an error, never a silent switch to another one.
enum Variant { kCudaCore = 0, kMmaSync = 1, kWgmma = 2 };

cudaError_t launch_plan(Params p, int dtype, int variant, int tm, int bn, int split,
                        int stages, cudaStream_t st) {
  if (p.m < 1 || p.k < 1 || p.n < 1 || p.n % kBN) return cudaErrorInvalidValue;
  if (variant == kCudaCore) {
    if (dtype != 0 || tm != kFB || bn != kFB || split != 1) return cudaErrorInvalidValue;
    const dim3 grid(p.n / kFB, (p.m + kFB - 1) / kFB);
    qmm_fp32_kernel<<<grid, kFThreads, 0, st>>>(p);
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  if (variant == kMmaSync) {
    if (tm != kBM || bn != kBN || split != 1) return cudaErrorInvalidValue;
    p.vec = p.k % 16 == 0 && aligned16(p.x, p.wq, nullptr, nullptr);
    const dim3 grid(p.n / kBN, (p.m + kBM - 1) / kBM);
    qmm_mma_kernel<<<grid, kThreads, 0, st>>>(p);
    return cudaGetLastError();
  }
  if (variant != kWgmma || p.k % 16 || !aligned16(p.x, p.wq, p.scale, p.out) ||
      (long long)p.m * p.k >= (1LL << 31) || (long long)p.n * p.k >= (1LL << 31) ||
      stages != 4 || (split != 1 && split != 2 && split != 4 && split != 8))
    return cudaErrorInvalidValue;
  if (tm == 128 && bn == 128) return launch_wgmma<128, 2, 4>(p, split, st);
  if (tm == 128 && bn == 64) return launch_wgmma<128, 1, 4>(p, split, st);
  if (tm == 64 && bn == 128) return launch_wgmma<64, 2, 4>(p, split, st);
  if (tm == 64 && bn == 64) return launch_wgmma<64, 1, 4>(p, split, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out). x (M, K) and w_q (N, K) are
// row-major and contiguous, scale (N,) fp32, out (M, N); N a multiple of 128.
// variant: a Variant code; tm x bn: the output tile of a block (x rows by
// weight rows); split: blocks a tile's K slices are split over; stages: ring
// depth. Returns a cudaError_t (0 = launched).
extern "C" int sdeo_quantized_matmul(const void* x, const void* wq,
                                     const void* scale, void* out, int dtype,
                                     int m, int n, int k, int variant, int tm,
                                     int bn, int split, int stages, void* stream) {
  Params p{x, static_cast<const int8_t*>(wq), static_cast<const float*>(scale),
           out, m, n, k, false};
  return (int)launch_plan(p, dtype, variant, tm, bn, split, stages,
                          static_cast<cudaStream_t>(stream));
}
