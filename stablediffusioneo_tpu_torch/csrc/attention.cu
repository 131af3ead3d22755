// Fused scaled-dot-product attention for Hopper (sm_90a), no mask.
//
// Replaces three Pallas TPU kernels of the JAX package:
//   - stablediffusioneo_tpu/ops/pallas/attention.py  _attn_kernel_packed
//     (launched by _packed_impl; head-packed q (B,Tq,H*D), k/v (B,S,H*D))
//   - stablediffusioneo_tpu/ops/pallas/attention.py  _attn_kernel_packed_stream
//     (launched by _packed_stream_call: the same layout, for bf16
//     self-attention whose K/V slab does not fit VMEM, e.g. the 1024x1024
//     hires pass's (2, 16384, 320) sites)
//   - stablediffusioneo_tpu/ops/pallas/attention.py  _attn_kernel
//     (launched by _split_impl; split q (B,H,Tq,D), k/v (B,H,S,D))
// Every layout reaches the same kernels: the wrapper passes each tensor's
// batch, head and token strides (the head dim is contiguous), so packed and
// split differ only in the strides, and q, k, v may be column views of a
// fused QKV projection. The streaming kernel needs nothing of its own: every
// variant here walks K/V in tiles with the same online-softmax recurrence,
// whatever the key length, so its entry (fused_attention_packed_stream)
// launches the packed variant. The TPU kernels held the whole K/V slab (or
// a stream of large blocks) in VMEM; a Hopper block has at most 227 KB of
// shared memory, so the K loop lives inside the block and a ragged last
// tile is masked (cross-attention has S = 77).
//
// Numerics follow the Pallas kernels: q is scaled by the scale rounded to
// its dtype and rounded to that dtype; logits and softmax statistics are
// fp32; the running max starts at -1e30; the denominator sums the unrounded
// p; p is rounded to v's dtype before the AV product; AV accumulates in
// fp32 and the divide by the denominator comes once, after AV. The bf16
// variants take exp(x) as ex2(x log2 e) on the special-function units.
//
// Three variants (`Variant`; chosen by ops/kernels/attention.py):
//   - attention_wgmma_kernel (bf16, d in {40, 64, 80, 160}: every UNet and
//     ControlNet site). Both products on the tensor cores by wgmma, K/V
//     tiles through a cp.async ring with mbarriers, p in registers. At d =
//     40 a logit costs 4 d = 160 tensor-core operations but also a max, an
//     FMA, an exp, an add and half a convert on the CUDA cores and the
//     special-function units, and each tile one round trip to the tensor
//     cores; those, not the products, bound it: at (2, 16384, 320) x 16384
//     the exp alone needs 1.2 ms where the products need 0.7 ms. The design
//     keeps several warpgroups an SM independent (no block barrier in the
//     loop), issues O += P V of one tile and S of the next as one wgmma
//     group, and widens the block to 3 or 4 warpgroups where the grid still
//     covers the SMs, which divides the K/V re-read from L2 (one pass per
//     block) and the copy requests by the same factor. The S = 77 sites are
//     bound by bytes and by the q loads and o stores of 4 bytes a thread.
//   - attention_split512_kernel (bf16, d = 512: the VAE mid-block). Both
//     products by wgmma with O's 512 columns split over two warpgroups. It
//     is bound by L2 traffic: each 64-row block re-reads all of K and V, and
//     O of a wider block does not fit the register file.
//   - attention_kernel (fp32 for the exact checks, and bf16 views whose rows
//     are not 16-byte aligned): fp32 FMAs on the CUDA cores from an RQ x RK
//     register tile per thread, bounded by shared-memory loads per FMA; no
//     bf16 main-path site reaches it.
// Measured times, bounds and the library call's times: PERF.md section 6.
// Head dims compiled: 40, 64, 80, 160 and 512.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTY = 16;  // thread rows: query rows ty, ty+16, ...
constexpr int kTX = 16;  // thread cols: key columns / head dims tx, tx+16, ...

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float load(float x) { return x; }
  __device__ static float store(float x) { return x; }
  __device__ static float round(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int heads, tq, s;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  float scale;
};

template <int D, int BQ, int BK>
struct Tile {
  static constexpr int RQ = BQ / kTY;              // query rows per thread
  static constexpr int RK = BK / kTX;              // key columns per thread
  static constexpr int RD = (D + kTX - 1) / kTX;   // output dims per thread
  static constexpr int QP = D + 1;                 // padded q row
  static constexpr int KP = BK + 1;                // padded K^T / logits row
  static constexpr int DP = RD * kTX;              // V row, zero beyond D
  static constexpr int kQ = BQ * QP;
  static constexpr int kK = D * KP;
  static constexpr int kV = BK * DP;
  static constexpr int kS = BQ * KP;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kS + 3 * BQ);
  static_assert(BQ % kTY == 0 && BK % kTX == 0, "tile must cover the thread grid");
  static_assert(kBytes <= 232448, "tile exceeds the shared memory of one block");
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) attention_kernel(Params p) {
  using L = Tile<D, BQ, BK>;
  extern __shared__ float smem[];
  float* q_s = smem;            // [BQ][QP] q * scale, rounded to T
  float* kt_s = q_s + L::kQ;    // [D][KP]  K tile, transposed
  float* v_s = kt_s + L::kK;    // [BK][DP] V tile
  float* s_s = v_s + L::kV;     // [BQ][KP] logits, then p rounded to T
  float* m_s = s_s + L::kS;     // [BQ] running max
  float* l_s = m_s + BQ;        // [BQ] running denominator
  float* a_s = l_s + BQ;        // [BQ] rescale factor of the current tile

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * BQ;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < p.tq) {
      x = Num<T>::round(Num<T>::load(q[(long long)(q0 + r) * p.q_st + d]) * p.scale);
    }
    q_s[r * L::QP + d] = x;
  }
  for (int i = tid; i < BQ; i += kThreads) {
    // -1e30, not -inf: exp(m_old - m_new) must stay a number on a fresh row
    m_s[i] = -1e30f;
    l_s[i] = 0.f;
  }

  float acc[L::RQ][L::RD];
#pragma unroll
  for (int i = 0; i < L::RQ; ++i)
#pragma unroll
    for (int e = 0; e < L::RD; ++e) acc[i][e] = 0.f;

  for (int k0 = 0; k0 < p.s; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and p are no longer read
    for (int i = tid; i < BK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      kt_s[d * L::KP + j] =
          (k0 + j < p.s) ? Num<T>::load(k[(long long)(k0 + j) * p.k_st + d]) : 0.f;
    }
    for (int i = tid; i < BK * L::DP; i += kThreads) {
      const int j = i / L::DP, d = i % L::DP;
      v_s[i] = (k0 + j < p.s && d < D)
                   ? Num<T>::load(v[(long long)(k0 + j) * p.v_st + d])
                   : 0.f;
    }
    __syncthreads();

    // logits of this tile: fp32 sums of the rounded q against K
    float sc[L::RQ][L::RK];
#pragma unroll
    for (int i = 0; i < L::RQ; ++i)
#pragma unroll
      for (int j = 0; j < L::RK; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[L::RQ], kb[L::RK];
#pragma unroll
      for (int i = 0; i < L::RQ; ++i) qa[i] = q_s[(ty + kTY * i) * L::QP + d];
#pragma unroll
      for (int j = 0; j < L::RK; ++j) kb[j] = kt_s[d * L::KP + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < L::RQ; ++i)
#pragma unroll
        for (int j = 0; j < L::RK; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < L::RQ; ++i)
#pragma unroll
      for (int j = 0; j < L::RK; ++j) {
        const int c = tx + kTX * j;
        s_s[(ty + kTY * i) * L::KP + c] = (k0 + c < p.s) ? sc[i][j] : -INFINITY;
      }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < BQ; r += kThreads / 32) {
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, s_s[r * L::KP + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float e = expf(s_s[r * L::KP + c] - m_new);
        sum += e;
        s_s[r * L::KP + c] = Num<T>::round(e);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        a_s[r] = a;
        l_s[r] = l_s[r] * a + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // rescale the accumulator, then add p @ V
#pragma unroll
    for (int i = 0; i < L::RQ; ++i) {
      const float a = a_s[ty + kTY * i];
#pragma unroll
      for (int e = 0; e < L::RD; ++e) acc[i][e] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pa[L::RQ], vb[L::RD];
#pragma unroll
      for (int i = 0; i < L::RQ; ++i) pa[i] = s_s[(ty + kTY * i) * L::KP + j];
#pragma unroll
      for (int e = 0; e < L::RD; ++e) vb[e] = v_s[j * L::DP + tx + kTX * e];
#pragma unroll
      for (int i = 0; i < L::RQ; ++i)
#pragma unroll
        for (int e = 0; e < L::RD; ++e) acc[i][e] = fmaf(pa[i], vb[e], acc[i][e]);
    }
  }

  // l_s was last written before the final __syncthreads of the loop
#pragma unroll
  for (int i = 0; i < L::RQ; ++i) {
    const int r = ty + kTY * i;
    if (q0 + r >= p.tq) continue;
    const float l = l_s[r];
    T* orow = o + (long long)(q0 + r) * p.o_st;
#pragma unroll
    for (int e = 0; e < L::RD; ++e) {
      const int d = tx + kTX * e;
      if (d < D) orow[d] = Num<T>::store(acc[i][e] / l);
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Tensor-core variants (bf16): wgmma (warpgroup mma, fp32 accumulate) fed by
// cp.async.
//
// Shared-memory layout. Every wgmma operand read from shared memory here is
// in the no-swizzle "core matrix" layout: a tile of R rows x C 16-byte
// chunks (8 bf16) stores chunk c of row r at
//     ((r / 8) * C + c) * 128 + (r % 8) * 16   bytes,
// so each 8-row x 16-byte core matrix is 128 contiguous bytes (every bank
// once, no conflicts, no swizzle to match). The same bytes serve both
// operand kinds; only the descriptor differs:
//   - K-major (Q and K in S = Q K^T; rows are the M/N index, the head dim is
//     the reduction): leading byte offset (reduction direction, next chunk)
//     = 128, stride byte offset (next 8 rows) = C * 128;
//   - MN-major (V in O += P V, "transposed B": rows are keys = the
//     reduction, the head dim is N): leading byte offset (next 8 keys)
//     = C * 128, stride byte offset (next 8 head dims) = 128.
// So V is consumed as it lies in memory, with no element-wise transpose.
// cp.async writes one 16-byte chunk per request, which places a head's
// row of any width (80 bytes at d = 40) and any row stride (packed heads,
// fused-QKV column views) without a TMA box; a request of source size 0
// zero-fills the rows past the end of a ragged tile.

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma.mma_async m64n64k16 with A and B by descriptor, both K-major; the
// accumulator layout and scale_d are those of wgmma_rs (hopper.cuh), which
// takes A from registers.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Copy rows [r0, r0 + kRows) of a (tokens, kChunks * 8) bf16 slice with
// token stride `st` into a core-matrix tile, one 16-byte cp.async per chunk;
// rows at or past `n` are zero-filled. Consecutive threads take consecutive
// rows of one chunk: 8 lanes write one 128-byte core matrix, 4 neighbouring
// groups of 8 read 64 contiguous bytes of each row. Chunk i lands at byte
// 16 i of the tile.
template <int kRows, int kChunks, int kThreadsPerBlock>
__device__ __forceinline__ void stage_tile_async(uint32_t dst,
                                                 const __nv_bfloat16* src,
                                                 long long st, int r0, int n) {
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreadsPerBlock) {
    const int r8 = i % 8, c = (i / 8) % kChunks, rg = i / (8 * kChunks);
    const int row = r0 + rg * 8 + r8;
    const bool live = row < n;
    cp_async16(dst + i * 16, src + (live ? (long long)row * st + c * 8 : 0),
               live ? 16 : 0);
  }
}

// scale two packed bf16 by `scale` (fp32 product, rounded back to bf16)
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  return pack_bf16(__bfloat162float(v.x) * scale, __bfloat162float(v.y) * scale);
}

constexpr float kLog2e = 1.4426950408889634f;

// One online-softmax step on a warpgroup's 64 x kBK logits tile `s`
// (accumulator layout above): masks keys at or past `valid`, updates the
// running max m and denominator l of rows g and g + 8, returns the factor
// that rescales the accumulator, and leaves p rounded to bf16 in the A
// fragments pa[kc] of the P V product (one per 16 keys). exp(x) is
// ex2(x * log2 e): one FMA and one special-function op per logit.
template <int kBK>
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2], int valid, int t,
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             uint32_t (&pa)[kBK / 16][4]) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (valid < kBK) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i)
      if ((i / 4) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2((m[r] - m_new) * kLog2e);
    m[r] = m_new;
    ml[r] = m_new * kLog2e;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    s[i] = ex2(fmaf(s[i], kLog2e, -ml[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];  // the denominator sums the unrounded p
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int kc = 0; kc < kBK / 16; ++kc) {
    pa[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
    pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// ---- packed / streaming kernel: bf16, d in {40, 64, 80, 160} -------------
//
// A block of NWG warpgroups owns NWG x 64 query rows of one (batch, head)
// and walks K/V in tiles of BK keys through a ring of STAGES shared-memory
// stages. Every thread issues its share of a tile's cp.async requests and
// lets them arrive on the stage's `full` mbarrier; a warp that is done
// with a tile arrives on the stage's `empty` mbarrier. The warpgroups never
// meet at a block barrier inside the loop, so one runs its softmax while
// another multiplies. Each warpgroup keeps its q fragments (scaled, rounded
// to bf16), the logits of one tile and its 64 x D fp32 output in registers:
// S = Q K^T takes A from registers and K (K-major) from shared memory; the
// S accumulators, turned into p, are the A fragments of O += P V, which
// takes V MN-major as it was copied. O += P_i V_i and S_(i+1) go to the
// tensor cores as one wgmma group. d = 40 multiplies at depth 48: q's
// columns 40..47 are zero fragments and the K stages' sixth chunk slot is
// zeroed once and never written again.

template <int D, int BK, int STAGES>
struct WgTile {
  static constexpr int DP = (D + 15) / 16 * 16;
  static constexpr int KCH = DP / 8;  // chunk slots of a K row
  static constexpr int VCH = D / 8;   // chunks of a V row
  static constexpr int kKBytes = BK * KCH * 16;
  static constexpr int kVBytes = BK * VCH * 16;
  static constexpr int kStage = kKBytes + kVBytes;
  static constexpr size_t kBytes = (size_t)STAGES * kStage + 2 * STAGES * 8;
  static_assert(D % 8 == 0 && D <= 160 && BK % 16 == 0 && STAGES >= 2, "tile");
};

template <int D, int BK, int STAGES, int NWG>
__global__ void __launch_bounds__(NWG * 128, (D <= 64 && NWG == 2) ? 2 : 1)
attention_wgmma_kernel(Params p) {
  constexpr int kBlock = NWG * 128;
  using L = WgTile<D, BK, STAGES>;
  using bf16 = __nv_bfloat16;
  constexpr int kAhead = STAGES - 2;  // tiles requested ahead of the one multiplied
  constexpr int kItems = BK * L::VCH;  // 16-byte chunks of a K (or V) tile
  constexpr int NI = (kItems + kBlock - 1) / kBlock;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const uint32_t smem0 = smem_u32(wg_smem);
  const uint32_t full0 = smem0 + STAGES * L::kStage, empty0 = full0 + STAGES * 8;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int row0 = blockIdx.x * NWG * 64 + wg * 64 + warp * 16 + g;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int n_tiles = (p.s + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + st * 8, kBlock);  // every thread's copies of a tile
      mbar_init(empty0 + st * 8, kBlock / 32);  // every warp is done with it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (L::KCH != L::VCH) {  // the depth pad of the K stages, zeroed once
    for (int i = tid; i < STAGES * BK; i += kBlock) {
      const int st = i / BK, j = i % BK;
      *reinterpret_cast<uint4*>(wg_smem + st * L::kStage +
                                ((j / 8) * L::KCH + L::VCH) * 128 + (j % 8) * 16) =
          make_uint4(0, 0, 0, 0);
    }
    fence_async_proxy();
  }
  __syncthreads();  // the only block-wide barrier: from here on the warpgroups
                    // meet at the mbarriers alone

  // This thread's chunks of every tile: item i = tid + n * kBlock is
  // chunk c of local row rg * 8 + r8 (8 consecutive threads take the 8 rows
  // of one core matrix, 4 neighbouring groups of 8 read 64 contiguous bytes
  // of each row). Row and 32-bit element offsets are kept per item, so a
  // tile costs each item two adds and two cp.async.
  int item_row[NI], k_off[NI], v_off[NI];
  uint32_t k_dst[NI];
#pragma unroll
  for (int n = 0; n < NI; ++n) {
    const int i = tid + n * kBlock;
    const int r8 = i % 8, c = (i / 8) % L::VCH, rg = i / (8 * L::VCH);
    item_row[n] = rg * 8 + r8;
    k_off[n] = item_row[n] * (int)p.k_st + c * 8;
    v_off[n] = item_row[n] * (int)p.v_st + c * 8;
    k_dst[n] = ((rg * L::KCH + c) * 8 + r8) * 16;
  }
  auto issue = [&](int tile) {
    const uint32_t base = smem0 + (tile % STAGES) * L::kStage;
    const int left = p.s - tile * BK;  // rows of this tile that exist
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      if (NI * kBlock == kItems || tid + n * kBlock < kItems) {
        const bool live = item_row[n] < left;
        cp_async16(base + k_dst[n], k + (live ? k_off[n] : 0), live ? 16 : 0);
        cp_async16(base + L::kKBytes + (tid + n * kBlock) * 16,
                   v + (live ? v_off[n] : 0), live ? 16 : 0);
      }
      k_off[n] += BK * (int)p.k_st;
      v_off[n] += BK * (int)p.v_st;
    }
    mbar_arrive_after_copies(full0 + (tile % STAGES) * 8);
  };
  // tiles are requested in order, so the offsets advance one tile a call
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (j < n_tiles) issue(j);

  // q fragments straight from global memory: rows row0 and row0 + 8
  uint32_t qa[L::DP / 16][4];
#pragma unroll
  for (int ks = 0; ks < L::DP / 16; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e & 1), col = ks * 16 + 2 * t + 8 * (e >> 1);
      qa[ks][e] = (row < p.tq && col < D)
                      ? scale_bf16x2(ld32(q + (long long)row * p.q_st + col), p.scale)
                      : 0u;
    }
  }

  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // S_0, then per tile: softmax of S_i, then O += P_i V_i and S_(i+1) = Q
  // K_(i+1)^T in ONE wgmma group (P_i lives in its own fragments, so the
  // logits' registers are free for S_(i+1)): one round trip to the tensor
  // cores per tile instead of two.
  float s[BK / 2];
  auto issue_s = [&](int tile) {
    const uint32_t kb = smem0 + (tile % STAGES) * L::kStage;
#pragma unroll
    for (int ks = 0; ks < L::DP / 16; ++ks)
      wgmma_rs<0>(s, qa[ks], wgmma_desc(kb + ks * 256, 128, L::KCH * 128), ks > 0);
  };
  auto request = [&](int j) {  // tile j's stage held tile j - STAGES
    if (j < n_tiles) {
      if (j >= STAGES) mbar_wait(empty0 + (j % STAGES) * 8, (j / STAGES - 1) & 1);
      issue(j);
    }
  };
  request(kAhead);
  mbar_wait(full0, 0);
  fence_async_proxy();
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  wgmma_wait();

  for (int i = 0; i < n_tiles; ++i) {
    float alpha[2];
    uint32_t pa[BK / 16][4];
    softmax_tile<BK>(s, p.s - i * BK, t, m, l, alpha, pa);
#pragma unroll
    for (int n = 0; n < D / 2; ++n) acc[n] *= alpha[(n >> 1) & 1];
    request(i + 1 + kAhead);
    if (i + 1 < n_tiles) {
      mbar_wait(full0 + ((i + 1) % STAGES) * 8, ((i + 1) / STAGES) & 1);
      fence_async_proxy();
    }
    const uint32_t vb = smem0 + (i % STAGES) * L::kStage + L::kKBytes;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
      wgmma_rs<1>(acc, pa[kc], wgmma_desc(vb + kc * 2 * L::VCH * 128, L::VCH * 128, 128), 1);
    if (i + 1 < n_tiles) issue_s(i + 1);
    wgmma_commit();
    wgmma_wait();
    if (lane == 0) mbar_arrive(empty0 + (i % STAGES) * 8);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row's denominator is spread over a quad
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.tq) continue;
    bf16* orow = o + (long long)row * p.o_st;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) = __floats2bfloat162_rn(
          acc[4 * n + 2 * r] / l[r], acc[4 * n + 2 * r + 1] / l[r]);
  }
}

int sm_count() {
  static int count = 0;  // of the current device at first use
  if (count == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess)
      count = 132;
  }
  return count;
}

template <int D, int BK, int STAGES, int NWG>
cudaError_t launch_wgmma(const Params& p, int batch, cudaStream_t stream) {
  using L = WgTile<D, BK, STAGES>;
  // the kernel keeps 32-bit element offsets into a head's K and V
  if ((long long)p.s * (p.k_st > p.v_st ? p.k_st : p.v_st) >= (1LL << 31))
    return cudaErrorInvalidValue;
  auto kernel = attention_wgmma_kernel<D, BK, STAGES, NWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tq + NWG * 64 - 1) / (NWG * 64), batch * p.heads);
  kernel<<<grid, NWG * 128, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

// More warpgroups a block share each K/V tile among more query rows (less
// L2 traffic and fewer copy requests per row), as long as the wider blocks
// still cover every SM; NWIDE is bounded by the registers of one SM.
template <int D, int STAGES, int NWIDE>
cudaError_t launch_wgmma_blocks(const Params& p, int batch, cudaStream_t stream) {
  const long long wide = (long long)((p.tq + NWIDE * 64 - 1) / (NWIDE * 64)) *
                         batch * p.heads;
  if (NWIDE > 2 && wide >= sm_count())
    return launch_wgmma<D, 64, STAGES, NWIDE>(p, batch, stream);
  return launch_wgmma<D, 64, STAGES, 2>(p, batch, stream);
}

// ---- split kernel: bf16, d = 512 (the VAE mid-block, one head) -----------
//
// O for 64 query rows is 64 x 512 fp32 = 128 KB, more than one warpgroup's
// registers, so a block of two warpgroups splits O's columns: warpgroup w
// holds columns [256 w, 256 w + 256) as one m64n256 accumulator (128
// registers a thread). Q (scaled, rounded to bf16; 64 KB) stays in shared
// memory as the A operand of S = Q K^T; one K tile and one V tile of 64
// keys (64 KB each) complete the 192 KB. S (depth 512, 32 wgmma m64n64k16)
// is computed by BOTH warpgroups rather than once: exchanging p would cost
// two more block barriers and a shared-memory round trip per tile, while
// the tensor work (1.5x with the duplicate) is not what bounds the kernel.
// Each 64-row block re-reads all of K and V (Tq/64 x S x 2 KB) from L2, and
// that traffic is the bound; a 128-row tile would halve it but its O does
// not fit the register file. So p stays in registers (the A fragments of
// O += P V) and the warpgroups meet only at the barriers that publish and
// free the two tiles. The copies alternate: V_i is requested before S_i is
// multiplied and K_(i+1) as soon as S_i is done, so each copy runs under
// the other tile's product.

constexpr int kSplitThreads = 256;  // the split kernel's two warpgroups
constexpr int kSplitD = 512;
constexpr int kSplitCH = kSplitD / 8;  // 16-byte chunks per row
constexpr int kSplitBQ = 64, kSplitBK = 64;
constexpr int kSplitTile = 64 * kSplitCH * 16;  // bytes of Q, of a K and of a V tile
constexpr size_t kSplitBytes = 3 * (size_t)kSplitTile;

__global__ void __launch_bounds__(kSplitThreads, 1) attention_split512_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const uint32_t q_s = smem_u32(wg_smem), k_s = q_s + kSplitTile, v_s = k_s + kSplitTile;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * kSplitBQ;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int n_tiles = (p.s + kSplitBK - 1) / kSplitBK;

  stage_tile_async<kSplitBK, kSplitCH, kSplitThreads>(k_s, k, p.k_st, 0, p.s);
  cp_async_commit();

  // Q, scaled and rounded, into its core-matrix tile
  for (int i = tid; i < kSplitBQ * kSplitCH; i += kSplitThreads) {
    const int r8 = i % 8, c = (i / 8) % kSplitCH, rg = i / (8 * kSplitCH);
    const int row = q0 + rg * 8 + r8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row < p.tq) {
      raw = *reinterpret_cast<const uint4*>(q + (long long)row * p.q_st + c * 8);
      raw.x = scale_bf16x2(raw.x, p.scale);
      raw.y = scale_bf16x2(raw.y, p.scale);
      raw.z = scale_bf16x2(raw.z, p.scale);
      raw.w = scale_bf16x2(raw.w, p.scale);
    }
    *reinterpret_cast<uint4*>(wg_smem + ((rg * kSplitCH + c) * 8 + r8) * 16) = raw;
  }

  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.f, 0.f};
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    // every thread is past P V of tile i - 1: the V tile is free
    stage_tile_async<kSplitBK, kSplitCH, kSplitThreads>(v_s, v, p.v_st,
                                                              i * kSplitBK, p.s);
    cp_async_commit();
    cp_async_wait<1>();  // K_i (this thread's part); V_i may be in flight
    fence_async_proxy();
    __syncthreads();  // K_i (and, at i = 0, Q) is whole

    float s[kSplitBK / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSplitD / 16; ++ks)
      wgmma_ss(s, wgmma_desc(q_s + ks * 256, 128, kSplitCH * 128),
               wgmma_desc(k_s + ks * 256, 128, kSplitCH * 128), ks > 0);
    wgmma_commit();
    wgmma_wait();
    __syncthreads();  // both warpgroups are done with K_i
    if (i + 1 < n_tiles)
      stage_tile_async<kSplitBK, kSplitCH, kSplitThreads>(
          k_s, k, p.k_st, (i + 1) * kSplitBK, p.s);
    cp_async_commit();

    float alpha[2];
    uint32_t pa[kSplitBK / 16][4];
    softmax_tile<kSplitBK>(s, p.s - i * kSplitBK, t, m, l, alpha, pa);
#pragma unroll
    for (int j = 0; j < 128; ++j) acc[j] *= alpha[(j >> 1) & 1];

    cp_async_wait<1>();  // V_i; K_(i+1) may be in flight
    fence_async_proxy();
    __syncthreads();  // V_i is whole
    const uint32_t vb = v_s + wg * 32 * 128;  // this warpgroup's 256 columns
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kSplitBK / 16; ++kc)
      wgmma_rs<1>(acc, pa[kc], wgmma_desc(vb + kc * 2 * kSplitCH * 128, kSplitCH * 128, 128), 1);
    wgmma_commit();
    wgmma_wait();
    __syncthreads();  // both warpgroups are done with V_i
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.tq) continue;
    bf16* orow = o + (long long)row * p.o_st + wg * 256;
#pragma unroll
    for (int n = 0; n < 32; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) = __floats2bfloat162_rn(
          acc[4 * n + 2 * r] / l[r], acc[4 * n + 2 * r + 1] / l[r]);
  }
}

cudaError_t launch_split512(const Params& p, int batch, cudaStream_t stream) {
  auto kernel = attention_split512_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSplitBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tq + kSplitBQ - 1) / kSplitBQ, batch * p.heads);
  kernel<<<grid, kSplitThreads, kSplitBytes, stream>>>(p);
  return cudaGetLastError();
}

// The tensor-core variants read 16-byte vectors of q, k, v and write 4-byte
// pairs of o: every row start must be aligned to that.
bool vectors_aligned(const Params& p) {
  const long long in_strides[] = {p.q_sb, p.q_sh, p.q_st, p.k_sb, p.k_sh,
                                  p.k_st, p.v_sb, p.v_sh, p.v_st};
  for (long long s : in_strides)
    if (s % 8) return false;
  if ((p.o_sb | p.o_sh | p.o_st) % 2) return false;
  return (reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
          reinterpret_cast<uintptr_t>(p.v)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.o) % 4 == 0;
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  using L = Tile<D, BQ, BK>;
  auto kernel = attention_kernel<T, D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tq + BQ - 1) / BQ, batch * p.heads);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cuda_core(const Params& p, int head_dim, int batch,
                             cudaStream_t stream) {
  switch (head_dim) {
    case 40: return launch<T, 40, 64, 64>(p, batch, stream);
    case 64: return launch<T, 64, 64, 64>(p, batch, stream);
    case 80: return launch<T, 80, 64, 64>(p, batch, stream);
    case 160: return launch<T, 160, 64, 32>(p, batch, stream);
    case 512: return launch<T, 512, 32, 32>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The variant is the caller's choice (ops/kernels/attention.py:
// attention_variant); a variant that does not take these arguments is an
// error, never a silent switch to another one.
enum Variant { kCudaCore = 0, kWgmma = 1, kWgmmaSplit = 2 };

cudaError_t launch_variant(const Params& p, int dtype, int head_dim, int batch,
                           int variant, cudaStream_t stream) {
  if (variant == kCudaCore) {
    if (dtype == 0) return launch_cuda_core<float>(p, head_dim, batch, stream);
    if (dtype == 1) return launch_cuda_core<__nv_bfloat16>(p, head_dim, batch, stream);
    return cudaErrorInvalidValue;
  }
  if (dtype != 1 || !vectors_aligned(p)) return cudaErrorInvalidValue;
  if (variant == kWgmma) {
    switch (head_dim) {
      case 40: return launch_wgmma_blocks<40, 4, 4>(p, batch, stream);
      case 64: return launch_wgmma_blocks<64, 4, 2>(p, batch, stream);
      case 80: return launch_wgmma_blocks<80, 4, 3>(p, batch, stream);
      case 160: return launch_wgmma_blocks<160, 3, 2>(p, batch, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (variant == kWgmmaSplit && head_dim == kSplitD)
    return launch_split512(p, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. variant: a Variant code. Strides are in
// elements; the head dim of every tensor is contiguous. Returns a
// cudaError_t (0 = launched).
extern "C" int sdeo_attention_forward(
    const void* q, const void* k, const void* v, void* o, int dtype, int batch,
    int heads, int tq, int s, int head_dim, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long o_sb,
    long long o_sh, long long o_st, float scale, int variant,
    void* stream) {
  Params p{q, k, v, o, heads, tq, s,
           q_sb, q_sh, q_st, k_sb, k_sh, k_st,
           v_sb, v_sh, v_st, o_sb, o_sh, o_st, scale};
  return (int)launch_variant(p, dtype, head_dim, batch, variant,
                             static_cast<cudaStream_t>(stream));
}
