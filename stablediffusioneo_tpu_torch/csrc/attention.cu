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
// All layouts reach this one kernel: the wrapper passes each tensor's batch,
// head and token strides (the head dim is contiguous), so packed and split
// differ only in the strides. The streaming kernel needs nothing of its own
// here: this kernel already walks K/V in tiles with the same online-softmax
// recurrence (running max from -1e30, one normalisation after AV), so its
// entry (fused_attention_packed_stream) launches the packed variant.
//
// Numerics follow the Pallas kernels: q is scaled and rounded to its own
// dtype; logits and softmax statistics are fp32; p is rounded to v's dtype
// before the AV product; AV accumulates in fp32 and the divide by the
// softmax denominator comes once, after AV.
//
// Schedule: one block per ((batch*head), q tile of BQ rows). K/V tiles of BK
// rows are staged through shared memory and folded in with the online
// softmax (running max from -1e30, running denominator, unnormalised fp32
// accumulator), so any key length works and a ragged last tile is masked
// (cross-attention has S = 77). The TPU kernel instead held the whole K/V
// slab in VMEM; a Hopper block has at most 227 KB of shared memory, so the
// K loop lives inside the block.
//
// What bounds it: at the 512x512 shapes (Tq = S = 4096, d = 40) attention is
// compute bound (about 4*Tq*S*d FLOPs per head against (Tq + 2*S)*d*2
// bytes), and the logits never reach device memory. Two variants:
//   - attention_mma_kernel (bf16, d a multiple of 8 up to 160: the UNet and
//     ControlNet sites): both products on the tensor cores with mma.sync
//     m16n8k16, p kept in registers. Its remaining limits are the exp of
//     every logit on the special-function units and the K/V staging through
//     registers; wgmma with TMA-fed tiles is the next step.
//   - attention_kernel (fp32, for exact checks, and d = 512, the VAE
//     mid-block site): fp32 FMAs on the CUDA cores from an RQ x RK register
//     tile per thread, bounded by shared-memory loads per FMA. d = 512 needs
//     a smaller q tile (its fp32 accumulator is 2 KB per query row) and more
//     than 48 KB of dynamic shared memory.
// At S = 16384 (kernel #3's sites: Tq = S = 16384, 8 heads, d = 40) shared
// memory and registers are what they are at S = 4096, since only one K/V
// tile is resident; the key length costs time alone. The grid is 256 q tiles
// x 16 (batch*head) = 4096 blocks, each walking 256 K/V tiles, so K/V (2.6 MB
// per head) is re-read from L2 by every q tile of its head, about 10.7 GB per
// call; with the staging not overlapped with the mma, that re-read and the
// d = 40 -> 48 padding of the mma K step bound it, not the exp count.
// The split variant at the 1024x1024 VAE mid-block (S = 16384, d = 512)
// scales as S^2 on the CUDA cores and is its slowest use.
// Head dims compiled: 40, 64, 80, 160 and 512.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// Tensor-core variant: bf16, head dims that are multiples of 8 up to 160.
//
// Same numerics and schedule, with both products on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate). A block of 4 warps owns
// 64 query rows, 16 per warp. Q (scaled, rounded to bf16) and the K tile
// sit in shared memory row-major, the V tile transposed, each row padded so
// that the 32-bit fragment loads of a warp hit 32 distinct banks. A warp
// keeps its logits S (16 x 64) and output accumulator O (16 x DP) in
// registers: the S accumulator fragments are exactly the A fragments of
// the p @ V product, so p never leaves registers. The head dim is padded to
// DP (a multiple of 16) with zeros in shared memory.

constexpr int kMmaWarps = 4;
constexpr int kMmaBQ = 16 * kMmaWarps;  // query rows per block
constexpr int kMmaBK = 64;              // keys per tile

template <int D>
struct MmaTile {
  static constexpr int DP = (D + 15) / 16 * 16;
  static constexpr int QS = DP + 8;      // q_s / k_s row stride (bf16)
  static constexpr int VS = kMmaBK + 8;  // vt_s row stride (bf16)
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * (kMmaBQ * QS + kMmaBK * QS + DP * VS);
  static_assert(D % 8 == 0 && D <= 160, "tensor-core path: D % 8 == 0, D <= 160");
};

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [r0, r0 + rows) of a (tokens, D) bf16 slice with token stride
// `st` into shared memory, 8 elements (16 bytes) per load; rows at or past
// `n` and columns D..DP are zero. transpose: dst[col][row] with row stride
// `ds`, else dst[row][col].
template <int D, int DP, bool kTranspose>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ds,
                                           const __nv_bfloat16* src,
                                           long long st, int r0, int rows,
                                           int n, float scale, bool scaled) {
  constexpr int kVec = DP / 8;
  for (int i = threadIdx.x; i < rows * kVec; i += kMmaWarps * 32) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (c < D && r0 + r < n) {
      raw = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * st + c);
      if (scaled) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * scale);
      }
    }
    if (kTranspose) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(c + j) * ds + r] = e[j];
    } else {
      *reinterpret_cast<uint4*>(dst + r * ds + c) = raw;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32) attention_mma_kernel(Params p) {
  using L = MmaTile<D>;
  constexpr int DP = L::DP, QS = L::QS, VS = L::VS;
  constexpr int NS = kMmaBK / 8;  // S column tiles of 8 keys
  constexpr int NO = DP / 8;      // O column tiles of 8 dims
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][QS]
  __nv_bfloat16* k_s = q_s + kMmaBQ * QS;                            // [BK][QS]
  __nv_bfloat16* vt_s = k_s + kMmaBK * QS;                           // [DP][VS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * kMmaBQ;
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  stage_rows<D, DP, false>(q_s, QS, q, p.q_st, q0, kMmaBQ, p.tq, p.scale, true);
  __syncthreads();
  uint32_t qa[DP / 16][4];  // A fragments of this warp's 16 query rows
  const bf16* qw = q_s + (warp * 16) * QS;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    qa[ks][0] = ld32(qw + g * QS + ks * 16 + 2 * t);
    qa[ks][1] = ld32(qw + (g + 8) * QS + ks * 16 + 2 * t);
    qa[ks][2] = ld32(qw + g * QS + ks * 16 + 2 * t + 8);
    qa[ks][3] = ld32(qw + (g + 8) * QS + ks * 16 + 2 * t + 8);
  }

  float m[2] = {-1e30f, -1e30f};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};        // running denominators (this thread's part)
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < p.s; k0 += kMmaBK) {
    __syncthreads();  // the previous tile's K and V are no longer read
    stage_rows<D, DP, false>(k_s, QS, k, p.k_st, k0, kMmaBK, p.s, 0.f, false);
    stage_rows<D, DP, true>(vt_s, VS, v, p.v_st, k0, kMmaBK, p.s, 0.f, false);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const bf16* kr = k_s + (n * 8 + g) * QS + 2 * t;
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        mma_16816(s[n], qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
    }
    // mask the ragged last tile, then the online softmax of rows g, g + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + n * 8 + 2 * t + (e & 1) >= p.s) s[n][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];  // the denominator sums the unrounded p
      }
    }
    // O += p @ V over the tile's 4 chunks of 16 keys; p rounds to bf16
#pragma unroll
    for (int kc = 0; kc < kMmaBK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const bf16* vr = vt_s + (n * 8 + g) * VS + kc * 16 + 2 * t;
        mma_16816(acc[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  // each row's denominator is spread over the 4 threads of a quad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.tq) continue;
    bf16* orow = o + (long long)row * p.o_st;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            acc[n][2 * r] / l[r], acc[n][2 * r + 1] / l[r]);
    }
  }
}

template <int D>
cudaError_t launch_mma(const Params& p, int batch, cudaStream_t stream) {
  using L = MmaTile<D>;
  auto kernel = attention_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tq + kMmaBQ - 1) / kMmaBQ, batch * p.heads);
  kernel<<<grid, kMmaWarps * 32, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

// The tensor-core path reads 16-byte vectors of q, k, v and writes 4-byte
// pairs of o: every row start must be aligned to that.
bool mma_aligned(const Params& p) {
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
cudaError_t launch_head_dim(const Params& p, int head_dim, int batch,
                            cudaStream_t stream) {
  if (sizeof(T) == 2 && mma_aligned(p)) {  // bf16: tensor cores
    switch (head_dim) {
      case 40: return launch_mma<40>(p, batch, stream);
      case 64: return launch_mma<64>(p, batch, stream);
      case 80: return launch_mma<80>(p, batch, stream);
      case 160: return launch_mma<160>(p, batch, stream);
      default: break;  // d = 512: CUDA cores below
    }
  }
  switch (head_dim) {
    case 40: return launch<T, 40, 64, 64>(p, batch, stream);
    case 64: return launch<T, 64, 64, 64>(p, batch, stream);
    case 80: return launch<T, 80, 64, 64>(p, batch, stream);
    case 160: return launch<T, 160, 64, 32>(p, batch, stream);
    case 512: return launch<T, 512, 32, 32>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head dim
// of every tensor is contiguous. Returns a cudaError_t (0 = launched).
extern "C" int sdeo_attention_forward(
    const void* q, const void* k, const void* v, void* o, int dtype, int batch,
    int heads, int tq, int s, int head_dim, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long o_sb,
    long long o_sh, long long o_st, float scale, void* stream) {
  Params p{q, k, v, o, heads, tq, s,
           q_sb, q_sh, q_st, k_sb, k_sh, k_st,
           v_sb, v_sh, v_st, o_sb, o_sh, o_st, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_head_dim<float>(p, head_dim, batch, st);
  if (dtype == 1) return (int)launch_head_dim<__nv_bfloat16>(p, head_dim, batch, st);
  return (int)cudaErrorInvalidValue;
}
