// Row LayerNorm for Hopper (sm_90a), behind
// stablediffusioneo_tpu_torch/ops/kernels/layernorm.py.
//
// Replaces the Pallas TPU kernel stablediffusioneo_tpu/ops/pallas/layernorm.py
// _ln_kernel (launched by _ln_call). Numerics follow it: fp32 sums of x and
// x^2 over the row in one pass; mean = S1 * inv_c, var = S2 * inv_c - mean^2,
// rstd = rsqrt(var + eps); y = (x - mean) * rstd * gamma + beta in fp32,
// rounded to x's dtype once. Every sum is taken in a fixed order (a thread's
// vectors in order, an xor butterfly, then the row's warps in order), so two
// runs give equal bytes.
//
// What bounds it: a few flops per element, so bytes; and at the UNet's sites
// (C = 320, 640, 1280; 0.7 to 21 MB a tensor) the time to get those bytes
// moving, since the smaller tensors are less than the card moves in a
// microsecond. The TPU kernel read a block of rows into VMEM once. Here:
//   - every access is a vector of `vec` elements, 16 bytes where C and the
//     pointers allow (8 bf16, 4 fp32), narrower otherwise;
//   - a row is held in registers between the sums and the normalisation:
//     global memory is read once, and all of a thread's loads (at most
//     kMaxVectors vectors) are issued before the first is used;
//   - `threads_per_row` threads share a row: a part of a warp (a power of
//     two, reduced by a butterfly inside the segment), one warp, or several
//     warps, whose partial sums meet in shared memory and are added in warp
//     order by every thread alike;
//   - a block runs `rows_par` rows side by side and walks `rows_block` rows
//     in all; gamma and beta are loaded once a block, into registers, since a
//     thread's columns do not change from row to row (loading them at each
//     use instead, or once a round, measured 0.1 to 1.2 us slower a call).
// A thread holds at most three vectors: the UNet's rows are 40, 80 and 160
// vectors, which 16, 32 and 64 threads hold in three each, and a fourth
// vector in registers made ptxas spill the 4-element instances.
// The plan (vec, threads_per_row, vectors a thread, rows_par, rows_block) is
// chosen by ops/kernels/layernorm.py: layer_norm_plan from the shape, so that
// every SM has work and no thread holds more than a few vectors; this file
// refuses a plan that does not fit the arguments. A row too long for the
// registers (vectors = 0) is walked twice instead, the second time through
// the caches. Measured times and bounds: PERF.md section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxVectors = 3;  // vectors of a row one thread holds at most

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float load(float x) { return x; }
  __device__ static float store(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
};

// VEC elements moved as one access (two of 16 bytes where VEC floats are 32)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC > 16 ? 16 : sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Sums over the `tpr` threads that share a row, returned to each of them.
// tpr <= 32: a power of two, the threads are neighbouring lanes of one warp.
// tpr > 32: a multiple of 32; the row's warps leave their sums in `part` and
// every thread adds them in warp order. Every thread of the block calls it.
__device__ __forceinline__ float2 row_sum(float2 v, int tpr, float2* part) {
  if (tpr <= 32) {
    for (int o = tpr >> 1; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    }
    return v;
  }
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  const int warp = threadIdx.x / 32, per_row = tpr / 32;
  if (threadIdx.x % 32 == 0) part[warp] = v;
  __syncthreads();
  const int first = warp / per_row * per_row;
  float2 s = make_float2(0.f, 0.f);
  for (int w = 0; w < per_row; ++w) {
    s.x += part[first + w].x;
    s.y += part[first + w].y;
  }
  __syncthreads();  // `part` is free for the block's next rows
  return s;
}

// Block b: rows [b * rows_block, (b + 1) * rows_block), blockDim.x / tpr of
// them at a time; thread t of a row holds vectors t, t + tpr, ... of it.
template <typename T, typename W, int VEC, int VPT>
__global__ void __launch_bounds__(kMaxThreads) ln_held_kernel(
    const T* __restrict__ x, const W* __restrict__ gamma, const W* __restrict__ beta,
    T* __restrict__ y, long long rows, int c, int tpr, int rows_block, float inv_c, float eps) {
  using P = Pack<T, VEC>;
  using PW = Pack<W, VEC>;
  __shared__ float2 part[kMaxThreads / 32];
  const int nvec = c / VEC, rows_par = blockDim.x / tpr;
  const int r = threadIdx.x / tpr, t = threadIdx.x - r * tpr;
  PW ga[VPT], be[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int col = t + j * tpr;
    if (col < nvec) {
      ga[j] = reinterpret_cast<const PW*>(gamma)[col];
      be[j] = reinterpret_cast<const PW*>(beta)[col];
    }
  }
  const long long row0 = (long long)blockIdx.x * rows_block;
#pragma unroll 1
  for (int it = 0; it < rows_block; it += rows_par) {  // the same trips for every thread
    const long long row = row0 + it + r;
    const bool live = row < rows;
    const P* xr = reinterpret_cast<const P*>(x + row * c);
    P v[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      if (live && t + j * tpr < nvec) v[j] = xr[t + j * tpr];
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (!(live && t + j * tpr < nvec)) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = Num<T>::load(v[j].v[e]);
        acc.x += f;
        acc.y += f * f;
      }
    }
    acc = row_sum(acc, tpr, part);
    const float mean = acc.x * inv_c;
    const float rstd = rsqrtf(acc.y * inv_c - mean * mean + eps);
    P* yr = reinterpret_cast<P*>(y + row * c);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (!(live && t + j * tpr < nvec)) continue;
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = (Num<T>::load(v[j].v[e]) - mean) * rstd;
        o.v[e] = Num<T>::store(f * Num<W>::load(ga[j].v[e]) + Num<W>::load(be[j].v[e]));
      }
      yr[t + j * tpr] = o;
    }
  }
}

// The same walk for a row too long to hold: the row is read for the sums and
// again (through the caches) for the normalisation.
template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(kMaxThreads) ln_twice_kernel(
    const T* __restrict__ x, const W* __restrict__ gamma, const W* __restrict__ beta,
    T* __restrict__ y, long long rows, int c, int tpr, int rows_block, float inv_c, float eps) {
  using P = Pack<T, VEC>;
  using PW = Pack<W, VEC>;
  __shared__ float2 part[kMaxThreads / 32];
  const int nvec = c / VEC, rows_par = blockDim.x / tpr;
  const int r = threadIdx.x / tpr, t = threadIdx.x - r * tpr;
  const long long row0 = (long long)blockIdx.x * rows_block;
#pragma unroll 1
  for (int it = 0; it < rows_block; it += rows_par) {
    const long long row = row0 + it + r;
    const bool live = row < rows;
    const P* xr = reinterpret_cast<const P*>(x + row * c);
    float2 acc = make_float2(0.f, 0.f);
    if (live) {
      for (int col = t; col < nvec; col += tpr) {
        const P v = xr[col];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = Num<T>::load(v.v[e]);
          acc.x += f;
          acc.y += f * f;
        }
      }
    }
    acc = row_sum(acc, tpr, part);
    const float mean = acc.x * inv_c;
    const float rstd = rsqrtf(acc.y * inv_c - mean * mean + eps);
    if (!live) continue;
    P* yr = reinterpret_cast<P*>(y + row * c);
    for (int col = t; col < nvec; col += tpr) {
      const P v = xr[col];
      const PW ga = reinterpret_cast<const PW*>(gamma)[col];
      const PW be = reinterpret_cast<const PW*>(beta)[col];
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = (Num<T>::load(v.v[e]) - mean) * rstd;
        o.v[e] = Num<T>::store(f * Num<W>::load(ga.v[e]) + Num<W>::load(be.v[e]));
      }
      yr[col] = o;
    }
  }
}

template <typename T, typename W, int VEC>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y, long long rows,
                   int c, int tpr, int vpt, int threads, int rows_block, float inv_c, float eps,
                   cudaStream_t st) {
  const unsigned blocks = (unsigned)((rows + rows_block - 1) / rows_block);
  auto run = [&](auto kernel) {
    kernel<<<blocks, threads, 0, st>>>(static_cast<const T*>(x), static_cast<const W*>(gamma),
                                       static_cast<const W*>(beta), static_cast<T*>(y), rows, c,
                                       tpr, rows_block, inv_c, eps);
    return cudaGetLastError();
  };
  switch (vpt) {
    case 0: return run(ln_twice_kernel<T, W, VEC>);
    case 1: return run(ln_held_kernel<T, W, VEC, 1>);
    case 2: return run(ln_held_kernel<T, W, VEC, 2>);
    case 3: return run(ln_held_kernel<T, W, VEC, 3>);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename W>
cudaError_t by_width(int vec, const void* x, const void* gamma, const void* beta, void* y,
                     long long rows, int c, int tpr, int vpt, int threads, int rows_block,
                     float inv_c, float eps, cudaStream_t st) {
  switch (vec) {
    case 1: return launch<T, W, 1>(x, gamma, beta, y, rows, c, tpr, vpt, threads, rows_block, inv_c, eps, st);
    case 2: return launch<T, W, 2>(x, gamma, beta, y, rows, c, tpr, vpt, threads, rows_block, inv_c, eps, st);
    case 4: return launch<T, W, 4>(x, gamma, beta, y, rows, c, tpr, vpt, threads, rows_block, inv_c, eps, st);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch<T, W, 8>(x, gamma, beta, y, rows, c, tpr, vpt, threads, rows_block, inv_c, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned_to(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// dtype, wdtype: 0 float32, 1 bfloat16 (of x/y and of gamma/beta). The plan
// is the caller's (ops/kernels/layernorm.py: layer_norm_plan): vec elements
// an access, threads_per_row threads a row (a power of two up to 32, or a
// multiple of 32), each holding at most `vectors` (1, 2 or 3) vectors of it
// (0: the row is read twice), rows_par rows side by side in a block, which
// takes rows_block rows in all. A plan that does not fit the arguments is an
// error.
extern "C" int sdeo_layer_norm(const void* x, const void* gamma, const void* beta, void* y,
                               int dtype, int wdtype, long long rows, int c, int vec,
                               int threads_per_row, int vectors, int rows_par, int rows_block,
                               float inv_c, float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int esize = dtype == 0 ? 4 : 2, wsize = wdtype == 0 ? 4 : 2;
  const int tpr = threads_per_row;
  if (rows < 1 || c < 1 || vec < 1 || c % vec || tpr < 1 || rows_par < 1 || rows_block < 1)
    return (int)cudaErrorInvalidValue;
  const bool sub_warp = tpr <= 32 && (tpr & (tpr - 1)) == 0;
  const long long threads = (long long)tpr * rows_par;
  if (!(sub_warp || tpr % 32 == 0) || threads > kMaxThreads || threads % 32 ||
      rows_block % rows_par || (rows + rows_block - 1) / rows_block > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (vectors != 0 && (long long)vectors * tpr * vec < c) return (int)cudaErrorInvalidValue;
  if (vec > 1) {
    const uintptr_t xa = (uintptr_t)vec * esize, wa = (uintptr_t)vec * wsize;
    if (!aligned_to(x, xa) || !aligned_to(y, xa) || !aligned_to(gamma, wa > 16 ? 16 : wa) ||
        !aligned_to(beta, wa > 16 ? 16 : wa))
      return (int)cudaErrorInvalidValue;
  }
  const int th = (int)threads;
  if (dtype == 0 && wdtype == 0)
    return (int)by_width<float, float>(vec, x, gamma, beta, y, rows, c, tpr, vectors, th, rows_block, inv_c, eps, st);
  if (dtype == 0 && wdtype == 1)
    return (int)by_width<float, bf16>(vec, x, gamma, beta, y, rows, c, tpr, vectors, th, rows_block, inv_c, eps, st);
  if (dtype == 1 && wdtype == 0)
    return (int)by_width<bf16, float>(vec, x, gamma, beta, y, rows, c, tpr, vectors, th, rows_block, inv_c, eps, st);
  if (dtype == 1 && wdtype == 1)
    return (int)by_width<bf16, bf16>(vec, x, gamma, beta, y, rows, c, tpr, vectors, th, rows_block, inv_c, eps, st);
  return (int)cudaErrorInvalidValue;
}
