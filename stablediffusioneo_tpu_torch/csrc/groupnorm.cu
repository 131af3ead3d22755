// GroupNorm(+SiLU) for Hopper (sm_90a): the three kernels behind
// stablediffusioneo_tpu_torch/ops/kernels/groupnorm.py.
//
// Replaces the Pallas TPU kernels of stablediffusioneo_tpu/ops/pallas/groupnorm.py:
//   gn_fused_kernel <- _gn_fused_kernel and _gn_resident_kernel (one read of
//                      the slab, stats, normalize, affine, SiLU, one write)
//   gn_stats_kernel <- _gn_stats_kernel (pass 1 for larger slabs: fp32
//                      partial sums per spatial chunk)
//   gn_apply_kernel <- _gn_apply_kernel (pass 2: normalize, affine, SiLU
//                      from the reduced partials)
//
// Numerics follow the Pallas bodies: fp32 sums of x and x^2 in one pass;
// mean = S1 * inv_count, var = S2 * inv_count - mean^2,
// rstd = rsqrt(var + eps); y = (x - mean) * rstd * gamma + beta in fp32,
// then y * sigmoid(y) when swish, rounded to x's dtype once. Every sum is
// reduced in a fixed order (no atomics), so two runs give equal bytes.
//
// Layout: the TPU kernels take NHWC. The port's networks hold NCHW tensors
// in channels-last memory (the same bytes as NHWC); plain NCHW memory is
// taken too. The elements of one (sample, group) over the spatial rows
// [p0, p0 + rows) are visited by an index k whose neighbours are neighbours
// in memory: channels-last k -> (row k / cg, channel k % cg), NCHW
// k -> (channel k / rows, row k % rows).
//
// What bounds it: a few flops per element, so memory traffic. The TPU
// kernel held the whole per-sample slab in VMEM. Here the fused kernel runs
// one block per (sample, group): it reduces the group, then reads it again
// to normalize. Under the dispatch gate a group holds at most
// 1,703,936 / groups elements (213 KB in fp32 at 32 groups), so the second
// read comes from the 50 MB L2 and device memory sees one read and one
// write. The two-pass kernels split each group into spatial chunks, one
// block each, so the large slabs they take spread over the whole card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <type_traits>

namespace {

constexpr int kFusedThreads = 1024;
constexpr int kChunkThreads = 256;

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

__device__ __forceinline__ float2 warp_sum(float2 v) {
  // xor butterfly: every lane ends with the same bits
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// Sum over the block, returned to every thread. Called once per kernel.
__device__ float2 block_sum(float2 v) {
  __shared__ float2 red[32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x / 32) ? red[lane] : make_float2(0.f, 0.f));
}

struct Slab {
  long long base;  // offset of (sample n, channel g*cg, row 0)
  int g, cg, hw, c;
};

template <bool CL>
__device__ __forceinline__ Slab slab_of(int ng, int c, int hw, int groups) {
  const int n = ng / groups, g = ng % groups, cg = c / groups;
  return {(long long)n * c * hw + (long long)g * cg * (CL ? 1 : hw), g, cg, hw, c};
}

// Offset (from s.base) and channel-in-group of element k of rows [p0, p0 + rows).
template <bool CL>
__device__ __forceinline__ long long element(const Slab& s, int k, int p0, int rows, int& ci) {
  if (CL) {
    const int r = k / s.cg;
    ci = k - r * s.cg;
    return (long long)(p0 + r) * s.c + ci;
  }
  ci = k / rows;
  return (long long)ci * s.hw + p0 + (k - ci * rows);
}

template <typename T, bool CL>
__device__ float2 sum_rows(const T* __restrict__ x, const Slab& s, int p0, int rows) {
  float2 acc = make_float2(0.f, 0.f);
  const int count = s.cg * rows;
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    int ci;
    const float v = Num<T>::load(x[s.base + element<CL>(s, k, p0, rows, ci)]);
    acc.x += v;
    acc.y += v * v;
  }
  return block_sum(acc);
}

__device__ __forceinline__ float2 mean_rstd(float s1, float s2, float inv_count, float eps) {
  const float mean = s1 * inv_count;
  const float var = s2 * inv_count - mean * mean;
  return make_float2(mean, rsqrtf(var + eps));
}

template <typename T, typename W, bool CL>
__device__ void normalize_rows(const T* __restrict__ x, const W* __restrict__ gamma,
                               const W* __restrict__ beta, T* __restrict__ y,
                               const Slab& s, int p0, int rows, float2 stats, int swish) {
  const int count = s.cg * rows;
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    int ci;
    const long long off = s.base + element<CL>(s, k, p0, rows, ci);
    const int ch = s.g * s.cg + ci;
    float v = (Num<T>::load(x[off]) - stats.x) * stats.y;
    v = v * Num<W>::load(gamma[ch]) + Num<W>::load(beta[ch]);
    if (swish) v = v * (1.f / (1.f + expf(-v)));
    y[off] = Num<T>::store(v);
  }
}

// One block per (sample, group): the whole group, one pass of stats.
template <typename T, typename W, bool CL>
__global__ void __launch_bounds__(kFusedThreads) gn_fused_kernel(
    const T* __restrict__ x, const W* __restrict__ gamma, const W* __restrict__ beta,
    T* __restrict__ y, int c, int hw, int groups, float inv_count, float eps, int swish) {
  const Slab s = slab_of<CL>(blockIdx.x, c, hw, groups);
  const float2 sums = sum_rows<T, CL>(x, s, 0, hw);
  normalize_rows<T, W, CL>(x, gamma, beta, y, s, 0, hw,
                           mean_rstd(sums.x, sums.y, inv_count, eps), swish);
}

// Block (sample*group, chunk): the group's sums over chunk rows -> partials
// laid out (N, G, chunks, 2).
template <typename T, bool CL>
__global__ void __launch_bounds__(kChunkThreads) gn_stats_kernel(
    const T* __restrict__ x, float* __restrict__ partials, int c, int hw, int groups,
    int chunk_rows) {
  const Slab s = slab_of<CL>(blockIdx.x, c, hw, groups);
  const int p0 = blockIdx.y * chunk_rows;
  const float2 sums = sum_rows<T, CL>(x, s, p0, min(chunk_rows, hw - p0));
  if (threadIdx.x == 0) {
    float* out = partials + ((long long)blockIdx.x * gridDim.y + blockIdx.y) * 2;
    out[0] = sums.x;
    out[1] = sums.y;
  }
}

// Block (sample*group, chunk): sum the group's partials in chunk order (every
// thread alike), then normalize the chunk.
template <typename T, typename W, bool CL>
__global__ void __launch_bounds__(kChunkThreads) gn_apply_kernel(
    const T* __restrict__ x, const float* __restrict__ partials, const W* __restrict__ gamma,
    const W* __restrict__ beta, T* __restrict__ y, int c, int hw, int groups, int chunk_rows,
    float inv_count, float eps, int swish) {
  const Slab s = slab_of<CL>(blockIdx.x, c, hw, groups);
  const float* part = partials + (long long)blockIdx.x * gridDim.y * 2;
  float s1 = 0.f, s2 = 0.f;
  for (int j = 0; j < (int)gridDim.y; ++j) {
    s1 += part[2 * j];
    s2 += part[2 * j + 1];
  }
  const int p0 = blockIdx.y * chunk_rows;
  normalize_rows<T, W, CL>(x, gamma, beta, y, s, p0, min(chunk_rows, hw - p0),
                           mean_rstd(s1, s2, inv_count, eps), swish);
}

// Calls f(T*, W*) with null pointers of the element types named by the
// dtype codes (0 float32, 1 bfloat16).
template <typename F>
cudaError_t by_types(int dtype, int wdtype, F&& f) {
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && wdtype == 0) return f((float*)nullptr, (float*)nullptr);
  if (dtype == 0 && wdtype == 1) return f((float*)nullptr, (bf16*)nullptr);
  if (dtype == 1 && wdtype == 0) return f((bf16*)nullptr, (float*)nullptr);
  if (dtype == 1 && wdtype == 1) return f((bf16*)nullptr, (bf16*)nullptr);
  return cudaErrorInvalidValue;
}

template <typename P>
using elem_t = std::remove_pointer_t<P>;

}  // namespace

extern "C" int sdeo_group_norm_fused(const void* x, const void* gamma, const void* beta,
                                     void* y, int dtype, int wdtype, int channels_last,
                                     int n, int c, int hw, int groups, float inv_count,
                                     float eps, int swish, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n * groups);
  return (int)by_types(dtype, wdtype, [&](auto tp, auto wp) {
    using T = elem_t<decltype(tp)>;
    using W = elem_t<decltype(wp)>;
    auto kernel = channels_last ? gn_fused_kernel<T, W, true> : gn_fused_kernel<T, W, false>;
    kernel<<<grid, kFusedThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const W*>(gamma), static_cast<const W*>(beta),
        static_cast<T*>(y), c, hw, groups, inv_count, eps, swish);
    return cudaGetLastError();
  });
}

extern "C" int sdeo_group_norm_stats(const void* x, float* partials, int dtype,
                                     int channels_last, int n, int c, int hw, int groups,
                                     int chunk_rows, int chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n * groups, chunks);
  return (int)by_types(dtype, 0, [&](auto tp, auto) {
    using T = elem_t<decltype(tp)>;
    auto kernel = channels_last ? gn_stats_kernel<T, true> : gn_stats_kernel<T, false>;
    kernel<<<grid, kChunkThreads, 0, st>>>(static_cast<const T*>(x), partials, c, hw,
                                           groups, chunk_rows);
    return cudaGetLastError();
  });
}

extern "C" int sdeo_group_norm_apply(const void* x, const float* partials, const void* gamma,
                                     const void* beta, void* y, int dtype, int wdtype,
                                     int channels_last, int n, int c, int hw, int groups,
                                     int chunk_rows, int chunks, float inv_count, float eps,
                                     int swish, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n * groups, chunks);
  return (int)by_types(dtype, wdtype, [&](auto tp, auto wp) {
    using T = elem_t<decltype(tp)>;
    using W = elem_t<decltype(wp)>;
    auto kernel = channels_last ? gn_apply_kernel<T, W, true> : gn_apply_kernel<T, W, false>;
    kernel<<<grid, kChunkThreads, 0, st>>>(
        static_cast<const T*>(x), partials, static_cast<const W*>(gamma),
        static_cast<const W*>(beta), static_cast<T*>(y), c, hw, groups, chunk_rows,
        inv_count, eps, swish);
    return cudaGetLastError();
  });
}
