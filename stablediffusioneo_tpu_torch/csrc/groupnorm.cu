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
// [p0, p0 + rows) are `runs` runs of `run_len` contiguous elements at a
// fixed pitch (`Span`): in channels-last memory one run of C / groups
// channels per row at a pitch of C, in NCHW memory one run of `rows`
// elements per channel at a pitch of H W.
//
// What bounds it: a few flops per element, so bytes; and at the SD-1.5 sites
// (batch 2, 32 groups, 0.3 to 5 MB a tensor) the time to get those bytes
// moving: a slab is small against what the card moves in a microsecond, so
// the kernel is as fast as it has blocks and loads in flight. The TPU kernel
// held the whole per-sample slab in VMEM on one core. Here:
//   - the fused kernel spreads each (sample, group) over the blocks of a
//     thread block cluster (1 to 8, chosen with the access width by
//     ops/kernels/groupnorm.py: group_norm_plan; at batch 2 x 32 groups two
//     blocks a group, 128 in all, measured fastest from four accesses a
//     thread up, one block below, and a larger cluster costs more to
//     schedule and to synchronise than its blocks bring). A block sums its
//     rows while it copies them into shared memory, the blocks exchange
//     their two partial sums through distributed shared memory and add them
//     in rank order, and each normalises its rows from shared memory: global
//     memory is read once and written once. A slab too large for the
//     cluster's shared memory is read again instead (keep = 0);
//   - a thread has four loads in flight before it uses the first;
//   - every access is a vector of `vec` elements (up to 16 bytes), as wide
//     as the run length, the pitch and the pointers allow: in channels-last
//     memory a group's run is 20 bytes at C = 320, so 4 bytes there, 8 at
//     C = 640, 16 at C = 1280;
//   - a thread walks its vectors with a carried (run, position) pair: no
//     integer division in the loops.
// The two-pass kernels split each group into spatial chunks, one block each,
// and share the loops. Measured times and bounds: PERF.md section 6.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kFusedThreads = 512;
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

// VEC elements moved as one access of sizeof(T) * VEC bytes
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
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

// The elements of one (sample, group) over the spatial rows [p0, p0 + rows).
struct Span {
  long long base;   // offset of the first element
  long long pitch;  // from one run to the next
  int runs, run_len;
  int ch0;          // first channel of the group
};

template <bool CL>
__device__ __forceinline__ Span span_of(int ng, int c, int hw, int groups, int p0, int rows) {
  const int n = ng / groups, g = ng % groups, cpg = c / groups;
  const long long sample = (long long)n * c * hw;
  if (rows < 0) rows = 0;
  if (CL) return {sample + (long long)p0 * c + g * cpg, c, rows, cpg, g * cpg};
  return {sample + (long long)g * cpg * hw + p0, hw, cpg, rows, g * cpg};
}

// A thread's walk over the span's vectors: vector k = threadIdx.x + j *
// blockDim.x is vector i of run r. The pair is carried from one vector to
// the next, so the loops divide once.
struct Walk {
  int k, r, i;
  int per_run, count, dq, dr;
  __device__ __forceinline__ Walk(const Span& s, int vec) {
    per_run = s.run_len / vec;
    count = s.runs * per_run;
    k = threadIdx.x;
    r = per_run ? k / per_run : 0;
    i = k - r * per_run;
    dq = per_run ? blockDim.x / per_run : 0;
    dr = blockDim.x - dq * per_run;
  }
  __device__ __forceinline__ bool live() const { return k < count; }
  __device__ __forceinline__ void next() {
    k += blockDim.x;
    r += dq;
    i += dr;
    if (i >= per_run) {
      i -= per_run;
      ++r;
    }
  }
};

constexpr int kBatch = 4;  // loads a thread has in flight before it uses them (8 was no faster)

// Sums of x and x^2 over the span, returned to every thread; keep: the
// vectors are also left in `slab`, vector k at index k.
template <typename T, int VEC>
__device__ float2 sum_span(const T* __restrict__ x, const Span& s, Pack<T, VEC>* slab,
                           bool keep) {
  using P = Pack<T, VEC>;
  float2 acc = make_float2(0.f, 0.f);
  Walk w(s, VEC);
  while (w.live()) {
    P v[kBatch];
    int k[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      k[j] = w.live() ? w.k : -1;
      if (k[j] >= 0) v[j] = *reinterpret_cast<const P*>(x + s.base + w.r * s.pitch + w.i * VEC);
      w.next();
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (k[j] < 0) continue;
      if (keep) slab[k[j]] = v[j];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = Num<T>::load(v[j].v[e]);
        acc.x += f;
        acc.y += f * f;
      }
    }
  }
  return block_sum(acc);
}

__device__ __forceinline__ float2 mean_rstd(float s1, float s2, float inv_count, float eps) {
  const float mean = s1 * inv_count;
  const float var = s2 * inv_count - mean * mean;
  return make_float2(mean, rsqrtf(var + eps));
}

// Normalise, affine and SiLU over the span; keep: x comes from `slab` as
// sum_span left it (each thread reads back the vectors it wrote).
template <typename T, typename W, bool CL, int VEC>
__device__ void normalize_span(const T* __restrict__ x, const W* __restrict__ gamma,
                               const W* __restrict__ beta, T* __restrict__ y, const Span& s,
                               const Pack<T, VEC>* slab, bool keep, float2 stats, int swish) {
  using P = Pack<T, VEC>;
  Walk w(s, VEC);
  while (w.live()) {
    P v[kBatch];
    long long off[kBatch];
    int ch[kBatch];  // the vector's first channel (channels-last) or its run's (NCHW)
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      off[j] = w.live() ? s.base + w.r * s.pitch + w.i * VEC : -1;
      ch[j] = s.ch0 + (CL ? w.i * VEC : w.r);
      if (off[j] >= 0) v[j] = keep ? slab[w.k] : *reinterpret_cast<const P*>(x + off[j]);
      w.next();
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (off[j] < 0) continue;
      // channels-last: the vector's channels are contiguous in gamma and
      // beta; NCHW: the run is one channel
      Pack<W, VEC> ga, be;
      if (CL) {
        ga = *reinterpret_cast<const Pack<W, VEC>*>(gamma + ch[j]);
        be = *reinterpret_cast<const Pack<W, VEC>*>(beta + ch[j]);
      } else {
        ga.v[0] = gamma[ch[j]];
        be.v[0] = beta[ch[j]];
      }
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float f = (Num<T>::load(v[j].v[e]) - stats.x) * stats.y;
        f = f * Num<W>::load(ga.v[CL ? e : 0]) + Num<W>::load(be.v[CL ? e : 0]);
        if (swish) f = f * (1.f / (1.f + expf(-f)));
        o.v[e] = Num<T>::store(f);
      }
      *reinterpret_cast<P*>(y + off[j]) = o;
    }
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Block (sample*group, rank) of a cluster (1, S, 1): rows [rank * rows_per_block,
// ...) of the group. One pass of stats over the cluster, then normalise.
template <typename T, typename W, bool CL, int VEC>
__global__ void __launch_bounds__(kFusedThreads) gn_fused_kernel(
    const T* __restrict__ x, const W* __restrict__ gamma, const W* __restrict__ beta,
    T* __restrict__ y, int c, int hw, int groups, int rows_per_block, int keep,
    float inv_count, float eps, int swish) {
  extern __shared__ __align__(16) unsigned char gn_slab[];
  __shared__ float2 part;  // this block's sums, read by the whole cluster
  Pack<T, VEC>* slab = reinterpret_cast<Pack<T, VEC>*>(gn_slab);
  const int p0 = blockIdx.y * rows_per_block;
  const Span s = span_of<CL>(blockIdx.x, c, hw, groups, p0, min(rows_per_block, hw - p0));
  const float2 sums = sum_span<T, VEC>(x, s, slab, keep);
  if (gridDim.y == 1) {  // the whole group: no exchange, no cluster barrier
    normalize_span<T, W, CL, VEC>(x, gamma, beta, y, s, slab, keep,
                                  mean_rstd(sums.x, sums.y, inv_count, eps), swish);
    return;
  }
  if (threadIdx.x == 0) part = sums;
  cluster_arrive();
  cluster_wait();  // every block's sums are written
  cg::cluster_group cluster = cg::this_cluster();
  float s1 = 0.f, s2 = 0.f;
  for (unsigned b = 0; b < cluster.num_blocks(); ++b) {  // rank order, every thread alike
    const float2 q = *cluster.map_shared_rank(&part, b);
    s1 += q.x;
    s2 += q.y;
  }
  cluster_arrive();  // this block has read the others' sums
  normalize_span<T, W, CL, VEC>(x, gamma, beta, y, s, slab, keep,
                                mean_rstd(s1, s2, inv_count, eps), swish);
  cluster_wait();  // no block leaves while its sums may still be read
}

// Block (sample*group, chunk): the group's sums over chunk rows -> partials
// laid out (N, G, chunks, 2).
template <typename T, bool CL, int VEC>
__global__ void __launch_bounds__(kChunkThreads) gn_stats_kernel(
    const T* __restrict__ x, float* __restrict__ partials, int c, int hw, int groups,
    int chunk_rows) {
  const int p0 = blockIdx.y * chunk_rows;
  const Span s = span_of<CL>(blockIdx.x, c, hw, groups, p0, min(chunk_rows, hw - p0));
  const float2 sums = sum_span<T, VEC>(x, s, nullptr, false);
  if (threadIdx.x == 0) {
    float* out = partials + ((long long)blockIdx.x * gridDim.y + blockIdx.y) * 2;
    out[0] = sums.x;
    out[1] = sums.y;
  }
}

// Block (sample*group, chunk): sum the group's partials in chunk order (every
// thread alike), then normalize the chunk.
template <typename T, typename W, bool CL, int VEC>
__global__ void __launch_bounds__(kChunkThreads) gn_apply_kernel(
    const T* __restrict__ x, const float* __restrict__ partials, const W* __restrict__ gamma,
    const W* __restrict__ beta, T* __restrict__ y, int c, int hw, int groups, int chunk_rows,
    float inv_count, float eps, int swish) {
  const float* part = partials + (long long)blockIdx.x * gridDim.y * 2;
  float s1 = 0.f, s2 = 0.f;
  for (int j = 0; j < (int)gridDim.y; ++j) {
    s1 += part[2 * j];
    s2 += part[2 * j + 1];
  }
  const int p0 = blockIdx.y * chunk_rows;
  const Span s = span_of<CL>(blockIdx.x, c, hw, groups, p0, min(chunk_rows, hw - p0));
  normalize_span<T, W, CL, VEC>(x, gamma, beta, y, s, nullptr, false,
                                mean_rstd(s1, s2, inv_count, eps), swish);
}

template <int V>
using vec_c = std::integral_constant<int, V>;

// Calls f(T*, W*, vec_c<VEC>) with null pointers of the element types named
// by the dtype codes (0 float32, 1 bfloat16) and the vector width; a width
// beyond 16 bytes is an error.
template <typename F>
cudaError_t by_types(int dtype, int wdtype, int vec, F&& f) {
  using bf16 = __nv_bfloat16;
  auto widths = [&](auto tp, auto wp) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tp)>;
    switch (vec) {
      case 1: return f(tp, wp, vec_c<1>());
      case 2: return f(tp, wp, vec_c<2>());
      case 4: return f(tp, wp, vec_c<4>());
      case 8:
        if constexpr (sizeof(T) == 2) return f(tp, wp, vec_c<8>());
      default: return cudaErrorInvalidValue;
    }
  };
  if (dtype == 0 && wdtype == 0) return widths((float*)nullptr, (float*)nullptr);
  if (dtype == 0 && wdtype == 1) return widths((float*)nullptr, (bf16*)nullptr);
  if (dtype == 1 && wdtype == 0) return widths((bf16*)nullptr, (float*)nullptr);
  if (dtype == 1 && wdtype == 1) return widths((bf16*)nullptr, (bf16*)nullptr);
  return cudaErrorInvalidValue;
}

template <typename P>
using elem_t = std::remove_pointer_t<P>;

// Whether vectors of `vec` elements place every run of the spans: they
// divide the run length and the pitch, and the pointers are aligned to them.
// rows: the spatial rows per block (chunk or cluster share).
bool vectors_fit(int vec, int elem_size, int channels_last, int c, int hw, int groups, int rows,
                 const void* x, const void* y) {
  if (vec == 1) return true;
  const int run_unit = channels_last ? c / groups : rows;
  if (run_unit % vec || (channels_last ? 0 : hw % vec)) return false;
  const uintptr_t bytes = (uintptr_t)vec * elem_size;
  return reinterpret_cast<uintptr_t>(x) % bytes == 0 && reinterpret_cast<uintptr_t>(y) % bytes == 0;
}

bool affine_fits(int vec, int wsize, int channels_last, const void* gamma, const void* beta) {
  if (vec == 1 || !channels_last) return true;  // NCHW reads one gamma a run
  const uintptr_t bytes = (uintptr_t)vec * wsize;
  return reinterpret_cast<uintptr_t>(gamma) % bytes == 0 &&
         reinterpret_cast<uintptr_t>(beta) % bytes == 0;
}

constexpr int kMaxSlabBytes = 232448 - 1024;  // dynamic shared memory beside the static

}  // namespace

// vec: elements per access; cluster: blocks that share a (sample, group), each
// taking rows_per_block spatial rows; keep: a block's rows stay in shared
// memory between the two passes. The plan is the caller's
// (ops/kernels/groupnorm.py: group_norm_plan); a plan that does not fit the
// arguments is an error.
extern "C" int sdeo_group_norm_fused(const void* x, const void* gamma, const void* beta,
                                     void* y, int dtype, int wdtype, int channels_last,
                                     int n, int c, int hw, int groups, int vec, int cluster,
                                     int rows_per_block, int keep, float inv_count,
                                     float eps, int swish, void* stream) {
  const int esize = dtype == 0 ? 4 : 2, wsize = wdtype == 0 ? 4 : 2;
  if (groups < 1 || c % groups || cluster < 1 || cluster > 8 || (cluster & (cluster - 1)) ||
      rows_per_block < 1 || (long long)rows_per_block * cluster < hw ||
      !vectors_fit(vec, esize, channels_last, c, hw, groups, rows_per_block, x, y) ||
      !affine_fits(vec, wsize, channels_last, gamma, beta))
    return (int)cudaErrorInvalidValue;
  const long long slab = keep ? (long long)rows_per_block * (c / groups) * esize : 0;
  if (slab > kMaxSlabBytes) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n * groups, cluster);
  config.blockDim = dim3(kFusedThreads);
  config.dynamicSmemBytes = (size_t)slab;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = cluster;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = cluster > 1;  // one block a group launches as a plain grid
  return (int)by_types(dtype, wdtype, vec, [&](auto tp, auto wp, auto vc) {
    using T = elem_t<decltype(tp)>;
    using W = elem_t<decltype(wp)>;
    constexpr int V = decltype(vc)::value;
    auto kernel = channels_last ? gn_fused_kernel<T, W, true, V> : gn_fused_kernel<T, W, false, V>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSlabBytes);
    if (err != cudaSuccess) return err;
    return cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(x),
                              static_cast<const W*>(gamma), static_cast<const W*>(beta),
                              static_cast<T*>(y), c, hw, groups, rows_per_block, keep,
                              inv_count, eps, swish);
  });
}

extern "C" int sdeo_group_norm_stats(const void* x, float* partials, int dtype,
                                     int channels_last, int n, int c, int hw, int groups,
                                     int chunk_rows, int chunks, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups < 1 || c % groups ||
      !vectors_fit(vec, dtype == 0 ? 4 : 2, channels_last, c, hw, groups, chunk_rows, x, x))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n * groups, chunks);
  return (int)by_types(dtype, 0, vec, [&](auto tp, auto, auto vc) {
    using T = elem_t<decltype(tp)>;
    constexpr int V = decltype(vc)::value;
    auto kernel = channels_last ? gn_stats_kernel<T, true, V> : gn_stats_kernel<T, false, V>;
    kernel<<<grid, kChunkThreads, 0, st>>>(static_cast<const T*>(x), partials, c, hw,
                                           groups, chunk_rows);
    return cudaGetLastError();
  });
}

extern "C" int sdeo_group_norm_apply(const void* x, const float* partials, const void* gamma,
                                     const void* beta, void* y, int dtype, int wdtype,
                                     int channels_last, int n, int c, int hw, int groups,
                                     int chunk_rows, int chunks, int vec, float inv_count,
                                     float eps, int swish, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups < 1 || c % groups ||
      !vectors_fit(vec, dtype == 0 ? 4 : 2, channels_last, c, hw, groups, chunk_rows, x, y) ||
      !affine_fits(vec, wdtype == 0 ? 4 : 2, channels_last, gamma, beta))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n * groups, chunks);
  return (int)by_types(dtype, wdtype, vec, [&](auto tp, auto wp, auto vc) {
    using T = elem_t<decltype(tp)>;
    using W = elem_t<decltype(wp)>;
    constexpr int V = decltype(vc)::value;
    auto kernel = channels_last ? gn_apply_kernel<T, W, true, V> : gn_apply_kernel<T, W, false, V>;
    kernel<<<grid, kChunkThreads, 0, st>>>(
        static_cast<const T*>(x), partials, static_cast<const W*>(gamma),
        static_cast<const W*>(beta), static_cast<T*>(y), c, hw, groups, chunk_rows,
        inv_count, eps, swish);
    return cudaGetLastError();
  });
}
