// Row LayerNorm for Hopper (sm_90a), behind
// stablediffusioneo_tpu_torch/ops/kernels/layernorm.py.
//
// Replaces the Pallas TPU kernel stablediffusioneo_tpu/ops/pallas/layernorm.py
// _ln_kernel (launched by _ln_call). Numerics follow it: fp32 sums of x and
// x^2 over the row in one pass; mean = S1 * inv_c, var = S2 * inv_c - mean^2,
// rstd = rsqrt(var + eps); y = (x - mean) * rstd * gamma + beta in fp32,
// rounded to x's dtype once.
//
// What bounds it: a few flops per element, so memory traffic. The TPU kernel
// read a block of rows into VMEM once. Here one warp takes one row (C = 320,
// 640 or 1280 at the UNet sites): the lanes stride over the row, the sums are
// reduced by an xor butterfly (fixed order, every lane gets the same bits),
// and the second read of the row, to normalize, comes from L1. Device memory
// sees one read and one write.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

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

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads) layer_norm_kernel(
    const T* __restrict__ x, const W* __restrict__ gamma, const W* __restrict__ beta,
    T* __restrict__ y, long long rows, int c, float inv_c, float eps) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + row * c;
  T* yr = y + row * c;
  float s1 = 0.f, s2 = 0.f;
  for (int j = lane; j < c; j += 32) {
    const float v = Num<T>::load(xr[j]);
    s1 += v;
    s2 += v * v;
  }
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float mean = s1 * inv_c;
  const float rstd = rsqrtf(s2 * inv_c - mean * mean + eps);
  for (int j = lane; j < c; j += 32) {
    const float v = (Num<T>::load(xr[j]) - mean) * rstd;
    yr[j] = Num<T>::store(v * Num<W>::load(gamma[j]) + Num<W>::load(beta[j]));
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y,
                   long long rows, int c, float inv_c, float eps, cudaStream_t st) {
  const unsigned blocks = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  layer_norm_kernel<T, W><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(gamma), static_cast<const W*>(beta),
      static_cast<T*>(y), rows, c, inv_c, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype, wdtype: 0 float32, 1 bfloat16 (of x/y and of gamma/beta).
extern "C" int sdeo_layer_norm(const void* x, const void* gamma, const void* beta, void* y,
                               int dtype, int wdtype, long long rows, int c, float inv_c,
                               float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wdtype == 0) return (int)launch<float, float>(x, gamma, beta, y, rows, c, inv_c, eps, st);
  if (dtype == 0 && wdtype == 1) return (int)launch<float, bf16>(x, gamma, beta, y, rows, c, inv_c, eps, st);
  if (dtype == 1 && wdtype == 0) return (int)launch<bf16, float>(x, gamma, beta, y, rows, c, inv_c, eps, st);
  if (dtype == 1 && wdtype == 1) return (int)launch<bf16, bf16>(x, gamma, beta, y, rows, c, inv_c, eps, st);
  return (int)cudaErrorInvalidValue;
}
