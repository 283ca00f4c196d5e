// Fused RMSNorm for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/fused_rmsnorm/fused_rmsnorm.py, function
//           `fused_rmsnorm` (Pallas body `_kernel`).
//
// Computes, per row of x (T, d):  y = x * rsqrt(mean(x^2) + eps) * scale,
// all in float32, stored in x's dtype (float32 or bfloat16); scale (d,) is
// float32 or bfloat16.
//
// What bounds it on the H100: bytes.  Three flops per element against the
// 4 to 8 bytes each element moves (read x, write y).
//
// Design (simple first): one block of 256 threads per row.  Each thread
// sums the squares of a strided share of the row in float32; a warp
// shuffle and then a block reduction through shared memory give mean(x^2);
// a second strided pass reads the row again (from L1/L2), scales and
// stores.  The TPU kernel's row tile of 256 rows in VMEM becomes one row
// per block, so any T runs without padding.  Vectorised 16-byte loads and
// several rows per block for small d are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  __shared__ float warp_sums[kWarps];
  __shared__ float inv_rms;
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  float ss = 0.0f;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const float v = load(xr + j);
    ss += v * v;
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < kWarps ? warp_sums[threadIdx.x] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (threadIdx.x == 0) inv_rms = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  T* outr = out + row * d;
  for (int j = threadIdx.x; j < d; j += kThreads)
    store(load(xr + j) * r * load(scale + j), outr + j);
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, long long T_rows,
           int d, float eps, cudaStream_t s) {
  rmsnorm_kernel<T, S><<<(unsigned)T_rows, kThreads, 0, s>>>(
      (const T*)x, (const S*)scale, (T*)out, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype / scale_dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue on a bad shape or dtype.
extern "C" int fused_rmsnorm_launch(const void* x, const void* scale,
                                    void* out, long long T, int d, float eps,
                                    int x_dtype, int scale_dtype,
                                    void* stream) {
  if (T <= 0 || d <= 0 || T > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, scale, out, T, d, eps, s);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, out, T, d, eps, s);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, out, T, d, eps, s);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, T, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
