// INT8 KV quantize / dequantize for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces: src/repro/kernels/kv_quant/kv_quant.py, functions
//           `kv_quantize` (Pallas body `_quant_kernel`) and
//           `kv_dequantize` (Pallas body `_dequant_kernel`).
//
// Computes per-row asymmetric INT8 (paper Eq. 8) over x (T, d) float32:
//   lam = max((max - min) / 255, 1e-8);  z = round(-min / lam);
//   q = clip(round(x / lam + z), 0, 255) - 128  stored as int8,
// and the inverse x = lam * (q + 128 - z) cast to float32 or bfloat16.
// round() is round-half-to-even (rintf), as jnp.round, and x / lam is a
// true IEEE division, as on the TPU (no fast-math).
//
// What bounds it on the H100: bytes.  A row reduction plus an elementwise
// pass do a handful of operations per byte moved.
//
// Design (simple first): quantize runs one warp per row (the row is read
// twice, the second time from L1/L2); dequantize is one thread per element
// over a grid-stride loop.  Vectorised 16-byte loads are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
kv_quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                   float* __restrict__ lam_out, float* __restrict__ z_out,
                   long long T, int d) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= T) return;
  const float* xr = x + row * d;
  float mx = -INFINITY, mn = INFINITY;
  for (int j = lane; j < d; j += 32) {
    const float v = xr[j];
    mx = fmaxf(mx, v);
    mn = fminf(mn, v);
  }
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  }
  const float lam = fmaxf((mx - mn) / 255.0f, 1e-8f);
  const float z = rintf(-mn / lam);
  int8_t* qr = q + row * d;
  for (int j = lane; j < d; j += 32) {
    const float c = fminf(fmaxf(rintf(xr[j] / lam + z), 0.0f), 255.0f);
    qr[j] = (int8_t)(int)(c - 128.0f);
  }
  if (lane == 0) {
    lam_out[row] = lam;
    z_out[row] = z;
  }
}

__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ lam,
                     const float* __restrict__ z, T* __restrict__ x,
                     long long T_rows, int d) {
  const long long n = T_rows * d;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const long long row = e / d;
    const float qv = (float)q[e] + 128.0f;
    store(lam[row] * (qv - z[row]), x + e);
  }
}

}  // namespace

// Returns cudaGetLastError(), or cudaErrorInvalidValue on a bad shape.
extern "C" int kv_quantize_launch(const void* x, void* q, void* lam, void* z,
                                  long long T, int d, void* stream) {
  if (T <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (T + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kv_quantize_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (int8_t*)q, (float*)lam, (float*)z, T, d);
  return (int)cudaGetLastError();
}

// out_dtype: 0 = float32, 1 = bfloat16.
extern "C" int kv_dequantize_launch(const void* q, const void* lam,
                                    const void* z, void* x, long long T, int d,
                                    int out_dtype, void* stream) {
  if (T <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const long long n = T * d;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond this
  cudaStream_t s = (cudaStream_t)stream;
  if (out_dtype == 0)
    kv_dequantize_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int8_t*)q, (const float*)lam, (const float*)z, (float*)x, T, d);
  else if (out_dtype == 1)
    kv_dequantize_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int8_t*)q, (const float*)lam, (const float*)z,
        (__nv_bfloat16*)x, T, d);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
