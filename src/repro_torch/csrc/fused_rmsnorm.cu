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
// Design: one block per row, sized to the row, and the row read from device
// memory once.  Each thread loads its share of the row as 16-byte vectors
// (8 bf16 or 4 f32: "items"), at most N items, all issued before the first
// is used, and keeps them in registers (N x 8 floats at most) through the
// sum of squares and the scaled store; the scale is read with vector loads
// too (L1/L2-resident: every row reads it).  The block has ceil(items / N)
// threads rounded up to a warp, with the smallest N in {1, 2, 4} that keeps
// it within 256 threads where it can: in bf16 granite's d 4096 is 256
// threads of 2 items and mamba's 2560 and 5120 are 160 threads of 2 and 4
// items, so a 1024-row prefill puts 1024 blocks of 5 to 8 warps on the
// card at once, and a decode batch of 8 rows has 8 blocks whose threads
// each wait on at most four loads.  (f32 5120 is 320 threads of 4 items:
// 8 items a thread measured slower, not faster.)  Sums
// of squares are float32: a warp shuffle, then one partial per warp
// through shared memory, which every thread adds in the same order.  The
// 16-byte path needs 16-byte-aligned rows (d a multiple of the vector,
// aligned x, scale and out); any other shape takes the scalar-load
// instance of the same template (an item is one element).
// A row too long for 1024 threads of N items streams: the sum pass and the
// store pass each read it (from L2 the second time).  The TPU kernel's
// tile of 256 rows in VMEM becomes one row per block, so any T runs
// without padding.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTargetThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// E consecutive elements of type U at p (aligned to E * sizeof(U) bytes
// when E > 1) as floats, with loads of up to 16 bytes
template <typename U, int E>
__device__ __forceinline__ void load_items(const U* __restrict__ p,
                                           float (&f)[E]) {
  constexpr int kBytes = E * (int)sizeof(U);
  if constexpr (E == 1) {
    f[0] = to_f(*p);
  } else if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / (int)sizeof(U);
#pragma unroll
    for (int c = 0; c < E / kPer; ++c) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const U* u = reinterpret_cast<const U*>(&raw);
#pragma unroll
      for (int e = 0; e < kPer; ++e) f[c * kPer + e] = to_f(u[e]);
    }
  } else {
    static_assert(kBytes == 8, "8- or 16-byte multiples");
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const U* u = reinterpret_cast<const U*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = to_f(u[e]);
  }
}

template <int E>
__device__ __forceinline__ void store_items(float* p, const float (&f)[E]) {
  if constexpr (E == 1) {
    *p = f[0];
  } else {
#pragma unroll
    for (int c = 0; c < E / 4; ++c)
      reinterpret_cast<float4*>(p)[c] =
          make_float4(f[4 * c], f[4 * c + 1], f[4 * c + 2], f[4 * c + 3]);
  }
}

template <int E>
__device__ __forceinline__ void store_items(__nv_bfloat16* p,
                                            const float (&f)[E]) {
  if constexpr (E == 1) {
    *p = __float2bfloat16(f[0]);
  } else {
    static_assert(E == 8, "16 bytes of bf16");
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// VEC: 16-byte items (else one element each); N: items a thread holds in
// registers, or 0 to stream the row twice.
template <typename T, typename S, bool VEC, int N>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  constexpr int E = VEC ? 16 / (int)sizeof(T) : 1;   // elements per item
  __shared__ float warp_sums[kMaxThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* outr = out + row * d;
  const int items = d / E, tid = threadIdx.x, nt = blockDim.x;
  constexpr int R = N > 0 ? N : 1;
  float v[R][E];
  float ss = 0.0f;
  if constexpr (N > 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int it = tid + j * nt;
      if (it < items) {
        load_items<T, E>(xr + it * E, v[j]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) v[j][e] = 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) ss += v[j][e] * v[j][e];
  } else {
    for (int it = tid; it < items; it += nt) {
      load_items<T, E>(xr + it * E, v[0]);
#pragma unroll
      for (int e = 0; e < E; ++e) ss += v[0][e] * v[0][e];
    }
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = ss;
  __syncthreads();
  float tot = 0.0f;
  for (int w = 0; w < (nt + 31) / 32; ++w) tot += warp_sums[w];
  const float r = rsqrtf(tot / (float)d + eps);

  float sc[E];
  if constexpr (N > 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int it = tid + j * nt;
      if (it < items) {
        load_items<S, E>(scale + it * E, sc);
#pragma unroll
        for (int e = 0; e < E; ++e) v[j][e] = v[j][e] * r * sc[e];
        store_items<E>(outr + it * E, v[j]);
      }
    }
  } else {
    for (int it = tid; it < items; it += nt) {
      load_items<T, E>(xr + it * E, v[0]);
      load_items<S, E>(scale + it * E, sc);
#pragma unroll
      for (int e = 0; e < E; ++e) v[0][e] = v[0][e] * r * sc[e];
      store_items<E>(outr + it * E, v[0]);
    }
  }
}

template <typename T, typename S, bool VEC>
int launch_items(const void* x, const void* scale, void* out,
                 long long rows, int d, float eps, cudaStream_t s) {
  constexpr int E = VEC ? 16 / (int)sizeof(T) : 1;
  const int items = d / E;
  int n = 1;
  while (n < 4 && (items + n - 1) / n > kTargetThreads) n *= 2;
  int threads = ((items + n - 1) / n + 31) / 32 * 32;
  const dim3 grid((unsigned)rows);
  const T* xp = (const T*)x;
  const S* sp = (const S*)scale;
  T* op = (T*)out;
  if (threads > kMaxThreads) {
    rmsnorm_kernel<T, S, VEC, 0><<<grid, kMaxThreads, 0, s>>>(xp, sp, op, d,
                                                              eps);
  } else if (n == 1) {
    rmsnorm_kernel<T, S, VEC, 1><<<grid, threads, 0, s>>>(xp, sp, op, d, eps);
  } else if (n == 2) {
    rmsnorm_kernel<T, S, VEC, 2><<<grid, threads, 0, s>>>(xp, sp, op, d, eps);
  } else {
    rmsnorm_kernel<T, S, VEC, 4><<<grid, threads, 0, s>>>(xp, sp, op, d, eps);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, long long rows,
           int d, float eps, cudaStream_t s) {
  constexpr int E = 16 / (int)sizeof(T);
  const bool aligned = d % E == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  return aligned ? launch_items<T, S, true>(x, scale, out, rows, d, eps, s)
                 : launch_items<T, S, false>(x, scale, out, rows, d, eps, s);
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
