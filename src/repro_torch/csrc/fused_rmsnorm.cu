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
//
// Split rows (a row whose columns lie on several ranks: Mamba-2's gated
// norm over d_inner under tensor parallelism, each rank holding its heads'
// columns) run the same body in two entries, with the cross-rank sum in
// between (an all-reduce on the host side):
//   rmsnorm_sumsq_launch: per row, the f32 sum of squares of the rank's
//     columns, stored to sumsq (T,): the body's loads and reduction, no
//     store pass;
//   rmsnorm_apply_launch: the body's scale-and-store, with the row's
//     rsqrt(sumsq[row] / d_full + eps) taken from the summed sumsq in
//     place of the reduction.
// Each keeps the body's 16-byte and scalar instances and its streaming
// form for long rows.

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

// What a launch of the body does with a row
enum Mode { kRow = 0, kSumsq = 1, kApply = 2 };

// VEC: 16-byte items (else one element each); N: items a thread holds in
// registers, or 0 to stream the row twice; MODE: the whole row (kRow), its
// sum of squares only (kSumsq, to sumsq[row]) or the scale-and-store from
// a given sum over d_full columns (kApply).
template <typename T, typename S, bool VEC, int N, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, float* __restrict__ sumsq, int d,
               float d_full, float eps) {
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
  } else if constexpr (MODE != kApply) {
    for (int it = tid; it < items; it += nt) {
      load_items<T, E>(xr + it * E, v[0]);
#pragma unroll
      for (int e = 0; e < E; ++e) ss += v[0][e] * v[0][e];
    }
  }
  float r;
  if constexpr (MODE == kApply) {
    r = rsqrtf(sumsq[row] / d_full + eps);
  } else {
    for (int o = 16; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if ((tid & 31) == 0) warp_sums[tid >> 5] = ss;
    __syncthreads();
    float tot = 0.0f;
    for (int w = 0; w < (nt + 31) / 32; ++w) tot += warp_sums[w];
    if constexpr (MODE == kSumsq) {
      if (tid == 0) sumsq[row] = tot;
      return;
    }
    r = rsqrtf(tot / (float)d + eps);
  }

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

template <typename T, typename S, bool VEC, int MODE>
int launch_items(const void* x, const void* scale, void* out, float* sumsq,
                 long long rows, int d, float d_full, float eps,
                 cudaStream_t s) {
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
    rmsnorm_kernel<T, S, VEC, 0, MODE><<<grid, kMaxThreads, 0, s>>>(
        xp, sp, op, sumsq, d, d_full, eps);
  } else if (n == 1) {
    rmsnorm_kernel<T, S, VEC, 1, MODE><<<grid, threads, 0, s>>>(
        xp, sp, op, sumsq, d, d_full, eps);
  } else if (n == 2) {
    rmsnorm_kernel<T, S, VEC, 2, MODE><<<grid, threads, 0, s>>>(
        xp, sp, op, sumsq, d, d_full, eps);
  } else {
    rmsnorm_kernel<T, S, VEC, 4, MODE><<<grid, threads, 0, s>>>(
        xp, sp, op, sumsq, d, d_full, eps);
  }
  return (int)cudaGetLastError();
}

// the 16-byte instance where d and every pointer the mode reads or writes
// (x; with kRow and kApply also scale and out) allow it
template <typename T, typename S, int MODE>
int launch(const void* x, const void* scale, void* out, float* sumsq,
           long long rows, int d, float d_full, float eps, cudaStream_t s) {
  constexpr int E = 16 / (int)sizeof(T);
  const bool aligned =
      d % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      (MODE == kSumsq || (reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(scale) % 16 == 0));
  return aligned
             ? launch_items<T, S, true, MODE>(x, scale, out, sumsq, rows, d,
                                              d_full, eps, s)
             : launch_items<T, S, false, MODE>(x, scale, out, sumsq, rows, d,
                                               d_full, eps, s);
}

template <int MODE>
int dispatch(const void* x, const void* scale, void* out, float* sumsq,
             long long T, int d, float d_full, float eps, int x_dtype,
             int scale_dtype, cudaStream_t s) {
  if (T <= 0 || d <= 0 || T > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float, MODE>(x, scale, out, sumsq, T, d, d_full,
                                      eps, s);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16, MODE>(x, scale, out, sumsq, T, d,
                                              d_full, eps, s);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float, MODE>(x, scale, out, sumsq, T, d,
                                              d_full, eps, s);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, MODE>(x, scale, out, sumsq,
                                                      T, d, d_full, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x_dtype / scale_dtype: 0 = float32, 1 = bfloat16.  Each entry returns
// cudaGetLastError(), or cudaErrorInvalidValue on a bad shape or dtype.
extern "C" int fused_rmsnorm_launch(const void* x, const void* scale,
                                    void* out, long long T, int d, float eps,
                                    int x_dtype, int scale_dtype,
                                    void* stream) {
  return dispatch<kRow>(x, scale, out, nullptr, T, d, (float)d, eps, x_dtype,
                        scale_dtype, (cudaStream_t)stream);
}

// sumsq (T,) float32: each row's sum of squares of its d columns.
extern "C" int rmsnorm_sumsq_launch(const void* x, float* sumsq, long long T,
                                    int d, int x_dtype, void* stream) {
  return dispatch<kSumsq>(x, nullptr, nullptr, sumsq, T, d, (float)d, 0.0f,
                          x_dtype, 0, (cudaStream_t)stream);
}

// out = x * rsqrt(sumsq[row] / d_full + eps) * scale over the row's d
// columns; sumsq (T,) float32 is the whole row's sum of squares.
extern "C" int rmsnorm_apply_launch(const void* x, const float* sumsq,
                                    const void* scale, void* out, long long T,
                                    int d, int d_full, float eps, int x_dtype,
                                    int scale_dtype, void* stream) {
  if (d_full < d) return (int)cudaErrorInvalidValue;
  return dispatch<kApply>(x, scale, out, const_cast<float*>(sumsq), T, d,
                          (float)d_full, eps, x_dtype, scale_dtype,
                          (cudaStream_t)stream);
}
