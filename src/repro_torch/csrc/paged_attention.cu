// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py,
//           function `paged_attention` (Pallas body `_kernel`).
//
// Computes single-query GQA attention over a block table:
//   q (B, H, d); k/v pool (num_pages, page, KVH, d); tables (B, max_pages)
//   int32; lengths (B,) int32 -> out (B, H, d) in q's dtype.
// Online softmax across pages, pages past lengths[b] skipped, tokens at or
// past the length masked with -1e30, output acc / max(l, 1e-30) -- the
// constants of the TPU kernel, so no row can produce NaN.
//
// What bounds it on the H100: bytes.  Each (b, kv-head) reads its live
// pages of K and V once and does 2 * G * d flops per key, far below the
// card's ~295 flops/byte balance point, so the floor is the K/V bytes over
// 3.35 TB/s.
//
// Design (simple first): one block per (b, kv-head), 128 threads, with its
// G = H / KVH query heads held in shared memory as float.  The TPU's
// sequential page grid axis becomes a loop over the sequence's pages inside
// the block; the block reads tables[b, p] itself (the TPU's scalar
// prefetch).  Per page: each warp scores its share of the page's tokens
// against all G heads (one K row read serves every head), one warp per
// head folds the page into that head's running max/sum, then every thread
// rescales and accumulates its (head, dim) elements of acc in registers.
// All math is float32 (bf16 loads).  Splitting a long sequence's pages
// across blocks, vectorised loads and tensor cores are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kMaxD = 256;
constexpr int kMaxPage = 64;
constexpr int kPerThread = (kMaxG * kMaxD + kThreads - 1) / kThreads;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
                       const TKV* __restrict__ vc,
                       const int32_t* __restrict__ tables,
                       const int32_t* __restrict__ lengths,
                       TQ* __restrict__ out, int H, int KVH, int d, int page,
                       int num_pages, int max_pages, float scale) {
  const int b = blockIdx.x / KVH;
  const int kvh = blockIdx.x % KVH;
  const int G = H / KVH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ float sq[kMaxG * kMaxD];
  __shared__ float ss[kMaxG * kMaxPage];   // scores, then probabilities
  __shared__ float sm[kMaxG], sl[kMaxG], scorr[kMaxG];

  const TQ* qb = q + ((size_t)b * H + (size_t)kvh * G) * d;
  for (int e = tid; e < G * d; e += kThreads) sq[e] = to_f(qb[e]);
  if (tid < G) { sm[tid] = kNegInf; sl[tid] = 0.f; }

  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;

  const int len = lengths[b];
  const int n_pages = min((len + page - 1) / page, max_pages);
  const size_t tok_stride = (size_t)KVH * d;          // one token's heads
  const size_t page_stride = (size_t)page * tok_stride;
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    const int pid = tables[(size_t)b * max_pages + p];
    const bool page_ok = pid >= 0 && pid < num_pages;  // never read outside
    const TKV* kp = kc + (size_t)(page_ok ? pid : 0) * page_stride + (size_t)kvh * d;
    const TKV* vp = vc + (size_t)(page_ok ? pid : 0) * page_stride + (size_t)kvh * d;

    // 1. scores: warp w takes tokens w, w + kWarps, ...
    for (int t = warp; t < page; t += kWarps) {
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      const TKV* krow = kp + (size_t)t * tok_stride;
      for (int j = lane; j < d; j += 32) {
        const float kv = to_f(krow[j]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) part[g] += sq[g * d + j] * kv;
      }
      const bool valid = page_ok && (p * page + t) < len;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float s = warp_sum(part[g]);
          if (lane == 0) ss[g * kMaxPage + t] = valid ? s * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // 2. online-softmax fold of this page, one warp per head
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, ss[g * kMaxPage + t]);
      mx = warp_max(mx);
      const float m_prev = sm[g];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float pr = expf(ss[g * kMaxPage + t] - m_new);
        ss[g * kMaxPage + t] = pr;
        psum += pr;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        scorr[g] = corr;
        sl[g] = sl[g] * corr + psum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

    // 3. acc[g, j] = acc * corr[g] + sum_t p[g, t] * v[t, j]
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < G * d) {
        const int g = e / d, j = e - g * d;
        float a = acc[i] * scorr[g];
        const float* pg = ss + g * kMaxPage;
        for (int t = 0; t < page; ++t) a += pg[t] * to_f(vp[(size_t)t * tok_stride + j]);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  TQ* ob = out + ((size_t)b * H + (size_t)kvh * G) * d;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * d) {
      const int g = e / d;
      from_f(acc[i] / fmaxf(sl[g], 1e-30f), ob + e);
    }
  }
}

template <typename TQ, typename TKV>
void launch(const void* q, const void* k, const void* v, const void* tables,
            const void* lengths, void* out, int B, int H, int KVH, int d,
            int page, int num_pages, int max_pages, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)d);
  paged_attention_kernel<TQ, TKV><<<B * KVH, kThreads, 0, stream>>>(
      (const TQ*)q, (const TKV*)k, (const TKV*)v, (const int32_t*)tables,
      (const int32_t*)lengths, (TQ*)out, H, KVH, d, page, num_pages,
      max_pages, scale);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lengths, void* out, int B, int H, int KVH, int d, int page,
    int num_pages, int max_pages, int q_dtype, int kv_dtype, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kMaxG || d > kMaxD ||
      page > kMaxPage || B <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0 && kv_dtype == 0)
    launch<float, float>(q, k, v, tables, lengths, out, B, H, KVH, d, page, num_pages, max_pages, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, tables, lengths, out, B, H, KVH, d, page, num_pages, max_pages, s);
  else if (q_dtype == 0 && kv_dtype == 1)
    launch<float, __nv_bfloat16>(q, k, v, tables, lengths, out, B, H, KVH, d, page, num_pages, max_pages, s);
  else if (q_dtype == 1 && kv_dtype == 0)
    launch<__nv_bfloat16, float>(q, k, v, tables, lengths, out, B, H, KVH, d, page, num_pages, max_pages, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
