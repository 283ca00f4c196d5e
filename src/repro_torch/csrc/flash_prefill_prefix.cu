// Chunked-prefill flash attention over a request's prefix KV, for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_prefill/flash_prefill.py,
//           function `flash_prefill_prefix` (Pallas body `_prefix_kernel`).
//
// Computes: chunk queries q (B, H, C, d) at absolute positions start[b] + i
// attend over the request's stripe k/v (B, KVH, Smax, d) with the causal
// mask on absolute positions (key j visible iff j <= start[b] + i); GQA
// head h reads kv-head h / (H / KVH).  Out (B, H, C, d) in q's dtype.
// Masking uses -1e30 and the output is acc / max(l, 1e-30), as on the TPU.
//
// What bounds it on the H100: for the short chunks of decode-time
// interleaving, bytes (the prefix K/V stripe is read once per q tile); for
// long chunks over long prefixes, operations (4 * C * ctx * d flops per
// head).  This first version does its math in float32 on the CUDA cores,
// so it is far from either bound; wgmma in bf16 is later work.
//
// Design (simple first): one block per (b * H + h, 64-row q tile), 128
// threads.  The TPU's sequential kv grid axis becomes a loop over 32-key
// tiles inside the block, carrying the online-softmax state (m, l, acc) in
// registers; tiles past the q tile's last absolute position are never read
// (the TPU kernel's block skip).  Ragged edges are masked instead of
// clamping block sizes to divisors: query rows >= C load zeros and are not
// stored, keys >= Smax are masked.  Each thread owns a 4 x 4 block of the
// 64 x 32 score tile and the same 4 rows of the output, so row statistics
// need only a shuffle among the 8 threads that share a row.  Tiles are
// staged in shared memory as float with one word of row padding against
// bank conflicts.  Inputs may be strided (the last axis must be
// contiguous), so the caller's transposed views need no copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 32;   // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

struct Strides { long long b, h, s; };   // element strides; last axis is 1

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefix_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int32_t* __restrict__ start,
                    T* __restrict__ out, Strides qs, Strides ks, Strides vs,
                    Strides os, int H, int KVH, int C, int Smax, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;                        // kBQ x (D + 1)
  float* sK = sQ + kBQ * (D + 1);          // kBK x (D + 1)
  float* sV = sK + kBK * (D + 1);          // kBK x D
  float* sP = sV + kBK * D;                // kBQ x (kBK + 1)

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;   // rows ty*4.., cols tx*4.. / dims tx+8j
  const int st = start[b];

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, j = e - r * D;
    sQ[r * (D + 1) + j] = (q0 + r < C) ? to_f(qb[(q0 + r) * qs.s + j]) : 0.f;
  }

  constexpr int DJ = D / 8;                // output dims per thread
  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf; l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  // keys past the q tile's last absolute position are never visible
  const int q_last = min(C, q0 + kBQ) - 1;
  const int n_kv = min(Smax, st + q_last + 1);
  const int n_tiles = (n_kv + kBK - 1) / kBK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // previous tile's readers are done with sK/sV/sP
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, j = e - c * D;
      const bool ok = k0 + c < Smax;
      sK[c * (D + 1) + j] = ok ? to_f(kb[(k0 + c) * ks.s + j]) : 0.f;
      sV[c * D + j] = ok ? to_f(vb[(k0 + c) * vs.s + j]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int j = 0; j < D; ++j) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * (D + 1) + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sK[(tx * 4 + c) * (D + 1) + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] += qv[i] * kv[c];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = st + q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx * 4 + c;
        s[i][c] = (kpos <= qpos && kpos < Smax) ? s[i][c] * scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      // the 8 threads of a row are 8 consecutive lanes
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        sP[(ty * 4 + i) * (kBK + 1) + tx * 4 + c] = p;
        psum += p;
      }
      for (int o = 1; o < 8; o <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * (kBK + 1) + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float vv = sV[c * D + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] += pv[i] * vv;
      }
    }
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r < C) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) from_f(acc[i][jj] * inv, ob + r * os.s + tx + 8 * jj);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* start,
           void* out, Strides qs, Strides ks, Strides vs, Strides os, int B,
           int H, int KVH, int C, int Smax, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefix_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + kBQ - 1) / kBQ, B * H);
  flash_prefix_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)start, (T*)out,
      qs, ks, vs, os, H, KVH, C, Smax, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 4 arrays of 3 element strides (batch, head, sequence) for q, k,
// v, out; the last axis of each must be contiguous.  dtype codes: 0 =
// float32, 1 = bfloat16 (q, k, v and out share it).  Head dims 64 and 128.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int flash_prefill_prefix_launch(
    const void* q, const void* k, const void* v, const void* start, void* out,
    const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* o_strides, int B, int H,
    int KVH, int C, int Smax, int d, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || Smax <= 0 || KVH <= 0 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_strides[0], q_strides[1], q_strides[2]};
  const Strides ks{k_strides[0], k_strides[1], k_strides[2]};
  const Strides vs{v_strides[0], v_strides[1], v_strides[2]};
  const Strides os{o_strides[0], o_strides[1], o_strides[2]};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, start, out, qs, ks, vs, os, B, H, KVH, C, Smax, s);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, start, out, qs, ks, vs, os, B, H, KVH, C, Smax, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, start, out, qs, ks, vs, os, B, H, KVH, C, Smax, s);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, start, out, qs, ks, vs, os, B, H, KVH, C, Smax, s);
  return (int)cudaErrorInvalidValue;
}
