// Flash attention for Hopper (sm_90a), plain C interface for ctypes: the
// chunked-prefill kernel over a request's prefix KV and the full-sequence
// kernel (causal or bidirectional), with three device bodies.
//
// Replaces: src/repro/kernels/flash_prefill/flash_prefill.py,
//   `flash_prefill_prefix` (Pallas body `_prefix_kernel`) and
//   `flash_prefill` (Pallas body `_kernel`).
//
// Computes, prefix mode: chunk queries q (B, H, C, d) at absolute positions
// start[b] + i attend over the request's stripe k/v (B, KVH, Smax, d) with
// the causal mask on absolute positions (key j visible iff j <= start[b] +
// i).  Full mode: q (B, H, S, d) over k/v (B, KVH, S, d), i.e. C = Smax = S
// and start = 0, causal (key j visible iff j <= i) or bidirectional (every
// key visible).  GQA head h reads kv-head h / (H / KVH).  Out (B, H, C, d)
// in q's dtype, acc / max(l, 1e-30).
//
// The three bodies, chosen per call by dtype and layout:
// - bfloat16 takes the Hopper body of flash_prefill_wgmma.cuh (tensor
//   cores through wgmma, K/V by TMA, GQA heads packed into one block's
//   rows, split-KV for grids too small to fill the card; its note says
//   how).  It rounds P to bf16 before P V, as SDPA's flash backend does.
// - float32 (training, held to 2e-5 of the plain version) takes the body
//   of flash_prefill_tf32x3.cuh: tensor cores through mma.sync in TF32,
//   each f32 product taken as three TF32 products (the 3xTF32 split), so
//   it keeps f32 accuracy; its bound is 3 x the operations over TF32's 495
//   TFLOP/s (0.2083 ms at B 4, H 32, S 1024, d 128, causal), below the FMA
//   bound of 1 x over 67 TFLOP/s (0.5133 ms).
// - A view the tensor-core bodies cannot take (an address or a stride not
//   a multiple of 16 bytes; or, in bf16, G > 64) takes the FMA body below.
//   The model's views always suit the tensor-core bodies.
//
// The FMA body.  What bounds it on the H100: operations (4 d flops per
// visible pair per head) at float32's 67 TFLOP/s outside the tensor cores.
// One block per (b * H + h, 64-row q tile), 128 threads.  The TPU's
// sequential kv grid axis becomes a loop over 32-key tiles inside the
// block, carrying the online-softmax state (m, l, acc) in registers; under
// a causal mask, tiles past the q tile's last position are never read (the
// TPU kernel's block skip).  In full mode the grid's slow axis is the q
// tile, walked from the last tile down, so the causal kernel's long (late)
// tiles start first and the short ones fill the tail.  Ragged edges are
// masked instead of clamping block sizes to divisors: query rows >= C load
// zeros and are not stored, keys >= Smax are masked (-1e30; key 0 is
// visible to every row and the first key tile is always read, so a masked
// score never enters the sum with weight 1).  Each thread owns a 4 x 4
// block of the 64 x 32 score tile and the same 4 rows of the output, so
// row statistics need only a shuffle among the 8 threads that share a row.
// Tiles are staged in shared memory as float with one word of row padding
// against bank conflicts.  All bodies read strided inputs (the last axis
// must be contiguous), so the caller's transposed views need no copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_prefill_wgmma.cuh"
#include "flash_prefill_tf32x3.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 32;   // keys per tile
constexpr float kNegInf = -1e30f;

// kPrefix: causal over absolute positions start[b] + i; kCausal: full
// sequence, key j visible to row i iff j <= i; kFull: every key visible.
enum Mode { kPrefix = 0, kCausal = 1, kFull = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

struct Strides { long long b, h, s; };   // element strides; last axis is 1

template <typename T, int D, int M>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int32_t* __restrict__ start,
                  T* __restrict__ out, Strides qs, Strides ks, Strides vs,
                  Strides os, int H, int KVH, int C, int Smax, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;                        // kBQ x (D + 1)
  float* sK = sQ + kBQ * (D + 1);          // kBK x (D + 1)
  float* sV = sK + kBK * (D + 1);          // kBK x D
  float* sP = sV + kBK * D;                // kBQ x (kBK + 1)

  // full mode: blockIdx.x is (b, h), fastest, and the q tiles run from
  // the last one down, so all heads' longest tiles are scheduled first
  const int bh = (M == kPrefix) ? blockIdx.y : blockIdx.x;
  const int qt = (M == kPrefix) ? blockIdx.x : gridDim.y - 1 - blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;   // rows ty*4.., cols tx*4.. / dims tx+8j
  const int st = (M == kPrefix) ? start[b] : 0;

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

  // under a causal mask, keys past the q tile's last absolute position are
  // never visible
  const int q_last = min(C, q0 + kBQ) - 1;
  const int n_kv = (M == kFull) ? Smax : min(Smax, st + q_last + 1);
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
        const bool vis = kpos < Smax && (M == kFull || kpos <= qpos);
        s[i][c] = vis ? s[i][c] * scale : kNegInf;
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

template <typename T, int D, int M>
int launch(const void* q, const void* k, const void* v, const void* start,
           void* out, Strides qs, Strides ks, Strides vs, Strides os, int B,
           int H, int KVH, int C, int Smax, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
  static bool attr_set = false;     // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<T, D, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int nq = (C + kBQ - 1) / kBQ;
  if (M != kPrefix && nq > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid = (M == kPrefix) ? dim3(nq, B * H) : dim3(B * H, nq);
  flash_attn_kernel<T, D, M><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)start, (T*)out,
      qs, ks, vs, os, H, KVH, C, Smax, 1.0f / sqrtf((float)D));
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++wg::launched[wg::kFmaBody];
  return (int)err;
}

template <int M>
int dispatch(const void* q, const void* k, const void* v, const void* start,
             void* out, void* scratch, int nsplit, const long long* q_strides,
             const long long* k_strides, const long long* v_strides,
             const long long* o_strides, int B, int H, int KVH, int C,
             int Smax, int d, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || Smax <= 0 || KVH <= 0 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_strides[0], q_strides[1], q_strides[2]};
  const Strides ks{k_strides[0], k_strides[1], k_strides[2]};
  const Strides vs{v_strides[0], v_strides[1], v_strides[2]};
  const Strides os{o_strides[0], o_strides[1], o_strides[2]};
  cudaStream_t s = (cudaStream_t)stream;
  // each body in turn for each head dim: the tensor-core bodies return
  // kNotTaken for a view they cannot take, which the FMA body then takes
#define FLASH_CASE(DIM)                                                       \
  if (d == DIM) {                                                             \
    if (dtype == 1) {                                                         \
      const int err = wg::launch<DIM, M>(q, k, v, start, out, scratch,        \
                                         nsplit, q_strides, k_strides,        \
                                         v_strides, o_strides, B, H, KVH, C,  \
                                         Smax, s);                            \
      if (err != wg::kNotTaken) return err;                                   \
      return launch<__nv_bfloat16, DIM, M>(q, k, v, start, out, qs, ks, vs,   \
                                           os, B, H, KVH, C, Smax, s);        \
    }                                                                         \
    if (dtype == 0) {                                                         \
      const int err = tf::launch<DIM, M>(q, k, v, start, out, q_strides,      \
                                         k_strides, v_strides, o_strides, B,  \
                                         H, KVH, C, Smax, s);                 \
      if (err != tf::kNotTaken) return err;                                   \
      return launch<float, DIM, M>(q, k, v, start, out, qs, ks, vs, os, B, H, \
                                   KVH, C, Smax, s);                          \
    }                                                                         \
  }
  FLASH_CASE(64)
  FLASH_CASE(80)
  FLASH_CASE(128)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 4 arrays of 3 element strides (batch, head, sequence) for q, k,
// v, out; the last axis of each must be contiguous.  dtype codes: 0 =
// float32, 1 = bfloat16 (q, k, v and out share it).  Head dims 64, 80
// (stablelm-3b) and 128.
// scratch / nsplit: the bf16 body's split-KV (kernels/flash_prefill/plan.py
// sizes both): nsplit 1 needs no scratch; nsplit > 1 needs nsplit * B * KVH
// * (q tiles) * 64 * (d + 2) floats.  The f32 and FMA bodies ignore them.
// Both entry points return cudaGetLastError(), or cudaErrorInvalidValue for
// a shape the kernels do not take.
extern "C" int flash_prefill_prefix_launch(
    const void* q, const void* k, const void* v, const void* start, void* out,
    void* scratch, int nsplit, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, int B, int H, int KVH, int C, int Smax, int d,
    int dtype, void* stream) {
  return dispatch<kPrefix>(q, k, v, start, out, scratch, nsplit, q_strides,
                           k_strides, v_strides, o_strides, B, H, KVH, C,
                           Smax, d, dtype, stream);
}

// Full-sequence attention: q (B, H, S, d), k/v (B, KVH, S, d); causal != 0
// masks keys after each query's position.
extern "C" int flash_prefill_launch(
    const void* q, const void* k, const void* v, void* out, void* scratch,
    int nsplit, const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* o_strides, int B, int H,
    int KVH, int S, int d, int causal, int dtype, void* stream) {
  if (causal)
    return dispatch<kCausal>(q, k, v, nullptr, out, scratch, nsplit,
                             q_strides, k_strides, v_strides, o_strides, B, H,
                             KVH, S, S, d, dtype, stream);
  return dispatch<kFull>(q, k, v, nullptr, out, scratch, nsplit, q_strides,
                         k_strides, v_strides, o_strides, B, H, KVH, S, S, d,
                         dtype, stream);
}

// Dynamic shared memory of the bf16 body for head dim d (bytes), for the
// build report; 0 for a d it does not take.
extern "C" int flash_prefill_wgmma_smem_bytes(int d) {
  return d == 64    ? wg::smem_bytes<64>()
         : d == 80  ? wg::smem_bytes<80>()
         : d == 128 ? wg::smem_bytes<128>()
                    : 0;
}

// Launches of the FMA body, the bf16 wgmma body, its split-KV merge and
// the f32 3xTF32 body since the library was loaded, into out[0..3];
// returns 0.
extern "C" int flash_prefill_body_launches(long long* out) {
  for (int i = 0; i < 4; ++i) out[i] = wg::launched[i];
  return 0;
}
