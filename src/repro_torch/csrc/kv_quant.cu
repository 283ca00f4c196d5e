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
// Design.  Quantize runs one warp per row (the row is read twice, the
// second time from L1/L2).  Dequantize has two bodies, chosen per call from
// d and the addresses (kernels/kv_quant/ops.py names the choice):
// - d a multiple of 16 and 16-byte aligned codes and output: one thread
//   owns 16 codes of a row, one 16-byte load, and writes 16 values with
//   16-byte stores (four for float32, two for bfloat16), reading its row's
//   lam and z once; neighbouring lanes trade pieces first, so that every
//   store instruction writes whole sectors (see the kernel).  The block is
//   (d / 16) x (about 256 / (d / 16)) threads, a row per y index, so the
//   row comes from the block and thread coordinates and nothing is
//   divided per element.
// - every other call: one thread per element over a grid-stride loop.
// Both compute lam * ((float)q + 128 - z) in that order, as the plain
// version does, so a float32 result equals it bit for bit and a bfloat16
// one is its round-to-nearest-even.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kVec = 16;            // codes a thread of the 16-byte body
constexpr int kMaxVecD = 1024;      // its rows: d / 16 <= 64 threads

// Launches since the library was loaded (host counters, read through
// kv_quant_body_launches): dequantize's 16-byte and scalar bodies.
long long launched[2] = {0, 0};

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

// 16 bytes of output from V codes (4 for float32, 8 for bfloat16), each
// lam * ((float)q + 128 - z)
__device__ __forceinline__ void store_piece(const uint32_t* w, float l,
                                            float zr, float* p) {
  const int8_t* c = reinterpret_cast<const int8_t*>(w);
  *reinterpret_cast<float4*>(p) = make_float4(
      l * ((float)c[0] + 128.0f - zr), l * ((float)c[1] + 128.0f - zr),
      l * ((float)c[2] + 128.0f - zr), l * ((float)c[3] + 128.0f - zr));
}
__device__ __forceinline__ void store_piece(const uint32_t* w, float l,
                                            float zr, __nv_bfloat16* p) {
  const int8_t* c = reinterpret_cast<const int8_t*>(w);
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(
        l * ((float)c[2 * i] + 128.0f - zr),
        l * ((float)c[2 * i + 1] + 128.0f - zr));
    o[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(o[0], o[1], o[2], o[3]);
}

// The 16-byte body.  threadIdx.x is the 16-code group of the row, row =
// blockIdx.x * blockDim.y + threadIdx.y, so consecutive threads own
// consecutive groups.  Each thread loads its group with one 16-byte load
// and cuts it into L pieces of V codes (V codes fill a 16-byte store: L 4
// for float32, 2 for bfloat16).  The L lanes of an aligned lane group (the
// block's size is a multiple of 4) transpose their pieces by shuffles, so
// that in store k every lane of the group holds a piece of lane k's group,
// with lane k's row's lam and z: each store instruction then writes whole
// 32-byte sectors (L x 16 contiguous bytes a lane group) instead of
// 16-byte pieces 16 L bytes apart.
template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_dequantize_vec16_kernel(const int8_t* __restrict__ q,
                           const float* __restrict__ lam,
                           const float* __restrict__ z, T* __restrict__ x,
                           long long T_rows, int d) {
  constexpr int V = 16 / sizeof(T);     // codes a 16-byte store holds
  constexpr int L = kVec / V;           // lanes that transpose together
  constexpr int W = V / 4;              // 32-bit words of a piece
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const int live = row < T_rows;
  const long long e = row * d + threadIdx.x * kVec;   // its first code
  int4 raw = make_int4(0, 0, 0, 0);
  float l = 0.f, zr = 0.f;
  if (live) {
    raw = *reinterpret_cast<const int4*>(q + e);
    l = lam[row];
    zr = z[row];
  }
  const uint32_t w[4] = {(uint32_t)raw.x, (uint32_t)raw.y, (uint32_t)raw.z,
                         (uint32_t)raw.w};
  const int lane = (threadIdx.y * blockDim.x + threadIdx.x) & 31;
  const int i = lane & (L - 1), base = lane - i;
  const unsigned mask = ((1u << L) - 1) << base;
  // piece[k]: piece i of the group of lane base + k.  In round r lane s
  // sends its piece (s + r) % L and lane i takes it from lane (i - r) % L.
  uint32_t piece[L][W];
#pragma unroll
  for (int r = 0; r < L; ++r) {
    const int send_idx = (i + r) & (L - 1), k = (i - r) & (L - 1);
#pragma unroll
    for (int ww = 0; ww < W; ++ww) {
      uint32_t send = w[ww];
#pragma unroll
      for (int m = 1; m < L; ++m)
        if (send_idx == m) send = w[m * W + ww];
      const uint32_t got = __shfl_sync(mask, send, base + k);
#pragma unroll
      for (int m = 0; m < L; ++m)
        if (k == m) piece[m][ww] = got;
    }
  }
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const float lk = __shfl_sync(mask, l, base + k);
    const float zk = __shfl_sync(mask, zr, base + k);
    const long long ek = __shfl_sync(mask, e, base + k);
    if (__shfl_sync(mask, live, base + k))
      store_piece(piece[k], lk, zk, x + ek + i * V);
  }
}

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

namespace {

template <typename T>
int dequantize(const void* q, const void* lam, const void* z, void* x,
               long long T_rows, int d, cudaStream_t s) {
  const bool vec = d % kVec == 0 && d <= kMaxVecD &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec) {
    // rows of d / 16 threads, as many as fit 256 threads with the block's
    // size a multiple of 4 (whole lane groups)
    const int gx = d / kVec;
    int gy = kThreads / gx;
    while ((gx * gy) % 4 != 0) --gy;
    const dim3 block(gx, gy);
    const long long blocks = (T_rows + block.y - 1) / block.y;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    kv_dequantize_vec16_kernel<T><<<(unsigned)blocks, block, 0, s>>>(
        (const int8_t*)q, (const float*)lam, (const float*)z, (T*)x, T_rows,
        d);
  } else {
    const long long n = T_rows * d;
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond this
    kv_dequantize_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int8_t*)q, (const float*)lam, (const float*)z, (T*)x, T_rows,
        d);
  }
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[vec ? 0 : 1];
  return (int)err;
}

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16.  d a multiple of 16 (at most 1024)
// with 16-byte aligned q and x takes the 16-byte body, anything else the
// scalar one.
extern "C" int kv_dequantize_launch(const void* q, const void* lam,
                                    const void* z, void* x, long long T, int d,
                                    int out_dtype, void* stream) {
  if (T <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_dtype == 0) return dequantize<float>(q, lam, z, x, T, d, s);
  if (out_dtype == 1) return dequantize<__nv_bfloat16>(q, lam, z, x, T, d, s);
  return (int)cudaErrorInvalidValue;
}

// Launches of dequantize's 16-byte and scalar bodies since the library was
// loaded, into out[0..1]; returns 0.
extern "C" int kv_quant_body_launches(long long* out) {
  out[0] = launched[0];
  out[1] = launched[1];
  return 0;
}
