// INT8 KV quantize / dequantize for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces: src/repro/kernels/kv_quant/kv_quant.py, functions
//           `kv_quantize` (:37, Pallas body `_quant_kernel`) and
//           `kv_dequantize` (Pallas body `_dequant_kernel`).
//
// Computes per-row asymmetric INT8 (paper Eq. 8) over rows of width d:
//   lam = max((max - min) / 255, 1e-8);  z = round(-min / lam);
//   q = clip(round(x / lam + z), 0, 255) - 128  stored as int8,
// and the inverse x = lam * (q + 128 - z) cast to float32 or bfloat16.
// round() is round-half-to-even (rintf), as jnp.round, and x / lam is a
// true IEEE division, as on the TPU (no fast-math).
//
// What bounds it on the H100: bytes.  A row reduction plus an elementwise
// pass do a handful of operations per byte moved, but the IEEE divisions
// (x / lam for every value, plus lam and z) make quantize's instruction
// stream long: about 13 instructions a value, so with a row's shared work
// some 110 warp instructions a float32 row of 128, against about 180 that
// the card's 528 schedulers can dispatch while its memory moves the row's
// 648 bytes.  So it stays bytes-bound only if the row is read
// once with wide accesses, the per-row work (the reduction's shuffles, lam
// and z, locating the row) is shared by many values, and each warp has
// independent rows in flight to cover the latency of its dependent chain.
//
// Quantize.  One kernel serves two entries:
// - `kv_quantize_launch`, a contiguous (T, d) float32 tensor into q, lam
//   and z (the TPU kernel's interface);
// - `kv_quantize_rows_launch`, the swap's device half: one or two KV
//   stores (K and V) read where they lie, in their own dtype (float32 or
//   bfloat16), as (L, N, O, H, d) at element strides, rows taken in
//   (l, i, o, h) order for i over a list of indices into N (a request's
//   pages of a paged pool) or over all of N (a dense lane's stripe span,
//   or a contiguous tensor).  Row (l, i, o, h) holds token position
//   i * O + o; a row at or past `length` is not read and gets the codes of
//   a zero row (lam 1e-8, z -0.0, codes -128), as the masked copy it
//   replaces.  Each source writes its own q, lam and z, which the wrapper
//   lays out in one staging buffer (kernels/kv_quant/ops.py).
// Two bodies, chosen per call (ops.py `quantize_body` names the choice):
// - 16-byte: d a multiple of the elements a 16-byte load holds (E: 4
//   float32, 8 bfloat16), 2 to 128 such loads a row, every row start
//   16-byte aligned and the codes E-byte aligned.  A row belongs to a
//   group of lpr lanes (2 to 32), each lane holding V (1, 2 or 4) 16-byte
//   loads of it in registers, neighbouring lanes on neighbouring
//   addresses: the row is read once.  Max and min reduce by shuffles
//   inside the group; each lane writes its E codes a load with one E-byte
//   store (4 bytes for float32, 8 for bfloat16), so a group writes its
//   row's codes in whole sectors.  A warp holds 32 / lpr rows at once.
//   The shape is chosen per call from d and the row count: up to 16 values
//   a lane (granite's float32 rows of 128: 8 lanes a row, 4 rows a warp),
//   which shares a row's reduction, lam and z among the most values, as
//   long as that leaves 32 warps an SM; a smaller call (a tier page) takes
//   fewer values a lane, so it still spreads over every SM.  Rows are
//   located by multiply-and-shift division (`FastDiv`), each of a warp's
//   first lanes locating one row.  The grid covers the rows once (a
//   grid-stride loop takes the rest past the launch limit).  Measured and
//   dropped: a grid of one wave, each warp walking many rows; two rows a
//   group at once (more registers, fewer warps); 32-row batches located
//   together.
// - scalar, every other call: one warp per row, the row read twice (the
//   second time from L1/L2).
// Both compute the same operations in the same order, so they agree bit
// for bit with each other and with a plain version that divides (and not
// multiplies by a reciprocal).
//
// Dequantize has two bodies, chosen per call from d and the addresses
// (kernels/kv_quant/ops.py names the choice):
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
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 16;            // codes a thread of the 16-byte body
constexpr int kMaxVecD = 1024;      // its rows: d / 16 <= 64 threads
constexpr int kMaxLoads = 4;        // quantize: 16-byte loads a lane holds
constexpr int kWarpsPerSm = 32;     // quantize: warps an SM should get

// Launches since the library was loaded (host counters, read through
// kv_quant_body_launches): dequantize's 16-byte and scalar bodies, then
// quantize's.
long long launched[4] = {0, 0, 0, 0};

// n / d for n < 2^31 by a multiply and a shift (d's magic number made on
// the host, as CUTLASS's FastDivmod): a row's (l, i, o, h) come from its
// index without a hardware-emulated division.
struct FastDiv {
  unsigned d, m, s;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return d == 1 ? n : __umulhi(n, m) >> s;
  }
};

FastDiv fast_div(unsigned d) {
  FastDiv f{d, 0, 0};
  if (d > 1) {
    int c = 0;
    while ((1u << c) < d) ++c;                  // ceil(log2 d)
    const int p = 31 + c;
    f.m = (unsigned)(((1ull << p) + d - 1) / d);
    f.s = (unsigned)(p - 32);
  }
  return f;
}

// Where a quantize call's rows lie (see the note above).
struct Rows {
  const void* x[2];
  int8_t* q[2];
  float* lam[2];
  float* z[2];
  const long long* pages;      // P indices into N, or null: i itself
  long long sL, sN, sO, sH;    // element strides (d is contiguous)
  long long length;            // positions >= length are not read
  unsigned rows;               // L * P * O * H, a source's rows
  FastDiv P, O, H;
  int d, n_src;
};

// Where global row gr (source rows of source 0, then of source 1) lies:
// its element offset in its source, and flags: 1 a row, 2 read it (its
// position is < length), 4 source 1.
__device__ __forceinline__ int locate(const Rows& R, unsigned gr,
                                      long long* off) {
  if (gr >= R.rows * (unsigned)R.n_src) return 0;
  const int src = gr >= R.rows;
  unsigned r = gr - (src ? R.rows : 0u);
  unsigned t = R.H.div(r);
  const unsigned h = r - t * R.H.d;
  r = R.O.div(t);
  const unsigned o = t - r * R.O.d;
  t = R.P.div(r);
  const unsigned i = r - t * R.P.d;
  const long long n = R.pages ? R.pages[i] : (long long)i;
  *off = t * R.sL + n * R.sN + o * R.sO + h * R.sH;
  return 1 | ((long long)i * R.O.d + o < R.length ? 2 : 0) | (src << 2);
}

template <typename T> struct Load16;
template <> struct Load16<float> {
  static constexpr int E = 4;
  __device__ static void at(const float* p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
};
template <> struct Load16<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void at(const __nv_bfloat16* p, float* v) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// clip(round(v / lam + z), 0, 255) as 0..255; the int8 code is that minus
// 128, i.e. the byte XOR 0x80
__device__ __forceinline__ uint32_t code(float v, float lam, float z) {
  return (uint32_t)fminf(fmaxf(rintf(v / lam + z), 0.0f), 255.0f);
}

// The 16-byte body.  Lane li of group g of a warp owns loads li, li + lpr,
// ... of the group's row; a warp takes 32 / lpr consecutive rows at a
// time (group g the g-th), so a load instruction reads whole rows of
// consecutive groups.  Each of the warp's first lanes locates one of its
// rows, whose place the groups take by shuffles.  lpr is at least 2.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
kv_quantize_vec16_kernel(const Rows R, int lpr_log2) {
  constexpr int E = Load16<T>::E;
  const int lpr = 1 << lpr_log2;
  const int lane = threadIdx.x & 31;
  const int g = lane >> lpr_log2, li = lane & (lpr - 1);
  const int groups = 32 >> lpr_log2;              // rows a warp takes
  const int F = R.d / E;                          // loads of a row
  const unsigned total = R.rows * (unsigned)R.n_src;
  const unsigned warps = gridDim.x * kWarps;
  for (unsigned base = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * groups;
       base < total; base += warps * groups) {
    long long my_off = 0;
    const int my_flags = lane < groups ? locate(R, base + lane, &my_off) : 0;
    const long long off = __shfl_sync(0xffffffffu, my_off, g);
    const int flags = __shfl_sync(0xffffffffu, my_flags, g);
    const T* x = static_cast<const T*>(R.x[flags >> 2]) + off;
    float v[V][E];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = li + k * lpr;
      if ((flags & 2) && j < F) {
        Load16<T>::at(x + j * E, v[k]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) v[k][e] = 0.0f;
      }
    }
    float mx = -INFINITY, mn = INFINITY;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (li + k * lpr < F) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          mx = fmaxf(mx, v[k][e]);
          mn = fminf(mn, v[k][e]);
        }
      }
    }
    for (int o = lpr >> 1; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    if (!(flags & 1)) continue;
    const float lam = fmaxf((mx - mn) / 255.0f, 1e-8f);
    const float z = rintf(-mn / lam);
    const int src = flags >> 2;
    const unsigned row = base + g - (src ? R.rows : 0u);
    int8_t* q = R.q[src] + (long long)row * R.d;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = li + k * lpr;
      if (j >= F) continue;
      uint32_t w[E / 4];
#pragma unroll
      for (int i = 0; i < E / 4; ++i) {
        const float* c = v[k] + 4 * i;
        w[i] = (code(c[0], lam, z) | code(c[1], lam, z) << 8 |
                code(c[2], lam, z) << 16 | code(c[3], lam, z) << 24) ^
               0x80808080u;
      }
      if constexpr (E == 4) {
        *reinterpret_cast<uint32_t*>(q + j * E) = w[0];
      } else {
        *reinterpret_cast<uint2*>(q + j * E) = make_uint2(w[0], w[1]);
      }
    }
    if (li == 0) {
      R.lam[src][row] = lam;
      R.z[src][row] = z;
    }
  }
}

// The scalar body: one warp per row over a grid-stride loop.
template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_quantize_scalar_kernel(const Rows R) {
  const int lane = threadIdx.x & 31;
  const unsigned total = R.rows * (unsigned)R.n_src;
  const unsigned warps = gridDim.x * kWarps;
  for (unsigned gr = blockIdx.x * kWarps + (threadIdx.x >> 5); gr < total;
       gr += warps) {
    long long off = 0;
    const int flags = locate(R, gr, &off);
    const bool read = flags & 2;
    const int s = flags >> 2;
    const unsigned row = gr - (s ? R.rows : 0u);
    const T* x = static_cast<const T*>(R.x[s]) + off;
    float mx = -INFINITY, mn = INFINITY;
    for (int j = lane; j < R.d; j += 32) {
      const float v = read ? to_float(x[j]) : 0.0f;
      mx = fmaxf(mx, v);
      mn = fminf(mn, v);
    }
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    const float lam = fmaxf((mx - mn) / 255.0f, 1e-8f);
    const float z = rintf(-mn / lam);
    int8_t* q = R.q[s] + (long long)row * R.d;
    for (int j = lane; j < R.d; j += 32) {
      const float v = read ? to_float(x[j]) : 0.0f;
      q[j] = (int8_t)(code(v, lam, z) ^ 0x80u);
    }
    if (lane == 0) {
      R.lam[s][row] = lam;
      R.z[s][row] = z;
    }
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


namespace {

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

// a grid that covers `need` blocks once (the kernels' grid-stride loops
// take the rest past the launch limit)
unsigned grid(unsigned long long need) {
  return (unsigned)(need == 0 ? 1 : need < 0x7fffffffull ? need : 0x7fffffff);
}

template <typename T, int V>
void launch_vec16(const Rows& R, int lpr_log2, cudaStream_t s) {
  const unsigned long long rows_a_block =
      (unsigned long long)kWarps * (32 >> lpr_log2);
  const unsigned long long total = (unsigned long long)R.rows * R.n_src;
  kv_quantize_vec16_kernel<T, V>
      <<<grid((total + rows_a_block - 1) / rows_a_block), kThreads, 0, s>>>(
          R, lpr_log2);
}

// The 16-byte body's shape: a lane holds up to 16 values of its row (4
// loads of float32, 2 of bfloat16; granite's float32 rows of 128: 8 lanes
// a row, 4 rows a warp), as long as that leaves kWarpsPerSm warps an SM;
// a smaller call (a tier page) takes fewer values a lane, so that it
// still spreads over every SM.
template <typename T>
void launch_vec16(const Rows& R, int F, cudaStream_t s) {
  constexpr int E = Load16<T>::E;
  const unsigned long long total = (unsigned long long)R.rows * R.n_src;
  const unsigned long long want = (unsigned long long)sm_count() * kWarpsPerSm;
  int lpr_log2 = 1;
  for (int per_lane = 16 / E; ; per_lane >>= 1) {
    lpr_log2 = 1;                         // lanes a row: lpr * per_lane >= F
    while ((1 << lpr_log2) * per_lane < F && lpr_log2 < 5) ++lpr_log2;
    const unsigned long long rows_a_warp = 32ull >> lpr_log2;
    if (per_lane == 1 || (total + rows_a_warp - 1) / rows_a_warp >= want)
      break;
  }
  const int loads = (F + (1 << lpr_log2) - 1) >> lpr_log2;   // a lane's
  if (loads <= 1) launch_vec16<T, 1>(R, lpr_log2, s);
  else if (loads == 2) launch_vec16<T, 2>(R, lpr_log2, s);
  else launch_vec16<T, 4>(R, lpr_log2, s);
}

template <typename T>
int quantize(const Rows& R, cudaStream_t s) {
  constexpr int E = Load16<T>::E;
  const int F = R.d / E;
  bool vec = R.d % E == 0 && F >= 2 && F <= 32 * kMaxLoads &&
             R.sL % E == 0 && R.sN % E == 0 && R.sO % E == 0 &&
             R.sH % E == 0;
  for (int i = 0; i < R.n_src; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(R.x[i]) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(R.q[i]) % E == 0;
  if (vec) {
    launch_vec16<T>(R, F, s);
  } else {
    const unsigned long long total = (unsigned long long)R.rows * R.n_src;
    kv_quantize_scalar_kernel<T>
        <<<grid((total + kWarps - 1) / kWarps), kThreads, 0, s>>>(R);
  }
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[vec ? 2 : 3];
  return (int)err;
}

int quantize_rows(const Rows& R, int in_dtype, cudaStream_t s) {
  if (in_dtype == 0) return quantize<float>(R, s);
  if (in_dtype == 1) return quantize<__nv_bfloat16>(R, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The (T, d) float32 entry.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue on a bad shape.
extern "C" int kv_quantize_launch(const void* x, void* q, void* lam, void* z,
                                  long long T, int d, void* stream) {
  if (T <= 0 || d <= 0 || T > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Rows R{};
  R.x[0] = x;
  R.q[0] = (int8_t*)q;
  R.lam[0] = (float*)lam;
  R.z[0] = (float*)z;
  R.sO = d;
  R.length = T;
  R.rows = (unsigned)T;
  R.P = R.H = fast_div(1);
  R.O = fast_div((unsigned)T);
  R.d = d;
  R.n_src = 1;
  return quantize_rows(R, 0, (cudaStream_t)stream);
}

// The store entry: sources k and (when not null) v, both (L, N, O, H, d) at
// element strides sL, sN, sO, sH with d contiguous, of in_dtype (0 =
// float32, 1 = bfloat16); pages: P int64 indices into N, or null for
// i itself (then P = N); rows at positions i * O + o >= length read as
// zeros.  Source k's rows go to qk, lamk, zk and v's to qv, lamv, zv.
// Returns cudaGetLastError(), or cudaErrorInvalidValue on a bad shape.
extern "C" int kv_quantize_rows_launch(
    const void* k, const void* v, void* qk, void* lamk, void* zk, void* qv,
    void* lamv, void* zv, const void* pages, long long L, long long P,
    long long O, long long H, int d, long long sL, long long sN, long long sO,
    long long sH, long long length, int in_dtype, void* stream) {
  const int n_src = v ? 2 : 1;
  if (L <= 0 || P <= 0 || O <= 0 || H <= 0 || d <= 0 || !k)
    return (int)cudaErrorInvalidValue;
  const long long rows = L * P * O * H;
  if (rows > 0x7fffffffLL / n_src || P * O > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Rows R{};
  R.x[0] = k;
  R.x[1] = v;
  R.q[0] = (int8_t*)qk;
  R.q[1] = (int8_t*)qv;
  R.lam[0] = (float*)lamk;
  R.lam[1] = (float*)lamv;
  R.z[0] = (float*)zk;
  R.z[1] = (float*)zv;
  R.pages = (const long long*)pages;
  R.sL = sL;
  R.sN = sN;
  R.sO = sO;
  R.sH = sH;
  R.length = length;
  R.rows = (unsigned)rows;
  R.P = fast_div((unsigned)P);
  R.O = fast_div((unsigned)O);
  R.H = fast_div((unsigned)H);
  R.d = d;
  R.n_src = n_src;
  return quantize_rows(R, in_dtype, (cudaStream_t)stream);
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

// Launches since the library was loaded, into out[0..3]: dequantize's
// 16-byte and scalar bodies, then quantize's; returns 0.
extern "C" int kv_quant_body_launches(long long* out) {
  for (int i = 0; i < 4; ++i) out[i] = launched[i];
  return 0;
}
