// The float32 flash-attention body for Hopper (sm_90a): tensor cores by the
// 3xTF32 split, accurate to float32.  Included by flash_prefill_prefix.cu,
// whose header note says what the kernels compute; this note says how.
//
// What bounds it on the H100: operations.  float32 products on the tensor
// cores go through TF32 (10 mantissa bits), so each operand x is split
// into hi = tf32(x) (round to nearest) and lo = x - hi (cut to TF32 by the
// tensor cores; see split()), and each product is taken as lo a' + hi lo'
// + hi hi' with f32 accumulation (in S = Q K^T the two small terms sum
// apart and join the big ones at the end of each tile, two chains of
// dependent mma instead of one): three TF32 products for one f32-accurate
// one, the split CUTLASS calls OpMultiplyAddFastF32.  The bound is 3 x (4 d
// flops per visible (query, key) pair per head) over TF32's 495 TFLOP/s,
// below the FMA body's 1 x the same over float32's 67 TFLOP/s.
//
// Design.
// - One block of 4 warps owns 64 query rows of one (b, head), 16 rows a
//   warp; the grid and the order of q tiles are the FMA body's (in full
//   mode the last q tile first, so the causal kernel's long tiles start
//   first).  Keys come in tiles of kBK (64 for d 64, 32 for d 80 and 128,
//   so that two blocks fit an SM).  Under a causal mask, tiles past the q tile's
//   last position are never read.
// - Both products are mma.sync.m16n8k8 tf32 with f32 accumulators.  S =
//   Q K^T takes Q (A) and K (B) from shared memory with the k index
//   permuted within each pair of k-steps, so that one 16-byte load of a Q
//   or K row feeds two k-steps (slot t of step 2i holds element 16 i + 4 t,
//   slot t + 4 element 16 i + 4 t + 1, step 2i + 1 the next two).  With
//   the keys of each k-step of P V permuted the same way (slot t is key
//   2t, slot t + 4 key 2t + 1), the S accumulator is P's A fragment as it
//   stands: P never leaves registers, and stays in f32 (split like any
//   operand).  V's output columns are permuted so that one thread's B
//   values of four n-tiles are one 16-byte load, and its output elements
//   of a row are contiguous (2 D/8-element runs).  For d 80 (10 n-tiles,
//   runs of 10 floats) the loads and stores are 8 bytes, two n-tiles each.
// - Q and double-buffered K/V tiles arrive by 16-byte cp.async (rows past
//   C or Smax zero-filled), the next K/V tile while this one computes.
//   Shared memory holds unpadded rows with their 16-byte chunks XOR-
//   swizzled so that each quarter-warp's 16-byte loads hit 8 distinct bank
//   groups: chunk c of a Q/K row r at c ^ 4 (r & 1) (d 80 needs none: its
//   row of 20 chunks already puts odd rows 4 bank groups over); of a V row
//   at c ^ t, t = (r / 2) % 4 (d 80, 128) or with t's bit 1 moved to bit 2
//   (d 64).
// - Online softmax in the log2 domain in the accumulator's layout: a
//   thread holds rows g and g + 8 of its warp's 16 (g = lane / 4) and
//   columns 2t, 2t + 1 of each 8-key n-tile (t = lane % 4); a row's max is
//   shared by its 4 threads through two shuffles, its sum stays per thread
//   until the end.  Masked scores are -1e30 (key 0 is visible to every
//   row and the first key tile is always read).
// - A view this body cannot take (an address or a stride not a multiple of
//   16 bytes) is left to the FMA body.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace tf {

constexpr int kThreads = 128;   // 4 warps
constexpr int kBQ = 64;         // query rows per block
constexpr float kNegInf = -1e30f;

template <int D>
__host__ __device__ constexpr int key_tile() { return D == 64 ? 64 : 32; }

// dynamic shared memory: Q, then 2 stages of (K, V)
template <int D>
constexpr int smem_bytes() { return (kBQ + 4 * key_tile<D>()) * D * 4; }

// float offset of logical element c of row r (rows of D floats)
template <int D>
__device__ __forceinline__ int at_qk(int r, int c) {
  const int s = (D / 4) % 8 == 0 ? (r & 1) << 2 : 0;
  return r * D + (((c >> 2) ^ s) << 2) + (c & 3);
}
template <int D>
__device__ __forceinline__ int at_v(int r, int c) {
  const int t = (r >> 1) & 3;
  const int s = D == 64 ? ((t & 1) | ((t & 2) << 1)) : t;
  return r * D + (((c >> 2) ^ s) << 2) + (c & 3);
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// M: 0 prefix (causal on start[b] + i), 1 causal, 2 bidirectional
template <int D, int M>
__global__ void __launch_bounds__(kThreads)
flash_attn_tf32x3_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int32_t* __restrict__ start,
                         float* __restrict__ out, long long qsb, long long qsh,
                         long long qss, long long ksb, long long ksh,
                         long long kss, long long vsb, long long vsh,
                         long long vss, long long osb, long long osh,
                         long long oss, int H, int KVH, int C, int Smax,
                         float scale_log2) {
  constexpr int kBK = key_tile<D>();
  constexpr int NT = kBK / 8;      // n-tiles of S, k-steps of P V
  constexpr int NO = D / 8;        // n-tiles of O
  constexpr int CH = D / 4;        // 16-byte chunks a row
  extern __shared__ __align__(16) float tf_smem[];
  float* sQ = tf_smem;                                  // kBQ x D
  float* sKV = sQ + kBQ * D;                         // [2][K, V] kBK x D

  const int bh = (M == 0) ? blockIdx.y : blockIdx.x;
  const int qt = (M == 0) ? blockIdx.x : gridDim.y - 1 - blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int st = (M == 0) ? start[b] : 0;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;

  const int q_last = min(C, q0 + kBQ) - 1;
  const int n_kv = (M == 2) ? Smax : min(Smax, st + q_last + 1);
  const int n_tiles = (n_kv + kBK - 1) / kBK;

  for (int i = tid; i < kBQ * CH; i += kThreads) {
    const int r = i / CH, c = i - r * CH;
    const bool ok = q0 + r < C;
    cp_async16(sQ + at_qk<D>(r, 4 * c), ok ? qb + (q0 + r) * qss + 4 * c : qb,
               ok);
  }
  auto load_kv = [&](int kt) {
    float* sK = sKV + (kt & 1) * 2 * kBK * D;
    float* sV = sK + kBK * D;
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = i - r * CH;
      const bool ok = k0 + r < Smax;
      cp_async16(sK + at_qk<D>(r, 4 * c),
                 ok ? kb + (k0 + r) * kss + 4 * c : kb, ok);
      cp_async16(sV + at_v<D>(r, 4 * c),
                 ok ? vb + (k0 + r) * vss + 4 * c : vb, ok);
    }
    cp_async_commit();
  };
  load_kv(0);

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  const int ra = warp * 16 + g, rb = ra + 8;          // block rows
  const int pos_a = st + q0 + ra, pos_b = pos_a + 8;  // absolute positions

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      load_kv(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sK = sKV + (kt & 1) * 2 * kBK * D;
    const float* sV = sK + kBK * D;
    const int k0 = kt * kBK;

    // S = Q K^T: the hi hi' products in s, the two small terms in sl (two
    // chains of dependent mma a tile, not one)
    float s[NT][4], sl[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = sl[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const float4 xa = lds4(sQ + at_qk<D>(ra, 16 * kk + 4 * t));
      const float4 xb = lds4(sQ + at_qk<D>(rb, 16 * kk + 4 * t));
      const float a0[4] = {xa.x, xb.x, xa.y, xb.y};
      const float a1[4] = {xa.z, xb.z, xa.w, xb.w};
      uint32_t ah0[4], al0[4], ah1[4], al1[4];
      split4(a0, ah0, al0);
      split4(a1, ah1, al1);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 kf = lds4(sK + at_qk<D>(n * 8 + g, 16 * kk + 4 * t));
        uint32_t bh[2], bl[2];
        split(kf.x, bh[0], bl[0]);
        split(kf.y, bh[1], bl[1]);
        mma(sl[n], al0, bh);
        mma(sl[n], ah0, bl);
        mma(s[n], ah0, bh);
        split(kf.z, bh[0], bl[0]);
        split(kf.w, bh[1], bl[1]);
        mma(sl[n], al1, bh);
        mma(sl[n], ah1, bl);
        mma(s[n], ah1, bh);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += sl[n][e];

    // mask, online softmax (log2 domain)
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const int pos = e < 2 ? pos_a : pos_b;
        const bool vis = key < Smax && (M == 2 || key <= pos);
        const float x = vis ? s[n][e] * scale_log2 : kNegInf;
        s[n][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float c_a = exp2f(m_a - mn_a), c_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - mn_a);
      s[n][1] = exp2f(s[n][1] - mn_a);
      s[n][2] = exp2f(s[n][2] - mn_b);
      s[n][3] = exp2f(s[n][3] - mn_b);
      ps_a += s[n][0] + s[n][1];
      ps_b += s[n][2] + s[n][3];
    }
    l_a = l_a * c_a + ps_a;
    l_b = l_b * c_b + ps_b;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= c_a;
      o[j][1] *= c_a;
      o[j][2] *= c_b;
      o[j][3] *= c_b;
    }

    // O += P V
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      const float pa[4] = {s[ks][0], s[ks][2], s[ks][1], s[ks][3]};
      uint32_t ph[4], pl[4];
      split4(pa, ph, pl);
      const int r0 = ks * 8 + 2 * t;
      if constexpr (NO % 4 == 0) {
#pragma unroll
        for (int jq = 0; jq < NO / 4; ++jq) {
          const float4 v0 = lds4(sV + at_v<D>(r0, g * NO + 4 * jq));
          const float4 v1 = lds4(sV + at_v<D>(r0 + 1, g * NO + 4 * jq));
          const float w0[4] = {v0.x, v0.y, v0.z, v0.w};
          const float w1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t bh[2], bl[2];
            split(w0[jj], bh[0], bl[0]);
            split(w1[jj], bh[1], bl[1]);
            mma3(o[4 * jq + jj], ph, pl, bh, bl);
          }
        }
      } else {   // d 80: runs of 10 floats, 8-byte loads
#pragma unroll
        for (int jp = 0; jp < NO / 2; ++jp) {
          const float2 v0 = lds2(sV + at_v<D>(r0, g * NO + 2 * jp));
          const float2 v1 = lds2(sV + at_v<D>(r0 + 1, g * NO + 2 * jp));
          const float w0[2] = {v0.x, v0.y};
          const float w1[2] = {v1.x, v1.y};
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            uint32_t bh[2], bl[2];
            split(w0[jj], bh[0], bl[0]);
            split(w1[jj], bh[1], bl[1]);
            mma3(o[2 * jp + jj], ph, pl, bh, bl);
          }
        }
      }
    }
    __syncthreads();   // this stage is free for the tile after next
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  float* ob = out + b * osb + h * osh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (q0 + r >= C) continue;
    const float inv = 1.f / fmaxf(half ? l_b : l_a, 1e-30f);
    float* row = ob + (q0 + r) * oss;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      float* dst = row + (2 * t + side) * NO;
      if constexpr (NO % 4 == 0) {
#pragma unroll
        for (int j = 0; j < NO; j += 4)
          *reinterpret_cast<float4*>(dst + j) = make_float4(
              o[j][2 * half + side] * inv, o[j + 1][2 * half + side] * inv,
              o[j + 2][2 * half + side] * inv,
              o[j + 3][2 * half + side] * inv);
      } else {
#pragma unroll
        for (int j = 0; j < NO; j += 2)
          *reinterpret_cast<float2*>(dst + j) = make_float2(
              o[j][2 * half + side] * inv, o[j + 1][2 * half + side] * inv);
      }
    }
  }
}

constexpr int kNotTaken = -1;   // the view does not suit this body

// Launches the body for float32 q/k/v/out with element strides (b, h, s)
// and a contiguous last axis.  Returns kNotTaken when an address or a
// stride is not a multiple of 16 bytes (the caller then takes the FMA
// body), else the launch's cudaError_t.
template <int D, int M>
int launch(const void* q, const void* k, const void* v, const void* start,
           void* out, const long long* qs, const long long* ks,
           const long long* vs, const long long* os, int B, int H, int KVH,
           int C, int Smax, cudaStream_t stream) {
  const void* ptrs[4] = {q, k, v, out};
  const long long* strides[4] = {qs, ks, vs, os};
  for (int a = 0; a < 4; ++a) {
    if (reinterpret_cast<uintptr_t>(ptrs[a]) % 16 != 0) return kNotTaken;
    for (int i = 0; i < 3; ++i)
      if (strides[a][i] % 4 != 0) return kNotTaken;
  }
  const int nq = (C + kBQ - 1) / kBQ;
  if (M != 0 && nq > 65535) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;     // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_tf32x3_kernel<D, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid = (M == 0) ? dim3(nq, B * H) : dim3(B * H, nq);
  flash_attn_tf32x3_kernel<D, M><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const int32_t*)start, (float*)out, qs[0], qs[1], qs[2], ks[0], ks[1],
      ks[2], vs[0], vs[1], vs[2], os[0], os[1], os[2], H, KVH, C, Smax,
      1.4426950408889634f / sqrtf((float)D));
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++wg::launched[wg::kTf32x3Body];
  return (int)err;
}

}  // namespace tf
