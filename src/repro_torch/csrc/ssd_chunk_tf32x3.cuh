// The tensor-core body of the SSD chunk step for Hopper (sm_90a), at f32
// accuracy by the 3xTF32 split (tf32x3.cuh).  Included by ssd_chunk.cu,
// whose header note says what the step computes; this note says how.
//
// What bounds it on the H100: operations.  Per chunk, C . B^T once (Q^2 N
// / 2 multiply-adds, shared by the heads) and per head the decayed scores
// times xbar (Q^2 P / 2) and the state (Q P N), each f32 product taken as
// three TF32 products: 3 x 2.74 GFLOP over TF32's 495 TFLOP/s is 0.0166 ms
// at B 1, C 4, Q 256, H 80, P 64, N 128, just above the 0.0159 ms its 53
// MB take at 3.35 TB/s.
//
// Takes Q <= 256, P 64, N 128 (mamba2-2.7b's heads and state; jamba's
// heads of 128 columns come as two heads of 64, kernels/ssd_scan/plan.py)
// and 16-byte aligned tensors; the FMA body in ssd_chunk.cu takes every
// other shape.
// Two launches, in stream order:
//  1. ssd_states_tf32x3_kernel.  Blocks [0, n_bc * H) each own one (b, c,
//     head): the head's cumsum, chunk_decay and its (P x N) state, the
//     rows s streamed in 32-row tiles of xbar and B (2-stage cp.async),
//     xbar's rows scaled by exp(cum[Q-1] - cum[s]) (P = 64 is narrower
//     than N) and the product xbar_d^T B taken by 4 warps of 32 state
//     columns each.  The last n_bc * ceil(Q / 64) blocks each own one (b,
//     c, 64-row q tile) and write its score tile S = C . B^T, s <= the
//     tile's last row, into the scratch, in the mma accumulator's layout
//     (warp, n-tile, lane): the y kernel's threads read back exactly the
//     values they multiply.
//  2. ssd_y_tf32x3_kernel.  A block owns one (b, c, q tile) and a group of
//     heads (kernels/ssd_scan/plan.py sizes the groups from the shapes so
//     that every block has about the same work, (q tile + 1) x heads, and
//     the grid is about one wave of 2 blocks an SM; q tiles walked from
//     the last down, so the long blocks start first).  Each warp owns 16
//     query rows and loads the scores of their q tile once, into registers
//     (up to 32 n-tiles x 4), for all the group's heads.  Per head it
//     multiplies each score by exp(cum[q] - cum[s]), taken as ex2 of the
//     difference times log2 e, masked BEFORE the exp, element by element
//     (s > q gives ex2(-inf) = 0; cum reaches -180 over a chunk at the
//     model's dt, so exp(cum[q]) . exp(-cum[s]) would overflow), splits
//     it and takes (L o S) xbar, with xbar's rows streamed in 64-row tiles
//     (2-stage cp.async ring across the group's heads).  Each warp walks
//     whole tiles up to the block's last row, with no branch a k-step;
//     the mask zeroes what lies above its own rows.  On the H100 each of
//     these was slower: splitting each xbar tile once in shared memory for
//     the 4 warps (twice the shared loads), a second code path without
//     the mask for the tiles below the diagonal, and scaling cum by log2 e
//     before the difference (also less accurate).
// Every block computes the cumsum of its heads with one warp a head (lane l
// sums rows 8l..8l+7, then a shuffle scan), in double, and keeps float
// offsets from a reference row near the rows whose decays it takes
// (warp_cumsum): float cumsums of the model's decay (about -180 over a
// chunk) left the kernel's y up to twice as far from the float64 truth
// as the plain version's at 128 heads of 128.

// Fragment layouts (tf32x3.cuh gives the mma's).  The k slots of a k-step
// are permuted so that wide loads feed them: in C . B^T slot t of k-step
// 2i is state element 16i + 4t and slot t + 4 element 16i + 4t + 1, step
// 2i + 1 the next two (one 16-byte load of a C or B row feeds two steps);
// in the s sums slot t is row s0 + 2t and slot t + 4 row s0 + 2t + 1, so
// the score accumulator (c0 c1 c2 c3) is the y product's A fragment as (c0
// c2 c1 c3).  y's output column p of n-tile j and in-tile column c is c * 8
// + j: a thread's B values of the 8 n-tiles are 8 consecutive floats of an
// xbar row (two 16-byte loads) and its outputs two runs of 8.  In the
// state, m-tile m's rows g and g + 8 are p = 8g + 2m and 8g + 2m + 1 (a
// thread's A values of the 4 m-tiles are 8 consecutive floats of an xbar
// row) and n-tile j's column c of warp w is n = 32w + 4c + j (one 16-byte
// load of a B row feeds the warp's 4 n-tiles).  Shared memory rows are
// unpadded, their 16-byte chunks XOR-swizzled so that each quarter-warp's
// loads hit 8 distinct bank groups (at_x, at_b, at_k below).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace ssd {

using tf::cp_async16;
using tf::lds4;
using tf::mma;
using tf::mma3;
using tf::split;
using tf::split4;

constexpr int kThreads = 128;    // 4 warps
constexpr int kP = 64;           // head dim the body takes
constexpr int kN = 128;          // state size the body takes
constexpr int kQT = 64;          // query rows of a y block / score tile
constexpr int kMaxQ = 256;       // chunk rows the body takes
constexpr int kMaxQT = kMaxQ / kQT;
constexpr int kMaxNT = kMaxQ / 8;   // score n-tiles of a warp's rows
constexpr int kMaxGroup = 16;    // heads of a y block
constexpr int kST = 32;          // rows of a states / scores tile
constexpr int kYT = 64;          // rows of a y block's xbar tile
constexpr float kLog2e = 1.4426950408889634f;

// 2^x (ex2.approx: relative error about 2^-22; -inf gives +0, results
// below 2^-126 flush to 0, far under the f32 tolerance of a sum)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// float offsets of logical element c of row r in shared tiles
// xbar rows (64 floats): the loads are (row s0 + 2t (+1), chunk 2g (+1))
__device__ __forceinline__ int at_x(int r, int c) {
  const int t = (r >> 1) & 3;
  return r * kP + (((c >> 2) ^ ((t & 1) | ((t & 2) << 1))) << 2) + (c & 3);
}
// B rows (128 floats) of the states: (row s0 + 2t (+1), chunk 8w + g)
__device__ __forceinline__ int at_b(int r, int c) {
  return r * kN + (((c >> 2) ^ (((r >> 1) & 3) << 1)) << 2) + (c & 3);
}
// C and B rows (128 floats) of the scores: (row g (+8), chunk 4i + t)
__device__ __forceinline__ int at_k(int r, int c) {
  return r * kN + (((c >> 2) ^ ((r & 1) << 2)) << 2) + (c & 3);
}

// Inclusive cumsum of dA[base + q * H], q < Q, by one warp, in double,
// stored into cum[0:256] as float offsets from the cumsum at row ref,
// cum[q] = cumsum[q] - cumsum[ref] (rows past Q repeat row Q - 1);
// returns cumsum[ref] as a float.  The decay's exponents are differences
// of these offsets: taken from a reference row near the rows that weigh
// (a q tile's middle, the chunk's last row), they are small where the
// decay is not, so their float rounding stays near the difference's own,
// where float cumsums reaching -180 over a chunk (the model's decay)
// would each carry an error of many units in the last place of 180.
__device__ __forceinline__ float warp_cumsum(const float* __restrict__ dA,
                                             long long base, int H, int Q,
                                             int ref, float* cum, int lane) {
  double v[8];
  double run = 0.0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = lane * 8 + i;
    if (q < Q) run += (double)dA[base + (long long)q * H];
    v[i] = run;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  double before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.0;
  double at_ref = 0.0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] += before;
    if (lane * 8 + i == ref) at_ref = v[i];
  }
  at_ref = __shfl_sync(0xffffffffu, at_ref, ref >> 3);
#pragma unroll
  for (int i = 0; i < 8; ++i) cum[lane * 8 + i] = (float)(v[i] - at_ref);
  return (float)at_ref;
}

// score n-tiles of warp w's rows in q tile qt: every s < min(Q, q0 + 64)
// (the tile's last row; above a warp's own rows the decay's mask zeroes
// them, so that each warp walks whole xbar tiles without a branch per
// k-step); none for a warp whose rows all lie past Q
__device__ __forceinline__ int warp_ntiles(int Q, int q0, int w) {
  return q0 + 16 * w < Q ? (min(Q, q0 + kQT) + 7) / 8 : 0;
}

// ------------------------------------------------------------ launch 1

// states of (b, c, head h): st[p, n] = sum_s xbar[s, p] d[s] B[s, n]
__device__ __forceinline__ void states_job(
    const float* __restrict__ xbar, const float* __restrict__ dA,
    const float* __restrict__ Bm, float* __restrict__ st,
    float* __restrict__ dk, long long bc, int h, int Q, int H, float* sm) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* cum = sm;                        // 256
  float* dec = cum + kMaxQ;               // 256
  float* ring = dec + kMaxQ;              // 2 x (X 32 x 64, B 32 x 128)
  constexpr int kXF = kST * kP, kStage = kST * (kP + kN);
  const float* xb = xbar + (bc * Q * H + h) * kP;
  const float* bb = Bm + bc * Q * kN;
  const int n_kt = (Q + kST - 1) / kST;

  auto load = [&](int kt) {
    float* X = ring + (kt & 1) * kStage;
    float* Bt = X + kXF;
    const int s0 = kt * kST;
    for (int i = tid; i < kST * kP / 4; i += kThreads) {
      const int r = i >> 4, c = (i & 15) * 4;
      const bool ok = s0 + r < Q;
      cp_async16(X + at_x(r, c), ok ? xb + (long long)(s0 + r) * H * kP + c
                                    : xb, ok);
    }
    for (int i = tid; i < kST * kN / 4; i += kThreads) {
      const int r = i >> 5, c = (i & 31) * 4;
      const bool ok = s0 + r < Q;
      cp_async16(Bt + at_b(r, c), ok ? bb + (long long)(s0 + r) * kN + c
                                     : bb, ok);
    }
    tf::cp_async_commit();
  };
  load(0);

  // offsets from the last row: dec[s] = exp(cumsum[Q-1] - cumsum[s])
  if (warp == 0) {
    const float last = warp_cumsum(dA, bc * Q * H + h, H, Q, Q - 1, cum,
                                   lane);
    if (lane == 0) dk[bc * H + h] = expf(last);
  }
  __syncthreads();
  for (int s = tid; s < kMaxQ; s += kThreads)
    dec[s] = s < Q ? expf(-cum[s]) : 0.f;

  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load(kt + 1);
      tf::cp_async_wait<1>();
    } else {
      tf::cp_async_wait<0>();
    }
    __syncthreads();
    const float* X = ring + (kt & 1) * kStage;
    const float* Bt = X + kXF;
#pragma unroll
    for (int ks = 0; ks < kST / 8; ++ks) {
      const int r0 = ks * 8 + 2 * t;
      const float2 d = *reinterpret_cast<const float2*>(dec + kt * kST + r0);
      const float4 x00 = lds4(X + at_x(r0, 8 * g));
      const float4 x01 = lds4(X + at_x(r0, 8 * g + 4));
      const float4 x10 = lds4(X + at_x(r0 + 1, 8 * g));
      const float4 x11 = lds4(X + at_x(r0 + 1, 8 * g + 4));
      const float xa[8] = {x00.x, x00.y, x00.z, x00.w,
                           x01.x, x01.y, x01.z, x01.w};
      const float xc[8] = {x10.x, x10.y, x10.z, x10.w,
                           x11.x, x11.y, x11.z, x11.w};
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float a[4] = {xa[2 * m] * d.x, xa[2 * m + 1] * d.x,
                            xc[2 * m] * d.y, xc[2 * m + 1] * d.y};
        split4(a, ah[m], al[m]);
      }
      const float4 b0 = lds4(Bt + at_b(r0, 32 * warp + 4 * g));
      const float4 b1 = lds4(Bt + at_b(r0 + 1, 32 * warp + 4 * g));
      const float bv0[4] = {b0.x, b0.y, b0.z, b0.w};
      const float bv1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bh[2], bl[2];
        split(bv0[j], bh[0], bl[0]);
        split(bv1[j], bh[1], bl[1]);
#pragma unroll
        for (int m = 0; m < 4; ++m) mma3(acc[m][j], ah[m], al[m], bh, bl);
      }
    }
    __syncthreads();   // this stage is free for the tile after next
  }

  float* out = st + (bc * H + h) * kP * kN + 32 * warp + 8 * t;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* row = out + (8 * g + 2 * m + half) * kN;
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[m][0][2 * half], acc[m][1][2 * half],
                      acc[m][2][2 * half], acc[m][3][2 * half]);
      *reinterpret_cast<float4*>(row + 4) =
          make_float4(acc[m][0][2 * half + 1], acc[m][1][2 * half + 1],
                      acc[m][2][2 * half + 1], acc[m][3][2 * half + 1]);
    }
}

// scores of (b, c, q tile qt): S[q, s] = C[q] . B[s], s < the tile's end
__device__ __forceinline__ void score_job(const float* __restrict__ Bm,
                                          const float* __restrict__ Cm,
                                          float* __restrict__ score,
                                          long long bc, int qt, int n_qt,
                                          int Q, float* sm) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* Ct = sm;                         // 64 x 128
  float* ring = Ct + kQT * kN;            // 2 x (32 x 128)
  const int q0 = qt * kQT;
  const int s_end = min(Q, q0 + kQT);
  const int n_kt = (s_end + kST - 1) / kST;
  const int nj = warp_ntiles(Q, q0, warp);
  const float* bb = Bm + bc * Q * kN;
  const float* cb = Cm + bc * Q * kN;

  for (int i = tid; i < kQT * kN / 4; i += kThreads) {
    const int r = i >> 5, c = (i & 31) * 4;
    const bool ok = q0 + r < Q;
    cp_async16(Ct + at_k(r, c), ok ? cb + (long long)(q0 + r) * kN + c : cb,
               ok);
  }
  auto load = [&](int kt) {
    float* Bt = ring + (kt & 1) * kST * kN;
    const int s0 = kt * kST;
    for (int i = tid; i < kST * kN / 4; i += kThreads) {
      const int r = i >> 5, c = (i & 31) * 4;
      const bool ok = s0 + r < Q;
      cp_async16(Bt + at_k(r, c), ok ? bb + (long long)(s0 + r) * kN + c
                                     : bb, ok);
    }
    tf::cp_async_commit();
  };
  load(0);

  float* out = score + ((bc * n_qt + qt) * 4 + warp) * (kMaxNT * 128)
               + lane * 4;
  const int ra = 16 * warp + g, rb = ra + 8;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load(kt + 1);
      tf::cp_async_wait<1>();
    } else {
      tf::cp_async_wait<0>();
    }
    __syncthreads();
    const float* Bt = ring + (kt & 1) * kST * kN;
    if (kt * 4 < nj) {
      // the hi hi' products in s, the two small terms in sl
      float s[4][4], sl[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.f;
#pragma unroll 2
      for (int i = 0; i < kN / 16; ++i) {
        const float4 xa = lds4(Ct + at_k(ra, 16 * i + 4 * t));
        const float4 xb = lds4(Ct + at_k(rb, 16 * i + 4 * t));
        const float a0[4] = {xa.x, xb.x, xa.y, xb.y};
        const float a1[4] = {xa.z, xb.z, xa.w, xb.w};
        uint32_t ah0[4], al0[4], ah1[4], al1[4];
        split4(a0, ah0, al0);
        split4(a1, ah1, al1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 bf = lds4(Bt + at_k(8 * j + g, 16 * i + 4 * t));
          uint32_t bh[2], bl[2];
          split(bf.x, bh[0], bl[0]);
          split(bf.y, bh[1], bl[1]);
          mma(sl[j], al0, bh);
          mma(sl[j], ah0, bl);
          mma(s[j], ah0, bh);
          split(bf.z, bh[0], bl[0]);
          split(bf.w, bh[1], bl[1]);
          mma(sl[j], al1, bh);
          mma(sl[j], ah1, bl);
          mma(s[j], ah1, bh);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kt * 4 + j < nj)
          *reinterpret_cast<float4*>(out + (kt * 4 + j) * 128) =
              make_float4(s[j][0] + sl[j][0], s[j][1] + sl[j][1],
                          s[j][2] + sl[j][2], s[j][3] + sl[j][3]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 3)
ssd_states_tf32x3_kernel(const float* __restrict__ xbar,
                         const float* __restrict__ dA,
                         const float* __restrict__ Bm,
                         const float* __restrict__ Cm, float* __restrict__ st,
                         float* __restrict__ dk, float* __restrict__ score,
                         int n_bc, int Q, int H) {
  extern __shared__ __align__(16) float ssd_smem[];
  const long long n_state = (long long)n_bc * H;
  const long long x = blockIdx.x;
  if (x < n_state) {
    states_job(xbar, dA, Bm, st, dk, x / H, (int)(x % H), Q, H, ssd_smem);
  } else {
    const int n_qt = (Q + kQT - 1) / kQT;
    const long long j = x - n_state;      // the last q tiles first
    score_job(Bm, Cm, score, j % n_bc, n_qt - 1 - (int)(j / n_bc), n_qt, Q,
              ssd_smem);
  }
}

constexpr int states_smem_bytes() {
  const int states = (2 * kMaxQ + 2 * kST * (kP + kN)) * 4;
  const int scores = (kQT * kN + 2 * kST * kN) * 4;
  return states > scores ? states : scores;
}

// ------------------------------------------------------------ launch 2

struct Groups {
  int heads[kMaxQT];   // heads of a y block, per q tile
};

__global__ void __launch_bounds__(kThreads, 2)
ssd_y_tf32x3_kernel(const float* __restrict__ xbar,
                    const float* __restrict__ dA,
                    const float* __restrict__ score, float* __restrict__ y,
                    int n_bc, int Q, int H, Groups groups) {
  extern __shared__ __align__(16) float ssd_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (Q + kQT - 1) / kQT;

  // block -> (q tile, head group, bc): the last q tiles first, bc fastest
  long long x = blockIdx.x;
  int qt = n_qt - 1, gh = groups.heads[qt];
  for (;;) {
    const long long n = (long long)((H + gh - 1) / gh) * n_bc;
    if (x < n || qt == 0) break;
    x -= n;
    --qt;
    gh = groups.heads[qt];
  }
  // the q tile's heads cut into ceil(H / gh) groups of near-equal size
  const long long bc = x % n_bc;
  const int n_g = (H + gh - 1) / gh, grp = (int)(x / n_bc);
  const int h0 = (int)((long long)grp * H / n_g);
  const int nh = (int)((long long)(grp + 1) * H / n_g) - h0;
  const int q0 = qt * kQT;
  const int n_kt = qt + 1;               // xbar tiles of 64 rows
  const int n_items = nh * n_kt;

  float* cum = ssd_smem;                 // kMaxGroup x 256
  float* ring = cum + kMaxGroup * kMaxQ; // 2 x (64 x 64)
  constexpr int kTile = kYT * kP, kStage = kTile;
  const float* xb = xbar + bc * Q * H * kP;

  auto load = [&](int it) {
    float* X = ring + (it & 1) * kStage;
    const int hh = it / n_kt, kt = it - hh * n_kt;
    const float* src = xb + (long long)(h0 + hh) * kP;
    const int s0 = kt * kYT;
    for (int i = tid; i < kTile / 4; i += kThreads) {
      const int r = i >> 4, c = (i & 15) * 4;
      const bool ok = s0 + r < Q;
      cp_async16(X + at_x(r, c),
                 ok ? src + (long long)(s0 + r) * H * kP + c : src, ok);
    }
    tf::cp_async_commit();
  };
  load(0);

  // offsets from the q tile's middle row (its decays' exponents are
  // differences of rows near it)
  const int ref = min(q0 + kQT / 2, Q - 1);
  for (int hh = warp; hh < nh; hh += kThreads / 32)
    warp_cumsum(dA, bc * Q * H + h0 + hh, H, Q, ref, cum + hh * kMaxQ,
                lane);

  // this warp's scores, in registers for every head of the group
  const int nj = warp_ntiles(Q, q0, warp);
  const float* sc = score + ((bc * n_qt + qt) * 4 + warp) * (kMaxNT * 128)
                    + lane * 4;
  float S[kMaxNT][4];
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < nj) v = *reinterpret_cast<const float4*>(sc + j * 128);
    S[j][0] = v.x;
    S[j][1] = v.y;
    S[j][2] = v.z;
    S[j][3] = v.w;
  }
  __syncthreads();

  const int qa = q0 + 16 * warp + g, qb = qa + 8;
  int it = 0;
  for (int hh = 0; hh < nh; ++hh) {
    const float* ch = cum + hh * kMaxQ;
    const float cqa = ch[qa], cqb = ch[qb];
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
    for (int kt = 0; kt < kMaxQT; ++kt) {
      if (kt < n_kt) {
        if (it + 1 < n_items) {
          load(it + 1);
          tf::cp_async_wait<1>();
        } else {
          tf::cp_async_wait<0>();
        }
        __syncthreads();
        const float* X = ring + (it & 1) * kStage;
        if (nj > 0) {
#pragma unroll
          for (int ks = 0; ks < kYT / 8; ++ks) {
            const int j = kt * (kYT / 8) + ks;
            const int r0 = ks * 8 + 2 * t, s0 = kt * kYT + r0;
            const float2 cs = *reinterpret_cast<const float2*>(ch + s0);
            // the decay masked before the exp, element by element
            const float a[4] = {
                S[j][0] * ex2(s0 <= qa ? (cqa - cs.x) * kLog2e : -INFINITY),
                S[j][2] * ex2(s0 <= qb ? (cqb - cs.x) * kLog2e : -INFINITY),
                S[j][1] * ex2(s0 + 1 <= qa ? (cqa - cs.y) * kLog2e
                                           : -INFINITY),
                S[j][3] * ex2(s0 + 1 <= qb ? (cqb - cs.y) * kLog2e
                                           : -INFINITY)};
            uint32_t ah[4], al[4];
            split4(a, ah, al);
            const float4 x00 = lds4(X + at_x(r0, 8 * g));
            const float4 x01 = lds4(X + at_x(r0, 8 * g + 4));
            const float4 x10 = lds4(X + at_x(r0 + 1, 8 * g));
            const float4 x11 = lds4(X + at_x(r0 + 1, 8 * g + 4));
            const float xa[8] = {x00.x, x00.y, x00.z, x00.w,
                                 x01.x, x01.y, x01.z, x01.w};
            const float xc[8] = {x10.x, x10.y, x10.z, x10.w,
                                 x11.x, x11.y, x11.z, x11.w};
#pragma unroll
            for (int jn = 0; jn < 8; ++jn) {
              uint32_t bh[2], bl[2];
              split(xa[jn], bh[0], bl[0]);
              split(xc[jn], bh[1], bl[1]);
              mma3(acc[jn], ah, al, bh, bl);
            }
          }
        }
        __syncthreads();   // this stage is free for the tile after next
        ++it;
      }
    }
    float* yh = y + (bc * Q * H + h0 + hh) * kP + 16 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = half ? qb : qa;
      if (q >= Q) continue;
      float* row = yh + (long long)q * H * kP;
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int j = 0; j < 8; j += 4)
          *reinterpret_cast<float4*>(row + 8 * side + j) = make_float4(
              acc[j][2 * half + side], acc[j + 1][2 * half + side],
              acc[j + 2][2 * half + side], acc[j + 3][2 * half + side]);
    }
  }
}

constexpr int y_smem_bytes() { return (kMaxGroup * kMaxQ + 2 * kYT * kP) * 4; }

}  // namespace ssd
