// SSD intra-chunk step of Mamba-2 for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py, function `ssd_chunk`
//           (Pallas body `_kernel`).
//
// Per (b, chunk c, head h), with cum = cumsum(dA[b, c, :, h]) over the
// chunk's Q rows:
//   y_diag[q, :] = sum_{s <= q} (C[q] . B[s]) * exp(cum[q] - cum[s]) * xbar[s, :]
//   states[p, n] = sum_s xbar[s, p] * B[s, n] * exp(cum[Q-1] - cum[s])
//   chunk_decay  = exp(cum[Q-1])
// Inputs xbar (B, C, Q, H, P), dA (B, C, Q, H), B and C (B, C, Q, N);
// outputs y_diag (B, C, Q, H, P), states (B, C, H, P, N), chunk_decay
// (B, C, H); everything float32.  The decay is masked above the diagonal
// BEFORE the exp, as ssd_scan.py does: for s > q, cum[q] - cum[s] is
// positive, its exp can overflow, and inf * 0 would give NaN.
//
// What bounds it on the H100: operations.  Per chunk and head the two
// products do about Q^2/2 * (N + P) + Q * P * N multiply-adds in float32
// against a few bytes per (q, p) and (p, n) element moved.
//
// Design (simple first).  The TPU kernel holds a (b, c, h)'s whole (Q, Q)
// decay matrix and its (Q, N) B and C tiles in VMEM: at Q 256 and N 128 in
// float32 that is 256 KB + 2 x 128 KB, more than the 227 KB of shared
// memory a Hopper block can have.  Here the query rows are tiled and B and
// C are streamed.  Every block recomputes its chunk's cumsum (a block-wide
// scan into shared memory), then does one of two jobs, by blockIdx.y:
//  * a y block owns kQT query rows: it keeps their C rows in shared memory,
//    streams B and xbar in kST-row tiles of s up to its last row, forms the
//    masked, decayed score tile (kQT x kST) in shared memory and
//    accumulates its (kQT x P) outputs in registers;
//  * a state block owns kPT rows p of the state: it streams the decayed B
//    rows and xbar's columns in kST-row tiles and accumulates (kPT x N) in
//    registers.
// All arithmetic is float32 FMA on the CUDA cores.  C . B^T is the same for
// every head of a chunk (ngroups 1) and is recomputed per head here;
// sharing it across heads, and tensor cores, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 32;          // query rows per y block
constexpr int kST = 32;          // s rows per streamed tile
constexpr int kPT = 16;          // state rows p per state block
constexpr int kMaxQ = 1024;
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kScanPer = kMaxQ / kThreads;                 // cumsum rows per thread
constexpr int kAccY = kQT * kMaxP / kThreads;              // y outputs per thread
constexpr int kAccS = kPT * kMaxN / kThreads;              // state outputs per thread
constexpr int kScorePer = kQT * kST / kThreads;            // score entries per thread

// Inclusive cumsum of dA[base + q * H] for q < Q into cum[0:Q] (shared).
// Thread t scans rows [t*E, t*E + E) serially, E = ceil(Q / kThreads); the
// per-thread totals are scanned across the block with warp shuffles.
__device__ void chunk_cumsum(const float* __restrict__ dA, long long base,
                             int H, int Q, float* cum, float* warp_tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int E = (Q + kThreads - 1) / kThreads;
  float v[kScanPer];
  float run = 0.0f;
#pragma unroll
  for (int i = 0; i < kScanPer; ++i) {
    const int q = t * E + i;
    if (i < E && q < Q) run += dA[base + (long long)q * H];
    v[i] = run;
  }
  float incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? warp_tot[lane] : 0.0f;
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    if (lane < kWarps) warp_tot[lane] = w;       // inclusive over warps
  }
  __syncthreads();
  const float before = excl + (warp > 0 ? warp_tot[warp - 1] : 0.0f);
#pragma unroll
  for (int i = 0; i < kScanPer; ++i) {
    const int q = t * E + i;
    if (i < E && q < Q) cum[q] = before + v[i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ xbar, const float* __restrict__ dA,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ y, float* __restrict__ st,
                 float* __restrict__ dk, int Q, int H, int P, int N,
                 int n_yblocks) {
  extern __shared__ float smem[];
  __shared__ float warp_tot[kWarps];
  const int t = threadIdx.x;
  const long long bch = blockIdx.x;            // ((b * C) + c) * H + h
  const int h = (int)(bch % H);
  const long long bc = bch / H;                // b * C + c
  const int qpad = (Q + 3) & ~3;
  float* cum = smem;
  chunk_cumsum(dA, bc * Q * H + h, H, Q, cum, warp_tot);
  if (blockIdx.y == 0 && t == 0) dk[bch] = expf(cum[Q - 1]);

  const float* Bc = Bm + bc * Q * N;
  const float* Cc = Cm + bc * Q * N;
  const long long xstride = (long long)H * P;   // between rows s of xbar
  const float* xc = xbar + bc * Q * xstride + (long long)h * P;

  if ((int)blockIdx.y < n_yblocks) {
    // ---------------------------------------------------------- y block
    const int q0 = blockIdx.y * kQT;
    const int nq = min(kQT, Q - q0);
    const int ld = N + 1;                        // padded rows: no bank clash
    float* Cs = cum + qpad;                      // kQT x ld
    float* Bs = Cs + kQT * ld;                   // kST x ld
    float* Xs = Bs + kST * ld;                   // kST x P
    float* Ss = Xs + kST * P;                    // kQT x (kST + 1)
    for (int i = t; i < kQT * N; i += kThreads) {
      const int q = i / N, n = i % N;
      Cs[q * ld + n] = q < nq ? Cc[(long long)(q0 + q) * N + n] : 0.0f;
    }
    float acc[kAccY];
#pragma unroll
    for (int k = 0; k < kAccY; ++k) acc[k] = 0.0f;
    const int s_end = q0 + nq;                   // rows s <= the last q
    for (int s0 = 0; s0 < s_end; s0 += kST) {
      const int ns = min(kST, s_end - s0);
      __syncthreads();                           // the last tile is consumed
      for (int i = t; i < kST * N; i += kThreads) {
        const int s = i / N, n = i % N;
        Bs[s * ld + n] = s < ns ? Bc[(long long)(s0 + s) * N + n] : 0.0f;
      }
      for (int i = t; i < kST * P; i += kThreads) {
        const int s = i / P, p = i % P;
        Xs[i] = s < ns ? xc[(long long)(s0 + s) * xstride + p] : 0.0f;
      }
      __syncthreads();
      // score tile: thread t owns column s = t % kST of rows t / kST + k * 8
      {
        const int s = t % kST;
        float dot[kScorePer];
#pragma unroll
        for (int k = 0; k < kScorePer; ++k) dot[k] = 0.0f;
        for (int n = 0; n < N; ++n) {
          const float b = Bs[s * ld + n];
#pragma unroll
          for (int k = 0; k < kScorePer; ++k) {
            const int q = t / kST + k * (kThreads / kST);
            dot[k] = fmaf(Cs[q * ld + n], b, dot[k]);
          }
        }
        const int sa = s0 + s;
#pragma unroll
        for (int k = 0; k < kScorePer; ++k) {
          const int q = t / kST + k * (kThreads / kST);
          const int qa = q0 + q;
          float v = 0.0f;
          if (q < nq && s < ns && sa <= qa) v = dot[k] * expf(cum[qa] - cum[sa]);
          Ss[q * (kST + 1) + s] = v;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kAccY; ++k) {
        const int i = t + k * kThreads;
        if (i < kQT * P) {
          const int q = i / P, p = i % P;
          float a = acc[k];
          for (int s = 0; s < ns; ++s)
            a = fmaf(Ss[q * (kST + 1) + s], Xs[s * P + p], a);
          acc[k] = a;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kAccY; ++k) {
      const int i = t + k * kThreads;
      if (i < kQT * P) {
        const int q = i / P, p = i % P;
        if (q < nq) y[((bc * Q + q0 + q) * H + h) * P + p] = acc[k];
      }
    }
  } else {
    // ------------------------------------------------------ state block
    const int p0 = (blockIdx.y - n_yblocks) * kPT;
    const int np = min(kPT, P - p0);
    float* Bd = cum + qpad;                      // kST x N, decayed B
    float* Xs = Bd + kST * N;                    // kST x kPT
    const float last = cum[Q - 1];
    float acc[kAccS];
#pragma unroll
    for (int k = 0; k < kAccS; ++k) acc[k] = 0.0f;
    for (int s0 = 0; s0 < Q; s0 += kST) {
      const int ns = min(kST, Q - s0);
      __syncthreads();
      for (int i = t; i < kST * N; i += kThreads) {
        const int s = i / N, n = i % N;
        Bd[i] = s < ns ? Bc[(long long)(s0 + s) * N + n]
                             * expf(last - cum[s0 + s])
                       : 0.0f;
      }
      for (int i = t; i < kST * kPT; i += kThreads) {
        const int s = i / kPT, p = i % kPT;
        Xs[i] = (s < ns && p < np)
                    ? xc[(long long)(s0 + s) * xstride + p0 + p] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kAccS; ++k) {
        const int i = t + k * kThreads;
        if (i < kPT * N) {
          const int p = i / N, n = i % N;
          float a = acc[k];
          for (int s = 0; s < ns; ++s)
            a = fmaf(Xs[s * kPT + p], Bd[s * N + n], a);
          acc[k] = a;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kAccS; ++k) {
      const int i = t + k * kThreads;
      if (i < kPT * N) {
        const int p = i / N, n = i % N;
        if (p < np) st[(bch * P + p0 + p) * N + n] = acc[k];
      }
    }
  }
}

}  // namespace

// n_bc = B * C.  Returns cudaGetLastError(), or cudaErrorInvalidValue on a
// shape the kernel does not take (Q <= 1024, P <= 128, N <= 256).
extern "C" int ssd_chunk_launch(const void* xbar, const void* dA,
                                const void* Bm, const void* Cm, void* y,
                                void* st, void* dk, int n_bc, int Q, int H,
                                int P, int N, void* stream) {
  if (n_bc <= 0 || Q <= 0 || Q > kMaxQ || H <= 0 || P <= 0 || P > kMaxP ||
      N <= 0 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const long long blocks_x = (long long)n_bc * H;
  if (blocks_x > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n_y = (Q + kQT - 1) / kQT;
  const int n_s = (P + kPT - 1) / kPT;
  const size_t qpad = (size_t)((Q + 3) & ~3);
  const size_t y_floats = qpad + (size_t)kQT * (N + 1) + (size_t)kST * (N + 1)
                          + (size_t)kST * P + (size_t)kQT * (kST + 1);
  const size_t s_floats = qpad + (size_t)kST * N + (size_t)kST * kPT;
  const size_t bytes = (y_floats > s_floats ? y_floats : s_floats) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)blocks_x, (unsigned)(n_y + n_s));
  ssd_chunk_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)xbar, (const float*)dA, (const float*)Bm, (const float*)Cm,
      (float*)y, (float*)st, (float*)dk, Q, H, P, N, n_y);
  return (int)cudaGetLastError();
}
