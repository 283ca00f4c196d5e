// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py,
//           function `paged_attention` (Pallas body `_kernel`), through
//           `paged_attention_launch`; and
//           src/repro/kernels/kv_quant/kv_quant.py, function
//           `paged_attention_q8` (Pallas body `_paged_q8_kernel`), through
//           `paged_attention_q8_launch`.
//
// Computes single-query GQA attention over a block table:
//   q (B, H, d); k/v pool (num_pages, page, KVH, d); tables (B, max_pages)
//   int32; lengths (B,) int32 -> out (B, H, d) in q's dtype.
// The q8 entry reads the pool as int8 codes with one float32 scale and
// zero per (token, head) row, (num_pages, page, KVH, 1), and dequantizes
// each row as it reads it: lam * (code + 128 - z), in float32, the order
// of the TPU kernel and of the plain version.  Pages past lengths[b] are
// never read (table entries past a sequence's length may hold anything),
// tokens at or past the length take no weight, the running max starts at
// -1e30 and the output is acc / max(l, 1e-30): the TPU kernels' constants.
//
// What bounds it on the H100: bytes.  Each (b, kv-head) reads its live
// pages of K and V once and does 4 G d flops per key, about 2 flops a byte
// in bf16, far below the card's ~295 flops/byte balance point; so the
// floor is the K/V bytes over 3.35 TB/s (2 d bytes of K and V per token
// and kv-head in bf16; d + 8 in int8, codes plus a float scale and zero
// each).  The math stays float32 on the CUDA cores: tensor cores are not
// the lever.  What the design does about it is keep enough bytes in flight.
//
// Design.
// - Split-KV over pages: the grid is (B * KVH, nsplit).  Split s of a
//   sequence owns pages [s pps, (s + 1) pps), pps = ceil(max_pages /
//   nsplit); kernels/paged_attention/plan.py sizes nsplit from the shapes
//   alone (no read of lengths), about 256 tokens a split, more splits when
//   the grid would not fill the card.  A block whose range starts past
//   lengths[b] exits at once; a block that holds the whole sequence (its
//   lane has one live split) writes the output itself.  Otherwise it
//   writes its partial (acc for G x d, and m, l per head) to scratch the
//   wrapper allocated, and paged_attention_merge_kernel combines the
//   partials of each lane in split order (no atomics: the same call gives
//   the same bits): out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M)
//   l_s, 1e-30), M = max_s m_s, the arithmetic of the bf16 flash body's
//   merge (flash_prefill_wgmma.cuh) in natural units.
// - Loads: a block walks its pages as tiles of up to 16 tokens of one page
//   (a page of one kv-head is `page` rows of d elements, KVH d apart),
//   each K and V row copied by 16-byte cp.async (4-byte for the q8 scales
//   and zeros) into a ring of kStages tiles in shared memory, so that three
//   tiles are in flight while one computes.  The block's page ids are read
//   from the table once, into shared memory, before the first tile.
// - Scores: L = pow2ceil(d / 8) lanes share a token, each holding 8
//   elements of d (one 16-byte load in bf16), and reduce the G dot
//   products over those L lanes by xor shuffles; 128 / L tokens per pass.
//   Each L-lane group keeps its own online softmax (m, l, acc for its 8
//   elements of each head), and rescales acc only when its max grows.  At
//   the end the groups are merged through shared memory in a fixed order.
// - The q8 entry shares this body; the row type (a template parameter)
//   says how a tile is copied and how 8 elements of a row become floats.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kMaxD = 256;
constexpr int kMaxPage = 64;
constexpr int kTile = 16;       // tokens per tile (of one page)
constexpr int kStages = 4;      // tiles in the ring
constexpr int kMergeThreads = 128;
constexpr float kNegInf = -1e30f;

// Launches since the library was loaded (host counters, read through
// paged_attention_body_launches): the split-KV body and the merge pass.
long long launched[2] = {0, 0};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 consecutive elements as float
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    x[2 * i] = __low2float(h);
    x[2 * i + 1] = __high2float(h);
  }
}

// Row types.  A stage holds one tile: K rows [kTile][d], V rows [kTile][d]
// (and, for int8, the tile's scales and zeros).  `copy` issues the tile's
// cp.asyncs (rows r0 .. r0 + n of page `pid`), `key`/`val` read 8 elements
// of tile row r from element j0 as float.
template <typename TKV>
struct FloatRows {
  const TKV* k;
  const TKV* v;
  static constexpr int kElt = sizeof(TKV);
  static __host__ __device__ int stage_bytes(int d) { return 2 * kTile * d * kElt; }
  __device__ __forceinline__ void copy(char* st, long long row0, int KVH,
                                       int n, int d, int tid) const {
    const int cpr = d * kElt / 16;                 // 16-byte chunks a row
    const int per = n * cpr;
    for (int i = tid; i < 2 * per; i += kThreads) {
      const int which = i >= per, e = i - which * per;
      const int r = e / cpr, c = e - r * cpr;
      const TKV* src = (which ? v : k) + (row0 + (long long)r * KVH) * d;
      char* dst = st + which * (kTile * d * kElt) + (r * d) * kElt + c * 16;
      cp_async16(dst, reinterpret_cast<const char*>(src) + c * 16);
    }
  }
  __device__ __forceinline__ void key(const char* st, int r, int j0, int d,
                                      float* x) const {
    load8(reinterpret_cast<const TKV*>(st) + r * d + j0, x);
  }
  __device__ __forceinline__ void val(const char* st, int r, int j0, int d,
                                      float* x) const {
    load8(reinterpret_cast<const TKV*>(st + kTile * d * kElt) + r * d + j0, x);
  }
};

struct Int8Rows {
  const int8_t* kq;
  const float* k_lam;
  const float* k_z;
  const int8_t* vq;
  const float* v_lam;
  const float* v_z;
  // codes K [kTile][d], V [kTile][d], then k_lam, k_z, v_lam, v_z [kTile]
  static __host__ __device__ int stage_bytes(int d) { return 2 * kTile * d + 4 * kTile * 4; }
  __device__ __forceinline__ void copy(char* st, long long row0, int KVH,
                                       int n, int d, int tid) const {
    const int cpr = d / 16;
    const int per = n * cpr;
    for (int i = tid; i < 2 * per; i += kThreads) {
      const int which = i >= per, e = i - which * per;
      const int r = e / cpr, c = e - r * cpr;
      const int8_t* src = (which ? vq : kq) + (row0 + (long long)r * KVH) * d;
      cp_async16(st + which * (kTile * d) + r * d + c * 16, src + c * 16);
    }
    float* sc = reinterpret_cast<float*>(st + 2 * kTile * d);
    for (int i = tid; i < 4 * n; i += kThreads) {
      const int a = i / n, r = i - a * n;
      const float* src = a == 0 ? k_lam : a == 1 ? k_z : a == 2 ? v_lam : v_z;
      cp_async4(sc + a * kTile + r, src + row0 + (long long)r * KVH);
    }
  }
  __device__ __forceinline__ void rows8(const char* st, int which, int r,
                                        int j0, int d, float* x) const {
    const uint2 u = *reinterpret_cast<const uint2*>(st + which * (kTile * d) +
                                                    r * d + j0);
    const float* sc = reinterpret_cast<const float*>(st + 2 * kTile * d);
    const float lam = sc[(2 * which) * kTile + r];
    const float z = sc[(2 * which + 1) * kTile + r];
    const uint32_t w[2] = {u.x, u.y};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int8_t c = (int8_t)((w[i >> 2] >> (8 * (i & 3))) & 0xff);
      x[i] = lam * ((float)c + 128.f - z);
    }
  }
  __device__ __forceinline__ void key(const char* st, int r, int j0, int d,
                                      float* x) const { rows8(st, 0, r, j0, d, x); }
  __device__ __forceinline__ void val(const char* st, int r, int j0, int d,
                                      float* x) const { rows8(st, 1, r, j0, d, x); }
};

struct Shape {
  int H, KVH, G, d, L, page, num_pages, max_pages, nsplit, pps, tpp;
  float scale;
};

// live splits of a sequence of `len` tokens: ceil(live pages / pps)
__host__ __device__ __forceinline__ int live_splits(int len, const Shape& s) {
  const int pages = min((len + s.page - 1) / s.page, s.max_pages);
  return (pages + s.pps - 1) / s.pps;
}

// Dynamic shared memory: the ring, or the end-of-block reduction when that
// is larger; then the page ids of one split and each group's (m, l).
template <typename Rows>
__host__ __device__ int ring_bytes(const Shape& s) {
  const int ring = kStages * ((Rows::stage_bytes(s.d) + 15) / 16 * 16);
  const int red = kWarps * s.G * s.d * 4;
  return ring > red ? ring : red;
}
template <typename Rows>
int smem_bytes(const Shape& s) {
  return ring_bytes<Rows>(s) + s.pps * 4 + (kThreads / s.L) * s.G * 8;
}

template <int KG, typename TQ, typename Rows>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const Rows rows,
                       const int32_t* __restrict__ tables,
                       const int32_t* __restrict__ lengths,
                       TQ* __restrict__ out, float* __restrict__ part,
                       const Shape sh) {
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x / sh.KVH, kvh = blockIdx.x % sh.KVH;
  const int split = blockIdx.y;
  const int G = sh.G, d = sh.d, L = sh.L, page = sh.page;
  const int len = lengths[b];
  const int n_pages = min((len + page - 1) / page, sh.max_pages);
  const int pg0 = split * sh.pps;
  if (pg0 >= n_pages) return;
  const int pg1 = min(n_pages, pg0 + sh.pps);
  const int tpp = sh.tpp;                        // tiles per page
  const int n_tiles = (pg1 - pg0) * tpp;

  const int stage = (Rows::stage_bytes(d) + 15) / 16 * 16;
  int32_t* spid = reinterpret_cast<int32_t*>(smem + ring_bytes<Rows>(sh));
  float* sml = reinterpret_cast<float*>(spid + sh.pps);
  const int tid = threadIdx.x;
  for (int i = tid; i < pg1 - pg0; i += kThreads)
    spid[i] = tables[(long long)b * sh.max_pages + pg0 + i];
  __syncthreads();

  // tile t: page pg0 + t / tpp, rows [16 (t % tpp), +16) of it
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int pid = spid[t / tpp];
      const int r0 = (t % tpp) * kTile;
      if (pid >= 0 && pid < sh.num_pages)
        rows.copy(smem + (t % kStages) * stage,
                  ((long long)pid * page + r0) * sh.KVH + kvh, sh.KVH,
                  min(kTile, page - r0), d, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  // this thread: token slot `grp` of a pass, elements [8 s, 8 s + 8)
  const int grp = tid / L, s = tid % L;
  const int j0 = 8 * s;
  const bool has = j0 < d;
  const int per_pass = kThreads / L;
  float qv[KG][8], acc[KG][8], m[KG], l[KG];
  const TQ* qb = q + ((long long)b * sh.H + (long long)kvh * G) * d;
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qv[g][i] = (g < G && has) ? to_f(qb[g * d + j0 + i]) * sh.scale : 0.f;
      acc[g][i] = 0.f;
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(t + kStages - 1);
    const char* st = smem + (t % kStages) * stage;
    const int pid = spid[t / tpp];
    const int r0 = (t % tpp) * kTile;
    const int n = min(kTile, page - r0);
    const int tok0 = (pg0 + t / tpp) * page + r0;
    const bool page_ok = pid >= 0 && pid < sh.num_pages;
    for (int r = grp; r < kTile; r += per_pass) {   // uniform trip count
      const bool valid = page_ok && r < n && tok0 + r < len;
      float x[8];
      float dot[KG];
      if (valid && has) {
        rows.key(st, r, j0, d, x);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) a += qv[g][i] * x[i];
        dot[g] = a;
      }
      for (int o = 1; o < L; o <<= 1)
#pragma unroll
        for (int g = 0; g < KG; ++g)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
      if (valid) {
        if (has) rows.val(st, r, j0, d, x);
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          if (g < G) {
            const float sc = dot[g];
            if (sc > m[g]) {
              const float corr = expf(m[g] - sc);
              l[g] *= corr;
#pragma unroll
              for (int i = 0; i < 8; ++i) acc[g][i] *= corr;
              m[g] = sc;
            }
            const float p = expf(sc - m[g]);
            l[g] += p;
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[g][i] += p * x[i];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                               // the ring is free

  // merge the groups: each group's (m, l) to shared memory
  const int n_grp = kThreads / L;
  if (s == 0)
#pragma unroll
    for (int g = 0; g < KG; ++g)
      if (g < G) {
        sml[(grp * G + g) * 2] = m[g];
        sml[(grp * G + g) * 2 + 1] = l[g];
      }
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);   // [kWarps][G][d]
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    if (g < G) {
      float M = kNegInf;
      for (int e = 0; e < n_grp; ++e) M = fmaxf(M, sml[(e * G + g) * 2]);
      const float w = expf(m[g] - M);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float a = acc[g][i] * w;
        for (int o = L; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        acc[g][i] = a;
      }
      if (lane < L && has)
#pragma unroll
        for (int i = 0; i < 8; ++i) red[(warp * G + g) * d + j0 + i] = acc[g][i];
    }
  }
  __syncthreads();

  const bool alone = live_splits(len, sh) == 1;
  const long long bk = (long long)b * sh.KVH + kvh;
  for (int e = tid; e < G * d; e += kThreads) {
    const int g = e / d;
    float M = kNegInf;
    for (int x = 0; x < n_grp; ++x) M = fmaxf(M, sml[(x * G + g) * 2]);
    float lsum = 0.f;
    for (int x = 0; x < n_grp; ++x)
      lsum += expf(sml[(x * G + g) * 2] - M) * sml[(x * G + g) * 2 + 1];
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[w * G * d + e];
    if (alone) {
      from_f(a / fmaxf(lsum, 1e-30f), out + bk * G * d + e);
    } else {
      // partials: acc [B KVH][nsplit][G][d], then (m, l) [B KVH][nsplit][G]
      const long long slot = bk * sh.nsplit + split;
      part[slot * G * d + e] = a;
      if (e % d == 0) {
        float* ml = part + (long long)gridDim.x * sh.nsplit * G * d;
        ml[(slot * G + g) * 2] = M;
        ml[(slot * G + g) * 2 + 1] = lsum;
      }
    }
  }
}

// Combines each lane's live splits in split order; lanes with one live
// split were written by the body.  One block per (b, kv-head).
template <typename TQ>
__global__ void __launch_bounds__(kMergeThreads)
paged_attention_merge_kernel(const int32_t* __restrict__ lengths,
                             const float* __restrict__ part,
                             TQ* __restrict__ out, const Shape sh) {
  const int b = blockIdx.x / sh.KVH;
  const int ns = live_splits(lengths[b], sh);
  if (ns <= 1) return;
  const int G = sh.G, d = sh.d;
  const long long bk = blockIdx.x;
  const float* ml = part + (long long)gridDim.x * sh.nsplit * G * d;
  for (int e = threadIdx.x; e < G * d; e += kMergeThreads) {
    const int g = e / d;
    float M = kNegInf;
    for (int s = 0; s < ns; ++s)
      M = fmaxf(M, ml[((bk * sh.nsplit + s) * G + g) * 2]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < ns; ++s) {
      const long long slot = bk * sh.nsplit + s;
      const float w = expf(ml[(slot * G + g) * 2] - M);
      l += w * ml[(slot * G + g) * 2 + 1];
      a += w * part[slot * G * d + e];
    }
    from_f(a / fmaxf(l, 1e-30f), out + bk * G * d + e);
  }
}

template <int KG, typename TQ, typename Rows>
int launch_kg(const void* q, Rows rows, const void* tables,
              const void* lengths, void* out, void* scratch, int B,
              const Shape& sh, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<KG, TQ, Rows>;
  const int smem = smem_bytes<Rows>(sh);
  static int attr = 48 * 1024;      // once per instantiation and size
  if (smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr = smem;
  }
  kernel<<<dim3(B * sh.KVH, sh.nsplit), kThreads, smem, stream>>>(
      (const TQ*)q, rows, (const int32_t*)tables, (const int32_t*)lengths,
      (TQ*)out, (float*)scratch, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++launched[0];
  if (sh.nsplit == 1) return 0;
  paged_attention_merge_kernel<TQ><<<B * sh.KVH, kMergeThreads, 0, stream>>>(
      (const int32_t*)lengths, (const float*)scratch, (TQ*)out, sh);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[1];
  return (int)err;
}

template <typename TQ, typename Rows>
int launch(const void* q, Rows rows, const void* tables, const void* lengths,
           void* out, void* scratch, int B, const Shape& sh,
           cudaStream_t stream) {
  if (sh.G <= 1) return launch_kg<1, TQ>(q, rows, tables, lengths, out, scratch, B, sh, stream);
  if (sh.G <= 2) return launch_kg<2, TQ>(q, rows, tables, lengths, out, scratch, B, sh, stream);
  if (sh.G <= 4) return launch_kg<4, TQ>(q, rows, tables, lengths, out, scratch, B, sh, stream);
  return launch_kg<8, TQ>(q, rows, tables, lengths, out, scratch, B, sh, stream);
}

// The shape the kernels take, or false: G <= 8, d a multiple of 8 (16 for
// int8 codes) up to 256, page <= 64, nsplit in [1, max_pages], scratch
// when nsplit > 1.
bool make_shape(Shape* sh, int B, int H, int KVH, int d, int page,
                int num_pages, int max_pages, int nsplit, const void* scratch,
                int d_mult) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || H / KVH > kMaxG || d <= 0 ||
      d > kMaxD || d % d_mult != 0 || page <= 0 || page > kMaxPage ||
      max_pages <= 0 || nsplit < 1 || nsplit > max_pages ||
      (nsplit > 1 && scratch == nullptr) || nsplit > 65535)
    return false;
  int L = 1;
  while (L * 8 < d) L <<= 1;
  sh->H = H; sh->KVH = KVH; sh->G = H / KVH; sh->d = d; sh->L = L;
  sh->page = page; sh->num_pages = num_pages; sh->max_pages = max_pages;
  sh->nsplit = nsplit;
  sh->pps = (max_pages + nsplit - 1) / nsplit;
  sh->tpp = (page + kTile - 1) / kTile;
  sh->scale = 1.0f / sqrtf((float)d);
  return true;
}

template <typename TKV>
FloatRows<TKV> float_rows(const void* k, const void* v) {
  return FloatRows<TKV>{(const TKV*)k, (const TKV*)v};
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  scratch / nsplit: the split-KV
// (kernels/paged_attention/plan.py sizes both): nsplit 1 needs no
// scratch; nsplit > 1 needs B * KVH * nsplit * G * (d + 2) floats.  Every
// pointer must be 16-byte aligned.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lengths, void* out, void* scratch, int nsplit, int B, int H,
    int KVH, int d, int page, int num_pages, int max_pages, int q_dtype,
    int kv_dtype, void* stream) {
  Shape sh;
  if (!make_shape(&sh, B, H, KVH, d, page, num_pages, max_pages, nsplit,
                  scratch, 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float>(q, float_rows<float>(k, v), tables, lengths, out, scratch, B, sh, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16>(q, float_rows<__nv_bfloat16>(k, v), tables, lengths, out, scratch, B, sh, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float>(q, float_rows<__nv_bfloat16>(k, v), tables, lengths, out, scratch, B, sh, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16>(q, float_rows<float>(k, v), tables, lengths, out, scratch, B, sh, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 pool: codes kq/vq (num_pages, page, KVH, d) int8, scales and
// zeros k_lam/k_z/v_lam/v_z (num_pages, page, KVH, 1) float32.  q_dtype,
// scratch and nsplit as above; the output takes q's dtype.
extern "C" int paged_attention_q8_launch(
    const void* q, const void* kq, const void* k_lam, const void* k_z,
    const void* vq, const void* v_lam, const void* v_z, const void* tables,
    const void* lengths, void* out, void* scratch, int nsplit, int B, int H,
    int KVH, int d, int page, int num_pages, int max_pages, int q_dtype,
    void* stream) {
  Shape sh;
  if (!make_shape(&sh, B, H, KVH, d, page, num_pages, max_pages, nsplit,
                  scratch, 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Int8Rows rows{(const int8_t*)kq, (const float*)k_lam, (const float*)k_z,
                      (const int8_t*)vq, (const float*)v_lam, (const float*)v_z};
  if (q_dtype == 0)
    return launch<float>(q, rows, tables, lengths, out, scratch, B, sh, s);
  if (q_dtype == 1)
    return launch<__nv_bfloat16>(q, rows, tables, lengths, out, scratch, B, sh, s);
  return (int)cudaErrorInvalidValue;
}

// Launches of the split-KV body and of the merge pass since the library
// was loaded, into out[0..1]; returns 0.
extern "C" int paged_attention_body_launches(long long* out) {
  out[0] = launched[0];
  out[1] = launched[1];
  return 0;
}
