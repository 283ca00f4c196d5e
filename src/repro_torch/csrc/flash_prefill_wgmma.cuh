// The bf16 flash-attention body for Hopper (sm_90a): tensor cores through
// `wgmma`, K/V tiles through TMA, the GQA heads of one kv-head packed into
// one block's rows, and a split of the key range across blocks when the
// grid is too small to fill the card.  Included by flash_prefill_prefix.cu,
// whose header note says what the kernels compute; this note says how.
//
// What bounds it on the H100: long chunks and full-sequence attention are
// bound by operations (4 d flops per visible (query, key) pair per head, at
// 989 TFLOP/s in bf16); short chunks over a long prefix by bytes (each
// kv-head's prefix K/V read once, at 3.35 TB/s).
//
// Design.
// - One block is one warpgroup (128 threads) and owns 64 packed rows: the
//   G = H / KVH query heads of one kv-head times P = 64 / G positions (G 4:
//   16 positions of 4 heads; G 8: 8 of 8; G 1: 64 of 1; a G that does not
//   divide 64 leaves 64 - G P rows empty).  Row r is head r / P at position
//   r % P, so each K/V tile is read once per kv-head, not G times.
// - S = Q K^T is wgmma m64n64k16 (f32 accumulate) with Q and the K tile in
//   shared memory as K-major operands; O += P V is wgmma m64n{d}k16 with P
//   taken straight from the S accumulator into A-operand registers as bf16
//   (the accumulator's layout is the A fragment's, so P never touches
//   shared memory) and V, stored (keys x d) row-major, as an MN-major B
//   operand through the descriptor's transpose bit.
// - Every tile in shared memory is cut into 64-column panels of 128-byte
//   rows under the 128-byte swizzle (16-byte chunk c of row r sits at chunk
//   c ^ (r % 8)), the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B and
//   the wgmma descriptors name (layout type 1; K-major: rows 128 B apart,
//   8-row groups 1024 B apart, a k16 step 32 B further; MN-major V: 8-key
//   groups 1024 B apart, the next 64 columns one panel further, a k16 step
//   16 keys further).  Panels start on 1024-byte boundaries.
// - K/V tiles (64 keys) arrive by TMA (cp.async.bulk.tensor.4d) into a ring
//   of two stages, each with an mbarrier that counts the bytes.  The tensor
//   map over the strided (d, S, KVH, B) view is encoded on the host for each
//   call (dims after d sorted by stride, as TMA wants them), passed as a
//   __grid_constant__ parameter; cuTensorMapEncodeTiled comes through
//   cudaGetDriverEntryPoint, so the library needs no -lcuda.  Thread 0
//   issues the loads: the next tile of a stage as soon as the block has
//   finished with it.  Keys past Smax are zero-filled by TMA and masked.
// - Online softmax in the log2 domain (scores times log2(e) / sqrt(d), then
//   exp2), masked scores -inf; each row's running max is shared by the 4
//   threads that hold it, its sum stays per thread until the end.  Causal
//   tiles past the block's last position are never read; only tiles that
//   cross a row's position (or Smax) pay for the mask.
// - Split-KV: when B * KVH * (q tiles) blocks would leave SMs idle (a chunk
//   of 16 queries gives 8), the wrapper asks for nsplit > 1 splits
//   (kernels/flash_prefill/plan.py, a function of the shapes).  Each block
//   then takes ns = min(nsplit, its tiles) contiguous ranges of whole tiles
//   (range s: tiles [s n / ns, (s + 1) n / ns), never empty), writes its
//   partial (m, l, acc) in f32 to scratch the wrapper allocated, and
//   flash_attn_merge_kernel combines the ns partials of each row in split
//   order (no atomics: the same call gives the same bits every run), a
//   thread per 4 columns of a row.  A block whose range is one tile (ns
//   1: a chunk at the head of the stripe) writes its output directly.
//
// - Head dim 80 (stablelm-3b) runs in the d-128 layout: two 64-column
//   panels, the tensor map's global width the true 80 (a 160-byte row
//   stride), so TMA zero-fills columns 80..127 of the second panel's
//   boxes.  S = Q K^T takes only the 5 k16 steps over real columns; O +=
//   P V is the n128 product, whose columns past 80 are zero and never
//   stored (128 / 80 = 1.6x the P V work; the whole body does 208 / 160 =
//   1.3x the work of an exact d 80).  Only 80 columns of O, of a split's
//   partials and of Q are read or written in global memory.
//
// Numerics, a difference by design: P is rounded to bf16 before P V, as
// SDPA's flash backend and FlashAttention do; the plain version and the
// TPU kernel keep P in f32.  Both products accumulate in f32, the output is
// acc / max(l, 1e-30) rounded once to bf16.  The row sum l is taken over
// the f32 P, so a row's error from the f32 result is at most 2^-8 sum_j p_j
// |v_j| / l (P's rounding) before the output's own rounding.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wg {

constexpr int kThreads = 128;   // one warpgroup
constexpr int kBM = 64;         // packed rows per block (wgmma's M)
constexpr int kBN = 64;         // keys per tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kCols = 64;       // bf16 columns in one 128-byte swizzled row

// columns a head dim D occupies in shared memory: whole 64-column panels
template <int D>
__host__ __device__ constexpr int panels_cols() {
  return (D + kCols - 1) / kCols * kCols;
}

// Launches of each device body since the library was loaded (host
// counters, read through flash_prefill_body_launches): which body a call
// took.
enum Body { kFmaBody, kWgmmaBody, kMergeBody, kTf32x3Body };
inline long long launched[4] = {0, 0, 0, 0};

// dynamic shared memory: Q and kStages x (K, V) in whole panels, plus
// slack to align the first panel to 1024 bytes
template <int D>
constexpr int smem_bytes() {
  return (kBM + 2 * kStages * kBN) * panels_cols<D>() * 2 + 1024;
}

struct Params {
  const __nv_bfloat16* q;
  const int32_t* start;         // prefix mode only
  __nv_bfloat16* out;
  float* part;                  // nsplit > 1: partial acc, then (m, l)
  long long qs_b, qs_h, qs_s, os_b, os_h, os_s;   // element strides
  int nbk, KVH, G, P, C, Smax, n_mt, nsplit;
  int kperm, vperm;             // map slot (1..3) of S, KVH, B: 2 bits each
  float scale_log2;             // log2(e) / sqrt(d)
};

// ----------------------------------------------------------- PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------- the three wgmma shapes used

// D (64 x 64, f32) = A (64 x 16) * B (16 x 64) [+ D when scale_d], A and
// B in shared memory, both K-major
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                  uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, shared
// memory, MN-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, shared
// memory, MN-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------- kernels

// the tensor-map coordinate of slot `slot` (1..3) for key k0, kv-head h and
// batch element b, under a map whose dims after d are in `perm`'s order
__device__ __forceinline__ int map_coord(int perm, int slot, int k0, int h,
                                         int b) {
  return (perm & 3) == slot ? k0 : ((perm >> 2) & 3) == slot ? h : b;
}

// The key range of one (b, q tile, split): the block's visible keys [0,
// n_kv) in tiles of kBN, cut into ns = min(nsplit, tiles) ranges of whole
// tiles.  kernels/flash_prefill/plan.py sizes nsplit and the scratch from
// the shapes alone; this is the only place the ranges are cut.
struct Span { int st, q0, n_tiles, ns; };

template <int M>
__device__ __forceinline__ Span block_span(const Params& p, int b, int mt) {
  Span s;
  s.st = (M == 0) ? p.start[b] : 0;
  s.q0 = mt * p.P;
  const int q_last = min(p.C, s.q0 + p.P) - 1;
  const int n_kv = (M == 2) ? p.Smax : min(p.Smax, s.st + q_last + 1);
  s.n_tiles = max(1, (n_kv + kBN - 1) / kBN);
  s.ns = min(p.nsplit, s.n_tiles);
  return s;
}

// Thread 0: the K and V tiles of keys [t kBN, (t + 1) kBN) into the stage
// at dst (K, then V), completing on barrier bar, by TMA.  DP is the tile's
// width in whole panels; columns past the map's width arrive as zeros and
// count towards the barrier's bytes like the rest of the box.
template <int DP>
__device__ __forceinline__ void issue_tile(const CUtensorMap* kmap,
                                           const CUtensorMap* vmap,
                                           const Params& p, uint32_t bar,
                                           uint32_t dst, int t, int kvh,
                                           int b) {
  constexpr int kTileBytes = kBN * DP * 2, kPanel = kBN * 128;
  const int k0 = t * kBN;
  mbar_expect_tx(bar, 2 * kTileBytes);
#pragma unroll
  for (int pn = 0; pn < DP / kCols; ++pn) {
    tma_load_4d(dst + pn * kPanel, kmap, bar, pn * kCols,
                map_coord(p.kperm, 1, k0, kvh, b),
                map_coord(p.kperm, 2, k0, kvh, b),
                map_coord(p.kperm, 3, k0, kvh, b));
    tma_load_4d(dst + kTileBytes + pn * kPanel, vmap, bar, pn * kCols,
                map_coord(p.vperm, 1, k0, kvh, b),
                map_coord(p.vperm, 2, k0, kvh, b),
                map_coord(p.vperm, 3, k0, kvh, b));
  }
}

// M: 0 prefix (causal on start[b] + i), 1 causal (start 0), 2 full
template <int D, int M>
__global__ void __launch_bounds__(kThreads)
flash_attn_wgmma_kernel(__grid_constant__ const CUtensorMap kmap,
                        __grid_constant__ const CUtensorMap vmap,
                        const Params p) {
  constexpr int DP = panels_cols<D>();       // D in whole 64-column panels
  constexpr int kQBytes = kBM * DP * 2;       // DP / 64 panels of kBM rows
  constexpr int kTileBytes = kBN * DP * 2;    // one K or V tile
  constexpr int kPanel = kBN * 128;           // one 64-column panel of it
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int idx = blockIdx.x;
  const int bk = idx % p.nbk;
  idx /= p.nbk;
  const int split = idx % p.nsplit;
  const int mt = p.n_mt - 1 - idx / p.nsplit;   // longest causal tiles first
  const int b = bk / p.KVH, kvh = bk % p.KVH;
  const Span sp = block_span<M>(p, b, mt);
  if (split >= sp.ns) return;
  const int t_lo = (int)((long long)split * sp.n_tiles / sp.ns);
  const int t_hi = (int)((long long)(split + 1) * sp.n_tiles / sp.ns);

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sKV = base + kQBytes;        // stage s: K, then V

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid == 0)
    for (int t = t_lo; t < min(t_hi, t_lo + kStages); ++t)
      issue_tile<DP>(&kmap, &vmap, p, smem_u32(&bars[(t - t_lo) % kStages]),
                     sKV + (t - t_lo) % kStages * 2 * kTileBytes, t, kvh, b);

  // Q: 16-byte loads into the swizzled panels; empty rows are zeros (a
  // panel's columns past D are never read: S stops at column D)
  constexpr int kChunks = D / 8;              // 16-byte chunks per row
  for (int e = tid; e < kBM * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const int g = r / p.P, i = r % p.P;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g < p.G && sp.q0 + i < p.C)
      val = *reinterpret_cast<const uint4*>(
          p.q + b * p.qs_b + (long long)(kvh * p.G + g) * p.qs_h +
          (long long)(sp.q0 + i) * p.qs_s + c * 8);
    const int off =
        (c >> 3) * (kBM * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(base_ptr + off) = val;
  }
  fence_proxy_async();   // the generic-proxy writes, before wgmma reads them
  __syncthreads();

  // this thread's two rows of the accumulators: ra and ra + 8
  const int t4 = lane & 3;
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8;
  const int pos_a = sp.st + sp.q0 + ra % p.P;
  const int pos_b = sp.st + sp.q0 + rb % p.P;
  const int pos_min = sp.st + sp.q0;          // the block's first position

  float o[DP / 2], sc[kBN / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int it = t - t_lo, s = it % kStages;
    const uint32_t sK = sKV + s * 2 * kTileBytes, sV = sK + kTileBytes;
    mbar_wait(smem_u32(&bars[s]), (it / kStages) & 1);

    // S = Q K^T: D / 16 steps of k16 (the zero columns past D skipped)
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;      // 16 columns, 32 bytes
      wgmma_m64n64k16_ss(
          sc, sw128_desc(sQ + (kk >> 2) * (kBM * 128) + off, 16, 1024),
          sw128_desc(sK + (kk >> 2) * kPanel + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax over this tile; column 8j + 2 t4 + e of rows a and b
    // is sc[4j + e] and sc[4j + 2 + e]
    const int k0 = t * kBN;
    const bool need_mask =
        (M != 2 && k0 + kBN - 1 > pos_min) || k0 + kBN > p.Smax;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float va = sc[4 * j + e] * p.scale_log2;
        float vb = sc[4 * j + 2 + e] * p.scale_log2;
        if (need_mask) {
          const int key = k0 + 8 * j + 2 * t4 + e;
          const bool in = key < p.Smax;
          if (!(in && (M == 2 || key <= pos_a))) va = -INFINITY;
          if (!(in && (M == 2 || key <= pos_b))) vb = -INFINITY;
        }
        sc[4 * j + e] = va;
        sc[4 * j + 2 + e] = vb;
        mx_a = fmaxf(mx_a, va);
        mx_b = fmaxf(mx_b, vb);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with nothing visible yet keeps max -inf: subtract 0 instead
    const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float corr_a = exp2f(m_a - mu_a), corr_b = exp2f(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    // P as bf16 A fragments: pa[4 kk + q] is register q of k-step kk
    uint32_t pa[kBN / 4];
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float p0 = exp2f(sc[4 * j] - mu_a);
      const float p1 = exp2f(sc[4 * j + 1] - mu_a);
      const float p2 = exp2f(sc[4 * j + 2] - mu_b);
      const float p3 = exp2f(sc[4 * j + 3] - mu_b);
      ps_a += p0 + p1;
      ps_b += p2 + p3;
      pa[2 * j] = pack_bf16(p0, p1);
      pa[2 * j + 1] = pack_bf16(p2, p3);
    }
    l_a = l_a * corr_a + ps_a;
    l_b = l_b * corr_b + ps_b;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= corr_a;
      o[4 * j + 1] *= corr_a;
      o[4 * j + 2] *= corr_b;
      o[4 * j + 3] *= corr_b;
    }

    // O += P V: kBN / 16 steps of k16, V's k-step 16 keys (2048 B) further
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
      const uint64_t dv = sw128_desc(sV + kk * 16 * 128, kPanel, 1024);
      if constexpr (DP == 128)
        wgmma_m64n128k16_rs_tb(o, a, dv);
      else
        wgmma_m64n64k16_rs_tb(o, a, dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);

    __syncthreads();   // every warp is done with stage s
    if (tid == 0 && t + kStages < t_hi)
      issue_tile<DP>(&kmap, &vmap, p, smem_u32(&bars[s]), sK, t + kStages,
                     kvh, b);
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
  }
  if (sp.ns == 1) {   // the whole key range: the output, no merge
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? rb : ra;
      const int g = r / p.P, i = r % p.P;
      if (g >= p.G || sp.q0 + i >= p.C) continue;
      const float inv = 1.f / fmaxf(h ? l_b : l_a, 1e-30f);
      __nv_bfloat16* dst = p.out + b * p.os_b +
                           (long long)(kvh * p.G + g) * p.os_h +
                           (long long)(sp.q0 + i) * p.os_s + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                  o[4 * j + 2 * h + 1] * inv);
    }
  } else {
    // partials: acc [split][bk][mt][kBM][D], then (m, l) [split][bk][mt][kBM]
    const long long tile = ((long long)split * p.nbk + bk) * p.n_mt + mt;
    float* po = p.part + tile * (kBM * D);
    float* pml = p.part + (long long)p.nsplit * p.nbk * p.n_mt * kBM * D +
                 tile * (kBM * 2);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(po + ra * D + 8 * j + 2 * t4) =
          make_float2(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<float2*>(po + rb * D + 8 * j + 2 * t4) =
          make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
    if (t4 == 0) {
      *reinterpret_cast<float2*>(pml + 2 * ra) = make_float2(m_a, l_a);
      *reinterpret_cast<float2*>(pml + 2 * rb) = make_float2(m_b, l_b);
    }
  }
}

constexpr int kMergeThreads = 256;

// Combines each row's ns partials in split order: M = max m_s, w_s =
// exp2(m_s - M) (0 for an empty partial), out = sum w_s acc_s / max(sum w_s
// l_s, 1e-30).  A thread owns 4 columns of one row: the tile's kBM x D / 4
// (row, 4 columns) items in row order, 256 a block (D a multiple of 16, so
// a tile is whole blocks), so a short chunk's few tiles still spread over
// many blocks.  Tiles whose block had one split wrote their output
// themselves.
template <int D, int M>
__global__ void __launch_bounds__(kMergeThreads)
flash_attn_merge_kernel(const Params p) {
  constexpr int kQuads = D / 4;                             // float4s per row
  constexpr int kParts = kBM * kQuads / kMergeThreads;      // blocks per tile
  static_assert(kBM * kQuads % kMergeThreads == 0, "whole blocks a tile");
  const int part = blockIdx.x % kParts, tile_id = blockIdx.x / kParts;
  const int bk = tile_id % p.nbk, mt = tile_id / p.nbk;
  const int b = bk / p.KVH, kvh = bk % p.KVH;
  const Span sp = block_span<M>(p, b, mt);
  const int item = part * kMergeThreads + threadIdx.x;
  const int r = item / kQuads;
  const int c = (item % kQuads) * 4;
  const int g = r / p.P, i = r % p.P;
  if (sp.ns == 1 || g >= p.G || sp.q0 + i >= p.C) return;
  const long long n_part = (long long)p.nbk * p.n_mt;   // tiles per split
  const long long row0 = ((long long)bk * p.n_mt + mt) * kBM + r;
  const float* ml = p.part + (long long)p.nsplit * n_part * kBM * D;
  float mx = -INFINITY;
#pragma unroll 4
  for (int s = 0; s < sp.ns; ++s)
    mx = fmaxf(mx, ml[(s * n_part * kBM + row0) * 2]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < sp.ns; ++s) {
    const long long row = s * n_part * kBM + row0;
    const float2 m_l = *reinterpret_cast<const float2*>(ml + row * 2);
    const float4 a = *reinterpret_cast<const float4*>(p.part + row * D + c);
    const float w = m_l.x == -INFINITY ? 0.f : exp2f(m_l.x - mx);
    l += w * m_l.y;
    acc.x += w * a.x;
    acc.y += w * a.y;
    acc.z += w * a.z;
    acc.w += w * a.w;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  __nv_bfloat16* dst = p.out + b * p.os_b +
                       (long long)(kvh * p.G + g) * p.os_h +
                       (long long)(sp.q0 + i) * p.os_s + c;
  __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = v;
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

constexpr int kNotTaken = -1;   // the view does not suit this body

// A bf16 TMA map over k/v (B, KVH, Smax, D) with element strides (b, h, s)
// and a contiguous last axis; boxes of 64 columns x kBN keys, 128-byte
// swizzle (for D 80, the second panel's box reads columns 64..79 and
// zero-fills the rest).  The dims after d are sorted by stride (a size-1 dim, whose
// stride never moves an address, goes last).  *perm gets the slot (1..3)
// of S, KVH and B, 2 bits each.  Returns 0, kNotTaken when TMA cannot take
// the view (an address or a stride not a multiple of 16 bytes: the caller
// then takes the FMA body), or an error: cudaErrorNotSupported when the
// driver has no cuTensorMapEncodeTiled, cudaErrorInvalidValue when the
// encode refuses a view that passed these checks.  A failure never sends
// a suitable view to the slow body.
inline int make_kv_map(CUtensorMap* map, int* perm, const void* ptr,
                       long long sb, long long sh, long long ss, int B,
                       int KVH, int Smax, int D) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return kNotTaken;
  struct Dim { unsigned long long size, stride; int which; };
  Dim dims[3] = {{(unsigned long long)Smax, (unsigned long long)ss * 2, 0},
                 {(unsigned long long)KVH, (unsigned long long)sh * 2, 1},
                 {(unsigned long long)B, (unsigned long long)sb * 2, 2}};
  unsigned long long span = (unsigned long long)D * 2;
  for (const Dim& d : dims)
    if (d.size > 1 && d.stride * d.size > span) span = d.stride * d.size;
  for (Dim& d : dims) {
    if (d.size == 1) d.stride = (span + 15) / 16 * 16;
    if (d.stride % 16 != 0 || d.stride >= (1ull << 40)) return kNotTaken;
  }
  for (int i = 1; i < 3; ++i)        // insertion sort by stride, stable
    for (int j = i; j > 0 && dims[j].stride < dims[j - 1].stride; --j) {
      Dim t = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = t;
    }
  cuuint64_t gdim[4] = {(cuuint64_t)D, dims[0].size, dims[1].size,
                        dims[2].size};
  cuuint64_t gstride[3] = {dims[0].stride, dims[1].stride, dims[2].stride};
  cuuint32_t box[4] = {(cuuint32_t)kCols, 1, 1, 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  int slot[3] = {0, 0, 0};
  for (int i = 0; i < 3; ++i) {
    slot[dims[i].which] = i + 1;
    if (dims[i].which == 0) box[i + 1] = kBN;
  }
  *perm = slot[0] | (slot[1] << 2) | (slot[2] << 4);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), gdim, gstride, box, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Launches the body (and the merge when nsplit > 1).  Returns kNotTaken
// only when the view does not suit it (an address or stride not 16-byte
// aligned, G > 64), else the launch's cudaError_t: a missing driver entry
// point, a refused encode or a split without scratch is an error, not a
// reason to run the FMA body.
template <int D, int M>
int launch(const void* q, const void* k, const void* v, const void* start,
           void* out, void* scratch, int nsplit, const long long* qs,
           const long long* ks, const long long* vs, const long long* os,
           int B, int H, int KVH, int C, int Smax, cudaStream_t stream) {
  const int G = H / KVH;
  if (G > kBM) return kNotTaken;
  if (nsplit < 1 || (nsplit > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return kNotTaken;
  for (int i = 0; i < 3; ++i)
    if (qs[i] % 8 != 0 || os[i] % 8 != 0) return kNotTaken;
  CUtensorMap kmap, vmap;
  Params p;
  int got = make_kv_map(&kmap, &p.kperm, k, ks[0], ks[1], ks[2], B, KVH,
                        Smax, D);
  if (got == 0)
    got = make_kv_map(&vmap, &p.vperm, v, vs[0], vs[1], vs[2], B, KVH, Smax,
                      D);
  if (got != 0) return got;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.start = static_cast<const int32_t*>(start);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part = static_cast<float*>(scratch);
  p.qs_b = qs[0]; p.qs_h = qs[1]; p.qs_s = qs[2];
  p.os_b = os[0]; p.os_h = os[1]; p.os_s = os[2];
  p.nbk = B * KVH;
  p.KVH = KVH;
  p.G = G;
  p.P = kBM / G;
  p.C = C;
  p.Smax = Smax;
  p.n_mt = (C + p.P - 1) / p.P;
  p.nsplit = nsplit;
  p.scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  const long long blocks = (long long)p.nbk * nsplit * p.n_mt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;     // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_wgmma_kernel<D, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  flash_attn_wgmma_kernel<D, M><<<(unsigned)blocks, kThreads, smem_bytes<D>(),
                                  stream>>>(kmap, vmap, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++launched[kWgmmaBody];
  if (nsplit == 1) return 0;
  const unsigned merge_blocks =
      (unsigned)(p.nbk * p.n_mt) * (kBM * D / 4 / kMergeThreads);
  flash_attn_merge_kernel<D, M><<<merge_blocks, kMergeThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[kMergeBody];
  return (int)err;
}

}  // namespace wg
