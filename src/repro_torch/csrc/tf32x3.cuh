// Tensor-core primitives for float32 products at f32 accuracy on Hopper
// (sm_90a): mma.sync.m16n8k8 in TF32 with the 3xTF32 split, and the
// 16-byte cp.async that feeds it.  Included by the f32 flash body
// (flash_prefill_tf32x3.cuh) and the SSD chunk kernel (ssd_chunk.cu).
//
// mma.sync.m16n8k8 .row.col, thread (g, t) = (lane / 4, lane % 4):
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B (8 x 8):  b0 (k t, n g), b1 (k t + 4, n g);
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// The k index is a sum's, so a kernel may map the 8 slots of a k-step to
// any 8 elements as long as A and B agree (the callers permute it so that
// one wide shared-memory load feeds several slots).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or zeros when !ok (nothing is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo.  hi is cvt.rna.tf32.f32's result (nearest, ties away) made
// with two integer operations: add half a TF32 ulp to the bit pattern and
// clear the 13 low bits.  lo = x - hi is exact and goes to the mma as it
// stands: the tensor cores read a .tf32 operand's top 19 bits, so lo is
// cut to TF32 toward zero there, an error of at most 2^-10 |lo| <= 2^-21
// |x|.  Rounding lo as well would cost three more operations an operand
// for precision the f32 tolerance does not need.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in f32 accuracy: lo hi', hi lo', hi hi'
__device__ __forceinline__ void mma3(float* c, const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* bh,
                                     const uint32_t* bl) {
  mma(c, al, bh);
  mma(c, ah, bl);
  mma(c, ah, bh);
}

__device__ __forceinline__ void split4(const float* x, uint32_t* hi,
                                       uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

}  // namespace tf
