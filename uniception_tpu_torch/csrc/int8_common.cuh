// What the int8 kernels (int8_matmul.cu, flash_attention_int8.cu) share:
// the s8 mma.sync m16n8k32 product and the symmetric int8 quantizer.
//
// mma.sync.m16n8k32 .s8 fragment layouts (g = lane / 4, t = lane % 4); each
// 32-bit register holds four int8, the lowest byte first:
//   A (16x32, row-major), 4 registers:
//     a[0] = A[g][4t..4t+3], a[1] = A[g+8][4t..4t+3], a[2] = A[g][4t+16..4t+19], a[3] = A[g+8][4t+16..4t+19]
//   B (32x8, "col"), 2 registers: b[0] = B[4t..4t+3][g], b[1] = B[4t+16..4t+19][g];
//     with B stored n-major ([n][k] rows) each is one 32-bit load.
//   C (16x8, s32): c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1].
// In bytes this is the bf16 m16n8k16 layout of fa_common.cuh.
#pragma once

#include <math.h>
#include <stdint.h>

namespace uc_i8 {

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// round(x / s) clipped to [-127, 127]: a true IEEE division and round half to
// even (rintf), as jnp.round(x / scale) and torch.round(x / scale) compute it.
__device__ __forceinline__ int quant8(float x, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
}

// quant8(x, s) given r = __frcp_rn(s), for a loop over many x with one s: the
// quotient x * r is corrected once with the exact residual x - q * s (one FMA),
// which makes it the correctly rounded x / s (Markstein: r is the correctly
// rounded reciprocal and q a faithful quotient; |x / s| <= 127 rules out
// overflow and underflow). Three operations in place of a division.
__device__ __forceinline__ int quant8_rcp(float x, float s, float r) {
  const float q = __fmul_rn(x, r);
  const float q1 = __fmaf_rn(__fmaf_rn(-q, s, x), r, q);
  return (int)fminf(fmaxf(rintf(q1), -127.f), 127.f);
}

__device__ __forceinline__ uint32_t pack_s8x4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

__device__ __forceinline__ uint32_t ld32s(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

// The symmetric scale of an abs-max: max(amax, 1e-30) / 127 in fp32.
__device__ __forceinline__ float absmax_scale(float amax) { return __fdiv_rn(fmaxf(amax, 1e-30f), 127.f); }

}  // namespace uc_i8
