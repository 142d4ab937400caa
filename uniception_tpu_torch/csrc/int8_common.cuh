// What the int8 kernels (int8_matmul.cu, flash_attention_int8.cu) share: the
// symmetric int8 quantizer and the packing of four codes into 32 bits.
#pragma once

#include <math.h>
#include <stdint.h>

namespace uc_i8 {

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

// The symmetric scale of an abs-max: max(amax, 1e-30) / 127 in fp32.
__device__ __forceinline__ float absmax_scale(float amax) { return __fdiv_rn(fmaxf(amax, 1e-30f), 127.f); }

}  // namespace uc_i8
