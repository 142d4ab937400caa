// What the attention kernels share: the log constants, the
// (b, n, h) stride triple of their fp32 and non-TMA paths, and pack_bf16
// (two floats rounded to one bf16x2 word, fused_attention.cu's epilogue). The
// bf16 tensor-core bodies (flash_attention.cu, flash_attention_bwd.cu,
// flash_attention_int8.cu, fused_attention.cu) run on wgmma and TMA through
// hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace uc_fa {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long b, n, h;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace uc_fa
