// What the attention kernels share: the head dim and the (b, n, h) stride
// triple (every kernel), and the bf16 mma.sync m16n8k16 helpers of the
// kernels not yet on wgmma (fused_attention.cu, flash_attention_int8.cu,
// sv_only.cu, conv3x3.cu). The bf16 bodies of flash_attention.cu and
// flash_attention_bwd.cu use wgmma and TMA through hopper.cuh.
//
// mma.sync.m16n8k16 fragment layouts (g = lane / 4, t = lane % 4):
//   A (16x16, row-major), 4 x 32-bit registers of two bf16:
//     a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..2t+1], a[2] = A[g][2t+8..2t+9], a[3] = A[g+8][2t+8..2t+9]
//   B (16x8, "col"), 2 registers: b[0] = B[2t..2t+1][g], b[1] = B[2t+8..2t+9][g];
//     with B stored n-major ([n][k] rows in shared memory) each is one 32-bit load.
//   C (16x8, fp32): c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1].
// The accumulators of two adjacent n-tiles (columns 0-7 and 8-15) hold, in
// order, exactly the A fragment of one 16-wide k-step, so a product's result
// feeds the next product without leaving registers (pack_a below).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace uc_fa {

constexpr int D = 64;  // the one head dim the kernels are built for
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long b, n, h;
};

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// The A fragment of k-step kc from the fp32 accumulators c[2kc], c[2kc+1], rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t a[4], const float c0[4], const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Rows r0 and r0 + 8 of a (rows x D) bf16 matrix read by row stride, as the
// A fragments of the four 16-wide k-steps over D; rows at or past n are zero.
__device__ __forceinline__ void load_a_rows(uint32_t a[D / 16][4], const __nv_bfloat16* p, long long stride, int r0,
                                            int n, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = r0 < n ? ld32(p + r0 * stride + c) : 0u;
    a[kk][1] = r1 < n ? ld32(p + r1 * stride + c) : 0u;
    a[kk][2] = r0 < n ? ld32(p + r0 * stride + c + 8) : 0u;
    a[kk][3] = r1 < n ? ld32(p + r1 * stride + c + 8) : 0u;
  }
}

// Stage rows [r0, r0 + ROWS) of a strided bf16 (rows x D) matrix in shared
// memory, row-major (s[row][d]) and, when T is non-null, transposed
// (T[d][row]); rows at or past n are zero. All threads of the block call it.
template <int ROWS, int PAD>
__device__ __forceinline__ void stage_tile(__nv_bfloat16 (*s)[D + PAD], __nv_bfloat16 (*T)[ROWS + PAD],
                                           const __nv_bfloat16* p, long long stride, int r0, int n) {
  // row-major: 8 threads cover one 128-byte row (coalesced, 16-byte stores)
  for (int c = threadIdx.x; c < ROWS * D / 8; c += blockDim.x) {
    const int r = c / (D / 8), d8 = (c % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) x = *reinterpret_cast<const uint4*>(p + (long long)(r0 + r) * stride + d8);
    *reinterpret_cast<uint4*>(&s[r][d8]) = x;
  }
  if (T == nullptr) return;
  // transposed: consecutive threads take consecutive rows, so the 2-byte
  // scatter hits consecutive shared-memory addresses
  for (int c = threadIdx.x; c < ROWS * D / 8; c += blockDim.x) {
    const int r = c % ROWS, d8 = (c / ROWS) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) x = *reinterpret_cast<const uint4*>(p + (long long)(r0 + r) * stride + d8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
    for (int i = 0; i < 8; ++i) T[d8 + i][r] = e[i];
  }
}

}  // namespace uc_fa
