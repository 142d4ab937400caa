// S.V without the softmax (K8): out = float(bf16(q k^T in fp32)) . v with
// fp32 accumulation, rounded to bf16, over bf16 (B, N, H, D) tensors, D = 64.
// No scale, no softmax, no mask: a diagnostic lower bound for the attention
// kernels (the two products of K1 without the exp/max/sum between them).
//
// Replaces: scripts/sweep_attention.py: mxu_only with the body
//   _mxu_only_kernel (the "MXU-only" diagnostic of the attention sweep).
//
// What bounds it on the H100: the tensor cores. Each (b, h) pair does
//   4 * Nq * Nk * D flops on 4 * N * D * 2 bytes of q/k/v/o: at the script's
//   shape (16, 1024, 16, 64) 68.7 GFLOP, >= 0.0695 ms at 989 TFLOP/s
//   (33.6 MB: 0.010 ms at 3.35 TB/s).
//
// What the design does about it: K1's bf16 layout (flash_attention.cu) with
//   the softmax taken out. One block of 4 warps per (b, h, 64-query tile);
//   key and value tiles of 64 rows in shared memory, V transposed; S = Q K^T
//   on mma.sync m16n8k16 with fp32 accumulation, its accumulators rounded to
//   bf16 in registers as the A fragments of S.V (the Pallas kernel's
//   s.astype(v.dtype)), which accumulates in fp32 registers over every key
//   tile (the Pallas kernel's fp32 scratch over its key grid axis). Keys past
//   Nk are zero, so their scores and values add nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fa_common.cuh"

namespace {

using namespace uc_fa;

constexpr int BQ = 64;   // query rows per block: 4 warps x 16
constexpr int BK = 64;   // key rows per shared-memory tile
constexpr int PAD = 8;   // bf16 padding per shared row

__global__ void __launch_bounds__(128) sv_only_kernel(const __nv_bfloat16* __restrict__ q,
                                                      const __nv_bfloat16* __restrict__ k,
                                                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                                                      int H, int Nq, int Nk, Strides qs, Strides ks, Strides vs) {
  __shared__ __align__(16) __nv_bfloat16 k_s[BK][D + PAD];   // [key][d]
  __shared__ __align__(16) __nv_bfloat16 vt_s[D][BK + PAD];  // [d][key]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * BQ + warp * 16 + g, row1 = row0 + 8;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;

  uint32_t qa[D / 16][4];
  load_a_rows(qa, q + b * qs.b + h * qs.h, qs.n, row0, Nq, t);

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();
    stage_tile<BK, PAD>(k_s, nullptr, kp + (long long)k0 * ks.n, ks.n, 0, Nk - k0);
    for (int c = tid; c < BK * D / 8; c += blockDim.x) {  // V transposed: consecutive threads, consecutive keys
      const int r = c % BK, d8 = (c / BK) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Nk) u = *reinterpret_cast<const uint4*>(vp + (long long)(k0 + r) * vs.n + d8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt_s[d8 + i][r] = e[i];
    }
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &k_s[j * 8 + g][kk * 16 + 2 * t];
        mma_16816(s[j], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const __nv_bfloat16* vr = &vt_s[i * 8 + g][kc * 16 + 2 * t];
        mma_16816(acc[i], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  __nv_bfloat16* op = o + ((long long)b * Nq * H + h) * D;  // o is contiguous (B, Nq, H, D)
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = i * 8 + 2 * t;
    if (row0 < Nq) *reinterpret_cast<uint32_t*>(op + (long long)row0 * H * D + c) = pack_bf16(acc[i][0], acc[i][1]);
    if (row1 < Nq) *reinterpret_cast<uint32_t*>(op + (long long)row1 * H * D + c) = pack_bf16(acc[i][2], acc[i][3]);
  }
}

}  // namespace

// bf16 q (B, Nq, H, D), k and v (B, Nk, H, D), read by their (b, n, h) strides
// (in elements; unit stride on d); o: contiguous (B, Nq, H, D) bf16. D = 64.
// Returns a cudaError_t.
extern "C" int uc_sv_only(const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int Nk,
                          int head_dim, long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn,
                          long long k_sh, long long v_sb, long long v_sn, long long v_sh, void* stream) {
  if (head_dim != D || B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  sv_only_kernel<<<dim3((Nq + BQ - 1) / BQ, H, B), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), H, Nq, Nk, qs, ks, vs);
  return (int)cudaGetLastError();
}
