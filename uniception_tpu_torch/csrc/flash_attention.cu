// Flash attention forward (non-causal, no mask) over (B, N, H, D) tensors, D = 64.
//
// Replaces: uniception_tpu/ops/flash_attention.py: flash_attention /
//   _flash_attention_impl with the bodies _fa_single_kernel and _fa_kernel
//   (forward; with_lse=True when an LSE pointer is given).
//
// What bounds it on the H100: at the main-path shapes (N = 1024 queries and
//   keys, D = 64) each (b, h) pair does 4*N*N*D flops on 4*N*D*2 bytes of
//   q/k/v/o, i.e. ~256 flops per byte in bf16, so the kernel sits at the
//   knee of the roofline: tensor-core issue rate and the exp/max/sum work of
//   the online softmax between the two products are what limit it, not HBM.
//
// What the design does about it:
//   * One thread block per (b, h, 64-query tile); 4 warps, each owning 16
//     query rows. Key/value tiles of 64 rows are staged in shared memory and
//     the block loops over them (the sequential key axis of the TPU grid
//     becomes a loop inside the block).
//   * bf16: both products run on the tensor cores with mma.sync m16n8k16
//     (fp32 accumulation). The score accumulator's register layout is the
//     A-operand layout of the next mma, so P never leaves registers: it is
//     rounded to bf16 there (as the TPU kernel casts p to v's dtype) and fed
//     straight into P.V. The running max and sum stay in fp32 registers;
//     the sum is kept per thread and reduced across the 4 lanes of a row
//     once, at the end.
//   * fp32: full fp32 FMA math on the CUDA cores, one query row per thread,
//     no TF32 (the TPU kernel runs fp32 at HIGHEST precision).
//   * q/k/v are read through their (b, n, h) strides with a unit stride on
//     d, so the q/k/v views of a fused qkv projection need no copy. The
//     ragged last key tile is masked to -inf, the TPU kernel's -1e30.
//   * With an LSE pointer (training), each row's logsumexp m + log(l) is
//     written in fp32 from the max and sum the kernel already holds in
//     registers, (B, H, Nq) contiguous, for the backward (K3,
//     flash_attention_bwd.cu). With a null pointer nothing more is written.
//   * Later work: cp.async/TMA double buffering of the key tiles, wgmma,
//     ldmatrix for the transposed V operand.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fa_common.cuh"

namespace {

using namespace uc_fa;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;   // query rows per block: 4 warps x 16
constexpr int BK = 64;   // key rows per shared-memory tile
constexpr int PAD = 8;   // bf16 padding per shared row: 144-byte rows keep the mma operand loads free of bank conflicts

__global__ void __launch_bounds__(128) fa_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int Nq,
    int Nk, Strides qs, Strides ks, Strides vs, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 k_s[BK][D + PAD];   // [key][d]
  __shared__ __align__(16) __nv_bfloat16 vt_s[D][BK + PAD];  // [d][key]: V transposed, the B operand of P.V

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * BQ + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const int row1 = row0 + 8;

  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;

  // Q as mma A fragments, loaded once: 4 k-steps of 16 over D.
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = row0 < Nq ? ld32(qp + row0 * qs.n + c) : 0u;
    qa[kk][1] = row1 < Nq ? ld32(qp + row1 * qs.n + c) : 0u;
    qa[kk][2] = row0 < Nq ? ld32(qp + row0 * qs.n + c + 8) : 0u;
    qa[kk][3] = row1 < Nq ? ld32(qp + row1 * qs.n + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows row0 / row1 (log2 units)
  float l[2] = {0.f, 0.f};              // this thread's share of the running sums

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    // K tile: 8 threads cover one 128-byte key row (coalesced, 16-byte stores).
    for (int c = tid; c < BK * D / 8; c += blockDim.x) {
      const int r = c / (D / 8), d8 = (c % (D / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Nk) x = *reinterpret_cast<const uint4*>(kp + (long long)(k0 + r) * ks.n + d8);
      *reinterpret_cast<uint4*>(&k_s[r][d8]) = x;
    }
    // V tile, transposed: consecutive threads take consecutive keys, so the
    // 2-byte scatter into vt_s hits consecutive addresses.
    for (int c = tid; c < BK * D / 8; c += blockDim.x) {
      const int r = c % BK, d8 = (c / BK) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Nk) x = *reinterpret_cast<const uint4*>(vp + (long long)(k0 + r) * vs.n + d8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt_s[d8 + i][r] = e[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 n-tiles of 8 keys.
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

    // scale into log2 units, mask keys past Nk, row max over the 4 lanes of a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const float x = col < Nk ? s[j][e] * scale_log2 : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: every tile holds at least one key < Nk
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;  // the sum takes p before its bf16 rounding, as the TPU kernel's does
      }
    }

    // O += P V: the accumulator layout of two adjacent n-tiles is the A layout of one k-step.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kc][0], s[2 * kc][1]), pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]), pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const __nv_bfloat16* vr = &vt_s[i * 8 + g][kc * 16 + 2 * t];
        mma_16816(acc[i], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* op = o + ((long long)b * Nq * H + h) * D;  // o is contiguous (B, Nq, H, D)
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = i * 8 + 2 * t;
    if (row0 < Nq)
      *reinterpret_cast<uint32_t*>(op + (long long)row0 * H * D + c) = pack_bf16(acc[i][0] / l[0], acc[i][1] / l[0]);
    if (row1 < Nq)
      *reinterpret_cast<uint32_t*>(op + (long long)row1 * H * D + c) = pack_bf16(acc[i][2] / l[1], acc[i][3] / l[1]);
  }
  if (lse != nullptr && t == 0) {  // m is in log2 units of the scaled scores
    float* lp = lse + ((long long)b * H + h) * Nq;
    if (row0 < Nq) lp[row0] = m[0] * LN2 + logf(l[0]);
    if (row1 < Nq) lp[row1] = m[1] * LN2 + logf(l[1]);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full precision
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 128;   // one query row per thread
constexpr int F32_BK = 32;    // key rows per shared-memory tile
constexpr int F32_CHUNK = 16; // keys scored before each rescale of the accumulator

__global__ void __launch_bounds__(F32_BQ) fa_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int H, int Nq, int Nk, Strides qs, Strides ks, Strides vs,
    float scale_log2) {
  __shared__ __align__(16) float k_s[F32_BK][D];
  __shared__ __align__(16) float v_s[F32_BK][D];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * F32_BQ + tid;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;

  float qr[D], acc[D];
  const float* qp = q + b * qs.b + h * qs.h + (long long)row * qs.n;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 x = row < Nq ? *reinterpret_cast<const float4*>(qp + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[d] = x.x, qr[d + 1] = x.y, qr[d + 2] = x.z, qr[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += F32_BK) {
    __syncthreads();
    for (int c = tid; c < F32_BK * D / 4; c += blockDim.x) {
      const int r = c / (D / 4), d4 = (c % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < Nk) {
        kx = *reinterpret_cast<const float4*>(kp + (long long)(k0 + r) * ks.n + d4);
        vx = *reinterpret_cast<const float4*>(vp + (long long)(k0 + r) * vs.n + d4);
      }
      *reinterpret_cast<float4*>(&k_s[r][d4]) = kx;
      *reinterpret_cast<float4*>(&v_s[r][d4]) = vx;
    }
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < F32_BK; c0 += F32_CHUNK) {
      float s[F32_CHUNK];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < F32_CHUNK; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {  // every thread reads the same key row: a shared-memory broadcast
          const float4 kx = *reinterpret_cast<const float4*>(&k_s[c0 + i][d]);
          dot = fmaf(qr[d], kx.x, dot);
          dot = fmaf(qr[d + 1], kx.y, dot);
          dot = fmaf(qr[d + 2], kx.z, dot);
          dot = fmaf(qr[d + 3], kx.w, dot);
        }
        s[i] = k0 + c0 + i < Nk ? dot * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i]);
      }
      const float m_new = fmaxf(m, mx);  // finite: the first chunk holds key 0
      const float corr = exp2f(m - m_new);
      m = m_new;
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int i = 0; i < F32_CHUNK; ++i) {
        const float p = exp2f(s[i] - m);
        l += p;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vx = *reinterpret_cast<const float4*>(&v_s[c0 + i][d]);
          acc[d] = fmaf(p, vx.x, acc[d]);
          acc[d + 1] = fmaf(p, vx.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vx.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vx.w, acc[d + 3]);
        }
      }
    }
  }

  if (row < Nq) {
    float* op = o + (((long long)b * Nq + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; d += 4)
      *reinterpret_cast<float4*>(op + d) = make_float4(acc[d] / l, acc[d + 1] / l, acc[d + 2] / l, acc[d + 3] / l);
    if (lse != nullptr) lse[((long long)b * H + h) * Nq + row] = m * LN2 + logf(l);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; d has unit stride.
// o is a contiguous (B, Nq, H, D) tensor; lse, when not null, a contiguous
// (B, H, Nq) float32 tensor. Returns a cudaError_t.
extern "C" int uc_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
                                      int B, int H, int Nq, int Nk, int head_dim, long long q_sb, long long q_sn,
                                      long long q_sh, long long k_sb, long long k_sn, long long k_sh, long long v_sb,
                                      long long v_sn, long long v_sh, float scale, void* stream) {
  if (head_dim != D || B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x * log2(e))
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((Nq + BQ - 1) / BQ, H, B);
    fa_fwd_bf16_kernel<<<grid, 128, 0, st>>>(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                                              static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
                                              static_cast<float*>(lse), H, Nq, Nk, qs, ks, vs, scale_log2);
  } else if (dtype == 0) {
    const dim3 grid((Nq + F32_BQ - 1) / F32_BQ, H, B);
    fa_fwd_f32_kernel<<<grid, F32_BQ, 0, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                static_cast<const float*>(v), static_cast<float*>(o),
                                                static_cast<float*>(lse), H, Nq, Nk, qs, ks, vs, scale_log2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* uc_error_string(int status) { return cudaGetErrorString(static_cast<cudaError_t>(status)); }
