// Flash attention backward (non-causal, no mask) over (B, N, H, D) tensors, D = 64.
//
// Replaces: uniception_tpu/ops/flash_attention.py: _flash_attention_bwd_pallas
//   with the bodies _fa_bwd_fused_kernel, _fa_bwd_dq_kernel and
//   _fa_bwd_dkv_kernel. The numerics are the Pallas kernels':
//     delta = rowsum(dO * O)                       fp32
//     p     = exp(s * scale - lse), padded keys 0  fp32 (s = q k^T, lse from the forward, K1)
//     dv    = p^T dO        with p rounded to dO's dtype
//     dp    = dO v^T,  ds = p * (dp - delta) * scale    fp32
//     dq    = ds k,  dk = ds^T q   with ds rounded to k's / q's dtype
//   fp32 accumulators; outputs in the input dtype.
//
// What bounds it on the H100: at the main-path shapes (N = 1024, D = 64) it
//   does 5 products of 2*N*N*D flops per (b, h) (s, dp, dv, dq, dk) plus the
//   recomputed s and dp of the second pass, on 8*N*D*2 bytes of q/k/v/o/dO and
//   gradients: far above the bf16 ridge, so tensor-core issue and the exp and
//   elementwise work between the products bound it, not HBM.
//
// What the design does about it:
//   * Three launches, no atomics, so the result is deterministic: delta
//     (one warp per row), dq (a block per 64-query tile looping over key
//     tiles) and dk/dv (a block per 64-key tile looping over query tiles).
//     The TPU's sequential "arbitrary" grid axis becomes the loop inside the
//     block; s and dp are recomputed in both passes, as the split Pallas
//     kernels do.
//   * bf16: all five products on the tensor cores with mma.sync m16n8k16 and
//     fp32 accumulation. The warp's own rows (queries in dq, keys in dk/dv)
//     are register A fragments loaded once; the tile it loops over is staged
//     in shared memory both row-major (the B operand of q k^T and dO v^T) and
//     transposed (the B operand of ds k, p^T dO and ds^T q). p and ds are
//     computed in the accumulator registers and rounded to bf16 straight into
//     the A fragments of the next product (fa_common.cuh).
//   * dk/dv computes s^T = k q^T directly (keys as rows), so p^T and ds^T are
//     already in A-operand form: no transpose of the score tile.
//   * fp32: full fp32 FMA on the CUDA cores, no TF32 (the Pallas kernels run
//     fp32 at HIGHEST precision). Two threads share a row, each holding half
//     of D in registers, and add their halves of each dot product with one
//     shuffle.
//   * q/k/v/dO are read through their (b, n, h) strides with a unit stride on
//     d, so the views of a fused qkv projection need no copy; o, lse and the
//     outputs are contiguous. Padded query rows and key columns get p = 0.
//   * Later work: one fused pass when a single tile covers all keys
//     (_fa_bwd_fused_kernel's 5-product shape), wgmma, ldmatrix.trans in place
//     of the transposed staging, cp.async double buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fa_common.cuh"

namespace {

using namespace uc_fa;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// delta[b, h, n] = sum_d dO[b, n, h, d] * O[b, n, h, d] in fp32; one warp per (b, n, h) row.
template <typename T>
__global__ void __launch_bounds__(256) fa_bwd_delta_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                                                           float* __restrict__ delta, int H, int Nq, long long rows,
                                                           Strides dos) {
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long step = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = first; r < rows; r += step) {  // r = (b * Nq + n) * H + h, o's row order
    const int h = (int)(r % H);
    const long long bn = r / H;
    const int n = (int)(bn % Nq), b = (int)(bn / Nq);
    const T* dp = dout + b * dos.b + n * dos.n + h * dos.h;
    const T* op = o + r * D;
    float s = to_f(dp[lane]) * to_f(op[lane]) + to_f(dp[lane + 32]) * to_f(op[lane + 32]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) delta[((long long)b * H + h) * Nq + n] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TILE = 64;  // rows per block (4 warps x 16) and rows per staged tile
constexpr int PAD = 8;    // bf16 padding per shared row (144-byte rows: conflict-free fragment loads)

// dq for one 64-query tile: loop over key tiles.
__global__ void __launch_bounds__(128) fa_bwd_dq_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int H, int Nq, int Nk, Strides qs, Strides ks, Strides vs, Strides dos,
    float scale, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 k_s[TILE][D + PAD];   // [key][d]: B of q k^T
  __shared__ __align__(16) __nv_bfloat16 kt_s[D][TILE + PAD];  // [d][key]: B of ds k
  __shared__ __align__(16) __nv_bfloat16 v_s[TILE][D + PAD];   // [key][d]: B of dO v^T

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * TILE + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const int rows[2] = {row0, row0 + 8};

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a_rows(qa, q + b * qs.b + h * qs.h, qs.n, row0, Nq, t);
  load_a_rows(da, dout + b * dos.b + h * dos.h, dos.n, row0, Nq, t);
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;
  const long long stat = ((long long)b * H + h) * Nq;
  float lse2[2], dl[2];  // lse in log2 units, delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = rows[r] < Nq ? lse[stat + rows[r]] * LOG2E : 0.f;
    dl[r] = rows[r] < Nq ? delta[stat + rows[r]] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += TILE) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<TILE, PAD>(k_s, kt_s, kp, ks.n, k0, Nk);
    stage_tile<TILE, PAD>(v_s, nullptr, vp, vs.n, k0, Nk);
    __syncthreads();

    // s = q k^T and dp = dO v^T for this warp's 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[TILE / 8][4], dp[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &k_s[j * 8 + g][kk * 16 + 2 * t];
        mma_16816(s[j], qa[kk], ld32(kr), ld32(kr + 8));
        const __nv_bfloat16* vr = &v_s[j * 8 + g][kk * 16 + 2 * t];
        mma_16816(dp[j], da[kk], ld32(vr), ld32(vr + 8));
      }
    }
    // ds = p * (dp - delta) * scale, in place of s
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + j * 8 + 2 * t + (e & 1);
        const float p = (col < Nk && rows[r] < Nq) ? exp2f(fmaf(s[j][e], scale_log2, -lse2[r])) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[r]) * scale;
      }
    }
    // dq += ds k: ds (rounded to bf16) is the A operand, k^T tile the B operand
#pragma unroll
    for (int kc = 0; kc < TILE / 16; ++kc) {
      uint32_t a[4];
      pack_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const __nv_bfloat16* kr = &kt_s[i * 8 + g][kc * 16 + 2 * t];
        mma_16816(acc[i], a, ld32(kr), ld32(kr + 8));
      }
    }
  }

  __nv_bfloat16* op = dq + ((long long)b * Nq * H + h) * D;  // dq is contiguous (B, Nq, H, D)
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = i * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < Nq)
        *reinterpret_cast<uint32_t*>(op + (long long)rows[r] * H * D + c) = pack_bf16(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

// dk and dv for one 64-key tile: loop over query tiles.
__global__ void __launch_bounds__(128) fa_bwd_dkv_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int Nq, int Nk, Strides qs, Strides ks,
    Strides vs, Strides dos, float scale, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 q_s[TILE][D + PAD];    // [query][d]: B of k q^T
  __shared__ __align__(16) __nv_bfloat16 qt_s[D][TILE + PAD];   // [d][query]: B of ds^T q
  __shared__ __align__(16) __nv_bfloat16 do_s[TILE][D + PAD];   // [query][d]: B of v dO^T
  __shared__ __align__(16) __nv_bfloat16 dot_s[D][TILE + PAD];  // [d][query]: B of p^T dO
  __shared__ float lse_s[TILE], delta_s[TILE];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int key0 = blockIdx.x * TILE + warp * 16 + g;  // this thread's keys: key0 and key0 + 8
  const int keys[2] = {key0, key0 + 8};

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a_rows(ka, k + b * ks.b + h * ks.h, ks.n, key0, Nk, t);
  load_a_rows(va, v + b * vs.b + h * vs.h, vs.n, key0, Nk, t);
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* dop = dout + b * dos.b + h * dos.h;
  const long long stat = ((long long)b * H + h) * Nq;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  for (int q0 = 0; q0 < Nq; q0 += TILE) {
    __syncthreads();
    stage_tile<TILE, PAD>(q_s, qt_s, qp, qs.n, q0, Nq);
    stage_tile<TILE, PAD>(do_s, dot_s, dop, dos.n, q0, Nq);
    for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
      const bool in = q0 + i < Nq;
      lse_s[i] = in ? lse[stat + q0 + i] * LOG2E : 0.f;
      delta_s[i] = in ? delta[stat + q0 + i] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v dO^T for this warp's 16 keys x 64 queries
    float st[TILE / 8][4], dpt[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* qr = &q_s[j * 8 + g][kk * 16 + 2 * t];
        mma_16816(st[j], ka[kk], ld32(qr), ld32(qr + 8));
        const __nv_bfloat16* dr = &do_s[j * 8 + g][kk * 16 + 2 * t];
        mma_16816(dpt[j], va[kk], ld32(dr), ld32(dr + 8));
      }
    }
    // p^T in place of s^T, ds^T in place of dp^T; the column is the query
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * t + (e & 1);
        const float p =
            (q0 + qc < Nq && keys[e >> 1] < Nk) ? exp2f(fmaf(st[j][e], scale_log2, -lse_s[qc])) : 0.f;
        dpt[j][e] = p * (dpt[j][e] - delta_s[qc]) * scale;
        st[j][e] = p;
      }
    }
    // dv += p^T dO, dk += ds^T q; 16 queries per k-step
#pragma unroll
    for (int kc = 0; kc < TILE / 16; ++kc) {
      uint32_t pa[4], sa[4];
      pack_a(pa, st[2 * kc], st[2 * kc + 1]);
      pack_a(sa, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const __nv_bfloat16* dr = &dot_s[i * 8 + g][kc * 16 + 2 * t];
        mma_16816(dv_acc[i], pa, ld32(dr), ld32(dr + 8));
        const __nv_bfloat16* qr = &qt_s[i * 8 + g][kc * 16 + 2 * t];
        mma_16816(dk_acc[i], sa, ld32(qr), ld32(qr + 8));
      }
    }
  }

  const long long base = ((long long)b * Nk * H + h) * D;  // dk, dv are contiguous (B, Nk, H, D)
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = i * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (keys[r] < Nk) {
        const long long off = base + (long long)keys[r] * H * D + c;
        *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(dk_acc[i][2 * r], dk_acc[i][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full precision
// ---------------------------------------------------------------------------

constexpr int F32_ROWS = 64;  // rows per block: two threads per row, each holding half of D
constexpr int F32_TILE = 32;  // rows per staged shared-memory tile
constexpr int HALF = D / 2;

// A thread's half of a row: float4 chunks 2i + half (i = 0..7), interleaved
// so that the two halves of a pair read different shared-memory banks.
__device__ __forceinline__ int chunk(int i, int half) { return 8 * i + 4 * half; }

__device__ __forceinline__ void load_half(float x[HALF], const float* p, bool in, int half) {
#pragma unroll
  for (int i = 0; i < HALF / 4; ++i) {
    const float4 v = in ? *reinterpret_cast<const float4*>(p + chunk(i, half)) : make_float4(0.f, 0.f, 0.f, 0.f);
    x[4 * i] = v.x, x[4 * i + 1] = v.y, x[4 * i + 2] = v.z, x[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void store_half(float* p, const float x[HALF], int half) {
#pragma unroll
  for (int i = 0; i < HALF / 4; ++i)
    *reinterpret_cast<float4*>(p + chunk(i, half)) = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}

// The full dot product of this thread's half row with a shared-memory row; the pair adds halves by shuffle.
__device__ __forceinline__ float dot_pair(const float x[HALF], const float* row, int half) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < HALF / 4; ++i) {
    const float4 y = *reinterpret_cast<const float4*>(row + chunk(i, half));
    s = fmaf(x[4 * i], y.x, s);
    s = fmaf(x[4 * i + 1], y.y, s);
    s = fmaf(x[4 * i + 2], y.z, s);
    s = fmaf(x[4 * i + 3], y.w, s);
  }
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

__device__ __forceinline__ void axpy_half(float acc[HALF], float a, const float* row, int half) {
#pragma unroll
  for (int i = 0; i < HALF / 4; ++i) {
    const float4 y = *reinterpret_cast<const float4*>(row + chunk(i, half));
    acc[4 * i] = fmaf(a, y.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(a, y.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(a, y.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(a, y.w, acc[4 * i + 3]);
  }
}

// Stage rows [r0, r0 + F32_TILE) of two strided (rows x D) fp32 matrices; rows at or past n are zero.
__device__ __forceinline__ void stage_pair_f32(float (*a_s)[D], float (*b_s)[D], const float* a, long long a_n,
                                               const float* b, long long b_n, int r0, int n) {
  for (int c = threadIdx.x; c < F32_TILE * D / 4; c += blockDim.x) {
    const int r = c / (D / 4), d4 = (c % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (r0 + r < n) {
      x = *reinterpret_cast<const float4*>(a + (long long)(r0 + r) * a_n + d4);
      y = *reinterpret_cast<const float4*>(b + (long long)(r0 + r) * b_n + d4);
    }
    *reinterpret_cast<float4*>(&a_s[r][d4]) = x;
    *reinterpret_cast<float4*>(&b_s[r][d4]) = y;
  }
}

__global__ void __launch_bounds__(2 * F32_ROWS) fa_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int Nq, int Nk, Strides qs, Strides ks, Strides vs, Strides dos, float scale,
    float scale_log2) {
  __shared__ __align__(16) float k_s[F32_TILE][D];
  __shared__ __align__(16) float v_s[F32_TILE][D];

  const int half = threadIdx.x & 1;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * F32_ROWS + (threadIdx.x >> 1);
  const bool in = row < Nq;
  float qr[HALF], dor[HALF], acc[HALF];
  load_half(qr, q + b * qs.b + h * qs.h + (long long)row * qs.n, in, half);
  load_half(dor, dout + b * dos.b + h * dos.h + (long long)row * dos.n, in, half);
#pragma unroll
  for (int i = 0; i < HALF; ++i) acc[i] = 0.f;
  const long long stat = ((long long)b * H + h) * Nq + row;
  const float lse2 = in ? lse[stat] * LOG2E : 0.f;
  const float dl = in ? delta[stat] : 0.f;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;

  for (int k0 = 0; k0 < Nk; k0 += F32_TILE) {
    __syncthreads();
    stage_pair_f32(k_s, v_s, kp, ks.n, vp, vs.n, k0, Nk);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < F32_TILE; ++j) {
      const float s = dot_pair(qr, k_s[j], half);
      const float dp = dot_pair(dor, v_s[j], half);
      const float p = (in && k0 + j < Nk) ? exp2f(fmaf(s, scale_log2, -lse2)) : 0.f;
      axpy_half(acc, p * (dp - dl) * scale, k_s[j], half);
    }
  }
  if (in) store_half(dq + (((long long)b * Nq + row) * H + h) * D, acc, half);
}

__global__ void __launch_bounds__(2 * F32_ROWS) fa_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Nq, int Nk, Strides qs, Strides ks, Strides vs,
    Strides dos, float scale, float scale_log2) {
  __shared__ __align__(16) float q_s[F32_TILE][D];
  __shared__ __align__(16) float do_s[F32_TILE][D];
  __shared__ float lse_s[F32_TILE], delta_s[F32_TILE];

  const int half = threadIdx.x & 1;
  const int b = blockIdx.z, h = blockIdx.y;
  const int key = blockIdx.x * F32_ROWS + (threadIdx.x >> 1);
  const bool in = key < Nk;
  float kr[HALF], vr[HALF], dk_acc[HALF], dv_acc[HALF];
  load_half(kr, k + b * ks.b + h * ks.h + (long long)key * ks.n, in, half);
  load_half(vr, v + b * vs.b + h * vs.h + (long long)key * vs.n, in, half);
#pragma unroll
  for (int i = 0; i < HALF; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* dop = dout + b * dos.b + h * dos.h;
  const long long stat = ((long long)b * H + h) * Nq;

  for (int q0 = 0; q0 < Nq; q0 += F32_TILE) {
    __syncthreads();
    stage_pair_f32(q_s, do_s, qp, qs.n, dop, dos.n, q0, Nq);
    for (int i = threadIdx.x; i < F32_TILE; i += blockDim.x) {
      const bool qin = q0 + i < Nq;
      lse_s[i] = qin ? lse[stat + q0 + i] * LOG2E : 0.f;
      delta_s[i] = qin ? delta[stat + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < F32_TILE; ++i) {
      const float s = dot_pair(kr, q_s[i], half);
      const float dp = dot_pair(vr, do_s[i], half);
      const float p = (in && q0 + i < Nq) ? exp2f(fmaf(s, scale_log2, -lse_s[i])) : 0.f;
      axpy_half(dv_acc, p, do_s[i], half);
      axpy_half(dk_acc, p * (dp - delta_s[i]) * scale, q_s[i], half);
    }
  }
  if (in) {
    const long long off = (((long long)b * Nk + key) * H + h) * D;
    store_half(dk + off, dk_acc, half);
    store_half(dv + off, dv_acc, half);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/dout strides are in elements (d has
// unit stride); o is a contiguous (B, Nq, H, D) tensor, lse a contiguous
// (B, H, Nq) float32 tensor from the forward, delta a (B, H, Nq) float32
// scratch tensor; dq (B, Nq, H, D) and dk, dv (B, Nk, H, D) are contiguous
// outputs in the input dtype. Launches the delta, dq and dk/dv kernels on
// the stream. Returns a cudaError_t.
extern "C" int uc_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                      const void* lse, void* delta, void* dq, void* dk, void* dv, int dtype, int B,
                                      int H, int Nq, int Nk, int head_dim, long long q_sb, long long q_sn,
                                      long long q_sh, long long k_sb, long long k_sn, long long k_sh, long long v_sb,
                                      long long v_sn, long long v_sh, long long do_sb, long long do_sn,
                                      long long do_sh, float scale, void* stream) {
  if (head_dim != D || B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh}, dos{do_sb, do_sn, do_sh};
  const float scale_log2 = scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  const float* ls = static_cast<const float*>(lse);

  const long long rows = (long long)B * Nq * H;
  const long long want = (rows + 7) / 8;  // 8 warps per block, one row each per step
  const int delta_blocks = (int)(want < 65536 ? want : 65536);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    fa_bwd_delta_kernel<bf><<<delta_blocks, 256, 0, st>>>(static_cast<const bf*>(dout), static_cast<const bf*>(o), dl,
                                                            H, Nq, rows, dos);
    fa_bwd_dq_bf16_kernel<<<dim3((Nq + TILE - 1) / TILE, H, B), 128, 0, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), static_cast<const bf*>(dout),
        ls, dl, static_cast<bf*>(dq), H, Nq, Nk, qs, ks, vs, dos, scale, scale_log2);
    fa_bwd_dkv_bf16_kernel<<<dim3((Nk + TILE - 1) / TILE, H, B), 128, 0, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), static_cast<const bf*>(dout),
        ls, dl, static_cast<bf*>(dk), static_cast<bf*>(dv), H, Nq, Nk, qs, ks, vs, dos, scale, scale_log2);
  } else {
    fa_bwd_delta_kernel<float><<<delta_blocks, 256, 0, st>>>(static_cast<const float*>(dout),
                                                              static_cast<const float*>(o), dl, H, Nq, rows, dos);
    fa_bwd_dq_f32_kernel<<<dim3((Nq + F32_ROWS - 1) / F32_ROWS, H, B), 2 * F32_ROWS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), ls, dl, static_cast<float*>(dq), H, Nq, Nk, qs, ks, vs, dos, scale,
        scale_log2);
    fa_bwd_dkv_f32_kernel<<<dim3((Nk + F32_ROWS - 1) / F32_ROWS, H, B), 2 * F32_ROWS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), ls, dl, static_cast<float*>(dk), static_cast<float*>(dv), H, Nq, Nk, qs, ks,
        vs, dos, scale, scale_log2);
  }
  return (int)cudaGetLastError();
}
