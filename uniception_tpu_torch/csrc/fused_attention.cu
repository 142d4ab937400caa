// Fused qkv projection + 2D RoPE + attention (K5), self and cross, D = 64.
//
// Replaces: uniception_tpu/ops/fused_attention.py: fused_qkv_rope_attention
//   (body _fused_self_kernel) and fused_cross_rope_attention (body
//   _fused_cross_kernel), which the attention layers take under the "fused"
//   implementation (nn/blocks.py _fused_attention_applicable).
//
// What it computes, as the Pallas kernel does:
//   * y = x . W^T + b with fp32 accumulation and the fp32 bias, rounded once
//     to the compute dtype (bf16 for bf16 x, else fp32);
//   * RoPE2D on the q and k columns, on each head's [u_Y v_Y u_X v_X]
//     quarters (Q = 16): out_u = u cos - v sin, out_v = v cos + u sin, with
//     angle = pos * f0 / base^(q/Q), the inverse frequency computed in double
//     and rounded once, cos/sin rounded to the compute dtype, the rotation in
//     fp32 and rounded once: K2's arithmetic (rope.cu), so K5's q and k equal
//     K2's output on the same projection;
//   * single-pass softmax attention per head: fp32 scores times the scale,
//     padded keys masked, the row max over ALL keys, p = exp(s - m), l summed
//     in fp32 from the unrounded p, p rounded to v's dtype before P.V, and
//     out = P.V / l, written (B, Nq, H*D) in x's dtype.
//
// What bounds it on the H100: the tensor cores. The encoder self call
//   (B 4, N 1024, C 1024, H 16) is 25.8 GFLOP of projection and 17.2 GFLOP
//   of attention, 43.0 GFLOP, so >= 0.0434 ms at 989 TFLOP/s, against 23 MB
//   of x, W and out (0.007 ms at 3.35 TB/s). The decoder self and cross
//   calls (B 2, N 1024, C 768, H 12) are 13.7 GFLOP each, >= 0.0138 ms. All
//   72 calls of a DUSt3R 512 forward at batch 2: >= 1.71 ms.
//
// What the design does about it (simple first):
//   * The Pallas kernel keeps x for a whole batch row, W (6 MB) and the k/v
//     scratch carried from the first q-block to the next in VMEM (110 MB).
//     None of that fits 227 KB of shared memory, and CUDA blocks carry
//     nothing from one to another, so the work is split into two launches.
//   * Launch 1, the projection: a GEMM over (B*N) x C x (S*H*D), S = 3 for
//     self (Wqkv), 1 for the cross q (Wq) and 2 for the cross k/v (Wk, Wv
//     given apart: no per-call concat). bf16: 128x128 output tiles, 8 warps
//     of 32x64, mma.sync m16n8k16 with fp32 accumulation, a two-stage
//     cp.async pipeline over 32-wide k steps (K7's GEMM, conv3x3.cu, without
//     the taps, fed as K4's, int8_matmul.cu). fp32: 64x64 tiles of full
//     fp32 FMA on the CUDA cores (no TF32: the Pallas kernel runs fp32 at
//     HIGHEST precision). A warp's 64 columns are one head, and a thread
//     holds each u column and its v partner (d + 16) at the same register
//     position, so the epilogue (+ bias, round, RoPE) pairs them in
//     registers. q, k and v go to a (S, B, H, N, D) scratch, each (b, h)
//     pair's rows contiguous for launch 2.
//   * Launch 2, the attention: one block of 4 warps per (b, h, 64-query
//     tile), key tiles of 64 in shared memory, in two passes over the keys:
//     the row max, then p, l and P.V. An online softmax would round p
//     against a running max and land 1 ulp away from the Pallas kernel's
//     single pass. bf16: both products on mma.sync; the score accumulators
//     are the A fragments of P.V, so p is rounded to bf16 in registers (K1's
//     layout, fa_common.cuh). fp32: one query row per thread on the CUDA
//     cores. Rows past N are never read: loads past N are masked, as K1's.
//   * The q/k/v round trip through device memory, which the Pallas design
//     avoids, is 3 x 8.4 MB written and read back per encoder call, mostly
//     from the 50 MB L2; its cost on the card is in PERF.md. Removing it
//     (one block per (b, h) projecting its own head's k and v) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fa_common.cuh"

namespace {

using namespace uc_fa;

constexpr int QUARTER = D / 4;  // RoPE quarter: [u_Y v_Y u_X v_X] of 16 each

struct ProjArgs {
  const void* x;         // (M, C) rows, contiguous, M = B * N
  const void* w[3];      // per section: (H * D, C) rows (torch's (out, in) layout), contiguous
  const float* bias[3];  // per section: (H * D,) fp32, or null
  const int* pos;        // (B, N, 2) int32 (y, x), by strides; null when no section takes RoPE
  long long p_sb, p_sn, p_s2;
  int rope_mask;         // bit s: section s takes RoPE
  void* out;             // (S, B, H, N, D) contiguous, in x's dtype
  int M, N, C, H, S;
  double base, f0;
};

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// 16 bytes from global to shared memory, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// The rotation of one (u, v) pair, in place, with cos/sin already rounded to the compute dtype.
__device__ __forceinline__ void rotate(float& u, float& v, float cs, float sn) {
  const float ou = __fsub_rn(__fmul_rn(u, cs), __fmul_rn(v, sn));
  const float ov = __fadd_rn(__fmul_rn(v, cs), __fmul_rn(u, sn));
  u = ou, v = ov;
}

// ---------------------------------------------------------------------------
// Launch 1, bf16: tensor-core GEMM with the bias + round + RoPE epilogue
// ---------------------------------------------------------------------------

constexpr int PM = 128, PN = 128, PK = 32;  // output rows x columns per block, k step
constexpr int PPAD = 8;                     // bf16 padding: 80-byte rows keep the fragment loads conflict-free
constexpr int PTHREADS = 256;
constexpr int PCHUNKS = PM * PK / 8 / PTHREADS;  // 16-byte chunks per thread and tile

__global__ void __launch_bounds__(PTHREADS) proj_bf16_kernel(const ProjArgs a) {
  __shared__ __align__(16) __nv_bfloat16 a_s[2][PM][PK + PPAD];  // x tiles [row][k]
  __shared__ __align__(16) __nv_bfloat16 b_s[2][PN][PK + PPAD];  // W tiles [column][k]
  __shared__ float inv_freq[QUARTER];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = (long long)blockIdx.x * PM;
  const int n0 = blockIdx.y * PN;
  const int hd = a.H * D, cols = a.S * hd;
  const auto* x = static_cast<const __nv_bfloat16*>(a.x);
  if (tid < QUARTER) inv_freq[tid] = (float)(a.f0 / pow(a.base, (double)tid / QUARTER));

  // the rows this thread copies: rows tid / 4 and tid / 4 + 64 of both tiles, 8 k values at (tid % 4) * 8
  const int k8 = (tid % (PK / 8)) * 8;
  const __nv_bfloat16* xrow[PCHUNKS];
  const __nv_bfloat16* wrow[PCHUNKS];
  bool xin[PCHUNKS], win[PCHUNKS];
#pragma unroll
  for (int i = 0; i < PCHUNKS; ++i) {
    const int r = tid / (PK / 8) + i * (PTHREADS / (PK / 8));
    xin[i] = m0 + r < a.M;
    xrow[i] = xin[i] ? x + (m0 + r) * a.C : x;
    const int col = n0 + r;
    win[i] = col < cols;
    const int s = win[i] ? col / hd : 0;
    wrow[i] = win[i] ? static_cast<const __nv_bfloat16*>(a.w[s]) + (long long)(col - s * hd) * a.C : x;
  }
  auto load_tiles = [&](int stage, int k0) {
    const bool in_k = k0 + k8 < a.C;  // C % 8 == 0: a chunk is all in or all out
#pragma unroll
    for (int i = 0; i < PCHUNKS; ++i) {
      const int r = tid / (PK / 8) + i * (PTHREADS / (PK / 8));
      const bool va = in_k && xin[i], vb = in_k && win[i];
      cp_async16(&a_s[stage][r][k8], va ? xrow[i] + k0 + k8 : x, va);
      cp_async16(&b_s[stage][r][k8], vb ? wrow[i] + k0 + k8 : x, vb);
    }
    cp_async_commit();
  };

  const int wm = warp >> 1, wn = warp & 1;  // this warp's 32x64 sub-tile: one head
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;

  const int nk = (a.C + PK - 1) / PK;
  load_tiles(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_tiles(st ^ 1, (kt + 1) * PK);  // the stage read in step kt - 1, released by its closing barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        af[mi][0] = ld32(&a_s[st][r][kk * 16 + 2 * t]);
        af[mi][1] = ld32(&a_s[st][r + 8][kk * 16 + 2 * t]);
        af[mi][2] = ld32(&a_s[st][r][kk * 16 + 2 * t + 8]);
        af[mi][3] = ld32(&a_s[st][r + 8][kk * 16 + 2 * t + 8]);
      }
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const __nv_bfloat16* br = &b_s[st][wn * 64 + nj * 8 + g][kk * 16 + 2 * t];
        const uint32_t b0 = ld32(br), b1 = ld32(br + 8);
        mma_16816(acc[0][nj], af[0], b0, b1);
        mma_16816(acc[1][nj], af[1], b0, b1);
      }
    }
    __syncthreads();
  }

  // epilogue. Column d = nj * 8 + 2t + e of the warp's head: nj 0-1 u_Y, 2-3 v_Y, 4-5 u_X, 6-7 v_X, so the
  // partner of (nj, e) is (nj + 2, e), and both sit in this thread's registers.
  const int c0 = n0 + wn * 64;
  if (c0 >= cols) return;
  const int s = c0 / hd, h = (c0 - s * hd) / D;
  const bool rope = (a.rope_mask >> s) & 1;
  const float* bias = a.bias[s];
  float bv[8][2];
#pragma unroll
  for (int nj = 0; nj < 8; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[nj][e] = bias != nullptr ? bias[h * D + nj * 8 + 2 * t + e] : 0.f;
  float freq[2][2];  // [j][e]: the inverse frequency of quarter index j * 8 + 2t + e
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) freq[j][e] = inv_freq[j * 8 + 2 * t + e];
  auto* out = static_cast<__nv_bfloat16*>(a.out) + (long long)s * a.M * hd;

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long m = m0 + wm * 32 + mi * 16 + g + 8 * hr;
      if (m >= a.M) continue;
      const int b = (int)(m / a.N), n = (int)(m - (long long)b * a.N);
      float y[8][2];
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) y[nj][e] = round_bf16(__fadd_rn(acc[mi][nj][2 * hr + e], bv[nj][e]));
      if (rope) {
        const int* pp = a.pos + b * a.p_sb + n * a.p_sn;
        const float p[2] = {(float)pp[0], (float)pp[a.p_s2]};  // y, x
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float sn, cs;
              sincosf(p[half] * freq[j][e], &sn, &cs);
              rotate(y[half * 4 + j][e], y[half * 4 + j + 2][e], round_bf16(cs), round_bf16(sn));
            }
      }
      __nv_bfloat16* orow = out + (((long long)b * a.H + h) * a.N + n) * D;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
        *reinterpret_cast<uint32_t*>(orow + nj * 8 + 2 * t) = pack_bf16(y[nj][0], y[nj][1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch 1, fp32: CUDA-core GEMM, the same epilogue without rounding
// ---------------------------------------------------------------------------

constexpr int FM = 64, FK = 16;  // rows per block (x one head of 64 columns), k step

__global__ void __launch_bounds__(256) proj_f32_kernel(const ProjArgs a) {
  __shared__ __align__(16) float a_s[FK][FM + 4];  // x tile, transposed: [k][row]
  __shared__ __align__(16) float b_s[FK][D + 4];   // W tile, transposed: [k][column]
  __shared__ float inv_freq[QUARTER];

  // thread (ty, tx): rows 4 ty .. 4 ty + 3, columns tx + 16 j (j = 0..3: u_Y v_Y u_X v_X of quarter index tx)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * FM;
  const int hd = a.H * D, c0 = blockIdx.y * D;  // one head of one section
  const int s = c0 / hd, h = (c0 - s * hd) / D;
  const auto* x = static_cast<const float*>(a.x);
  const auto* w = static_cast<const float*>(a.w[s]) + (long long)h * D * a.C;
  if (tid < QUARTER) inv_freq[tid] = (float)(a.f0 / pow(a.base, (double)tid / QUARTER));

  const int lr = tid / 4, lk = (tid % 4) * 4;  // the row (and column) this thread stages, 4 k values
  const bool row_in = m0 + lr < a.M;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.C; k0 += FK) {
    const bool in_k = k0 + lk < a.C;  // C % 4 == 0
    const float4 xv = row_in && in_k ? *reinterpret_cast<const float4*>(x + (m0 + lr) * a.C + k0 + lk)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 wv = in_k ? *reinterpret_cast<const float4*>(w + (long long)lr * a.C + k0 + lk)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    a_s[lk][lr] = xv.x, a_s[lk + 1][lr] = xv.y, a_s[lk + 2][lr] = xv.z, a_s[lk + 3][lr] = xv.w;
    b_s[lk][lr] = wv.x, b_s[lk + 1][lr] = wv.y, b_s[lk + 2][lr] = wv.z, b_s[lk + 3][lr] = wv.w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[k][4 * ty]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bw = b_s[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ar[i], bw, acc[i][j]);
      }
    }
    __syncthreads();
  }

  const bool rope = (a.rope_mask >> s) & 1;
  const float* bias = a.bias[s];
  const float freq = inv_freq[tx];
  auto* out = static_cast<float*>(a.out) + (long long)s * a.M * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + 4 * ty + i;
    if (m >= a.M) continue;
    const int b = (int)(m / a.N), n = (int)(m - (long long)b * a.N);
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = __fadd_rn(acc[i][j], bias != nullptr ? bias[h * D + tx + 16 * j] : 0.f);
    if (rope) {
      const int* pp = a.pos + b * a.p_sb + n * a.p_sn;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float sn, cs;
        sincosf((float)pp[half * a.p_s2] * freq, &sn, &cs);
        rotate(y[2 * half], y[2 * half + 1], cs, sn);
      }
    }
    float* orow = out + (((long long)b * a.H + h) * a.N + n) * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[tx + 16 * j] = y[j];
  }
}

// ---------------------------------------------------------------------------
// Launch 2, bf16: two-pass attention on the tensor cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;   // query rows per block: 4 warps x 16
constexpr int BK = 64;   // key rows per shared-memory tile
constexpr int PAD = 8;   // bf16 padding: 144-byte rows keep the operand loads free of bank conflicts

// q: (B, H, Nq, D), k and v: (B, H, Nk, D), contiguous; o: (B, Nq, H, D) contiguous.
__global__ void __launch_bounds__(128) attend_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                                          const __nv_bfloat16* __restrict__ k,
                                                          const __nv_bfloat16* __restrict__ v,
                                                          __nv_bfloat16* __restrict__ o, int H, int Nq, int Nk,
                                                          float scale) {
  __shared__ __align__(16) __nv_bfloat16 k_s[BK][D + PAD];   // [key][d]
  __shared__ __align__(16) __nv_bfloat16 vt_s[D][BK + PAD];  // [d][key]: V transposed, the B operand of P.V

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * BQ + warp * 16 + g, row1 = row0 + 8;
  const long long bh = (long long)b * H + h;
  const __nv_bfloat16* kp = k + bh * Nk * D;
  const __nv_bfloat16* vp = v + bh * Nk * D;

  uint32_t qa[D / 16][4];
  load_a_rows(qa, q + bh * Nq * D, D, row0, Nq, t);

  auto stage_k = [&](int k0) {  // 8 threads cover one 128-byte key row
    for (int c = tid; c < BK * D / 8; c += blockDim.x) {
      const int r = c / (D / 8), d8 = (c % (D / 8)) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Nk) u = *reinterpret_cast<const uint4*>(kp + (long long)(k0 + r) * D + d8);
      *reinterpret_cast<uint4*>(&k_s[r][d8]) = u;
    }
  };
  // the scaled scores of key n-tile j (8 keys) for rows row0 / row1; -inf past Nk
  auto scores = [&](int k0, int j, float s[4]) {
    s[0] = s[1] = s[2] = s[3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* kr = &k_s[j * 8 + g][kk * 16 + 2 * t];
      mma_16816(s, qa[kk], ld32(kr), ld32(kr + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = k0 + j * 8 + 2 * t + (e & 1) < Nk ? __fmul_rn(s[e], scale) : -INFINITY;
  };

  // pass 1: the row max over every key
  float m[2] = {-INFINITY, -INFINITY};
  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();
    stage_k(k0);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float s[4];
      scores(k0, j, s);
      m[0] = fmaxf(m[0], fmaxf(s[0], s[1]));
      m[1] = fmaxf(m[1], fmaxf(s[2], s[3]));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }

  // pass 2: p, the sums and P.V
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();
    stage_k(k0);
    // V tile, transposed: consecutive threads take consecutive keys
    for (int c = tid; c < BK * D / 8; c += blockDim.x) {
      const int r = c % BK, d8 = (c / BK) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Nk) u = *reinterpret_cast<const uint4*>(vp + (long long)(k0 + r) * D + d8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt_s[d8 + i][r] = e[i];
    }
    __syncthreads();

    float p[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      scores(k0, j, p[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] = k0 + j * 8 + 2 * t + (e & 1) < Nk ? expf(__fsub_rn(p[j][e], m[e >> 1])) : 0.f;
        l[e >> 1] += p[j][e];  // the sum takes p before its bf16 rounding
      }
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      pack_a(pa, p[2 * kc], p[2 * kc + 1]);
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
  __nv_bfloat16* op = o + ((long long)b * Nq * H + h) * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = i * 8 + 2 * t;
    if (row0 < Nq)
      *reinterpret_cast<uint32_t*>(op + (long long)row0 * H * D + c) =
          pack_bf16(__fdiv_rn(acc[i][0], l[0]), __fdiv_rn(acc[i][1], l[0]));
    if (row1 < Nq)
      *reinterpret_cast<uint32_t*>(op + (long long)row1 * H * D + c) =
          pack_bf16(__fdiv_rn(acc[i][2], l[1]), __fdiv_rn(acc[i][3], l[1]));
  }
}

// ---------------------------------------------------------------------------
// Launch 2, fp32: two-pass attention on the CUDA cores, one query row per thread
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 128;  // query rows per block
constexpr int F32_BK = 32;   // key rows per shared-memory tile

__global__ void __launch_bounds__(F32_BQ) attend_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                                            const float* __restrict__ v, float* __restrict__ o, int H,
                                                            int Nq, int Nk, float scale) {
  __shared__ __align__(16) float k_s[F32_BK][D];
  __shared__ __align__(16) float v_s[F32_BK][D];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * F32_BQ + tid;
  const long long bh = (long long)b * H + h;
  const float* kp = k + bh * Nk * D;
  const float* vp = v + bh * Nk * D;

  float qr[D];
  const float* qp = q + (bh * Nq + row) * D;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 x = row < Nq ? *reinterpret_cast<const float4*>(qp + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[d] = x.x, qr[d + 1] = x.y, qr[d + 2] = x.z, qr[d + 3] = x.w;
  }
  auto stage = [&](int k0, bool with_v) {
    for (int c = tid; c < F32_BK * D / 4; c += blockDim.x) {
      const int r = c / (D / 4), d4 = (c % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < Nk) {
        kx = *reinterpret_cast<const float4*>(kp + (long long)(k0 + r) * D + d4);
        if (with_v) vx = *reinterpret_cast<const float4*>(vp + (long long)(k0 + r) * D + d4);
      }
      *reinterpret_cast<float4*>(&k_s[r][d4]) = kx;
      if (with_v) *reinterpret_cast<float4*>(&v_s[r][d4]) = vx;
    }
  };
  auto score = [&](int i) {  // every thread reads the same key row: a shared-memory broadcast
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 kx = *reinterpret_cast<const float4*>(&k_s[i][d]);
      dot = fmaf(qr[d], kx.x, dot);
      dot = fmaf(qr[d + 1], kx.y, dot);
      dot = fmaf(qr[d + 2], kx.z, dot);
      dot = fmaf(qr[d + 3], kx.w, dot);
    }
    return __fmul_rn(dot, scale);
  };

  float m = -INFINITY;
  for (int k0 = 0; k0 < Nk; k0 += F32_BK) {
    __syncthreads();
    stage(k0, false);
    __syncthreads();
    const int n = min(F32_BK, Nk - k0);
    for (int i = 0; i < n; ++i) m = fmaxf(m, score(i));
  }

  float l = 0.f, acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int k0 = 0; k0 < Nk; k0 += F32_BK) {
    __syncthreads();
    stage(k0, true);
    __syncthreads();
    const int n = min(F32_BK, Nk - k0);
    for (int i = 0; i < n; ++i) {
      const float p = expf(__fsub_rn(score(i), m));
      l += p;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vx = *reinterpret_cast<const float4*>(&v_s[i][d]);
        acc[d] = fmaf(p, vx.x, acc[d]);
        acc[d + 1] = fmaf(p, vx.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vx.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vx.w, acc[d + 3]);
      }
    }
  }
  if (row < Nq) {
    float* op = o + (((long long)b * Nq + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; d += 4)
      *reinterpret_cast<float4*>(op + d) =
          make_float4(__fdiv_rn(acc[d], l), __fdiv_rn(acc[d + 1], l), __fdiv_rn(acc[d + 2], l), __fdiv_rn(acc[d + 3], l));
  }
}

}  // namespace

// Launch 1. x: contiguous (B, N, C); w0..w2: the S sections' contiguous (H * D, C) weights (unused ones null);
// b0..b2: their (H * D,) float32 biases or null; pos: (B, N, 2) int32 by strides (in elements), or null when
// rope_mask is 0; out: contiguous (S, B, H, N, D). x, w and out share dtype (0 = float32, 1 = bfloat16);
// C % 8 == 0 (bfloat16) or C % 4 == 0 (float32); D = 64. Returns a cudaError_t.
extern "C" int uc_fused_project(const void* x, const void* w0, const void* w1, const void* w2, const void* b0,
                                const void* b1, const void* b2, const void* pos, long long p_sb, long long p_sn,
                                long long p_s2, int rope_mask, void* out, int dtype, int B, int N, int C, int H, int S,
                                double base, double f0, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || H <= 0 || S < 1 || S > 3 || (rope_mask != 0 && pos == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* ws[3] = {w0, w1, w2};
  for (int s = 0; s < S; ++s)
    if (ws[s] == nullptr) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * N;
  if (M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ProjArgs a{x, {w0, w1, w2}, {static_cast<const float*>(b0), static_cast<const float*>(b1),
             static_cast<const float*>(b2)}, static_cast<const int*>(pos), p_sb, p_sn, p_s2, rope_mask, out,
             (int)M, N, C, H, S, base, f0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = S * H * D;
  if (dtype == 1) {
    if (C % 8 != 0 || (cols + PN - 1) / PN > 65535) return (int)cudaErrorInvalidValue;
    proj_bf16_kernel<<<dim3((unsigned)((M + PM - 1) / PM), (cols + PN - 1) / PN), PTHREADS, 0, st>>>(a);
  } else if (dtype == 0) {
    if (C % 4 != 0 || cols / D > 65535) return (int)cudaErrorInvalidValue;
    proj_f32_kernel<<<dim3((unsigned)((M + FM - 1) / FM), cols / D), 256, 0, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Launch 2. q: contiguous (B, H, Nq, D); k, v: contiguous (B, H, Nk, D); o: contiguous (B, Nq, H, D); all of
// one dtype (0 = float32, 1 = bfloat16). Returns a cudaError_t.
extern "C" int uc_fused_attend(const void* q, const void* k, const void* v, void* o, int dtype, int B, int H, int Nq,
                               int Nk, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    attend_bf16_kernel<<<dim3((Nq + BQ - 1) / BQ, H, B), 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, Nq, Nk, scale);
  } else if (dtype == 0) {
    attend_f32_kernel<<<dim3((Nq + F32_BQ - 1) / F32_BQ, H, B), F32_BQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), H, Nq, Nk, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
