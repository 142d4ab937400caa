// Fused qkv projection + 2D RoPE + attention (K5), self and cross, D a multiple of 4 up to 256.
//
// Replaces: uniception_tpu/ops/fused_attention.py: fused_qkv_rope_attention
//   (body _fused_self_kernel) and fused_cross_rope_attention (body
//   _fused_cross_kernel), which the attention layers take under the "fused"
//   implementation (nn/blocks.py _fused_attention_applicable).
//
// What it computes, as the Pallas kernel does:
//   * y = x . W^T + b with fp32 accumulation and the bias in fp32, rounded
//     once to the compute dtype (bf16 for bf16 x, else fp32);
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
// What the design does about it:
//   * The Pallas kernel keeps x for a whole batch row, W (6 MB) and the k/v
//     scratch carried from the first q-block to the next in VMEM (110 MB).
//     None of that fits 227 KB of shared memory, and CUDA blocks carry
//     nothing from one to another, so the work is split into two launches.
//   * Launch 1, the projection: a GEMM over (B*N) x C x (S*H*D), S = 3 for
//     self (Wqkv), 1 for the cross q (Wq) and 2 for the cross k/v (Wk, Wv
//     given apart: no per-call concat). bf16: hopper.cuh's persistent,
//     warp-specialised GEMM (the one K4 runs on): x and each section's
//     weight, in torch's (out, in) layout and so K-major as B, go through
//     2-D tensor maps into a TMA ring, two consumer warpgroups run bf16 wgmma
//     m64nBNk16 with fp32 accumulators, BN = 128 or 256 as ops/gemm.py
//     gemm_plan picks; an n-tile holds whole heads of one section. fp32:
//     64x64 tiles of full fp32 FMA on the CUDA cores (no TF32: the Pallas
//     kernel runs fp32 at HIGHEST precision). Either way a thread holds each
//     u column and its v partner (d + 16) at the same register position (in
//     wgmma's accumulator layout, column 8c + 2t + j is register pair c, so
//     the partner is pair c + 2), so the epilogue (+ bias, round, RoPE) pairs
//     them in registers. q, k and v go to a (S, B, H, N, D) scratch, each
//     (b, h) pair's rows contiguous, in 16-byte stores (a whole 8-column chunk
//     per lane after hopper.cuh quad_transpose); each head's biases are
//     loaded once for both of a thread's rows, ahead of the stores.
//   * Launch 2, the attention: K1's kernel (flash_attention.cu), launched by
//     the wrapper (ops/fused_attention.py), reads the scratch in place
//     through (B, N, H, D) views. K1's online softmax rounds p against a
//     running max where the Pallas kernel takes the row max over all keys
//     first; the difference is a bf16 rounding of p, inside K5's tolerance
//     (chip_smoke.py phases 16-17 hold each call to it).
//   * The q/k/v round trip through device memory, which the Pallas design
//     avoids, is 3 x 8.4 MB written and read back per encoder call, mostly
//     from the 50 MB L2; its cost on the card is in PERF.md.
//   * Head dims other than 64 (RADIO-h and Pixio-H's 80, any D % 4 == 0 up to
//     256, the JAX fused rule). The epilogue above pairs u with v = u + 16 in
//     a thread's registers because D = 64 puts each quarter's 16 pairs 16
//     columns apart and a 128- or 256-column tile holds whole heads. At D = 80
//     the partner of column j is j + 20, in another lane, and a tile straddles
//     heads. So for D != 64 the wrapper (ops/fused_attention.py
//     rope_pair_layout) hands the GEMM each section's weight (and fp32 bias)
//     with its rows permuted into a padded head of DPAD = 32, 64, 128 or 256
//     columns: rotation pair P (its u_Y / v_Y or u_X / v_X columns) at padded
//     column 32 (P / 16) + P % 16 and its partner 16 further on, zero rows past
//     the D / 2 pairs. The GEMM's tile width is a multiple of DPAD, so a tile
//     holds whole padded heads, every pair is in one thread's registers again,
//     and PadRopeEpilogue rotates it with the pair's frequency (the plain
//     version's table, passed in) and writes u and v to their head columns.
//     The cost: the per-call copy of the weights and DPAD / D of the GEMM's
//     work (1.6x at D = 80), and two-byte stores. The scratch rows are D
//     rounded up to 8 (zeros past D), so K1's tensor maps read it in place.
//     fp32: the CUDA-core kernel takes a head of any such D per block, each
//     thread up to 8 pairs of a quarter index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fa_common.cuh"
#include "hopper.cuh"

namespace {

using namespace uc_fa;
namespace hw = uc_hopper;

constexpr int HD = 64;             // the head dim of BiasRopeEpilogue's register pairs
constexpr int QUARTER = HD / 4;    // its RoPE quarter: [u_Y v_Y u_X v_X] of 16 each
constexpr int MAX_D = 256;         // the widest head

struct ProjArgs {
  const void* x;         // (M, C) rows, contiguous, M = B * N
  const void* w[3];      // per section: (H * D, C) rows (torch's (out, in) layout), contiguous
  const float* bias[3];  // per section: (H * D,) fp32, or null
  const int* pos;        // (B, N, 2) int32 (y, x), by strides; null when no section takes RoPE
  long long p_sb, p_sn, p_s2;
  int rope_mask;         // bit s: section s takes RoPE
  void* out;             // (S, B, H, N, DS) contiguous, in x's dtype
  int M, N, C, H, S, D, DS;  // DS: the scratch's row, D rounded up to 8
  double base, f0;
};

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// The rotation of one (u, v) pair, in place, with cos/sin already rounded to the compute dtype.
__device__ __forceinline__ void rotate(float& u, float& v, float cs, float sn) {
  const float ou = __fsub_rn(__fmul_rn(u, cs), __fmul_rn(v, sn));
  const float ov = __fadd_rn(__fmul_rn(v, cs), __fmul_rn(u, sn));
  u = ou, v = ov;
}

// ---------------------------------------------------------------------------
// Launch 1, bf16: the shared wgmma GEMM with the bias + round + RoPE epilogue
// ---------------------------------------------------------------------------

__device__ __forceinline__ float load_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

// TB: the biases' type, fp32, or the bf16 of a bf16 model read as they are (widened to fp32, which is exact).
template <typename TB>
struct BiasRopeEpilogue {
  struct State {
    float freq[2][2];  // [j][e]: the inverse frequency of quarter index 8j + 2t + e
  };
  const TB* bias[3];     // per section, or null
  const int* pos;        // (B, N, 2) int32 (y, x) by strides; null when no section takes RoPE
  long long p_sb, p_sn, p_s2;
  int rope_mask;         // bit s: section s takes RoPE
  __nv_bfloat16* out;    // (S, B, H, N, HD) contiguous
  int M, N, H;
  double base, f0;

  __device__ State init(int t) const {
    State st;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) st.freq[j][e] = (float)(f0 / pow(base, (double)(8 * j + 2 * t + e) / QUARTER));
    return st;
  }

  // Column 64 hh + 8 nj + 2t + e of the tile is head column d = 8 nj + 2t + e of its head hh: nj 0-1 u_Y, 2-3
  // v_Y, 4-5 u_X, 6-7 v_X, so the partner of (nj, e) is (nj + 2, e), in this thread's registers. A row's cos
  // and sin depend on its position and the quarter index alone, so they are computed once for all its heads,
  // and a head's biases are loaded once for both rows, ahead of the stores (a load after a store to `out`
  // cannot be hoisted above it).
  template <int NA>
  __device__ __forceinline__ void operator()(const float (&acc)[NA], const State& st, int row0, int s, int col0,
                                             int t) const {
    constexpr int HEADS = 2 * NA / HD;
    const int hd = H * HD;
    const bool rope = (rope_mask >> s) & 1;
    const TB* b = s == 0 ? bias[0] : s == 1 ? bias[1] : bias[2];  // no dynamic index: no local copy
    __nv_bfloat16* o = out + (long long)s * M * hd;
    int bi[2], n[2];
    float cs[2][2][2][2], sn[2][2][2][2];  // [row i][y / x half][j][e], rounded to bf16
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = min(row0 + 8 * i, M - 1);  // a row past M is never stored
      bi[i] = m / N, n[i] = m - bi[i] * N;
    }
    if (rope) {
      float p[2][2];  // [row i][y, x]
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int* pp = pos + bi[i] * p_sb + n[i] * p_sn;
        p[i][0] = (float)__ldg(pp), p[i][1] = (float)__ldg(pp + p_s2);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float sv, cv;
              sincosf(p[i][half] * st.freq[j][e], &sv, &cv);
              cs[i][half][j][e] = round_bf16(cv);
              sn[i][half][j][e] = round_bf16(sv);
            }
    }
#pragma unroll
    for (int hh = 0; hh < HEADS; ++hh) {
      const int c0 = col0 + hh * HD;
      if (c0 >= hd) break;  // past the section: TMA's zeros, never stored
      float bv[8][2];
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) bv[nj][e] = b != nullptr ? load_float(b + c0 + nj * 8 + 2 * t + e) : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float y[8][2];
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) y[nj][e] = round_bf16(__fadd_rn(acc[4 * (8 * hh + nj) + 2 * i + e], bv[nj][e]));
        if (rope) {
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                rotate(y[half * 4 + j][e], y[half * 4 + j + 2][e], cs[i][half][j][e], sn[i][half][j][e]);
        }
        // the head's row: 8 chunks of 8 columns, two of 4 chunks transposed across the quad, a chunk per lane
        __nv_bfloat16* orow = o + (((long long)bi[i] * H + c0 / HD) * N + n[i]) * HD;
#pragma unroll
        for (int q = 0; q < 8; q += 4) {
          uint32_t w[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) w[u] = pack_bf16(y[q + u][0], y[q + u][1]);
          hw::quad_transpose(w, t);  // every lane, whatever its row
          if (row0 + 8 * i < M) *reinterpret_cast<uint4*>(orow + (q + t) * 8) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
  }
};


// D != 64 (bf16): the GEMM ran over each section's weight permuted into padded heads of DPAD columns
// (ops/fused_attention.py rope_pair_layout): rotation pair P of a head sits at padded column 32 (P / 16) + P % 16,
// its partner 16 columns on, so in each 32-column group of the tile chunks 0 and 1 hold u and chunks 2 and 3 their
// v, in this thread's registers. The bias comes in the same padded layout (fp32). Each pair is rounded after the
// bias, rotated by its frequency (inv_freq, the plain version's table, rounded cos/sin as K2 rounds them) and its
// two columns written to the head's row of the (S, B, H, N, DS) scratch.
struct PadRopeEpilogue {
  struct State {};
  const float* bias[3];  // per section, (H * DPAD,) in the padded layout, or null
  const int* pos;        // (B, N, 2) int32 (y, x) by strides; null when no section takes RoPE
  long long p_sb, p_sn, p_s2;
  int rope_mask;         // bit s: section s takes RoPE
  __nv_bfloat16* out;    // (S, B, H, N, DS) contiguous
  int M, N, H, D, DS, DPAD;
  const float* inv_freq;  // (D / 4,) fp32

  __device__ State init(int) const { return State{}; }

  template <int NA>
  __device__ __forceinline__ void operator()(const float (&acc)[NA], const State&, int row0, int s, int col0,
                                             int t) const {
    const int Q = D / 4, hw_ = H * DPAD;
    const bool rope = (rope_mask >> s) & 1;
    const float* b = s == 0 ? bias[0] : s == 1 ? bias[1] : bias[2];
    __nv_bfloat16* o = out + (long long)s * M * H * DS;
    int bi[2], n[2];
    float p[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [row i][y, x]
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = min(row0 + 8 * i, M - 1);  // a row past M is never stored
      bi[i] = m / N, n[i] = m - bi[i] * N;
      if (rope) {
        const int* pp = pos + bi[i] * p_sb + n[i] * p_sn;
        p[i][0] = (float)__ldg(pp), p[i][1] = (float)__ldg(pp + p_s2);
      }
    }
#pragma unroll
    for (int g4 = 0; g4 < NA / 16; ++g4) {  // 32-column groups: registers [16 g4, 16 g4 + 16)
      const int col = col0 + 32 * g4;
      if (col >= hw_) break;  // past the section: TMA's zeros, never stored
      const int h = col / DPAD, gi = (col - h * DPAD) / 32;
#pragma unroll
      for (int mc = 0; mc < 2; ++mc)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int P = 16 * gi + 8 * mc + 2 * t + e;  // the rotation pair
          if (P >= 2 * Q) continue;                    // the padding's zero rows
          const int half = P >= Q, qi = P - half * Q;
          const int du = 2 * half * Q + qi, dv = du + Q;
          const int cu = col + 8 * mc + 2 * t + e;
          const float bu = b != nullptr ? __ldg(b + cu) : 0.f, bv = b != nullptr ? __ldg(b + cu + 16) : 0.f;
          const float freq = rope ? __ldg(inv_freq + qi) : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float yu = round_bf16(__fadd_rn(acc[16 * g4 + 4 * mc + 2 * i + e], bu));
            float yv = round_bf16(__fadd_rn(acc[16 * g4 + 4 * (mc + 2) + 2 * i + e], bv));
            if (rope) {
              float sv, cv;
              sincosf(p[i][half] * freq, &sv, &cv);
              rotate(yu, yv, round_bf16(cv), round_bf16(sv));
            }
            if (row0 + 8 * i < M) {
              __nv_bfloat16* orow = o + (((long long)bi[i] * H + h) * N + n[i]) * DS;
              orow[du] = __float2bfloat16_rn(yu);
              orow[dv] = __float2bfloat16_rn(yv);
            }
          }
        }
    }
  }
};

// ---------------------------------------------------------------------------
// Launch 1, fp32: CUDA-core GEMM, the same epilogue without rounding
// ---------------------------------------------------------------------------

constexpr int FM = 64, FK = 16;  // rows per block (x one head), k step
constexpr int FJ = MAX_D / 32;     // rotation pairs per thread: tx + 16 j, j < FJ

// A block: FM rows x one head of one section. Thread (ty, tx): rows 4 ty .. 4 ty + 3 and the rotation pairs
// P = tx + 16 j (P < D / 2) of the head, each pair's u and v columns (u_Y / v_Y of quarter index P, or u_X / v_X
// of P - D / 4), so the epilogue rotates in registers. At D = 64 these are columns tx + 16 j, j < 4, as before.
__global__ void __launch_bounds__(256) proj_f32_kernel(const ProjArgs a) {
  __shared__ __align__(16) float a_s[FK][FM + 4];      // x tile, transposed: [k][row]
  __shared__ __align__(16) float b_s[FK][MAX_D + 4];   // W tile, transposed: [k][column]
  __shared__ float inv_freq[MAX_D / 4];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int D = a.D, Q = D / 4;
  const long long m0 = (long long)blockIdx.x * FM;
  const int hd = a.H * D, c0 = blockIdx.y * D;  // one head of one section
  const int s = c0 / hd, h = (c0 - s * hd) / D;
  const auto* x = static_cast<const float*>(a.x);
  const auto* w = static_cast<const float*>(a.w[s]) + (long long)h * D * a.C;
  for (int i = tid; i < Q; i += blockDim.x) inv_freq[i] = (float)(a.f0 / pow(a.base, (double)i / Q));
  int du[FJ];  // the u column of each of this thread's pairs (the v column is du + Q); -1 past the pairs
#pragma unroll
  for (int j = 0; j < FJ; ++j) {
    const int P = tx + 16 * j, half = P >= Q;
    du[j] = P < 2 * Q ? 2 * half * Q + P - half * Q : -1;
  }

  const int lr = tid / 4, lk = (tid % 4) * 4;  // the row (and columns) this thread stages, 4 k values
  const bool row_in = m0 + lr < a.M;
  float acc[4][FJ][2] = {};
  for (int k0 = 0; k0 < a.C; k0 += FK) {
    const bool in_k = k0 + lk < a.C;  // C % 4 == 0
    const float4 xv = row_in && in_k ? *reinterpret_cast<const float4*>(x + (m0 + lr) * a.C + k0 + lk)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    a_s[lk][lr] = xv.x, a_s[lk + 1][lr] = xv.y, a_s[lk + 2][lr] = xv.z, a_s[lk + 3][lr] = xv.w;
    for (int r = lr; r < D; r += FM) {  // the head's D weight rows
      const float4 wv = in_k ? *reinterpret_cast<const float4*>(w + (long long)r * a.C + k0 + lk)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      b_s[lk][r] = wv.x, b_s[lk + 1][r] = wv.y, b_s[lk + 2][r] = wv.z, b_s[lk + 3][r] = wv.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[k][4 * ty]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int j = 0; j < FJ; ++j) {
        if (du[j] < 0) continue;
        const float bu = b_s[k][du[j]], bv = b_s[k][du[j] + Q];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] = fmaf(ar[i], bu, acc[i][j][0]);
          acc[i][j][1] = fmaf(ar[i], bv, acc[i][j][1]);
        }
      }
    }
    __syncthreads();
  }

  const bool rope = (a.rope_mask >> s) & 1;
  const float* bias = a.bias[s];
  auto* out = static_cast<float*>(a.out) + (long long)s * a.M * a.H * a.DS;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + 4 * ty + i;
    if (m >= a.M) continue;
    const int b = (int)(m / a.N), n = (int)(m - (long long)b * a.N);
    const int* pp = rope ? a.pos + b * a.p_sb + n * a.p_sn : nullptr;
    float* orow = out + (((long long)b * a.H + h) * a.N + n) * a.DS;
#pragma unroll
    for (int j = 0; j < FJ; ++j) {
      if (du[j] < 0) continue;
      const int dv = du[j] + Q;
      float yu = __fadd_rn(acc[i][j][0], bias != nullptr ? bias[h * D + du[j]] : 0.f);
      float yv = __fadd_rn(acc[i][j][1], bias != nullptr ? bias[h * D + dv] : 0.f);
      if (rope) {
        const int P = tx + 16 * j, half = P >= Q;
        float sn, cs;
        sincosf((float)pp[half * a.p_s2] * inv_freq[P - half * Q], &sn, &cs);
        rotate(yu, yv, cs, sn);
      }
      orow[du[j]] = yu;
      orow[dv] = yv;
    }
  }
}

template <typename TB>
int project_bf16(const hw::GemmMaps& m, const hw::GemmParams& g, const void* b0, const void* b1, const void* b2,
                 const void* pos, long long p_sb, long long p_sn, long long p_s2, int rope_mask, void* out, int N, int H,
                 double base, double f0, int bn, cudaStream_t st) {
  const BiasRopeEpilogue<TB> epi{{static_cast<const TB*>(b0), static_cast<const TB*>(b1), static_cast<const TB*>(b2)},
                                 static_cast<const int*>(pos), p_sb, p_sn, p_s2, rope_mask,
                                 static_cast<__nv_bfloat16*>(out), g.M, N, H, base, f0};
  return bn == 256 ? hw::launch_gemm<false, 256>(m, g, epi, st) : hw::launch_gemm<false, 128>(m, g, epi, st);
}

}  // namespace

// The projection. x: contiguous (B, N, C); w0..w2: the S sections' contiguous (H * D, C) weights (unused ones
// null), or with dpad > 0 their (H * dpad, C) permutation into padded heads (ops/fused_attention.py
// rope_pair_layout); b0..b2: their (H * D,) biases (with dpad, (H * dpad,) permuted, float32) or null, float32, or
// bfloat16 with bias_bf16 = 1 (bfloat16 x at D = 64 only); pos: (B, N, 2) int32 by strides (in elements), or null
// when rope_mask is 0; out: contiguous (S, B, H, N, DS), DS = D rounded up to 8 (the columns past D are left as
// they are). x, w and out share dtype (0 = float32, 1 = bfloat16); C % 8 == 0 (bfloat16) or C % 4 == 0
// (float32); D % 4 == 0 up to 256. bfloat16 runs the GEMM with the tensor maps of `maps` (ops/gemm.py gemm_maps,
// 10 ints: x as A, each section's weight as B) in tiles of bn = 128 or 256 columns (a multiple of dpad), at D = 64
// on the weights as they are (dpad 0), at any other D on the permuted ones (dpad > 0) with inv_freq the (D / 4,)
// float32 RoPE frequencies; float32 takes the weights as they are and ignores maps, bn, dpad and inv_freq.
// Returns a cudaError_t.
extern "C" int uc_fused_project(const void* x, const void* w0, const void* w1, const void* w2, const void* b0,
                                const void* b1, const void* b2, const void* pos, long long p_sb, long long p_sn,
                                long long p_s2, int rope_mask, void* out, int dtype, int B, int N, int C, int H, int D,
                                int S, double base, double f0, const long long* maps, int bn, int bias_bf16, int dpad,
                                const void* inv_freq, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || H <= 0 || S < 1 || S > 3 || D < 4 || D > MAX_D || D % 4 != 0 ||
      (rope_mask != 0 && pos == nullptr) || (bias_bf16 && (dtype != 1 || dpad != 0)))
    return (int)cudaErrorInvalidValue;
  const void* ws[3] = {w0, w1, w2};
  for (int s = 0; s < S; ++s)
    if (ws[s] == nullptr) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * N;
  if (M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int DS = (D + 7) / 8 * 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const bool padded = dpad > 0;
    if (padded ? (dpad % 32 != 0 || dpad < D || bn % dpad != 0 || (rope_mask != 0 && inv_freq == nullptr))
               : D != HD)
      return (int)cudaErrorInvalidValue;
    const int hd = H * (padded ? dpad : D);
    if (C % 8 != 0 || maps == nullptr || maps[0] != C || maps[1] != M || maps[6] != hd) return (int)cudaErrorInvalidValue;
    hw::GemmParams g;
    int status = hw::gemm_params(&g, (int)M, hd, S, 2LL * C, bn, 1, nullptr);
    hw::GemmMaps m;
    if (status == 0) status = hw::encode_gemm_maps(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, ws, S, maps, bn);
    if (status != 0) return status;
    if (padded) {
      const PadRopeEpilogue epi{{static_cast<const float*>(b0), static_cast<const float*>(b1),
                                 static_cast<const float*>(b2)},
                                static_cast<const int*>(pos), p_sb, p_sn, p_s2, rope_mask,
                                static_cast<__nv_bfloat16*>(out), (int)M, N, H, D, DS, dpad,
                                static_cast<const float*>(inv_freq)};
      return bn == 256 ? hw::launch_gemm<false, 256>(m, g, epi, st) : hw::launch_gemm<false, 128>(m, g, epi, st);
    }
    return bias_bf16 ? project_bf16<__nv_bfloat16>(m, g, b0, b1, b2, pos, p_sb, p_sn, p_s2, rope_mask, out, N, H, base,
                                                    f0, bn, st)
                     : project_bf16<float>(m, g, b0, b1, b2, pos, p_sb, p_sn, p_s2, rope_mask, out, N, H, base, f0, bn,
                                           st);
  }
  if (dtype != 0 || C % 4 != 0 || S * H > 65535) return (int)cudaErrorInvalidValue;
  const ProjArgs a{x, {w0, w1, w2}, {static_cast<const float*>(b0), static_cast<const float*>(b1),
                   static_cast<const float*>(b2)}, static_cast<const int*>(pos), p_sb, p_sn, p_s2, rope_mask, out,
                   (int)M, N, C, H, S, D, DS, base, f0};
  proj_f32_kernel<<<dim3((unsigned)((M + FM - 1) / FM), S * H), 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}
