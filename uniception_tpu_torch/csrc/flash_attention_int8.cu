// Int8 attention (inference): softmax(q k^T * scale) v over bf16 (B, N, H, D)
// tensors, D = 64, with QK^T (and, in "int8pv" mode, P.V) as int8 products.
// Only for the case where every key fits one block (Nk <= 1024 at D = 64).
//
// Replaces: uniception_tpu/ops/flash_attention.py: _fa_single_kernel_int8,
//   the kernel _flash_attention_impl picks when the attention quant mode is
//   "int8" or "int8pv", one key block covers all keys, no logsumexp is wanted
//   and the dtype is not float32.
//
// Numerics, as the Pallas kernel computes them (k and q in fp32 from bf16):
//   * K smoothing: k -= mean over the valid keys; ks = max(max|k|, 1e-30) / 127
//     over the (b, h) pair; k8 = round(k / ks).
//   * q per row: qs = max(max|q_row|, 1e-30) / 127, q8 = round(q / qs).
//   * s = float(q8 . k8) * (qs * (ks * scale)); padded keys are -inf; the
//     softmax takes the row max over ALL keys, p = exp(s - m), l = sum of the
//     unrounded p.
//   * "int8": o = (p rounded to bf16) . v in fp32, / l.
//     "int8pv": vs = max(max|v|, 1e-30) / 127 over the pair, v8 = round(v / vs),
//     p8 = round(p * 127), o = float(p8 . v8) * (vs / 127) / l.
//   Divisions are IEEE (__fdiv_rn), rounding is half to even (rintf), and each
//   product in the scale chains is rounded on its own (__fmul_rn).
//
// What bounds it on the H100: like K1 (flash_attention.cu), ~256 operations
//   per byte of q/k/v/o at N = 1024: tensor-core throughput and the softmax's
//   exp/max/sum, not HBM. The int8 products run at twice the bf16 rate.
//
// What the design does about it:
//   * The k mean and the k (and v) scales need every key before any score, and
//     blocks of different query tiles cannot share them: a first kernel, one
//     block per (b, h), computes them and writes k8 (and v8) to a (B, H,
//     Nk rounded up to 64, D) int8 scratch, zero past Nk (4 MB at the encoder
//     shape, read back from L2).
//   * The main kernel is K1's layout: one block per (b, h, 64-query tile), 4
//     warps of 16 query rows, key tiles of 64 staged in shared memory. Each
//     thread loads exactly the q elements of its mma A fragments (16 per row),
//     and the 4 lanes of a row reduce the row abs-max with two shuffles.
//   * An online softmax would round other values than the Pallas kernel's
//     (it rescales with a running max), so the block makes two passes over
//     the int8 keys: the first only takes the row max, the second computes
//     p, the sum and P.V. The int8 QK^T is cheap next to P.V at Nk <= 1024.
//   * int8: the score accumulators' layout is the bf16 A layout (as in K1),
//     so p is rounded to bf16 in registers and fed straight to m16n8k16.
//     int8pv: the m16n8k32 A fragment wants 4 consecutive keys per register
//     where the accumulators hold 2; instead of shuffling, the keys of each
//     32-key step are permuted (the product sums over keys, so any order
//     does) and v8 is staged transposed in that same order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fa_common.cuh"
#include "int8_common.cuh"

namespace {

using namespace uc_fa;
using namespace uc_i8;

constexpr int BQ = 64;      // query rows per block: 4 warps x 16
constexpr int BK = 64;      // key rows per shared-memory tile
constexpr int PADB = 16;    // bytes of padding per int8 shared row (80-byte rows: conflict-free fragment loads)
constexpr int PADH = 8;     // bf16 padding per bf16 shared row
constexpr int PREP_THREADS = 256;

// ---------------------------------------------------------------------------
// Pass 0, one block per (b, h): k mean, ks, k8; vs and v8 for int8pv.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < PREP_THREADS / 32; ++i) r = fmaxf(r, red[i]);
  return r;
}

__global__ void __launch_bounds__(PREP_THREADS) fa8_prep_kernel(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v, int8_t* __restrict__ k8,
    int8_t* __restrict__ v8, float* __restrict__ kscale, float* __restrict__ vscale, int H, int Nk, int nk_pad,
    Strides ks, Strides vs, int pv_int8) {
  __shared__ float part[PREP_THREADS / D][D];
  __shared__ float mean_s[D];
  __shared__ float red[PREP_THREADS / 32];

  const int tid = threadIdx.x, d = tid % D, grp = tid / D;
  const int b = blockIdx.y, h = blockIdx.x;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;

  float sum = 0.f;
  for (int n = grp; n < Nk; n += PREP_THREADS / D) sum += __bfloat162float(kp[(long long)n * ks.n + d]);
  part[grp][d] = sum;
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PREP_THREADS / D; ++i) s += part[i][tid];
    mean_s[tid] = __fdiv_rn(s, (float)Nk);
  }
  __syncthreads();
  const float mean = mean_s[d];

  float amax = 0.f, vmax = 0.f;
  for (int n = grp; n < Nk; n += PREP_THREADS / D) {
    amax = fmaxf(amax, fabsf(__fsub_rn(__bfloat162float(kp[(long long)n * ks.n + d]), mean)));
    if (pv_int8) vmax = fmaxf(vmax, fabsf(__bfloat162float(vp[(long long)n * vs.n + d])));
  }
  const float ksc = absmax_scale(block_max(amax, red));
  const float vsc = pv_int8 ? absmax_scale(block_max(vmax, red)) : 0.f;
  if (tid == 0) {
    kscale[b * H + h] = ksc;
    if (pv_int8) vscale[b * H + h] = vsc;
  }

  const long long base = ((long long)b * H + h) * nk_pad * D;
  for (int n = grp; n < nk_pad; n += PREP_THREADS / D) {
    int kq = 0, vq = 0;
    if (n < Nk) {
      kq = quant8(__fsub_rn(__bfloat162float(kp[(long long)n * ks.n + d]), mean), ksc);
      if (pv_int8) vq = quant8(__bfloat162float(vp[(long long)n * vs.n + d]), vsc);
    }
    k8[base + (long long)n * D + d] = (int8_t)kq;
    if (pv_int8) v8[base + (long long)n * D + d] = (int8_t)vq;
  }
}

// ---------------------------------------------------------------------------
// The attention proper.
// ---------------------------------------------------------------------------

// Position of key kk (0..63 of a tile) in the permuted order of the int8pv
// P.V product: thread t's accumulators hold keys 2t, 2t+1 of each 8-key
// n-tile; the A fragment's register of 4 consecutive positions 4t..4t+3 takes
// keys 2t, 2t+1, 8+2t, 9+2t of the same 16-key half.
__device__ __forceinline__ int pv_pos(int kk) {
  const int base = kk & ~15, r = kk & 15;
  return base + (r < 8 ? 4 * (r >> 1) + (r & 1) : 4 * ((r - 8) >> 1) + 2 + (r & 1));
}

template <bool PV8>
__global__ void __launch_bounds__(128) fa8_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ v, const int8_t* __restrict__ k8,
    const int8_t* __restrict__ v8, const float* __restrict__ kscale, const float* __restrict__ vscale,
    __nv_bfloat16* __restrict__ o, int H, int Nq, int Nk, int nk_pad, Strides qs, Strides vs, float scale) {
  __shared__ __align__(16) int8_t k_s[BK][D + PADB];                   // k8 tile [key][d]
  __shared__ __align__(16) int8_t vt8_s[PV8 ? D : 1][BK + PADB];       // int8pv: v8 tile [d][permuted key]
  __shared__ __align__(16) __nv_bfloat16 vt_s[PV8 ? 1 : D][BK + PADH];  // int8: v tile [d][key]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * BQ + warp * 16 + g, row1 = row0 + 8;
  const long long bh = (long long)b * H + h;
  const int8_t* k8p = k8 + bh * nk_pad * D;
  const int8_t* v8p = PV8 ? v8 + bh * nk_pad * D : nullptr;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;

  // q8 as the A fragments of the two 32-wide k steps over D: this thread holds
  // columns 4t..4t+3 and 16+4t..16+4t+3 of each half, for rows row0 and row1
  uint32_t qa[2][4];
  float f[2];  // per row: qs * (ks * scale)
  {
    const float ksc = __fmul_rn(kscale[bh], scale);
    float vals[2][16];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      const __nv_bfloat16* qp = q + b * qs.b + h * qs.h + (long long)row * qs.n;
      float amax = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // columns 16c + 4t .. 16c + 4t + 3
        uint2 u = make_uint2(0u, 0u);
        if (row < Nq) u = *reinterpret_cast<const uint2*>(qp + 16 * c + 4 * t);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          vals[r][4 * c + i] = __bfloat162float(e[i]);
          amax = fmaxf(amax, fabsf(vals[r][4 * c + i]));
        }
      }
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      const float qsc = absmax_scale(amax);
      f[r] = __fmul_rn(qsc, ksc);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        qa[c >> 1][(c & 1) * 2 + r] = pack_s8x4(quant8(vals[r][4 * c], qsc), quant8(vals[r][4 * c + 1], qsc),
                                                quant8(vals[r][4 * c + 2], qsc), quant8(vals[r][4 * c + 3], qsc));
    }
  }

  auto stage_k = [&](int k0) {  // 64 keys x 64 bytes, zero past Nk (the scratch is padded)
    for (int c = tid; c < BK * D / 16; c += blockDim.x) {
      const int r = c / (D / 16), d16 = (c % (D / 16)) * 16;
      *reinterpret_cast<uint4*>(&k_s[r][d16]) = *reinterpret_cast<const uint4*>(k8p + (long long)(k0 + r) * D + d16);
    }
  };
  // the scores of key tile j (8 keys) for rows row0 / row1, masked past Nk
  auto scores = [&](int k0, int j, float s[4]) {
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      mma_s8(acc, qa[ks], ld32s(&k_s[j * 8 + g][ks * 32 + 4 * t]), ld32s(&k_s[j * 8 + g][ks * 32 + 16 + 4 * t]));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + j * 8 + 2 * t + (e & 1);
      s[e] = col < Nk ? __fmul_rn((float)acc[e], f[e >> 1]) : -INFINITY;
    }
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
  int acc8[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f, acc8[i][e] = 0;

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();
    stage_k(k0);
    if constexpr (PV8) {
      // v8 tile, transposed into the permuted key order: a thread takes 16 d of one key
      for (int c = tid; c < BK * D / 16; c += blockDim.x) {
        const int r = c % BK, d16 = (c / BK) * 16;
        const uint4 u = *reinterpret_cast<const uint4*>(v8p + (long long)(k0 + r) * D + d16);
        const int8_t* e = reinterpret_cast<const int8_t*>(&u);
        const int pos = (r & ~31) + pv_pos(r & 31);
#pragma unroll
        for (int i = 0; i < 16; ++i) vt8_s[d16 + i][pos] = e[i];
      }
    } else {
      // v tile in bf16, transposed: consecutive threads take consecutive keys
      for (int c = tid; c < BK * D / 8; c += blockDim.x) {
        const int r = c % BK, d8 = (c / BK) * 8;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < Nk) u = *reinterpret_cast<const uint4*>(vp + (long long)(k0 + r) * vs.n + d8);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
        for (int i = 0; i < 8; ++i) vt_s[d8 + i][r] = e[i];
      }
    }
    __syncthreads();

    float p[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float s[4];
      scores(k0, j, s);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] = k0 + j * 8 + 2 * t + (e & 1) < Nk ? expf(__fsub_rn(s[e], m[e >> 1])) : 0.f;
        l[e >> 1] += p[j][e];  // the sum takes p before any rounding
      }
    }

    if constexpr (PV8) {
#pragma unroll
      for (int kc = 0; kc < BK / 32; ++kc) {
        int p8[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) p8[jj][e] = (int)rintf(__fmul_rn(p[4 * kc + jj][e], 127.f));
        const uint32_t pa[4] = {pack_s8x4(p8[0][0], p8[0][1], p8[1][0], p8[1][1]),
                                pack_s8x4(p8[0][2], p8[0][3], p8[1][2], p8[1][3]),
                                pack_s8x4(p8[2][0], p8[2][1], p8[3][0], p8[3][1]),
                                pack_s8x4(p8[2][2], p8[2][3], p8[3][2], p8[3][3])};
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          mma_s8(acc8[i], pa, ld32s(&vt8_s[i * 8 + g][kc * 32 + 4 * t]), ld32s(&vt8_s[i * 8 + g][kc * 32 + 16 + 4 * t]));
      }
    } else {
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
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float vsc = PV8 ? __fdiv_rn(vscale[bh], 127.f) : 0.f;
  __nv_bfloat16* op = o + ((long long)b * Nq * H + h) * D;  // o is contiguous (B, Nq, H, D)
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = PV8 ? __fmul_rn((float)acc8[i][e], vsc) : acc[i][e];
      y[e] = __fdiv_rn(pv, l[e >> 1]);
    }
    const int c = i * 8 + 2 * t;
    if (row0 < Nq) *reinterpret_cast<uint32_t*>(op + (long long)row0 * H * D + c) = pack_bf16(y[0], y[1]);
    if (row1 < Nq) *reinterpret_cast<uint32_t*>(op + (long long)row1 * H * D + c) = pack_bf16(y[2], y[3]);
  }
}

}  // namespace

// bf16 q (B, Nq, H, D), k and v (B, Nk, H, D), read by their (b, n, h) strides
// (in elements; unit stride on d); o: contiguous (B, Nq, H, D) bf16. Scratch:
// k8 and (int8pv) v8, contiguous (B, H, nk_pad, D) int8 with nk_pad = Nk
// rounded up to 64; kscale and (int8pv) vscale, (B, H) float32. D = 64,
// Nk <= 1024. Returns a cudaError_t.
extern "C" int uc_flash_attention_int8(const void* q, const void* k, const void* v, void* o, void* k8, void* v8,
                                       void* kscale, void* vscale, int pv_int8, int B, int H, int Nq, int Nk,
                                       int head_dim, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
                                       long long k_sn, long long k_sh, long long v_sb, long long v_sn, long long v_sh,
                                       float scale, void* stream) {
  if (head_dim != D || B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || Nk > 1024 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (pv_int8 && (v8 == nullptr || vscale == nullptr)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  const int nk_pad = (Nk + BK - 1) / BK * BK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fa8_prep_kernel<<<dim3(H, B), PREP_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), static_cast<int8_t*>(k8),
      static_cast<int8_t*>(v8), static_cast<float*>(kscale), static_cast<float*>(vscale), H, Nk, nk_pad, ks, vs,
      pv_int8);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Nq + BQ - 1) / BQ, H, B);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  if (pv_int8)
    fa8_fwd_kernel<true><<<grid, 128, 0, st>>>(qp, vp, static_cast<const int8_t*>(k8), static_cast<const int8_t*>(v8),
                                               static_cast<const float*>(kscale), static_cast<const float*>(vscale),
                                               static_cast<__nv_bfloat16*>(o), H, Nq, Nk, nk_pad, qs, vs, scale);
  else
    fa8_fwd_kernel<false><<<grid, 128, 0, st>>>(qp, vp, static_cast<const int8_t*>(k8), nullptr,
                                                static_cast<const float*>(kscale), nullptr,
                                                static_cast<__nv_bfloat16*>(o), H, Nq, Nk, nk_pad, qs, vs, scale);
  return (int)cudaGetLastError();
}
