// Int8 matmul with dynamic per-row activation quantization:
// y = (round(x / a_scale) @ w_q) * (a_scale * w_scale) + bias, int32 accumulation.
//
// Replaces: uniception_tpu/ops/int8_matmul.py: int8_matmul_dynamic (body
//   _kernel), which Int8Linear (nn/quant.py) calls for its symmetric dynamic
//   mode.
//
// Numerics, in the Pallas kernel's order: a_scale = max(max|x_row|, 1e-30) / 127
//   and x_q = clip(round(x / a_scale), -127, 127) with the correctly rounded
//   quotient (quant8_rcp of int8_common.cuh: the row's reciprocal and one FMA
//   correction, equal to the IEEE division) and round half to even; the int32
//   sum is exact; y = float(acc) * (a_scale * w_scale) + bias with each product
//   and sum rounded on its own (__fmul_rn / __fadd_rn keep nvcc from
//   contracting them into an FMA), then cast to the output dtype.
//
// What bounds it on the H100: at the trunk shapes (M = 2048-4096 tokens, K and
//   N 768-4096) the product is 2.4-34 GOP at ~100-200 int8 operations per
//   byte of x, w_q and y, so tensor-core throughput is the limit, not HBM.
//
// What the design does about it (mma.sync, no TMA or wgmma yet):
//   * The Pallas kernel quantizes x inside the matmul, keeping x_q in VMEM. On
//     this card the quantization (a dozen instructions per element) costs more
//     than the products it feeds when it is repeated for every 128-column
//     tile of the output: a first version that did so ran at 41-106 TOP/s,
//     80% of it the staging. So a first kernel quantizes each row once (a
//     warp per row: the abs-max, then the codes) into an int8 scratch of
//     M x K bytes (4 MB at the encoder's fc1, which stays in the 50 MB L2)
//     and the row scales; the matmul then streams int8 tiles only.
//   * The matmul: one block of 8 warps per 128x128 output tile, K in 64-byte
//     steps through a two-stage cp.async pipeline (the next tile's copy is in
//     flight while the current one is multiplied); w_q is kept (N, K) so that
//     A and B fragments are both 32-bit loads from rows padded to 80 bytes
//     (the 8 row groups of a warp fall in distinct banks).
//   * Each warp owns a 32x64 sub-tile: 2 x 8 mma.sync m16n8k32 s8 products per
//     32-wide k step, int32 accumulators in registers.
//   * Ragged M and N are zero-filled in the copies (cp.async with a zero
//     source size) and masked in the stores; K must be a multiple of 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

using namespace uc_i8;

constexpr int BM = 128;      // rows per block
constexpr int BN = 128;      // output columns per block
constexpr int BK = 64;       // k step in bytes (int8)
constexpr int PADB = 16;     // bytes of padding per shared row
constexpr int THREADS = 256;
constexpr int QROWS = THREADS / 32;  // rows per block of the quantizing kernel: a warp each

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Eight consecutive elements as floats (K % 8 == 0, 16-byte aligned rows).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float f[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// Kernel 1: a warp per row of x: a_scale, then the row's int8 codes.
template <typename TX>
__global__ void __launch_bounds__(THREADS) quant_rows_kernel(const TX* __restrict__ x, int8_t* __restrict__ xq,
                                                             float* __restrict__ ascale, int M, int K) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * QROWS + (threadIdx.x >> 5);
  if (row >= M) return;
  const TX* xr = x + row * K;
  float amax = 0.f;
  for (int c = lane * 8; c < K; c += 32 * 8) {
    float f[8];
    load8(xr + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(f[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = absmax_scale(amax), rc = __frcp_rn(s);
  if (lane == 0) ascale[row] = s;
  for (int c = lane * 8; c < K; c += 32 * 8) {  // the row again, from L1
    float f[8];
    load8(xr + c, f);
    int q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = quant8_rcp(f[i], s, rc);
    *reinterpret_cast<uint2*>(xq + row * K + c) =
        make_uint2(pack_s8x4(q[0], q[1], q[2], q[3]), pack_s8x4(q[4], q[5], q[6], q[7]));
  }
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Kernel 2: out = float(x_q @ w_q^T) * (a_scale * w_scale) + bias.
template <typename TO>
__global__ void __launch_bounds__(THREADS) int8_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                                                            const float* __restrict__ ascale,
                                                            const float* __restrict__ wscale,
                                                            const float* __restrict__ bias, TO* __restrict__ out, int M,
                                                            int N, int K) {
  __shared__ __align__(16) int8_t a_s[2][BM][BK + PADB];  // x_q tiles [row][k]
  __shared__ __align__(16) int8_t b_s[2][BN][BK + PADB];  // w_q tiles [col][k]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // each thread copies 2 of the 512 16-byte chunks of each tile
  auto load_tiles = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < BM * BK / 16 / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 16), k16 = (c % (BK / 16)) * 16;
      const bool in_k = k0 + k16 < K;
      const bool va = in_k && m0 + r < M, vb = in_k && n0 + r < N;
      cp_async16(&a_s[stage][r][k16], va ? xq + (m0 + r) * K + k0 + k16 : xq, va);
      cp_async16(&b_s[stage][r][k16], vb ? wq + (long long)(n0 + r) * K + k0 + k16 : wq, vb);
    }
    cp_async_commit();
  };

  const int wm = warp >> 1, wn = warp & 1;  // this warp's 32x64 sub-tile
  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0;

  const int nk = (K + BK - 1) / BK;
  load_tiles(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_tiles(st ^ 1, (kt + 1) * BK);  // the stage read in step kt - 1, released by its closing barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        a[mi][0] = ld32s(&a_s[st][r][ks * 32 + 4 * t]);
        a[mi][1] = ld32s(&a_s[st][r + 8][ks * 32 + 4 * t]);
        a[mi][2] = ld32s(&a_s[st][r][ks * 32 + 16 + 4 * t]);
        a[mi][3] = ld32s(&a_s[st][r + 8][ks * 32 + 16 + 4 * t]);
      }
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const int n = wn * 64 + nj * 8 + g;
        const uint32_t b0 = ld32s(&b_s[st][n][ks * 32 + 4 * t]), b1 = ld32s(&b_s[st][n][ks * 32 + 16 + 4 * t]);
        mma_s8(acc[0][nj], a[0], b0, b1);
        mma_s8(acc[1][nj], a[1], b0, b1);
      }
    }
    __syncthreads();
  }

  // epilogue: float(acc) * (a_scale * w_scale) + bias, in that order
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + wm * 32 + mi * 16 + g + 8 * half;
      if (row >= M) continue;
      const float as = ascale[row];
      TO* orow = out + row * N;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * 64 + nj * 8 + 2 * t + e;
          if (col >= N) continue;
          float y = __fmul_rn((float)acc[mi][nj][2 * half + e], __fmul_rn(as, wscale[col]));
          if (bias != nullptr) y = __fadd_rn(y, bias[col]);
          store(orow + col, y);
        }
      }
    }
  }
}

template <typename TX>
void quantize(const void* x, int8_t* xq, float* ascale, int M, int K, cudaStream_t st) {
  quant_rows_kernel<TX><<<(M + QROWS - 1) / QROWS, THREADS, 0, st>>>(static_cast<const TX*>(x), xq, ascale, M, K);
}

template <typename TO>
void gemm(const int8_t* xq, const void* wq, const float* ascale, const void* wscale, const void* bias, void* out,
          int M, int N, int K, cudaStream_t st) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  int8_gemm_kernel<TO><<<grid, THREADS, 0, st>>>(xq, static_cast<const int8_t*>(wq), ascale,
                                                 static_cast<const float*>(wscale), static_cast<const float*>(bias),
                                                 static_cast<TO*>(out), M, N, K);
}

}  // namespace

// x: contiguous (M, K), dtype code 0 = float32, 1 = bfloat16; w_q: contiguous
// (N, K) int8; w_scale: (N,) float32; bias: (N,) float32 or null; out:
// contiguous (M, N) in out_dtype (same codes). Scratch: xq, (M, K) int8, and
// ascale, (M,) float32, both 16-byte aligned. K % 16 == 0. Returns a cudaError_t.
extern "C" int uc_int8_matmul(const void* x, const void* wq, const void* wscale, const void* bias, void* out,
                              void* xq, void* ascale, int x_dtype, int out_dtype, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || (N + BN - 1) / BN > 65535) return (int)cudaErrorInvalidValue;
  if ((x_dtype != 0 && x_dtype != 1) || (out_dtype != 0 && out_dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* a = static_cast<float*>(ascale);
  if (x_dtype == 1)
    quantize<__nv_bfloat16>(x, q, a, M, K, st);
  else
    quantize<float>(x, q, a, M, K, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (out_dtype == 1)
    gemm<__nv_bfloat16>(q, wq, a, wscale, bias, out, M, N, K, st);
  else
    gemm<float>(q, wq, a, wscale, bias, out, M, N, K, st);
  return (int)cudaGetLastError();
}
