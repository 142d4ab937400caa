// Int8 matmul with dynamic per-row activation quantization:
// y = (round(x / a_scale) @ w_q) * (a_scale * w_scale) + bias, int32 accumulation. A second mode takes the row
// scales given and writes the int32 sums (a tensor-parallel row-parallel layer's share of the product).
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
//   Only wgmma reaches the int8 tensor cores' full rate on this card.
//
// What the design does about it:
//   * The Pallas kernel quantizes x inside the matmul, keeping x_q in VMEM. On
//     this card the quantization (a dozen instructions per element) costs more
//     than the products it feeds when it is repeated for every output tile: a
//     first version that did so ran at 41-106 TOP/s, 80% of it the staging. So
//     a first launch quantizes each row once (a warp per row: the abs-max,
//     then the codes) into an int8 scratch of M x K bytes (4 MB at the
//     encoder's fc1, which stays in the 50 MB L2) and the row scales.
//   * The matmul is hopper.cuh's persistent, warp-specialised GEMM: x_q and w_q
//     (kept (N, K), so both operands are K-major, as 8-bit wgmma needs) go
//     through 2-D tensor maps in boxes of 128 rows (BN for w_q) x 128 bytes,
//     128-byte swizzled, into a 4-6 stage ring that one producer warp keeps
//     full; two consumer warpgroups run s8 wgmma m64nBNk32 (BN = 128 or 256,
//     both operands from shared memory) into int32 accumulators in registers.
//     TMA's zero fill makes ragged M, N and K add nothing; K must be a
//     multiple of 16 (a tensor map's row stride).
//   * The planner (ops/gemm.py gemm_plan) picks BN and a split of the K loop
//     by the makespan of the persistent grid on the card's SMs: a split adds
//     its int32 partial sums into a zeroed workspace, and the last split of a
//     tile reads the total back, so the dequantization runs once on the full
//     sum and two calls give the same bits.
//   * The epilogue (DequantBiasEpilogue) dequantizes in registers, in the
//     Pallas kernel's order of roundings, and stores bf16 or fp32. It runs
//     while the tensor cores wait, so it is kept short: the scales and biases
//     of 8 column chunks are loaded together ahead of their stores, and bf16
//     rows go out in 16-byte stores, a whole 8-column chunk per lane after a
//     transpose of the quad's packed words (hopper.cuh quad_transpose).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "int8_common.cuh"

namespace {

using namespace uc_i8;
namespace hw = uc_hopper;

constexpr int THREADS = 256;         // threads per block of the quantizing kernel
constexpr int QROWS = THREADS / 32;  // rows per block of the quantizing kernel: a warp each

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = hw::pack_bf16x2(a, b);
}

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

// A warp per row of x: a_scale, then the row's int8 codes. GIVEN: the row's scale is read from ascale (a
// tensor-parallel row-parallel layer's, from the abs-max of the whole row over the ranks) instead of computed.
template <typename TX, bool GIVEN>
__global__ void __launch_bounds__(THREADS) quant_rows_kernel(const TX* __restrict__ x, int8_t* __restrict__ xq,
                                                             float* __restrict__ ascale, int M, int K) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * QROWS + (threadIdx.x >> 5);
  if (row >= M) return;
  const TX* xr = x + row * K;
  float s;
  if constexpr (GIVEN) {
    s = ascale[row];
  } else {
    float amax = 0.f;
    for (int c = lane * 8; c < K; c += 32 * 8) {
      float f[8];
      load8(xr + c, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(f[i]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    s = absmax_scale(amax);
    if (lane == 0) ascale[row] = s;
  }
  const float rc = __frcp_rn(s);
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

// The GEMM's epilogue: out = float(acc) * (a_scale * w_scale) + bias, each product and sum rounded on its own.
// The scales and biases of EPI_CHUNKS column chunks are loaded together, ahead of their stores (a load after a
// store to `out` cannot be hoisted above it, so loads inside the store loop would each wait a full latency).
constexpr int EPI_CHUNKS = 8;

template <typename TO>
struct DequantBiasEpilogue {
  struct State {};
  const float* ascale;
  const float* wscale;
  const float* bias;  // or null
  TO* out;
  int M, N;

  __device__ State init(int) const { return {}; }

  template <int NA>
  __device__ __forceinline__ void operator()(const int (&acc)[NA], State, int row0, int, int col0, int t) const {
    constexpr int CHUNKS = NA / 4;  // 8-column chunks of the tile
    float as[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) as[i] = row0 + 8 * i < M ? __ldg(ascale + row0 + 8 * i) : 0.f;
#pragma unroll
    for (int c0 = 0; c0 < CHUNKS; c0 += EPI_CHUNKS) {
      float ws[EPI_CHUNKS][2], bs[EPI_CHUNKS][2];
#pragma unroll
      for (int c = 0; c < EPI_CHUNKS; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = col0 + 8 * (c0 + c) + 2 * t + j;
          ws[c][j] = col < N ? __ldg(wscale + col) : 0.f;
          bs[c][j] = col < N && bias != nullptr ? __ldg(bias + col) : 0.f;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        TO* orow = out + (long long)row * N;
        float y[EPI_CHUNKS][2];
#pragma unroll
        for (int c = 0; c < EPI_CHUNKS; ++c)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            y[c][j] = __fmul_rn((float)acc[4 * (c0 + c) + 2 * i + j], __fmul_rn(as[i], ws[c][j]));
            if (bias != nullptr) y[c][j] = __fadd_rn(y[c][j], bs[c][j]);
          }
        if constexpr (sizeof(TO) == 2) {
          if (N % 8 == 0) {  // bf16 rows of 16-byte aligned chunks: a chunk per lane (hw::quad_transpose)
#pragma unroll
            for (int q = 0; q < EPI_CHUNKS; q += 4) {
              uint32_t w[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) w[u] = hw::pack_bf16x2(y[q + u][0], y[q + u][1]);
              hw::quad_transpose(w, t);  // every lane, whatever its row
              const int col = col0 + 8 * (c0 + q + t);
              if (row < M && col < N) *reinterpret_cast<uint4*>(orow + col) = make_uint4(w[0], w[1], w[2], w[3]);
            }
            continue;
          }
        }
        if (row >= M) continue;
#pragma unroll
        for (int c = 0; c < EPI_CHUNKS; ++c) {
          const int col = col0 + 8 * (c0 + c) + 2 * t;
          if (col >= N) continue;
          if ((N & 1) == 0)  // col is even, so the pair is in range and aligned
            store2(orow + col, y[c][0], y[c][1]);
          else {
            store(orow + col, y[c][0]);
            if (col + 1 < N) store(orow + col + 1, y[c][1]);
          }
        }
      }
    }
  }
};

// The int32 epilogue (out dtype code 2): the exact sums, stored as they are. A tensor-parallel row-parallel layer's
// share of the product (parallel/mesh.py RowParallel) is summed over the ranks in int32, exactly, and dequantized
// once after, so it gives the unsharded layer's bits.
struct Int32Epilogue {
  struct State {};
  int* out;
  int M, N;

  __device__ State init(int) const { return {}; }

  template <int NA>
  __device__ __forceinline__ void operator()(const int (&acc)[NA], State, int row0, int, int col0, int t) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= M) continue;
      int* orow = out + (long long)row * N;
#pragma unroll
      for (int c = 0; c < NA / 4; ++c) {
        const int col = col0 + 8 * c + 2 * t;
        if (col >= N) continue;
        const int a = acc[4 * c + 2 * i], b = acc[4 * c + 2 * i + 1];
        if ((N & 1) == 0) {  // col is even, so the pair is in range and 8-byte aligned
          *reinterpret_cast<int2*>(orow + col) = make_int2(a, b);
        } else {
          orow[col] = a;
          if (col + 1 < N) orow[col + 1] = b;
        }
      }
    }
  }
};

template <typename TX>
void quantize(const void* x, int8_t* xq, float* ascale, int M, int K, bool given, cudaStream_t st) {
  const dim3 grid((M + QROWS - 1) / QROWS);
  if (given)
    quant_rows_kernel<TX, true><<<grid, THREADS, 0, st>>>(static_cast<const TX*>(x), xq, ascale, M, K);
  else
    quant_rows_kernel<TX, false><<<grid, THREADS, 0, st>>>(static_cast<const TX*>(x), xq, ascale, M, K);
}

template <typename TO, int BN>
int gemm(const hw::GemmMaps& maps, const hw::GemmParams& g, const float* ascale, const void* wscale,
         const void* bias, void* out, int N, cudaStream_t st) {
  const DequantBiasEpilogue<TO> epi{ascale, static_cast<const float*>(wscale), static_cast<const float*>(bias),
                                    static_cast<TO*>(out), g.M, N};
  return hw::launch_gemm<true, BN>(maps, g, epi, st);
}

template <int BN>
int gemm_int32(const hw::GemmMaps& maps, const hw::GemmParams& g, void* out, int N, cudaStream_t st) {
  const Int32Epilogue epi{static_cast<int*>(out), g.M, N};
  return hw::launch_gemm<true, BN>(maps, g, epi, st);
}

}  // namespace

// x: contiguous (M, K), dtype code 0 = float32, 1 = bfloat16; w_q: contiguous (N, K) int8; w_scale: (N,)
// float32; bias: (N,) float32 or null; out: contiguous (M, N) in out_dtype (same codes, and 2: the int32 sums, with
// w_scale and bias unused). Scratch: xq, (M, K)
// int8, and ascale, (M,) float32, both 16-byte aligned. `maps`: the GEMM's tensor maps (ops/gemm.py gemm_maps,
// 10 ints) for the plan's bn (128 or 256) and split; with split > 1, ws is a zeroed int32 workspace of M * N
// values and then one per tile. with_quant = 0 skips the rows' quantization and runs the GEMM alone on the codes
// and scales already in xq and ascale (x is then unused); 1 quantizes the rows with their own scales, written to
// ascale; 2 quantizes them with the scales already in ascale (at least each row's abs-max / 127). K % 16 == 0.
// Returns a cudaError_t.
extern "C" int uc_int8_matmul(const void* x, const void* wq, const void* wscale, const void* bias, void* out,
                              void* xq, void* ascale, void* ws, const long long* maps, int x_dtype, int out_dtype,
                              int M, int N, int K, int bn, int split, int with_quant, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0) return (int)cudaErrorInvalidValue;
  if ((x_dtype != 0 && x_dtype != 1) || out_dtype < 0 || out_dtype > 2) return (int)cudaErrorInvalidValue;
  if (maps[0] != K || maps[1] != M || maps[2] != K || maps[6] != N) return (int)cudaErrorInvalidValue;
  hw::GemmParams g;
  int status = hw::gemm_params(&g, M, N, 1, K, bn, split, static_cast<int*>(ws));
  hw::GemmMaps m;
  const void* b[1] = {wq};
  if (status == 0) status = hw::encode_gemm_maps(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, b, 1, maps, bn);
  if (status != 0) return status;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* a = static_cast<float*>(ascale);
  if (with_quant < 0 || with_quant > 2) return (int)cudaErrorInvalidValue;
  if (with_quant) {
    if (x_dtype == 1)
      quantize<__nv_bfloat16>(x, q, a, M, K, with_quant == 2, st);
    else
      quantize<float>(x, q, a, M, K, with_quant == 2, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (out_dtype == 2)
    return bn == 256 ? gemm_int32<256>(m, g, out, N, st) : gemm_int32<128>(m, g, out, N, st);
  if (out_dtype == 1)
    return bn == 256 ? gemm<__nv_bfloat16, 256>(m, g, a, wscale, bias, out, N, st)
                     : gemm<__nv_bfloat16, 128>(m, g, a, wscale, bias, out, N, st);
  return bn == 256 ? gemm<float, 256>(m, g, a, wscale, bias, out, N, st) : gemm<float, 128>(m, g, a, wscale, bias, out, N, st);
}
