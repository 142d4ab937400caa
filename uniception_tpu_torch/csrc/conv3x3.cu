// 3x3 convolution, stride 1, padding 1, over bf16 NHWC activations, as an
// implicit GEMM: out[pixel][co] = sum over the nine taps and C channels of
// x[shifted pixel][c] * w[co][tap][c], fp32 accumulation, + fp32 bias, cast to
// bf16.
//
// Replaces: uniception_tpu/ops/conv3x3.py: conv3x3_nhwc /
//   _conv3x3_pallas_impl (body _kernel), which the DPT head's eligible convs
//   take (nn/dpt_parts.py _Conv2dDPT: bf16 module and input, H*W <= 256^2,
//   C and Co multiples of 128).
//
// What bounds it on the H100: at the DPT shapes (C = 256-768, Co = 128-256,
//   up to 2 x 256 x 256 pixels) a conv is 2-60 GFLOP at ~100-600 flops per
//   byte of x, w and out: the tensor cores' throughput, not HBM.
//
// What the design does about it (simple first: mma.sync, single-buffered):
//   * One block of 8 warps per tile of 128 output pixels (consecutive in
//     (b, y, x) order, so a tile spans image rows) x 128 output channels. The
//     K loop runs over the nine taps and, inside each, over C in steps of 64.
//     For each step the block stages the 128 shifted input pixels' 64
//     channels (zero where the tap falls outside the image: that is the
//     padding) and the weights' 128 x 64 slice, then each warp runs its 32x64
//     sub-tile as 2 x 8 mma.sync m16n8k16 bf16 products per 16 channels.
//   * The Pallas kernel materializes overlapping row windows on the host so
//     that each input tile reaches VMEM once for all nine taps; here the nine
//     shifted reads of a tile hit L2/L1 instead, with no extra copy.
//   * The weight is (Co, 3, 3, C): for a fixed output channel the K index
//     (tap, c) is contiguous, so every B fragment is one 32-bit load. The
//     wrapper makes it from the HWIO weight at each call (1.2 MB at most).
//   * Shared rows are 144 bytes, so the fragment loads of a warp's 8 row
//     groups hit distinct banks.
//   * Pixels past B*H*W and channels past Co are masked; C % 64 == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fa_common.cuh"

namespace {

using uc_fa::ld32;
using uc_fa::mma_16816;
using uc_fa::pack_bf16;

constexpr int BM = 128;   // output pixels per block
constexpr int BN = 128;   // output channels per block
constexpr int BK = 64;    // input channels per step
constexpr int PAD = 8;    // bf16 padding per shared row
constexpr int THREADS = 256;
constexpr int A_CHUNKS = BM * BK / 8 / THREADS;  // 16-byte chunks per thread and step
constexpr int B_CHUNKS = BN * BK / 8 / THREADS;

__global__ void __launch_bounds__(THREADS) conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
                                                          const __nv_bfloat16* __restrict__ w,
                                                          const float* __restrict__ bias,
                                                          __nv_bfloat16* __restrict__ out, int Bn, int H, int W,
                                                          int C, int Co) {
  __shared__ __align__(16) __nv_bfloat16 a_s[BM][BK + PAD];  // [pixel][channel]
  __shared__ __align__(16) __nv_bfloat16 b_s[BN][BK + PAD];  // [output channel][channel]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long M = (long long)Bn * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int c8 = (tid % (BK / 8)) * 8;  // this thread's 8 channels of every staged row

  // the A_CHUNKS pixels this thread stages: rows tid / 8 + 32 i of the tile
  int py[A_CHUNKS], px[A_CHUNKS];
  long long pimg[A_CHUNKS];  // element offset of the pixel's image
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const long long p = m0 + tid / (BK / 8) + i * (THREADS / (BK / 8));
    if (p < M) {
      const long long img = p / ((long long)H * W);
      const int rem = (int)(p - img * H * W);
      py[i] = rem / W, px[i] = rem % W, pimg[i] = img * H * W * C;
    } else {
      py[i] = -4, px[i] = -4, pimg[i] = 0;  // every tap falls outside: zeros
    }
  }

  const int wm = warp >> 1, wn = warp & 1;  // this warp's 32x64 sub-tile
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += BK) {
#pragma unroll
      for (int i = 0; i < A_CHUNKS; ++i) {
        const int r = tid / (BK / 8) + i * (THREADS / (BK / 8));
        const int yy = py[i] + dy, xx = px[i] + dx;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (yy >= 0 && yy < H && xx >= 0 && xx < W)
          u = *reinterpret_cast<const uint4*>(x + pimg[i] + ((long long)yy * W + xx) * C + c0 + c8);
        *reinterpret_cast<uint4*>(&a_s[r][c8]) = u;
      }
#pragma unroll
      for (int i = 0; i < B_CHUNKS; ++i) {
        const int r = tid / (BK / 8) + i * (THREADS / (BK / 8));
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + r < Co) u = *reinterpret_cast<const uint4*>(w + ((long long)(n0 + r) * 9 + tap) * C + c0 + c8);
        *reinterpret_cast<uint4*>(&b_s[r][c8]) = u;
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + g;
          a[mi][0] = ld32(&a_s[r][kk * 16 + 2 * t]);
          a[mi][1] = ld32(&a_s[r + 8][kk * 16 + 2 * t]);
          a[mi][2] = ld32(&a_s[r][kk * 16 + 2 * t + 8]);
          a[mi][3] = ld32(&a_s[r + 8][kk * 16 + 2 * t + 8]);
        }
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          const __nv_bfloat16* br = &b_s[wn * 64 + nj * 8 + g][kk * 16 + 2 * t];
          const uint32_t b0 = ld32(br), b1 = ld32(br + 8);
          mma_16816(acc[0][nj], a[0], b0, b1);
          mma_16816(acc[1][nj], a[1], b0, b1);
        }
      }
      __syncthreads();
    }
  }

  // epilogue: + fp32 bias, bf16 pairs (Co is even)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long p = m0 + wm * 32 + mi * 16 + g + 8 * half;
      if (p >= M) continue;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const int co = n0 + wn * 64 + nj * 8 + 2 * t;
        if (co >= Co) continue;
        float y0 = acc[mi][nj][2 * half], y1 = acc[mi][nj][2 * half + 1];
        if (bias != nullptr) y0 += bias[co], y1 += bias[co + 1];
        *reinterpret_cast<uint32_t*>(out + p * Co + co) = pack_bf16(y0, y1);
      }
    }
  }
}

}  // namespace

// x: contiguous NHWC (B, H, W, C) bf16; w: contiguous (Co, 3, 3, C) bf16;
// bias: (Co,) float32 or null; out: contiguous NHWC (B, H, W, Co) bf16.
// C % 64 == 0, Co % 8 == 0. Returns a cudaError_t.
extern "C" int uc_conv3x3(const void* x, const void* w, const void* bias, void* out, int B, int H, int W, int C,
                          int Co, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % BK != 0 || Co % 8 != 0) return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)B * H * W + BM - 1) / BM;
  if (tiles > 0x7fffffffLL || (Co + BN - 1) / BN > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (Co + BN - 1) / BN);
  conv3x3_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), B, H, W, C, Co);
  return (int)cudaGetLastError();
}
