// 3x3 convolution, stride 1, padding 1, over bf16 NHWC activations, as an
// implicit GEMM: out[pixel][co] = sum over the nine taps and C channels of
// x[shifted pixel][c] * w[tap][c][co], fp32 accumulation, + bias in fp32, one
// rounding to bf16.
//
// Replaces: uniception_tpu/ops/conv3x3.py: conv3x3_nhwc /
//   _conv3x3_pallas_impl (body _kernel), which the DPT head's eligible convs
//   take (nn/dpt_parts.py Conv2dTorch: bf16 module and input, H*W <= 256^2,
//   C and Co multiples of 128).
//
// What bounds it on the H100: at the DPT shapes (C = 256-768, Co = 128-256,
//   up to 2 x 256 x 256 pixels) a conv is 0.6-77 GFLOP at ~100-600 flops per
//   byte of x, w and out: the tensor cores' throughput, not HBM. The two
//   largest shapes (the 128^2 RCUs and the 256^2 regressor conv) carry most of
//   the FLOPs; the 16^2-32^2 levels are too small to fill the card with
//   output tiles alone.
//
// What the design does about it (the outline of a Hopper GEMM):
//   * An output tile is a rectangle of TW x TH = 128 pixels of one image
//     (ops/conv3x3.py conv3x3_plan picks TW from the image width) by BN = 128
//     or 256 output channels. The K loop runs over the nine taps and, inside
//     each, over C in steps of 64 channels.
//   * A (pixels x 64 channels) for one tap is ONE 4-D TMA box (64, TW, TH, 1)
//     of the NHWC input at (c0, x0 + dx, y0 + dy, b). TMA writes zeros for
//     coordinates outside the tensor, negative ones included: that is the
//     conv's padding, with no halo copy and no masks. 64 bf16 channels are one
//     128-byte swizzled row per pixel: the K-major A operand of wgmma.
//   * B is the HWIO weight itself, read through a 3-D tensor map over
//     (Co, C, tap) in boxes of 64 channels x 64 output channels: MN-major,
//     read with the transpose bit as K1 reads V, BN / 64 swizzle atoms 8 KB
//     apart. Boxes wholly past Co are not loaded (their columns are never
//     stored). The bias is read in its own dtype, so a call launches nothing
//     but this kernel (and, when split, the reduction below).
//   * Warp specialisation, persistent: one block per SM walks the work items;
//     a producer warp issues the TMA loads into a ring of 4 (BN = 256) or 6
//     (BN = 128) stages of A and B; two consumer warpgroups each run wgmma
//     m64nBNk16 on 64 pixels of the tile, keeping one k-step's products in
//     flight while the next one's operands arrive, and release each slot when
//     its products are done. The producer runs ahead across items, so the next
//     tile's loads overlap this tile's epilogue.
//   * Split-K where the output tiles alone do not fill the card: the planner
//     cuts the K loop (taps x channel chunks) into `split` ranges; each item
//     writes its fp32 partial sums to a scratch, and a second small launch
//     adds the partials in split order (a fixed order: no atomics, so two
//     calls give the same bits), adds the bias and rounds once.
//   * Epilogue: + bias in fp32, one bf16 rounding, stores clipped at the
//     ragged W, H and Co.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace hw = uc_hopper;

constexpr int BM = 128;                // output pixels per tile
constexpr int BK = 64;                 // input channels per k-step
constexpr int THREADS = 384;           // producer warpgroup + two consumer warpgroups
constexpr int A_BYTES = BM * BK * 2;   // one A box: 128 pixel rows of 128 bytes
constexpr int ATOM_BYTES = 64 * BK * 2;  // one B box: 64 channel rows of 64 output channels

template <int BN>
struct Cfg {
  static constexpr int STAGES = BN == 256 ? 4 : 6;
};

template <int BN>
struct alignas(hw::SMEM_ALIGN) ConvSmem {
  __nv_bfloat16 a[Cfg<BN>::STAGES][BM * BK];  // [pixel][channel], 128B-swizzled
  __nv_bfloat16 b[Cfg<BN>::STAGES][BN * BK];  // BN / 64 boxes of [channel][64 output channels]
  uint64_t full[Cfg<BN>::STAGES], empty[Cfg<BN>::STAGES];
};

template <int BN>
constexpr int smem_bytes() {
  return sizeof(ConvSmem<BN>) + hw::SMEM_ALIGN > hw::MIN_SMEM_BYTES ? sizeof(ConvSmem<BN>) + hw::SMEM_ALIGN
                                                                    : hw::MIN_SMEM_BYTES;
}

struct ConvParams {
  int B, H, W, C, Co;
  int tw_shift, TH, tiles_x, tiles_y, px_tiles, co_tiles, steps, per, items;
  const void* bias;
  int bias_type;  // 0: none, 1: float32, 2: bfloat16
  __nv_bfloat16* out;
  float* ws;  // split > 1: fp32 partials (split, B*H*W, Co); else null
};

// A work item: the pixel tile (image b, corner x0, y0), the output-channel tile, the split and its k-steps.
// Pixel tiles run fastest, so the blocks working at one time share the weight tiles and the halos in L2.
struct Item {
  int b, x0, y0, co_tile, split, k0, k1;
};

__device__ __forceinline__ Item decode(const ConvParams& p, int item) {
  Item it;
  const int px = item % p.px_tiles, rest = item / p.px_tiles;
  it.co_tile = rest % p.co_tiles;
  it.split = rest / p.co_tiles;
  it.x0 = (px % p.tiles_x) << p.tw_shift;
  it.y0 = (px / p.tiles_x) % p.tiles_y * p.TH;
  it.b = px / (p.tiles_x * p.tiles_y);
  it.k0 = it.split * p.per;
  it.k1 = min(it.k0 + p.per, p.steps);
  return it;
}

__device__ __forceinline__ float bias_at(const ConvParams& p, int co) {
  if (p.bias_type == 1) return static_cast<const float*>(p.bias)[co];
  if (p.bias_type == 2) return __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[co]);
  return 0.f;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                   const ConvParams p) {
  constexpr int STAGES = Cfg<BN>::STAGES;
  extern __shared__ uint8_t smem_raw[];
  ConvSmem<BN>& sm = *reinterpret_cast<ConvSmem<BN>*>(hw::align_smem(smem_raw));
  const int tid = threadIdx.x;
  const int cchunks = p.C / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&sm.full[s], 1);
      hw::mbar_init(&sm.empty[s], THREADS - 128);  // every consumer thread releases the slot
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues every load
    hw::setmaxnreg_dec<40>();
    if (tid == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const Item it = decode(p, item);
        const int co0 = it.co_tile * BN;
        const int atoms = min(BN / 64, (p.Co - co0 + 63) / 64);  // boxes wholly past Co are not loaded
        for (int k = it.k0; k < it.k1; ++k) {
          const int tap = k / cchunks, c0 = (k - tap * cchunks) * BK;
          hw::mbar_wait(&sm.empty[s], phase ^ 1);  // the first pass over the ring finds every slot free
          hw::mbar_arrive_expect_tx(&sm.full[s], A_BYTES + atoms * ATOM_BYTES);
          hw::tma_load_4d(sm.a[s], &xmap, &sm.full[s], c0, it.x0 + tap % 3 - 1, it.y0 + tap / 3 - 1, it.b);
          for (int j = 0; j < atoms; ++j)
            hw::tma_load_3d(sm.b[s] + j * 64 * BK, &wmap, &sm.full[s], co0 + 64 * j, c0, tap);
          if (++s == STAGES) s = 0, phase ^= 1;
        }
      }
    }
  } else {  // consumer warpgroups: 64 pixels of the tile each
    hw::setmaxnreg_inc<232>();
    const int ctid = tid - 128, cwg = ctid >> 7, warp = (ctid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const long long M = (long long)p.B * p.H * p.W;
    int s = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const Item it = decode(p, item);
      const int co0 = it.co_tile * BN;
      float acc[BN / 2];  // m64nBN accumulator
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

      int prev = -1;
      for (int k = it.k0; k < it.k1; ++k) {
        hw::mbar_wait(&sm.full[s], phase);
        const uint32_t a_addr = hw::smem_u32(sm.a[s]) + cwg * 64 * BK * 2;
        const uint32_t b_addr = hw::smem_u32(sm.b[s]);
        hw::fence_regs(acc);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = hw::desc_k_major(a_addr + kk * 32);
          const uint64_t db = hw::desc_mn_major(b_addr + kk * 16 * 128, ATOM_BYTES);
          if constexpr (BN == 256)
            hw::wgmma_m64n256k16_ss<0, 1>(acc, da, db, 1);
          else
            hw::wgmma_m64n128k16_ss<0, 1>(acc, da, db, 1);
        }
        hw::wgmma_commit();
        hw::fence_regs(acc);
        hw::wgmma_wait<1>();  // the previous k-step's products are done: release its slot
        if (prev >= 0) hw::mbar_arrive(&sm.empty[prev]);
        prev = s;
        if (++s == STAGES) s = 0, phase ^= 1;
      }
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
      hw::mbar_arrive(&sm.empty[prev]);

      // epilogue: thread rows r = 64 cwg + 16 warp + g + 8 i of the tile, columns 8c + 2t + j
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = cwg * 64 + warp * 16 + g + 8 * i;
        const int px = it.x0 + (r & ((1 << p.tw_shift) - 1)), py = it.y0 + (r >> p.tw_shift);
        if (px >= p.W || py >= p.H) continue;
        const long long pix = ((long long)it.b * p.H + py) * p.W + px;
        if (p.ws != nullptr) {
          float* wp = p.ws + ((long long)it.split * M + pix) * p.Co;
#pragma unroll
          for (int c = 0; c < BN / 8; ++c) {
            const int co = co0 + 8 * c + 2 * t;
            if (co < p.Co) *reinterpret_cast<float2*>(wp + co) = make_float2(acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
          }
        } else {
          __nv_bfloat16* op = p.out + pix * p.Co;
#pragma unroll
          for (int c = 0; c < BN / 8; ++c) {
            const int co = co0 + 8 * c + 2 * t;
            if (co < p.Co)
              *reinterpret_cast<uint32_t*>(op + co) =
                  hw::pack_bf16x2(acc[4 * c + 2 * i] + bias_at(p, co), acc[4 * c + 2 * i + 1] + bias_at(p, co + 1));
          }
        }
      }
    }
  }
}

// The split-K partials added in split order (0, 1, ...), + bias in fp32, one bf16 rounding: four outputs per
// thread (Co % 8 == 0, so the four share a pixel).
__global__ void __launch_bounds__(256) conv3x3_reduce_kernel(const float* __restrict__ ws, const ConvParams p,
                                                             long long n4, int split) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  float4 a = w4[i];
  for (int s = 1; s < split; ++s) {
    const float4 b = w4[(long long)s * n4 + i];
    a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
  }
  const int co = (int)((i * 4) % p.Co);
  uint2 o;
  o.x = hw::pack_bf16x2(a.x + bias_at(p, co), a.y + bias_at(p, co + 1));
  o.y = hw::pack_bf16x2(a.z + bias_at(p, co + 2), a.w + bias_at(p, co + 3));
  reinterpret_cast<uint2*>(p.out)[i] = o;
}

template <int BN>
int launch(const CUtensorMap& xm, const CUtensorMap& wm, const ConvParams& p, cudaStream_t st) {
  static bool smem_set[64];
  int status = hw::allow_smem(conv3x3_kernel<BN>, smem_bytes<BN>(), smem_set);
  if (status != 0) return status;
  int sms = 0;
  status = hw::sm_count(&sms);
  if (status != 0) return status;
  const int grid = p.items < sms ? p.items : sms;
  conv3x3_kernel<BN><<<grid, THREADS, smem_bytes<BN>(), st>>>(xm, wm, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x: contiguous NHWC (B, H, W, C) bf16; w: contiguous HWIO (3, 3, C, Co) bf16; bias: (Co,) of bias_type
// (0: none, 1: float32, 2: bfloat16); out: contiguous NHWC (B, H, W, Co) bf16. `maps` holds the two tensor
// maps (ops/conv3x3.py conv3x3_maps, 19 ints): x's dims (C, W, H, B), byte strides and box (64, tw, th, 1) with
// tw x th = 128 pixels (tw a power of two from 8 to 128); w's dims (Co, C, 9), byte strides and box (64, 64, 1).
// The plan (conv3x3_plan): bn = 128 or 256 output channels, the K loop of 9 * C / 64 steps cut into `split`
// ranges of ceil(steps / split) steps, none empty; with split > 1, ws is a float32 scratch of
// split * B * H * W * Co. C % 64 == 0, Co % 8 == 0. A box other than the kernel's is refused (its barrier
// would wait for other bytes than arrive). Returns a cudaError_t.
extern "C" int uc_conv3x3(const void* x, const void* w, const void* bias, int bias_type, void* out, void* ws,
                          const long long* maps, int bn, int split, void* stream) {
  const long long *xl = maps, *wl = maps + 11;
  const int C = (int)xl[0], W = (int)xl[1], H = (int)xl[2], B = (int)xl[3], Co = (int)wl[0];
  const int tw = (int)xl[8], th = (int)xl[9];
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % BK != 0 || Co % 8 != 0) return (int)cudaErrorInvalidValue;
  if (xl[7] != BK || xl[10] != 1 || wl[1] != C || wl[2] != 9 || wl[5] != 64 || wl[6] != BK || wl[7] != 1)
    return (int)cudaErrorInvalidValue;
  if (xl[4] % 16 || xl[5] % 16 || xl[6] % 16 || wl[3] % 16 || wl[4] % 16) return (int)cudaErrorInvalidValue;
  int tw_shift = 0;
  while ((1 << tw_shift) < tw) ++tw_shift;
  if (tw < 8 || tw > 128 || (1 << tw_shift) != tw || tw * th != BM || (bn != 128 && bn != 256) || bias_type < 0 ||
      bias_type > 2 || (bias_type != 0 && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  const int steps = 9 * (C / BK);
  if (split < 1 || split > steps || (split > 1 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  const int per = (steps + split - 1) / split;
  if ((split - 1) * per >= steps) return (int)cudaErrorInvalidValue;  // an empty split
  ConvParams p;
  p.B = B, p.H = H, p.W = W, p.C = C, p.Co = Co, p.tw_shift = tw_shift, p.TH = th;
  p.tiles_x = (W + tw - 1) / tw, p.tiles_y = (H + th - 1) / th;
  const long long px_tiles = (long long)B * p.tiles_x * p.tiles_y;
  p.co_tiles = (Co + bn - 1) / bn;
  const long long items = px_tiles * p.co_tiles * split;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.px_tiles = (int)px_tiles, p.steps = steps, p.per = per, p.items = (int)items;
  p.bias = bias, p.bias_type = bias_type, p.out = static_cast<__nv_bfloat16*>(out);
  p.ws = split > 1 ? static_cast<float*>(ws) : nullptr;

  CUtensorMap xm, wm;
  const cuuint64_t xdims[4] = {(cuuint64_t)xl[0], (cuuint64_t)xl[1], (cuuint64_t)xl[2], (cuuint64_t)xl[3]};
  const cuuint64_t xstrides[3] = {(cuuint64_t)xl[4], (cuuint64_t)xl[5], (cuuint64_t)xl[6]};
  const cuuint32_t xbox[4] = {(cuuint32_t)xl[7], (cuuint32_t)xl[8], (cuuint32_t)xl[9], (cuuint32_t)xl[10]};
  int status = hw::encode_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, xdims, xstrides, xbox,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  const cuuint64_t wdims[3] = {(cuuint64_t)wl[0], (cuuint64_t)wl[1], (cuuint64_t)wl[2]};
  const cuuint64_t wstrides[2] = {(cuuint64_t)wl[3], (cuuint64_t)wl[4]};
  const cuuint32_t wbox[3] = {(cuuint32_t)wl[5], (cuuint32_t)wl[6], (cuuint32_t)wl[7]};
  if (status == 0)
    status = hw::encode_map(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, wdims, wstrides, wbox,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (status != 0) return status;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  status = bn == 256 ? launch<256>(xm, wm, p, st) : launch<128>(xm, wm, p, st);
  if (status != 0 || split == 1) return status;
  const long long n4 = (long long)B * H * W * Co / 4;
  conv3x3_reduce_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(p.ws, p, n4, split);
  return (int)cudaGetLastError();
}
