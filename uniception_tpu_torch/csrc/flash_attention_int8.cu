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
//   product in the scale chains is rounded on its own (__fmul_rn). The k mean
//   is summed in a fixed order: within each chunk of 128 keys, each group of 4
//   keys in key order, then the 32 groups in order; then the chunks in order
//   (ops/flash_attention.py flash_attention_int8_prep_ref sums in the same
//   order, so the scratch is the plain version's bit for bit).
//
// What bounds it on the H100: like K1 (flash_attention.cu), ~256 operations
//   per byte of q/k/v/o at N = 1024: tensor-core throughput and the softmax's
//   exponentials, not HBM. The int8 products run at twice the bf16 rate.
//
// What the design does about it:
//   * Prep over the whole card, two small launches over (b, h, 128-key chunk)
//     blocks of 256 threads, each thread 4 keys x 8 channels in 16-byte loads
//     (so no thread walks the keys in a chain of dependent loads): the first
//     takes each chunk's k sums (in the fixed order above), max and min per d
//     (and max |v|); the second has every block add the chunk sums in chunk
//     order for the mean, take the scale from the chunks' max and min
//     (fl(k - mean) is monotone in k, so its abs-max over the keys is that of
//     the extremes), and quantize its chunk: k8 as (B, H, Nk_pad, 64) int8
//     rows, and for "int8pv" v8 TRANSPOSED through shared memory, (B, H, 64,
//     Nk_pad), because 8-bit wgmma has no transpose bit and both of its
//     operands must be K-major. Within each 32 keys v8 is stored in the order
//     in which the score accumulators hold p (below). Zeros past Nk. Nk_pad =
//     Nk rounded up to 128.
//   * The attention is K1's structure: a persistent grid (one block per SM
//     over the (128-query tile, head, batch) items), a producer warp issuing
//     TMA loads into an mbarrier ring, two consumer warpgroups of 64 query
//     rows. Each consumer reads its bf16 q rows from the item's TMA tile,
//     takes each row's abs-max across the 4 lanes that hold it, and keeps q8
//     as the register A operand of wgmma m64n128k32.s32.s8.s8, the k8 tile (a
//     64-byte-swizzled TMA box) as B.
//   * The exact softmax, in two passes over the keys. Pass 1 runs only the s8
//     Q.K^T and the row max: no exponentials, and the integer product at twice
//     the bf16 rate (the MUFU, not the tensor cores, sets K1's pace). The max
//     is taken over the int32 sums, since fl(a * f) is monotone in a for the
//     positive row factor f. Pass 2 recomputes the scores and takes p,
//     l and P.V, with tile j's Q.K^T issued beside tile j-1's P.V and tile
//     j's softmax run while that P.V is on the tensor cores, and the two
//     consumers taking turns on the tensor cores (K1's order and ping-pong).
//     The int32 sums become floats by an exact add on the FP32 pipe, not the
//     conversion instruction, which has the exponentials' low rate. An
//     online softmax would rescale with a running max and round other p than
//     the Pallas kernel, so it is not used.
//   * "int8" P.V is K1's: p rounded to bf16 in registers as the A operand of
//     wgmma m64n64k16, the strided bf16 v read MN-major from its TMA tile.
//     "int8pv": p8 = round(p * 127) as the s8 register A operand of
//     m64n64k32; its 4 consecutive k positions per register take keys 2t,
//     2t+1, 8+2t, 9+2t of the accumulator layout, and the prep stored v8 in
//     that same order (the product sums over keys, so any order that both
//     operands share does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "fa_common.cuh"
#include "hopper.cuh"
#include "int8_common.cuh"

namespace {

using namespace uc_fa;
using namespace uc_i8;
namespace hw = uc_hopper;

constexpr int BQ = 128;       // query rows per item: two consumer warpgroups x 64
constexpr int BK = 128;       // keys per tile, and per prep chunk
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int QBOX = 64;      // bf16 columns of one q (and bf16 v) TMA box: 128 bytes
constexpr int RING_BYTES = 200 * 1024;

// The kernel built for DK, the int8 row of k8 (and the rows of v8): D rounded up to 64, 128 or 256 (zeros past D).
// At DK = 64 a k8 tile is one 64-byte-swizzled box of 64-byte rows; above, DK / 128 boxes of 128-byte rows under the
// 128-byte swizzle. P.V runs over OW output columns at a time (64, or 128 above DK = 64), in DK / OW sweeps over the
// keys, so the accumulator stays at one m64n64 or m64n128 (the scores and p are recomputed in each sweep).
template <bool PV8, int DK>
struct Fa8Cfg {
  static constexpr int OW = DK == 64 ? 64 : 128;
  static constexpr int SWEEPS = DK / OW;
  static constexpr int Q_BYTES = BQ * DK * 2;                       // the item's bf16 q rows, DK / 64 boxes
  static constexpr int K_BYTES = BK * DK;                           // one k8 tile
  static constexpr int V_BYTES = PV8 ? OW * BK : BK * OW * 2;       // one sweep's v8 tile (OW d rows of BK keys) or
                                                                    // bf16 v tile (BK key rows, OW / 64 boxes)
  static constexpr int STAGES = DK == 64 ? 6 : (RING_BYTES - Q_BYTES) / (K_BYTES + V_BYTES);
  static_assert(STAGES >= 2, "the ring");
};

// ---------------------------------------------------------------------------
// Prep: k mean, scales, k8 (and v8 transposed).
// ---------------------------------------------------------------------------

// A prep block covers one chunk of BK keys of one (b, h) pair and, in the stats pass, one block of 64 channels:
// thread (kg, dg) takes the PREP_KEYS keys PREP_KEYS kg .. + PREP_KEYS - 1 and the 8 channels 8 dg .. 8 dg + 7 of
// the block, each key's channels one 16-byte load.
constexpr int PREP_KEYS = 4;
constexpr int PREP_GROUPS = BK / PREP_KEYS;  // 32 key groups
constexpr int CB = 64;                       // channels per channel block
constexpr int PREP_THREADS = PREP_GROUPS * (CB / 8);  // x 8 channel groups = 256
constexpr int MAX_DK = 256;

__device__ __forceinline__ void load8(float (&x)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = __bfloat162float(e[c]);
}

// Per (chunk x channel block, h, b) block: the chunk's k sum per d in a fixed order (each thread's PREP_KEYS keys in
// key order, then the PREP_GROUPS partial sums in group order), its k max and min per d, and ("int8pv") its max |v|
// per d. stats is (4, B, H, chunks, DK) float32: sum, max, min, max |v|; channels past D hold 0, -inf, inf, 0.
// D = DK = DS when DS is not 0 (64, built as constants, as the attention kernel), else head_dim and row.
template <int DS>
__global__ void __launch_bounds__(PREP_THREADS) fa8_stats_kernel(const __nv_bfloat16* __restrict__ k,
                                                                 const __nv_bfloat16* __restrict__ v,
                                                                 float* __restrict__ stats, int B, int H, int Nk,
                                                                 int head_dim, int row, Strides ks, Strides vs,
                                                                 int pv_int8) {
  const int D = DS > 0 ? DS : head_dim, DK = DS > 0 ? DS : row;
  __shared__ float red[4][PREP_GROUPS][CB + 1];
  const int tid = threadIdx.x, kg = tid >> 3, dg = tid & 7;
  const int blocks = DK / CB, chunk = blockIdx.x / blocks, d0 = (blockIdx.x % blocks) * CB;
  const int h = blockIdx.y, b = blockIdx.z, chunks = gridDim.x / blocks;
  float sum[8], mx[8], mn[8], vmax[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) sum[c] = 0.f, mx[c] = -INFINITY, mn[c] = INFINITY, vmax[c] = 0.f;
  if (d0 + dg * 8 < D) {  // D is a multiple of 8: a channel group is all in or all out
#pragma unroll
    for (int i = 0; i < PREP_KEYS; ++i) {
      const int n = chunk * BK + kg * PREP_KEYS + i;
      if (n >= Nk) break;
      float x[8];
      load8(x, k + b * ks.b + h * ks.h + (long long)n * ks.n + d0 + dg * 8);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        sum[c] = __fadd_rn(sum[c], x[c]), mx[c] = fmaxf(mx[c], x[c]), mn[c] = fminf(mn[c], x[c]);
      if (pv_int8) {
        load8(x, v + b * vs.b + h * vs.h + (long long)n * vs.n + d0 + dg * 8);
#pragma unroll
        for (int c = 0; c < 8; ++c) vmax[c] = fmaxf(vmax[c], fabsf(x[c]));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    red[0][kg][dg * 8 + c] = sum[c];
    red[1][kg][dg * 8 + c] = mx[c];
    red[2][kg][dg * 8 + c] = mn[c];
    red[3][kg][dg * 8 + c] = vmax[c];
  }
  __syncthreads();
  if (tid >= CB) return;
  float tot = 0.f, m1 = -INFINITY, m0 = INFINITY, va = 0.f;
  for (int g = 0; g < PREP_GROUPS; ++g) {  // in group order: the sum's fixed order
    tot = __fadd_rn(tot, red[0][g][tid]);
    m1 = fmaxf(m1, red[1][g][tid]);
    m0 = fminf(m0, red[2][g][tid]);
    va = fmaxf(va, red[3][g][tid]);
  }
  const long long plane = (long long)B * H * chunks * DK;
  const long long at = (((long long)b * H + h) * chunks + chunk) * DK + d0 + tid;
  stats[at] = tot;
  stats[plane + at] = m1;
  stats[2 * plane + at] = m0;
  stats[3 * plane + at] = va;
}

// The key at position p (0..31) of a 32-key group in the "int8pv" P.V order (ops/flash_attention.py
// int8_pv_keys): position 4t + e of each 16-half holds key 2t + (e & 1) + 8 (e >> 1) of that half, as the score
// accumulators hold p.
__device__ __forceinline__ int pv_key(int p) { return (p & 16) + ((p & 2) << 2) + ((p & 12) >> 1) + (p & 1); }

// Per (chunk, h, b) block: the mean (the chunk sums added in chunk order, / Nk), the scales over the D channels,
// and the chunk's k8 rows and ("int8pv") v8 columns over DK channels, zeros past Nk and past D. D and DK as in
// fa8_stats_kernel.
template <int DS>
__global__ void __launch_bounds__(PREP_THREADS) fa8_quant_kernel(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v, const float* __restrict__ stats,
    int8_t* __restrict__ k8, int8_t* __restrict__ v8t, float* __restrict__ kscale, float* __restrict__ vscale,
    int B, int H, int Nk, int head_dim, int row, int nk_pad, Strides ks, Strides vs, int pv_int8) {
  const int D = DS > 0 ? DS : head_dim, DK = DS > 0 ? DS : row;
  __shared__ float mean_s[MAX_DK], red[2][PREP_THREADS / 32];
  __shared__ __align__(16) uint8_t v8s[CB][BK];  // one channel block's v8, one row per d, keys in P.V order
  const int tid = threadIdx.x, kg = tid >> 3, dg = tid & 7, warp = tid >> 5;
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z, chunks = gridDim.x;
  const long long bh = (long long)b * H + h, plane = (long long)B * H * chunks * DK;
  float kabs = 0.f, vmax = 0.f;  // channels past D take no part in the scales
  if (tid < D) {
    const float* st = stats + bh * chunks * DK + tid;
    float tot = 0.f, mx = -INFINITY, mn = INFINITY;
    for (int c = 0; c < chunks; ++c) {
      tot = __fadd_rn(tot, st[c * DK]);
      mx = fmaxf(mx, st[plane + c * DK]);
      mn = fminf(mn, st[2 * plane + c * DK]);
      vmax = fmaxf(vmax, st[3 * plane + c * DK]);
    }
    const float mean = __fdiv_rn(tot, (float)Nk);
    mean_s[tid] = mean;
    // fl(k - mean) is monotone in k, so the abs-max over the keys is that of the extremes
    kabs = fmaxf(fabsf(__fsub_rn(mx, mean)), fabsf(__fsub_rn(mn, mean)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {  // every lane of every warp: the block's 256 threads
    kabs = fmaxf(kabs, __shfl_xor_sync(0xffffffffu, kabs, o));
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
  }
  if ((tid & 31) == 0) red[0][warp] = kabs, red[1][warp] = vmax;
  __syncthreads();
  float kmax = 0.f, vm = 0.f;
#pragma unroll
  for (int w = 0; w < PREP_THREADS / 32; ++w) kmax = fmaxf(kmax, red[0][w]), vm = fmaxf(vm, red[1][w]);
  const float ksc = absmax_scale(kmax);
  const float vsc = pv_int8 ? absmax_scale(vm) : 0.f;
  if (chunk == 0 && tid == 0) {
    kscale[bh] = ksc;
    if (pv_int8) vscale[bh] = vsc;
  }
  const float krcp = __frcp_rn(ksc), vrcp = pv_int8 ? __frcp_rn(vsc) : 0.f;
  for (int d0 = 0; d0 < DK; d0 += CB) {
    const bool d_in = d0 + dg * 8 < D;  // D is a multiple of 8
    float mean[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) mean[c] = d_in ? mean_s[d0 + dg * 8 + c] : 0.f;
#pragma unroll
    for (int i = 0; i < PREP_KEYS; ++i) {
      const int n = chunk * BK + kg * PREP_KEYS + i;
      uint2 codes = make_uint2(0u, 0u);
      if (n < Nk && d_in) {
        float x[8];
        load8(x, k + b * ks.b + h * ks.h + (long long)n * ks.n + d0 + dg * 8);
        int q[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) q[c] = quant8_rcp(__fsub_rn(x[c], mean[c]), ksc, krcp);
        codes = make_uint2(pack_s8x4(q[0], q[1], q[2], q[3]), pack_s8x4(q[4], q[5], q[6], q[7]));
      }
      *reinterpret_cast<uint2*>(k8 + (bh * nk_pad + n) * DK + d0 + dg * 8) = codes;
    }
    if (!pv_int8) continue;
    // v8: thread (kg, dg) quantizes the keys at positions PREP_KEYS kg .. + 3 of the P.V order, for its 8
    // channels, into the shared tile; then the tile's 64 rows are stored as (DK, Nk_pad) columns.
    int q[PREP_KEYS][8];
#pragma unroll
    for (int i = 0; i < PREP_KEYS; ++i) {
      const int pos = kg * PREP_KEYS + i, n = chunk * BK + (pos & ~31) + pv_key(pos & 31);
      float x[8] = {};
      const bool in = n < Nk && d_in;
      if (in) load8(x, v + b * vs.b + h * vs.h + (long long)n * vs.n + d0 + dg * 8);
#pragma unroll
      for (int c = 0; c < 8; ++c) q[i][c] = in ? quant8_rcp(x[c], vsc, vrcp) : 0;
    }
    if (d0 > 0) __syncthreads();  // the previous channel block's tile has been stored
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<uint32_t*>(&v8s[dg * 8 + c][kg * PREP_KEYS]) = pack_s8x4(q[0][c], q[1][c], q[2][c], q[3][c]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < CB * BK / 16 / PREP_THREADS; ++i) {
      const int idx = tid + i * PREP_THREADS, row = idx / (BK / 16), col = idx % (BK / 16);
      *reinterpret_cast<uint4*>(v8t + (bh * DK + d0 + row) * nk_pad + chunk * BK + col * 16) =
          *reinterpret_cast<const uint4*>(&v8s[row][col * 16]);
    }
  }
}

// ---------------------------------------------------------------------------
// The attention proper.
// ---------------------------------------------------------------------------

template <bool PV8, int DK>
struct alignas(hw::SMEM_ALIGN) Fa8Smem {
  using Cfg = Fa8Cfg<PV8, DK>;
  __nv_bfloat16 q[BQ * DK];                      // the item's bf16 q rows, 128B-swizzled boxes of 64 columns
  int8_t k[Cfg::STAGES][Cfg::K_BYTES];           // k8 tiles (64B-swizzled at DK = 64, else 128B boxes)
  uint8_t v[Cfg::STAGES][Cfg::V_BYTES];          // v8 tiles (int8pv) or bf16 v tiles (int8), 128B-swizzled
  uint64_t q_full, q_empty, full[Cfg::STAGES], empty[Cfg::STAGES];
};

template <bool PV8, int DK>
constexpr int fa8_smem() {
  return sizeof(Fa8Smem<PV8, DK>) + hw::SMEM_ALIGN > hw::MIN_SMEM_BYTES ? sizeof(Fa8Smem<PV8, DK>) + hw::SMEM_ALIGN
                                                                        : hw::MIN_SMEM_BYTES;
}

// S = q8 k8^T for one consumer's 64 rows and a 128-key tile: DK / 32 k-steps of 32, q8 from registers, k8 read
// K-major from its tile (at DK = 64 one 64-byte-swizzled box; above, box kk / 4 of 128-byte rows, 32 bytes a k-step
// inside its swizzled rows); the first k-step overwrites S. One wgmma group, committed.
template <int DK>
__device__ __forceinline__ void issue_qk8(int (&sc)[BK / 2], const uint32_t (&qa)[DK / 32][4], uint32_t k_addr) {
  hw::fence_regs(sc);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DK / 32; ++kk) {
    const uint64_t desc = DK == 64 ? hw::desc_k_major_64b(k_addr + kk * 32)
                                   : hw::desc_k_major(k_addr + (kk / 4) * BK * 128 + (kk % 4) * 32);
    hw::wgmma_m64n128k32_s8_rs(sc, qa[kk], desc, kk);
  }
  hw::wgmma_commit();
}

// O += P V for "int8": 8 k-steps of 16 keys, p in bf16 from registers, v read MN-major from its bf16 tile (OW / 64
// boxes of BK rows, BK * 128 bytes apart).
template <int OW>
__device__ __forceinline__ void issue_pv(float (&acc)[OW / 2], uint32_t (&pa)[BK / 16][4], uint32_t v_addr) {
  hw::fence_regs(acc);
  hw::fence_regs(pa);
  hw::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    if constexpr (OW == 64)
      hw::wgmma_m64n64k16_rs<1>(acc, pa[kc], hw::desc_mn_major(v_addr + kc * 16 * 128), 1);
    else
      hw::wgmma_m64n128k16_rs<1>(acc, pa[kc], hw::desc_mn_major(v_addr + kc * 16 * 128, BK * 128), 1);
  }
  hw::wgmma_commit();
}

// O += P8 V8 for "int8pv": 4 k-steps of 32 keys, p8 from registers, the transposed v8 tile (OW rows of d) read
// K-major.
template <int OW>
__device__ __forceinline__ void issue_pv(int (&acc)[OW / 2], uint32_t (&pa)[BK / 32][4], uint32_t v_addr) {
  hw::fence_regs(acc);
  hw::fence_regs(pa);
  hw::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < BK / 32; ++kc) {
    if constexpr (OW == 64)
      hw::wgmma_m64n64k32_s8_rs(acc, pa[kc], hw::desc_k_major(v_addr + kc * 32), 1);
    else
      hw::wgmma_m64n128k32_s8_rs(acc, pa[kc], hw::desc_k_major(v_addr + kc * 32), 1);
  }
  hw::wgmma_commit();
}

// float(a) for |a| < 2^22 (a q8.k8 sum is at most 127 * 127 * 256 = 4129024 < 2^22 at D <= 256; columns past D
// are zeros in q8 and k8) on the FP32 pipe: a + 1.5 * 2^23 as float bits is
// 1.5 * 2^23 + a exactly, and the subtraction is exact. The same bits as the conversion instruction, which issues
// 16 results a clock per SM (as the MUFU's exponentials do) against 128 for an FP32 add.
__device__ __forceinline__ float small_int_to_float(int a) { return __fsub_rn(__int_as_float(a + 0x4B400000), 12582912.f); }
// The row max of one tile's int32 sums, keys past Nk left out.
__device__ __forceinline__ void tile_max(int (&mx)[2], const int (&sc)[BK / 2], int j, int Nk, int t) {
  const bool ragged = (j + 1) * BK > Nk;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    if (!ragged || j * BK + (i >> 2) * 8 + 2 * t + (i & 1) < Nk) mx[(i >> 1) & 1] = max(mx[(i >> 1) & 1], sc[i]);
}

// p of tile j in place of its scores (as float bits), the row sums l taking p before any rounding. Keys past Nk
// have p = 0. Accumulator element i holds row (i >> 1) & 1 (of g, g + 8) and key j BK + 8 (i >> 2) + 2t + (i & 1).
__device__ __forceinline__ void softmax_tile(int (&sc)[BK / 2], const float (&f)[2], const float (&m)[2], float (&l)[2],
                                             int j, int Nk, int t) {
  const bool ragged = (j + 1) * BK > Nk;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    float p = expf(__fsub_rn(__fmul_rn(small_int_to_float(sc[i]), f[r]), m[r]));
    if (ragged && j * BK + (i >> 2) * 8 + 2 * t + (i & 1) >= Nk) p = 0.f;
    l[r] += p;
    sc[i] = __float_as_int(p);
  }
}

// The register A operands of P.V from the p of softmax_tile: bf16 pairs of the 16-key k-steps ("int8"), or
// p8 = round(p * 127) in fours of the 32-key k-steps ("int8pv").
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4], const int (&sc)[BK / 2]) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kc][i] = hw::pack_bf16x2(__int_as_float(sc[8 * kc + 2 * i]), __int_as_float(sc[8 * kc + 2 * i + 1]));
}
__device__ __forceinline__ int p8(int bits) { return (int)rintf(__fmul_rn(__int_as_float(bits), 127.f)); }
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 32][4], const int (&sc)[BK / 2]) {
#pragma unroll
  for (int kc = 0; kc < BK / 32; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // register i: row half i & 1, the 8-key chunks 2 (i >> 1) and 2 (i >> 1) + 1
      const int a = 16 * kc + 8 * (i >> 1) + 2 * (i & 1), b = a + 4;
      pa[kc][i] = pack_s8x4(p8(sc[a]), p8(sc[a + 1]), p8(sc[b]), p8(sc[b + 1]));
    }
}

// D = DS when DS is not 0 (64, built as a constant, as K1's), else head_dim.
template <bool PV8, int DK, int DS>
__global__ void __launch_bounds__(THREADS, 1) fa8_fwd_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const float* __restrict__ kscale, const float* __restrict__ vscale,
    __nv_bfloat16* __restrict__ o, int B, int H, int Nq, int Nk, int head_dim, float scale) {
  using Cfg = Fa8Cfg<PV8, DK>;
  const int D = DS > 0 ? DS : head_dim;
  constexpr int STAGES = Cfg::STAGES, OW = Cfg::OW;
  using Acc = typename std::conditional<PV8, int, float>::type;
  using PA = uint32_t[PV8 ? BK / 32 : BK / 16][4];
  extern __shared__ uint8_t smem_raw[];
  Fa8Smem<PV8, DK>& sm = *reinterpret_cast<Fa8Smem<PV8, DK>*>(hw::align_smem(smem_raw));
  const int tid = threadIdx.x;
  const int q_tiles = (Nq + BQ - 1) / BQ, n_items = q_tiles * H * B;
  const int n_tiles = (Nk + BK - 1) / BK;

  if (tid == 0) {
    hw::mbar_init(&sm.q_full, 1);
    hw::mbar_init(&sm.q_empty, THREADS - 128);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&sm.full[s], 1);
      hw::mbar_init(&sm.empty[s], THREADS - 128);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues every load
    hw::setmaxnreg_dec<40>();
    if (tid == 0) {
      int s = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int qt = item % q_tiles, h = (item / q_tiles) % H, b = item / (q_tiles * H);
        hw::mbar_wait(&sm.q_empty, q_phase ^ 1);
        hw::mbar_arrive_expect_tx(&sm.q_full, Cfg::Q_BYTES);
#pragma unroll
        for (int box = 0; box < DK / QBOX; ++box)
          hw::tma_load_4d(sm.q + box * BQ * QBOX, &qmap, &sm.q_full, box * QBOX, h, qt * BQ, b);
        q_phase ^= 1;
        // pass 0: k8 for the row max; then one pass per sweep of OW output columns: k8 and that sweep's v
        for (int pass = 0; pass <= Cfg::SWEEPS; ++pass)
          for (int j = 0; j < n_tiles; ++j) {
            hw::mbar_wait(&sm.empty[s], phase ^ 1);
            hw::mbar_arrive_expect_tx(&sm.full[s], Cfg::K_BYTES + (pass ? Cfg::V_BYTES : 0));
            if constexpr (DK == 64) {
              hw::tma_load_3d(sm.k[s], &kmap, &sm.full[s], 0, j * BK, b * H + h);
            } else {
#pragma unroll
              for (int box = 0; box < DK / 128; ++box)
                hw::tma_load_3d(sm.k[s] + box * BK * 128, &kmap, &sm.full[s], box * 128, j * BK, b * H + h);
            }
            if (pass) {
              const int col0 = (pass - 1) * OW;  // the sweep's first output column
              if constexpr (PV8) {
                hw::tma_load_3d(sm.v[s], &vmap, &sm.full[s], j * BK, col0, b * H + h);
              } else {
#pragma unroll
                for (int box = 0; box < OW / QBOX; ++box)
                  hw::tma_load_4d(sm.v[s] + box * BK * 128, &vmap, &sm.full[s], col0 + box * QBOX, h, j * BK, b);
              }
            }
            if (++s == STAGES) s = 0, phase ^= 1;
          }
      }
    }
  } else {  // consumer warpgroups: 64 query rows each
    hw::setmaxnreg_inc<232>();
    const int ctid = tid - 128, cwg = ctid >> 7, warp = (ctid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // Ping-pong between the consumers in the P.V passes (named barriers 1 and 2, 256 threads), as in K1: each
    // issues its wgmma groups only in its turn and hands the turn over right after, so one consumer's softmax
    // overlaps the other's products. Consumer 0 goes first; consumer 1's last hand-over is never waited for.
    const int my_turn = 1 + cwg, other_turn = 2 - cwg;
    if (cwg == 1) hw::named_bar_arrive(1, 256);
    int s = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int qt = item % q_tiles, h = (item / q_tiles) % H, b = item / (q_tiles * H);
      const bool last_item = item + gridDim.x >= n_items;
      const long long bh = (long long)b * H + h;
      const int row0 = qt * BQ + cwg * 64 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8

      // q8 as the A operands of the DK / 32 k-steps of 32: this thread holds columns 16c + 4t .. + 3 of rows
      // row0 / row0 + 8 (c = 0 .. DK / 16 - 1: box c / 4 of the q tile); the 4 lanes t of a row reduce its abs-max.
      uint32_t qa[DK / 32][4];
      float f[2];  // per row: qs * (ks * scale)
      {
        const float ksc = __fmul_rn(kscale[bh], scale);
        hw::mbar_wait(&sm.q_full, q_phase);
        const uint8_t* qs = reinterpret_cast<const uint8_t*>(sm.q);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int R = cwg * 64 + warp * 16 + g + 8 * r;
          float vals[DK / 4], amax = 0.f;
#pragma unroll
          for (int c = 0; c < DK / 16; ++c) {
            const int byte = 32 * (c % 4) + 8 * t;
            const uint2 u = *reinterpret_cast<const uint2*>(qs + (c / 4) * BQ * 128 + R * 128 +
                                                            ((((byte >> 4) ^ (R & 7))) << 4) + (byte & 15));
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              vals[4 * c + i] = __bfloat162float(e[i]);
              amax = fmaxf(amax, fabsf(vals[4 * c + i]));
            }
          }
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
          const float qsc = absmax_scale(amax);
          f[r] = __fmul_rn(qsc, ksc);
#pragma unroll
          for (int c = 0; c < DK / 16; ++c)
            qa[c >> 1][(c & 1) * 2 + r] = pack_s8x4(quant8(vals[4 * c], qsc), quant8(vals[4 * c + 1], qsc),
                                                    quant8(vals[4 * c + 2], qsc), quant8(vals[4 * c + 3], qsc));
        }
        hw::mbar_arrive(&sm.q_empty);
        q_phase ^= 1;
      }

      int sc[BK / 2];  // S of a tile (int32 sums), then its p as float bits

      // pass 1: the row max over every key, on the int32 sums
      int mx[2] = {INT_MIN, INT_MIN};
      for (int j = 0; j < n_tiles; ++j) {
        hw::mbar_wait(&sm.full[s], phase);
        issue_qk8<DK>(sc, qa, hw::smem_u32(sm.k[s]));
        hw::wgmma_wait<0>();
        hw::fence_regs(sc);
        hw::mbar_arrive(&sm.empty[s]);
        tile_max(mx, sc, j, Nk, t);
        if (++s == STAGES) s = 0, phase ^= 1;
      }
      float m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m[r] = __fmul_rn((float)mx[r], f[r]);  // the max of s: f > 0, so fl(a f) is monotone in a
      }
      const float vsc = PV8 ? __fdiv_rn(vscale[bh], 127.f) : 0.f;

      // one pass per sweep of OW output columns: p, the sums and P.V; tile j's Q.K^T beside tile j-1's P.V, tile
      // j's softmax while it runs, the products issued in this consumer's turn
      for (int sweep = 0; sweep < Cfg::SWEEPS; ++sweep) {
        Acc acc[OW / 2];
#pragma unroll
        for (int i = 0; i < OW / 2; ++i) acc[i] = 0;
        float l[2] = {0.f, 0.f};
        PA pa;
        hw::mbar_wait(&sm.full[s], phase);
        hw::named_bar_sync(my_turn, 256);
        issue_qk8<DK>(sc, qa, hw::smem_u32(sm.k[s]));
        hw::named_bar_arrive(other_turn, 256);
        hw::wgmma_wait<0>();
        hw::fence_regs(sc);
        softmax_tile(sc, f, m, l, 0, Nk, t);
        pack_p(pa, sc);
        int prev = s;
        if (++s == STAGES) s = 0, phase ^= 1;
        for (int j = 1; j < n_tiles; ++j) {
          hw::mbar_wait(&sm.full[s], phase);
          hw::named_bar_sync(my_turn, 256);
          issue_qk8<DK>(sc, qa, hw::smem_u32(sm.k[s]));
          issue_pv<OW>(acc, pa, hw::smem_u32(sm.v[prev]));
          hw::named_bar_arrive(other_turn, 256);
          hw::wgmma_wait<1>();  // S has landed; P.V may still run
          hw::fence_regs(sc);
          softmax_tile(sc, f, m, l, j, Nk, t);
          hw::wgmma_wait<0>();  // the previous P.V is done: release its slot
          hw::fence_regs(acc);
          hw::mbar_arrive(&sm.empty[prev]);
          pack_p(pa, sc);
          prev = s;
          if (++s == STAGES) s = 0, phase ^= 1;
        }
        hw::named_bar_sync(my_turn, 256);
        issue_pv<OW>(acc, pa, hw::smem_u32(sm.v[prev]));
        if (cwg == 0 || !last_item || sweep + 1 < Cfg::SWEEPS) hw::named_bar_arrive(other_turn, 256);
        hw::wgmma_wait<0>();
        hw::fence_regs(acc);
        hw::mbar_arrive(&sm.empty[prev]);

#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        }
        __nv_bfloat16* op = o + ((long long)b * Nq * H + h) * D + sweep * OW;  // o is contiguous (B, Nq, H, D)
#pragma unroll
        for (int c = 0; c < OW / 8; ++c) {
          if (sweep * OW + c * 8 >= D) continue;  // the columns past D are zeros, never stored
          float y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pv = PV8 ? __fmul_rn((float)acc[4 * c + e], vsc) : (float)acc[4 * c + e];
            y[e] = __fdiv_rn(pv, l[e >> 1]);
          }
          const int col = c * 8 + 2 * t;
          if (row0 < Nq) *reinterpret_cast<uint32_t*>(op + (long long)row0 * H * D + col) = hw::pack_bf16x2(y[0], y[1]);
          if (row0 + 8 < Nq)
            *reinterpret_cast<uint32_t*>(op + (long long)(row0 + 8) * H * D + col) = hw::pack_bf16x2(y[2], y[3]);
        }
      }
    }
  }
}

// The element strides (b, n, h) of a bf16 tensor from its tensor-map layout (byte strides of h, n, b).
Strides layout_strides(const long long* L) { return Strides{L[6] / 2, L[5] / 2, L[4] / 2}; }

// DK, the int8 row of the scratch: D rounded up to 64, 128 or 256.
int row_bytes(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }

int prep(const void* k, const void* v, void* k8, void* v8t, void* stats, void* kscale, void* vscale, int pv_int8,
         int B, int H, int Nk, int D, const long long* lk, const long long* lv, cudaStream_t st) {
  const int chunks = (Nk + BK - 1) / BK, nk_pad = chunks * BK, DK = row_bytes(D);
  const Strides ks = layout_strides(lk), vs = layout_strides(lv);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const dim3 stats_grid(chunks * (DK / CB), H, B), grid(chunks, H, B);
  auto* sp = static_cast<float*>(stats);
  auto *k8p = static_cast<int8_t*>(k8), *v8p = static_cast<int8_t*>(v8t);
  auto *ksp = static_cast<float*>(kscale), *vsp = static_cast<float*>(vscale);
  if (D == 64) {
    fa8_stats_kernel<64><<<stats_grid, PREP_THREADS, 0, st>>>(kp, vp, sp, B, H, Nk, D, DK, ks, vs, pv_int8);
    fa8_quant_kernel<64><<<grid, PREP_THREADS, 0, st>>>(kp, vp, sp, k8p, v8p, ksp, vsp, B, H, Nk, D, DK, nk_pad, ks, vs,
                                                        pv_int8);
  } else {
    fa8_stats_kernel<0><<<stats_grid, PREP_THREADS, 0, st>>>(kp, vp, sp, B, H, Nk, D, DK, ks, vs, pv_int8);
    fa8_quant_kernel<0><<<grid, PREP_THREADS, 0, st>>>(kp, vp, sp, k8p, v8p, ksp, vsp, B, H, Nk, D, DK, nk_pad, ks, vs,
                                                       pv_int8);
  }
  return (int)cudaGetLastError();
}

bool prep_args_ok(const void* v8t, const void* vscale, int pv_int8, int B, int H, int Nk, int D) {
  return B > 0 && H > 0 && Nk > 0 && Nk <= 1024 && B <= 65535 && H <= 65535 && D >= 8 && D <= MAX_DK &&
         D % 8 == 0 && !(pv_int8 && (v8t == nullptr || vscale == nullptr));
}

// The attention launch on the prep's scratch, for the kernel built for DK (and DS, as the kernel takes it).
template <bool PV8, int DK, int DS>
int launch_fa8(const void* q, const void* v, const void* k8, const void* v8t, const void* kscale,
               const void* vscale, void* o, int B, int H, int Nq, int Nk, int D, const long long* lq,
               const long long* lv, float scale, int sms, cudaStream_t st) {
  using Cfg = Fa8Cfg<PV8, DK>;
  const int nk_pad = (Nk + BK - 1) / BK * BK;
  CUtensorMap qm, km, vm;
  int status = hw::encode_tile_map(&qm, q, lq, BQ);
  const cuuint64_t kdims[3] = {DK, (cuuint64_t)nk_pad, (cuuint64_t)B * H};
  const cuuint64_t kstrides[2] = {DK, (cuuint64_t)nk_pad * DK};
  const cuuint32_t kbox[3] = {DK == 64 ? 64u : 128u, BK, 1};
  if (status == 0)
    status = hw::encode_map(&km, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, k8, kdims, kstrides, kbox,
                            DK == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  if (status == 0 && PV8) {
    const cuuint64_t vdims[3] = {(cuuint64_t)nk_pad, DK, (cuuint64_t)B * H};
    const cuuint64_t vstrides[2] = {(cuuint64_t)nk_pad, (cuuint64_t)nk_pad * DK};
    const cuuint32_t vbox[3] = {BK, Cfg::OW, 1};
    status = hw::encode_map(&vm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, v8t, vdims, vstrides, vbox,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  } else if (status == 0) {
    status = hw::encode_tile_map(&vm, v, lv, BK);
  }
  static bool smem_set[64];
  if (status == 0) status = hw::allow_smem(fa8_fwd_kernel<PV8, DK, DS>, fa8_smem<PV8, DK>(), smem_set);
  if (status != 0) return status;
  const long long items = (long long)((Nq + BQ - 1) / BQ) * H * B;
  const int grid = (int)(items < sms ? items : sms);
  fa8_fwd_kernel<PV8, DK, DS><<<grid, THREADS, fa8_smem<PV8, DK>(), st>>>(
      qm, km, vm, static_cast<const float*>(kscale), static_cast<const float*>(vscale),
      static_cast<__nv_bfloat16*>(o), B, H, Nq, Nk, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The prep alone. k and v: bf16 (B, Nk, H, D) read through their tensor-map layouts (hopper.cuh LAYOUT_INTS
// each; the byte strides give the element strides), D a multiple of 8 up to 256. Writes k8 (B, H, Nk_pad, DK) and
// ("int8pv") v8t (B, H, DK, Nk_pad) int8 contiguous, DK = D rounded up to 64, 128 or 256, Nk_pad = Nk rounded up
// to 128, zeros past Nk and past D; kscale and vscale (B, H) float32; stats is a float32 scratch of
// 4 * B * H * (Nk_pad / 128) * DK. Returns a cudaError_t.
extern "C" int uc_flash_attention_int8_prep(const void* k, const void* v, void* k8, void* v8t, void* stats,
                                            void* kscale, void* vscale, int pv_int8, int B, int H, int Nk, int D,
                                            const long long* layouts, void* stream) {
  if (layouts[0] != D || layouts[hw::LAYOUT_INTS] != D || !prep_args_ok(v8t, vscale, pv_int8, B, H, Nk, D))
    return (int)cudaErrorInvalidValue;
  return prep(k, v, k8, v8t, stats, kscale, vscale, pv_int8, B, H, Nk, D, layouts, layouts + hw::LAYOUT_INTS,
              static_cast<cudaStream_t>(stream));
}

// The prep, then the attention. q (B, Nq, H, D), k and v (B, Nk, H, D), bf16, read through their tensor-map
// layouts (`layouts`: q, k, v, 11 ints each, boxes of 128 rows); o: contiguous (B, Nq, H, D) bf16; the
// scratch as for uc_flash_attention_int8_prep. D a multiple of 8 up to 256, Nk <= 1024. Returns a cudaError_t.
extern "C" int uc_flash_attention_int8(const void* q, const void* k, const void* v, void* o, void* k8, void* v8t,
                                       void* stats, void* kscale, void* vscale, int pv_int8, int B, int H, int Nq,
                                       int Nk, int head_dim, const long long* layouts, float scale, void* stream) {
  const int D = head_dim;
  if (Nq <= 0 || !prep_args_ok(v8t, vscale, pv_int8, B, H, Nk, D)) return (int)cudaErrorInvalidValue;
  const long long *lq = layouts, *lk = layouts + hw::LAYOUT_INTS, *lv = layouts + 2 * hw::LAYOUT_INTS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long items = (long long)((Nq + BQ - 1) / BQ) * H * B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int sms = 0;
  int status = hw::sm_count(&sms);
  if (status == 0) status = prep(k, v, k8, v8t, stats, kscale, vscale, pv_int8, B, H, Nk, D, lk, lv, st);
  if (status != 0) return status;
  const int DK = row_bytes(D);
#define UC_FA8(PV8, DKC, DS) \
  launch_fa8<PV8, DKC, DS>(q, v, k8, v8t, kscale, vscale, o, B, H, Nq, Nk, D, lq, lv, scale, sms, st)
  if (pv_int8)
    return D == 64 ? UC_FA8(true, 64, 64) : DK == 64 ? UC_FA8(true, 64, 0) : DK == 128 ? UC_FA8(true, 128, 0)
                                                                                 : UC_FA8(true, 256, 0);
  return D == 64 ? UC_FA8(false, 64, 64) : DK == 64 ? UC_FA8(false, 64, 0) : DK == 128 ? UC_FA8(false, 128, 0)
                                                                                  : UC_FA8(false, 256, 0);
#undef UC_FA8
}
