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
//   elementwise work between the products bound it, not HBM. Only wgmma
//   reaches the full tensor-core rate on this card.
//
// What the design does about it:
//   * Three launches, no atomics, so the result is deterministic: delta
//     (one 16-byte vector of a row per thread), dq (128-query work items
//     looping over 64-key tiles) and dk/dv (128-key work items looping over
//     64-query tiles). The TPU's sequential "arbitrary" grid axis becomes the
//     loop inside the block; s and dp are recomputed in both passes, as the
//     split Pallas kernels do.
//   * bf16: persistent, warp-specialised wgmma kernels on hopper.cuh, one
//     block per SM walking the work items (128-row own tiles, head, batch).
//     Warpgroup 0 is the producer (setmaxnreg.dec): one thread issues TMA
//     loads of each item's own tiles and of the tiles it loops over into a
//     ring of STAGES slots with full / empty mbarriers, running ahead across
//     items; in dk/dv its warp also stages each query tile's lse and delta in
//     the slot (after the tile's TMA is issued, so the two overlap).
//     Warpgroups 1 and 2 are the consumers (setmaxnreg.inc), 64 own rows
//     each, read once per item into wgmma register A operands.
//   * dk/dv: s^T = k q^T and dp^T = v dO^T by wgmma m64n64k16 with k and v
//     from registers and q, dO read K-major from shared memory (keys as rows,
//     so p^T and ds^T come out already in A-operand form); p^T and ds^T are
//     formed on the fp32 accumulators, rounded to bf16 in registers and used
//     as the register A operand of dv += p^T dO and dk += ds^T q, with dO and
//     q read MN-major (transpose bit) straight from their TMA tiles: no staged
//     transposes.
//   * dq: s = q k^T and dp = dO v^T (q, dO from registers, k, v K-major),
//     then dq += ds k with ds in registers and k read MN-major.
//   * In both, a consumer issues tile j's pair of products and then tile
//     j-1's register-A products, and forms tile j's p and ds while those run;
//     each wgmma group has its own fence, so ptxas never serialises them, and
//     the two consumers take turns on the tensor cores (ping-pong).
//   * fp32: full fp32 FMA on the CUDA cores, no TF32 (the Pallas kernels run
//     fp32 at HIGHEST precision), the parity path. Two threads share a row,
//     each holding half of D in registers, and add their halves of each dot
//     product with one shuffle.
//   * q/k/v/dO are read through 4-D tensor maps (D, H, N, B) with their byte
//     strides (ops/flash_attention.py tma_layout), so the views of a fused qkv
//     projection need no copy; o, lse and the outputs are contiguous. TMA
//     fills rows past N with zeros: a padded query has zero q and dO, so it
//     adds nothing to dk and dv; padded keys get p = 0 in dq (fp32: padded
//     rows and keys get p = 0).
//   * Later work: one fused pass when a single tile covers all keys
//     (_fa_bwd_fused_kernel's 5-product shape), 128-row loop tiles, dq
//     accumulated in the dk/dv pass (which needs atomics or a reduction).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fa_common.cuh"
#include "hopper.cuh"

namespace {

using namespace uc_fa;
namespace hw = uc_hopper;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// delta[b, h, n] = sum_d dO[b, n, h, d] * O[b, n, h, d] in fp32. Each thread takes one 16-byte vector of a
// row (8 bf16 or 4 fp32), so D / VEC neighbouring lanes share a row and add their sums by shuffle.
template <typename T>
__global__ void __launch_bounds__(256) fa_bwd_delta_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                                                           float* __restrict__ delta, int H, int Nq, long long rows,
                                                           Strides dos) {
  constexpr int VEC = 16 / sizeof(T), LANES = D / VEC, ROWS_PER_WARP = 32 / LANES;
  const int part = threadIdx.x % LANES, group = (threadIdx.x & 31) / LANES;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long step = (((long long)gridDim.x * blockDim.x) >> 5) * ROWS_PER_WARP;
  for (long long r0 = warp * ROWS_PER_WARP; r0 < rows; r0 += step) {  // the same trip count for the whole warp
    const long long r = r0 + group;  // (b * Nq + n) * H + h, o's row order
    float s = 0.f;
    int b = 0, n = 0, h = 0;
    if (r < rows) {
      const long long bn = r / H;
      h = (int)(r - bn * H), n = (int)(bn % Nq), b = (int)(bn / Nq);
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + b * dos.b + n * dos.n + h * dos.h + part * VEC);
      const uint4 ov = *reinterpret_cast<const uint4*>(o + r * D + part * VEC);
      const T* de = reinterpret_cast<const T*>(&dv);
      const T* oe = reinterpret_cast<const T*>(&ov);
#pragma unroll
      for (int i = 0; i < VEC; ++i) s = fmaf(to_f(de[i]), to_f(oe[i]), s);
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (r < rows && part == 0) delta[((long long)b * H + h) * Nq + n] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int THREADS = 384;             // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = THREADS - 128;
constexpr int OWN = 128;                 // the block's own rows: queries in dq, keys in dk/dv (2 x 64)
constexpr int LOOP = 64;                 // rows of each tile the block loops over
constexpr int STAGES = 4;
constexpr int OWN_BYTES = OWN * D * 2, LOOP_BYTES = LOOP * D * 2;

struct alignas(hw::SMEM_ALIGN) DqSmem {
  __nv_bfloat16 q[OWN * D], dout[OWN * D];
  __nv_bfloat16 k[STAGES][LOOP * D], v[STAGES][LOOP * D];
  uint64_t own_full, own_empty, full[STAGES], empty[STAGES];
};

struct alignas(hw::SMEM_ALIGN) DkvSmem {
  __nv_bfloat16 k[OWN * D], v[OWN * D];
  __nv_bfloat16 q[STAGES][LOOP * D], dout[STAGES][LOOP * D];
  float lse[STAGES][LOOP], delta[STAGES][LOOP];  // lse in log2 units; 0 past Nq
  uint64_t own_full, own_empty, full[STAGES], empty[STAGES];
};

template <typename S>
constexpr int smem_bytes() {
  return sizeof(S) + hw::SMEM_ALIGN > hw::MIN_SMEM_BYTES ? sizeof(S) + hw::SMEM_ALIGN : hw::MIN_SMEM_BYTES;
}

// The barriers of either kernel: own tiles (one TMA arrival in, every consumer thread out), ring slots
// (`full_count` arrivals in, every consumer thread out).
template <typename S>
__device__ __forceinline__ void init_barriers(S& sm, int full_count) {
  if (threadIdx.x == 0) {
    hw::mbar_init(&sm.own_full, 1);
    hw::mbar_init(&sm.own_empty, CONSUMERS);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&sm.full[s], full_count);
      hw::mbar_init(&sm.empty[s], CONSUMERS);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();
}

// x = a b^T and y = c d^T for one consumer's 64 rows and a 64-row tile, 4 k-steps of 16 over D: a and c from
// registers (the consumer's own rows, read once), b and d read K-major from shared memory (s and dp in dq;
// s^T and dp^T in dk/dv); the first k-step overwrites x and y. One wgmma group, committed.
__device__ __forceinline__ void issue_pair(float (&x)[LOOP / 2], float (&y)[LOOP / 2], const uint32_t (&a)[D / 16][4],
                                           uint32_t b, const uint32_t (&c)[D / 16][4], uint32_t d) {
  hw::fence_regs(x);
  hw::fence_regs(y);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    hw::wgmma_m64n64k16_rs<0>(x, a[kk], hw::desc_k_major(b + kk * 32), kk > 0);
    hw::wgmma_m64n64k16_rs<0>(y, c[kk], hw::desc_k_major(d + kk * 32), kk > 0);
  }
  hw::wgmma_commit();
}

// dq += ds k for one consumer's 64 rows: 4 k-steps of 16 keys, ds from registers, k read MN-major (rows =
// keys). One wgmma group.
__device__ __forceinline__ void issue_ds_k(float (&acc)[D / 2], uint32_t (&a)[LOOP / 16][4], uint32_t k_addr) {
  hw::fence_regs(acc);
  hw::fence_regs(a);
  hw::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < LOOP / 16; ++kc)
    hw::wgmma_m64n64k16_rs<1>(acc, a[kc], hw::desc_mn_major(k_addr + kc * 16 * D * 2), 1);
  hw::wgmma_commit();
}

// dv += p^T dO and dk += ds^T q for one consumer's 64 keys: 4 k-steps of 16 queries, p^T and ds^T from
// registers, dO and q read MN-major (rows = queries). One wgmma group.
__device__ __forceinline__ void issue_dkv(float (&dv_acc)[D / 2], float (&dk_acc)[D / 2], uint32_t (&pa)[LOOP / 16][4],
                                          uint32_t (&sa)[LOOP / 16][4], uint32_t do_addr, uint32_t q_addr) {
  hw::fence_regs(dv_acc);
  hw::fence_regs(dk_acc);
  hw::fence_regs(pa);
  hw::fence_regs(sa);
  hw::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < LOOP / 16; ++kc) {
    hw::wgmma_m64n64k16_rs<1>(dv_acc, pa[kc], hw::desc_mn_major(do_addr + kc * 16 * D * 2), 1);
    hw::wgmma_m64n64k16_rs<1>(dk_acc, sa[kc], hw::desc_mn_major(q_addr + kc * 16 * D * 2), 1);
  }
  hw::wgmma_commit();
}

// The work item `item` of a persistent kernel: (tile, head, batch), tile fastest.
struct Item {
  int tile, h, b;
};
__device__ __forceinline__ Item decode(int item, int tiles, int H) {
  return Item{item % tiles, (item / tiles) % H, item / (tiles * H)};
}

// dq: a persistent kernel whose work items are 128-query tiles; each loops over 64-key tiles. The producer
// runs ahead across items (the consumers hold their q and dO rows in registers and release the own-tile
// buffer at once), which hides each item's pipeline fill and epilogue.
__global__ void __launch_bounds__(THREADS, 1) fa_bwd_dq_bf16_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int B, int H,
    int Nq, int Nk, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(hw::align_smem(smem_raw));
  const int tid = threadIdx.x;
  const int q_tiles = (Nq + OWN - 1) / OWN, n_items = q_tiles * H * B;
  const int n_tiles = (Nk + LOOP - 1) / LOOP;
  init_barriers(sm, 1);

  if (tid < 128) {  // producer
    hw::setmaxnreg_dec<40>();
    if (tid == 0) {
      int s = 0;
      uint32_t phase = 0, own_phase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const Item it = decode(item, q_tiles, H);
        hw::mbar_wait(&sm.own_empty, own_phase ^ 1);
        hw::mbar_arrive_expect_tx(&sm.own_full, 2 * OWN_BYTES);
        hw::tma_load_4d(sm.q, &qmap, &sm.own_full, 0, it.h, it.tile * OWN, it.b);
        hw::tma_load_4d(sm.dout, &domap, &sm.own_full, 0, it.h, it.tile * OWN, it.b);
        own_phase ^= 1;
        for (int j = 0; j < n_tiles; ++j) {
          hw::mbar_wait(&sm.empty[s], phase ^ 1);
          hw::mbar_arrive_expect_tx(&sm.full[s], 2 * LOOP_BYTES);
          hw::tma_load_4d(sm.k[s], &kmap, &sm.full[s], 0, it.h, j * LOOP, it.b);
          hw::tma_load_4d(sm.v[s], &vmap, &sm.full[s], 0, it.h, j * LOOP, it.b);
          if (++s == STAGES) s = 0, phase ^= 1;
        }
      }
    }
  } else {  // consumers: 64 queries each
    hw::setmaxnreg_inc<232>();
    const int ctid = tid - 128, cwg = ctid >> 7, warp = (ctid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // Ping-pong between the consumers, as in the forward (flash_attention.cu): each issues its wgmma groups
    // only in its turn (named barriers 1 and 2), so one consumer's elementwise work overlaps the other's
    // products; consumer 1's last hand-over is never waited for.
    const int my_turn = 1 + cwg, other_turn = 2 - cwg;
    if (cwg == 1) hw::named_bar_arrive(1, 256);
    int s = 0;
    uint32_t phase = 0, own_phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const Item it = decode(item, q_tiles, H);
      const bool last_item = item + gridDim.x >= n_items;
      const int row0 = it.tile * OWN + cwg * 64 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
      const int rows[2] = {row0, row0 + 8};
      const long long stat = ((long long)it.b * H + it.h) * Nq;
      float lse2[2], dl[2];  // lse in log2 units, delta
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = rows[r] < Nq ? lse[stat + rows[r]] * LOG2E : 0.f;
        dl[r] = rows[r] < Nq ? delta[stat + rows[r]] : 0.f;
      }
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      // ds = p * (dp - delta) * scale in place of s for the key tile at k0. Rows past Nq need no mask: TMA
      // zero-fills their q and dO, so dp = 0 and ds = 0 (and they are not written). Keys past Nk (the last
      // tile only) get p = 0: their k is zero, but exp2(-lse) alone could overflow.
      float sc[LOOP / 2], dp[LOOP / 2];
      auto ds_tile = [&](int k0) {
        const bool ragged = k0 + LOOP > Nk;
#pragma unroll
        for (int i = 0; i < LOOP / 2; ++i) {
          const int r = (i >> 1) & 1;
          float p = hw::exp2_ftz(fmaf(sc[i], scale_log2, -lse2[r]));
          if (ragged && k0 + (i >> 2) * 8 + 2 * t + (i & 1) >= Nk) p = 0.f;
          sc[i] = p * (dp[i] - dl[r]) * scale;
        }
      };

      // q and dO of this consumer's rows as register A operands; the own-tile buffer is then free.
      uint32_t qa[D / 16][4], da[D / 16][4];
      hw::mbar_wait(&sm.own_full, own_phase);
      hw::load_a_frags(qa, sm.q + cwg * 64 * D, warp, lane);
      hw::load_a_frags(da, sm.dout + cwg * 64 * D, warp, lane);
      hw::mbar_arrive(&sm.own_empty);
      own_phase ^= 1;

      // Software pipeline inside the warpgroup: tile j's s and dp are issued, then tile j-1's dq += ds k,
      // and the elementwise work of tile j runs while that product is on the tensor cores.
      uint32_t a[LOOP / 16][4];  // ds of the previous tile in bf16: the register A operand of ds k
      hw::mbar_wait(&sm.full[s], phase);
      hw::named_bar_sync(my_turn, 256);
      issue_pair(sc, dp, qa, hw::smem_u32(sm.k[s]), da, hw::smem_u32(sm.v[s]));
      hw::named_bar_arrive(other_turn, 256);
      hw::wgmma_wait<0>();
      hw::fence_regs(sc);
      hw::fence_regs(dp);
      ds_tile(0);
      hw::pack_a<LOOP>(a, sc);
      int prev = s;
      if (++s == STAGES) s = 0, phase ^= 1;
      for (int j = 1; j < n_tiles; ++j) {
        hw::mbar_wait(&sm.full[s], phase);
        hw::named_bar_sync(my_turn, 256);
        issue_pair(sc, dp, qa, hw::smem_u32(sm.k[s]), da, hw::smem_u32(sm.v[s]));
        issue_ds_k(acc, a, hw::smem_u32(sm.k[prev]));
        hw::named_bar_arrive(other_turn, 256);
        hw::wgmma_wait<1>();
        hw::fence_regs(sc);
        hw::fence_regs(dp);
        ds_tile(j * LOOP);
        hw::wgmma_wait<0>();  // the previous tile's product is done: release its slot
        hw::fence_regs(acc);
        hw::mbar_arrive(&sm.empty[prev]);
        hw::pack_a<LOOP>(a, sc);
        prev = s;
        if (++s == STAGES) s = 0, phase ^= 1;
      }
      hw::named_bar_sync(my_turn, 256);
      issue_ds_k(acc, a, hw::smem_u32(sm.k[prev]));
      if (cwg == 0 || !last_item) hw::named_bar_arrive(other_turn, 256);
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
      hw::mbar_arrive(&sm.empty[prev]);

      __nv_bfloat16* op = dq + ((long long)it.b * Nq * H + it.h) * D;  // dq is contiguous (B, Nq, H, D)
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const int col = c * 8 + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (rows[r] < Nq)
            *reinterpret_cast<uint32_t*>(op + (long long)rows[r] * H * D + col) =
                hw::pack_bf16x2(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
      }
    }
  }
}

// dk and dv: a persistent kernel whose work items are 128-key tiles; each loops over 64-query tiles. The
// producer runs ahead across items as in dq.
__global__ void __launch_bounds__(THREADS, 1) fa_bwd_dkv_bf16_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int B, int H, int Nq, int Nk, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(hw::align_smem(smem_raw));
  const int tid = threadIdx.x;
  const int k_tiles = (Nk + OWN - 1) / OWN, n_items = k_tiles * H * B;
  const int n_tiles = (Nq + LOOP - 1) / LOOP;
  init_barriers(sm, 33);  // lane 0 with the TMA bytes, then the producer warp's 32 lanes with lse / delta

  if (tid < 128) {  // producer: warp 0
    hw::setmaxnreg_dec<40>();
    if (tid < 32) {
      const int lane = tid;
      int s = 0;
      uint32_t phase = 0, own_phase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const Item it = decode(item, k_tiles, H);
        if (lane == 0) {
          hw::mbar_wait(&sm.own_empty, own_phase ^ 1);
          hw::mbar_arrive_expect_tx(&sm.own_full, 2 * OWN_BYTES);
          hw::tma_load_4d(sm.k, &kmap, &sm.own_full, 0, it.h, it.tile * OWN, it.b);
          hw::tma_load_4d(sm.v, &vmap, &sm.own_full, 0, it.h, it.tile * OWN, it.b);
        }
        own_phase ^= 1;
        const long long stat = ((long long)it.b * H + it.h) * Nq;
        for (int j = 0; j < n_tiles; ++j) {
          hw::mbar_wait(&sm.empty[s], phase ^ 1);
          if (lane == 0) {  // the tiles first, so their transfer overlaps the lse / delta loads
            hw::mbar_arrive_expect_tx(&sm.full[s], 2 * LOOP_BYTES);
            hw::tma_load_4d(sm.q[s], &qmap, &sm.full[s], 0, it.h, j * LOOP, it.b);
            hw::tma_load_4d(sm.dout[s], &domap, &sm.full[s], 0, it.h, j * LOOP, it.b);
          }
#pragma unroll
          for (int i = lane; i < LOOP; i += 32) {
            const int qi = j * LOOP + i;
            sm.lse[s][i] = qi < Nq ? lse[stat + qi] * LOG2E : 0.f;
            sm.delta[s][i] = qi < Nq ? delta[stat + qi] : 0.f;
          }
          hw::mbar_arrive(&sm.full[s]);
          if (++s == STAGES) s = 0, phase ^= 1;
        }
      }
    }
  } else {  // consumers: 64 keys each
    hw::setmaxnreg_inc<232>();
    const int ctid = tid - 128, cwg = ctid >> 7, warp = (ctid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int my_turn = 1 + cwg, other_turn = 2 - cwg;  // ping-pong, as in dq
    if (cwg == 1) hw::named_bar_arrive(1, 256);
    int s = 0;
    uint32_t phase = 0, own_phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const Item it = decode(item, k_tiles, H);
      const bool last_item = item + gridDim.x >= n_items;
      const int key0 = it.tile * OWN + cwg * 64 + warp * 16 + g;  // this thread's keys: key0 and key0 + 8
      const int keys[2] = {key0, key0 + 8};
      float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      // p^T in place of s^T and ds^T in place of dp^T for the query tile in slot s; the column is the
      // query. No mask: a query past Nq has q = dO = 0 (TMA's zero fill) and lse = delta = 0, so p = 1 meets
      // dO = 0 and ds = 0; a key past Nk only fills rows of dk and dv that are not written.
      float st[LOOP / 2], dpt[LOOP / 2];
      auto p_ds_tile = [&](int slot) {
        const float* lse_s = sm.lse[slot];
        const float* delta_s = sm.delta[slot];
#pragma unroll
        for (int i = 0; i < LOOP / 2; ++i) {
          const int qc = (i >> 2) * 8 + 2 * t + (i & 1);
          const float p = hw::exp2_ftz(fmaf(st[i], scale_log2, -lse_s[qc]));
          dpt[i] = p * (dpt[i] - delta_s[qc]) * scale;
          st[i] = p;
        }
      };

      // k and v of this consumer's keys as register A operands; the own-tile buffer is then free.
      uint32_t ka[D / 16][4], va[D / 16][4];
      hw::mbar_wait(&sm.own_full, own_phase);
      hw::load_a_frags(ka, sm.k + cwg * 64 * D, warp, lane);
      hw::load_a_frags(va, sm.v + cwg * 64 * D, warp, lane);
      hw::mbar_arrive(&sm.own_empty);
      own_phase ^= 1;

      // Software pipeline inside the warpgroup: tile j's s^T and dp^T are issued, then tile j-1's
      // dv += p^T dO and dk += ds^T q, and the elementwise work of tile j runs while those run.
      uint32_t pa[LOOP / 16][4], sa[LOOP / 16][4];  // the previous tile's p^T and ds^T in bf16
      hw::mbar_wait(&sm.full[s], phase);
      hw::named_bar_sync(my_turn, 256);
      issue_pair(st, dpt, ka, hw::smem_u32(sm.q[s]), va, hw::smem_u32(sm.dout[s]));
      hw::named_bar_arrive(other_turn, 256);
      hw::wgmma_wait<0>();
      hw::fence_regs(st);
      hw::fence_regs(dpt);
      p_ds_tile(s);
      hw::pack_a<LOOP>(pa, st);
      hw::pack_a<LOOP>(sa, dpt);
      int prev = s;
      if (++s == STAGES) s = 0, phase ^= 1;
      for (int j = 1; j < n_tiles; ++j) {
        hw::mbar_wait(&sm.full[s], phase);
        hw::named_bar_sync(my_turn, 256);
        issue_pair(st, dpt, ka, hw::smem_u32(sm.q[s]), va, hw::smem_u32(sm.dout[s]));
        issue_dkv(dv_acc, dk_acc, pa, sa, hw::smem_u32(sm.dout[prev]), hw::smem_u32(sm.q[prev]));
        hw::named_bar_arrive(other_turn, 256);
        hw::wgmma_wait<1>();
        hw::fence_regs(st);
        hw::fence_regs(dpt);
        p_ds_tile(s);
        hw::wgmma_wait<0>();  // the previous tile's products are done: release its slot
        hw::fence_regs(dv_acc);
        hw::fence_regs(dk_acc);
        hw::mbar_arrive(&sm.empty[prev]);
        hw::pack_a<LOOP>(pa, st);
        hw::pack_a<LOOP>(sa, dpt);
        prev = s;
        if (++s == STAGES) s = 0, phase ^= 1;
      }
      hw::named_bar_sync(my_turn, 256);
      issue_dkv(dv_acc, dk_acc, pa, sa, hw::smem_u32(sm.dout[prev]), hw::smem_u32(sm.q[prev]));
      if (cwg == 0 || !last_item) hw::named_bar_arrive(other_turn, 256);
      hw::wgmma_wait<0>();
      hw::fence_regs(dv_acc);
      hw::fence_regs(dk_acc);
      hw::mbar_arrive(&sm.empty[prev]);

      const long long base = ((long long)it.b * Nk * H + it.h) * D;  // dk, dv are contiguous (B, Nk, H, D)
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const int col = c * 8 + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (keys[r] < Nk) {
            const long long off = base + (long long)keys[r] * H * D + col;
            *reinterpret_cast<uint32_t*>(dk + off) = hw::pack_bf16x2(dk_acc[4 * c + 2 * r], dk_acc[4 * c + 2 * r + 1]);
            *reinterpret_cast<uint32_t*>(dv + off) = hw::pack_bf16x2(dv_acc[4 * c + 2 * r], dv_acc[4 * c + 2 * r + 1]);
          }
        }
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

// The element strides (b, n, h) of a tensor from its tensor-map layout (byte strides of h, n, b).
static Strides layout_strides(const long long* L, int elem_bytes) {
  return Strides{L[6] / elem_bytes, L[5] / elem_bytes, L[4] / elem_bytes};
}

// dtype: 0 = float32, 1 = bfloat16. `layouts` holds eight tensor-map layouts, 11 ints each (hopper.cuh
// LAYOUT_INTS): q, k, v, dO with the dq kernel's boxes (128 query rows, 64 key rows), then k, v, q, dO with
// the dk/dv kernel's (128 key rows, 64 query rows); the fp32 kernels and the delta kernel take their element
// strides from them (d has unit stride). o is a contiguous (B, Nq, H, D) tensor, lse a contiguous (B, H, Nq)
// float32 tensor from the forward, delta a (B, H, Nq) float32 scratch tensor; dq (B, Nq, H, D) and dk, dv
// (B, Nk, H, D) are contiguous outputs in the input dtype. Launches the delta, dq and dk/dv kernels on the
// stream. Returns a cudaError_t.
extern "C" int uc_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                      const void* lse, void* delta, void* dq, void* dk, void* dv, int dtype, int B,
                                      int H, int Nq, int Nk, int head_dim, const long long* layouts, float scale,
                                      void* stream) {
  if (head_dim != D || B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const long long* L[8];
  for (int i = 0; i < 8; ++i) L[i] = layouts + i * hw::LAYOUT_INTS;
  const int es = dtype == 1 ? 2 : 4;
  const Strides qs = layout_strides(L[0], es), ks = layout_strides(L[1], es), vs = layout_strides(L[2], es),
                dos = layout_strides(L[3], es);
  const float scale_log2 = scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  const float* ls = static_cast<const float*>(lse);

  const long long rows = (long long)B * Nq * H;
  const long long want = (rows * (D * es / 16) + 255) / 256;  // one 16-byte vector per thread
  const int delta_blocks = (int)(want < 65536 ? want : 65536);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    CUtensorMap m[8];
    const int boxes[8] = {OWN, LOOP, LOOP, OWN, OWN, OWN, LOOP, LOOP};
    const void* bases[8] = {q, k, v, dout, k, v, q, dout};
    int status = 0;
    for (int i = 0; i < 8 && status == 0; ++i) status = hw::encode_tile_map(&m[i], bases[i], L[i], boxes[i]);
    static bool dq_set[64], dkv_set[64];
    constexpr int DQ_SMEM = smem_bytes<DqSmem>(), DKV_SMEM = smem_bytes<DkvSmem>();
    if (status == 0) status = hw::allow_smem(fa_bwd_dq_bf16_kernel, DQ_SMEM, dq_set);
    if (status == 0) status = hw::allow_smem(fa_bwd_dkv_bf16_kernel, DKV_SMEM, dkv_set);
    if (status != 0) return status;
    fa_bwd_delta_kernel<bf><<<delta_blocks, 256, 0, st>>>(static_cast<const bf*>(dout), static_cast<const bf*>(o), dl,
                                                            H, Nq, rows, dos);
    int sms = 0;
    status = hw::sm_count(&sms);
    if (status != 0) return status;
    const long long dq_items = (long long)((Nq + OWN - 1) / OWN) * H * B;
    const long long dkv_items = (long long)((Nk + OWN - 1) / OWN) * H * B;
    if (dq_items > 0x7fffffff || dkv_items > 0x7fffffff) return (int)cudaErrorInvalidValue;
    fa_bwd_dq_bf16_kernel<<<(int)(dq_items < sms ? dq_items : sms), THREADS, DQ_SMEM, st>>>(
        m[0], m[1], m[2], m[3], ls, dl, static_cast<bf*>(dq), B, H, Nq, Nk, scale, scale_log2);
    fa_bwd_dkv_bf16_kernel<<<(int)(dkv_items < sms ? dkv_items : sms), THREADS, DKV_SMEM, st>>>(
        m[6], m[4], m[5], m[7], ls, dl, static_cast<bf*>(dk), static_cast<bf*>(dv), B, H, Nq, Nk, scale, scale_log2);
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
