// Flash attention backward (non-causal, no mask) over (B, N, H, D) tensors, D a multiple of 8 up to 256
// (ops/flash_attention.py pads any other into a copy).
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
//   * fp32: see "fp32" below.
//   * q/k/v/dO are read through 4-D tensor maps (D, H, N, B) with their byte
//     strides (ops/flash_attention.py tma_layout), so the views of a fused qkv
//     projection need no copy; o, lse and the outputs are contiguous. TMA
//     fills rows past N with zeros: a padded query has zero q and dO, so it
//     adds nothing to dk and dv; padded keys get p = 0 in dq (fp32: padded
//     rows and keys get p = 0).
//   * Head dims. D <= 64 runs the kernels above on one 64-column TMA box per
//     tile (TMA writes zeros past D; D at run time, the columns written).
//   * 64 < D <= 256 (fa_bwd_dq_wide_kernel, fa_bwd_dkv_wide_kernel, built for
//     the padded head dim DP = 128, 192 or 256): whole-width accumulators. The
//     kernels they replace covered one 64-column chunk per work item,
//     recomputing s and dp over the whole DP for each (1.7x the minimum work at
//     D = 128, 2.5-3x at 256), in one issue order without overlap: 186 TFLOP/s
//     of the five products at (4,1024,1024,8,128), 1.99x SDPA's backward. What
//     bounds these kernels is the tensor cores' issue and, for the products
//     with both operands in shared memory, its bandwidth; not HBM. A work item
//     now covers 128 output columns: one chunk at DP = 128 (no recomputation),
//     two at 192 and 256 (s and dp twice: 1.25-1.5x the minimum), chunk fastest
//     so blocks working at one time share their tiles in L2. Each chunk is one
//     m64n128 product per k-step, its B operand the chunk's two 64-column boxes
//     read MN-major as the operand's two atoms; at DP = 192 the last chunk is one
//     box wide and its second atom is a box of zeros, because a run-time choice
//     between an m64n128 and an m64n64 product on one accumulator made ptxas
//     serialise every wgmma of the kernel (C7520; 0.264 -> 0.141 ms at
//     (2,1024,1024,8,192) when removed). A dq consumer holds dq's chunk (64
//     registers), s and dp (64) and ds as bf16 A fragments (16); at DP = 128 also
//     q and dO as register A operands (64), read once per item, so the own
//     tiles are free for the next item's loads at once (above 128 they stay in
//     shared memory). A dk/dv consumer holds dk's and dv's chunks (128), s^T and
//     dp^T (64), then p^T and ds^T as bf16 A fragments (32); k and v stay in
//     shared memory. Neither has the registers to overlap tile j + 1's s and dp
//     with tile j's register-A products, as the D <= 64 kernels do: tried in dq
//     at DP = 128, ptxas serialised the products (C7512) and spilled, and it ran
//     slower (0.1381-0.1402 against 0.1331-0.1350 ms at (4,1024,1024,8,128)). So
//     each consumer finishes tile j before it issues tile j + 1, and the two
//     consumers issue independently: strict turns (ping-pong), as in the D <= 64
//     kernels, measured 0.1644 against 0.1396 ms there (dq 0.0794 against 0.0561).
//     The producer warpgroup gives up its registers
//     (setmaxnreg.dec). The ring of 64-row loop tiles has 4, 2 or 1 slots at DP =
//     128, 192, 256 (what 200 KB leaves beside the own tiles). The plan and a
//     walk of the work items over every output row and column are in
//     tests/test_torch_kernel_layouts.py (k3_plan, k3_items). Measured on the
//     card: PERF.md section 6 (chip_smoke.py phase 47).
//   * Later work: one fused pass when a single tile covers all keys
//     (_fa_bwd_fused_kernel's 5-product shape), 128-row loop tiles, dq
//     accumulated in the dk/dv pass (which needs atomics or a reduction), the
//     own tiles of the next item loaded while the last one finishes.
//
// fp32 (fa_bwd_tf32_kernel<DP, DKV>, DP = 32, 64, 128 or 256; D at run time; D <= 16 keeps the CUDA-core kernels at
//   the end of this file, one row per pair of lanes: at the JAX training example's (16,4,4,4,16) they took 0.0122 ms
//   against the 3xTF32 kernels' 0.0182-0.0187 on an H100, PERF.md section 6): the Pallas kernels run fp32 at
//   Precision.HIGHEST. The CUDA-core kernels this replaces above D = 16 (one row per 2-8 lanes, a shuffle for every
//   dot product, each K/V row read for 64 queries) reached 0.30 of the FFMA peak at the fp32 trunk's
//   (4,1024,1024,16,64), 1.66x SDPA's fp32 backward. What bounds it now: the tensor cores' TF32 rate at three products
//   for each needed one (165 TFLOP/s of the five needed products), and the waits of the per-k-step chains below.
//   * Numerics: K1's fp32 kernel's (flash_attention.cu): each operand split into hi = tf32(x) and lo = tf32(x - hi),
//     each product taken as hi.lo' + lo.hi' + hi.hi' in that order, every 8-wide k-step a chain of its own into fresh
//     registers added to S, dP or the gradient in fp32 with round to nearest (chained sums truncate: chained over a
//     tile they biased fp32 training's near-cancelling gradients). p and ds are split in registers before the
//     products they feed; delta, p and ds as above. Within a 32-column box, and within a piece, the k-steps alternate
//     between two chain buffers (and two sets of A operands), so one k-step's products run while the last one's are
//     added. tests/test_torch_tf32_split.py emulates these numerics down to the tensor cores' truncation.
//   * Layouts: tf32 wgmma takes only K-major shared-memory operands, and three of the five products contract over
//     the rows (dq = ds k over the keys, dv = p^T dO and dk = ds^T q over the queries). A split pre-pass
//     (k3_split_kernel, launched by the same entry point) writes q, dO, k and v as (2, B H, N, D) hi/lo planes and
//     q, dO and k transposed, (2, B H, D, N8), rows contiguous and in t_key order within each 8 (the order the
//     register A operand of p, ds and their transposes holds them in), into a workspace the wrapper allocates
//     (ops/flash_attention.py k3_tf32_workspace_floats: 14 planes, 235 MB at the fp32 trunk's shape).
//   * Shape: the passes above (delta, then dq over 128-query units looping over 64-key tiles, then dk/dv over
//     128-key units looping over 64-query tiles), persistent, a TMA producer and two consumer warpgroups of 64 own
//     rows each, both reading every slot of the ring. S and dP are m64n64k8 products with both operands in shared
//     memory; the output products take p, ds or their transposes from registers and the transposed planes in pieces
//     of 64 (at DP = 32, 32) output columns. Up to DP = 64 the unit's own tiles (two tensors, hi and lo) stay resident
//     and a slot carries a loop tile's boxes; above, the own boxes travel through the ring beside the loop boxes (256
//     KB of them would not fit). A unit covers dq's whole width up to DP = 128 (128-column chunks above) and dk's and
//     dv's up to 64 (64-column chunks above: both whole at DP = 128 would not fit the registers). The plan is in
//     tests/test_torch_kernel_layouts.py (k3_f32_plan, k3_f32_items). Measured: PERF.md section 6 (chip_smoke.py
//     phase 47).

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

// delta[b, h, n] = sum_d dO[b, n, h, d] * O[b, n, h, d] in fp32. Each thread takes 16-byte vectors of a row (8 bf16
// or 4 fp32; D a multiple of the vector): `lanes` neighbouring lanes share a row (its vector count rounded up to a
// power of two, at most 32; 8 at D = 64 in bf16, 4 rows a warp), each taking every lanes-th vector, and add their
// sums by shuffle.
template <typename T>
__global__ void __launch_bounds__(256) fa_bwd_delta_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                                                           float* __restrict__ delta, int H, int Nq, int D, int lanes,
                                                           long long rows, Strides dos) {
  constexpr int VEC = 16 / sizeof(T);
  const int vecs = D / VEC, rows_per_warp = 32 / lanes;
  const int part = threadIdx.x % lanes, group = (threadIdx.x & 31) / lanes;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long step = (((long long)gridDim.x * blockDim.x) >> 5) * rows_per_warp;
  for (long long r0 = warp * rows_per_warp; r0 < rows; r0 += step) {  // the same trip count for the whole warp
    const long long r = r0 + group;  // (b * Nq + n) * H + h, o's row order
    float s = 0.f;
    int b = 0, n = 0, h = 0;
    if (r < rows) {
      const long long bn = r / H;
      h = (int)(r - bn * H), n = (int)(bn % Nq), b = (int)(bn / Nq);
      for (int v = part; v < vecs; v += lanes) {
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + b * dos.b + n * dos.n + h * dos.h + v * VEC);
        const uint4 ov = *reinterpret_cast<const uint4*>(o + r * D + v * VEC);
        const T* de = reinterpret_cast<const T*>(&dv);
        const T* oe = reinterpret_cast<const T*>(&ov);
#pragma unroll
        for (int i = 0; i < VEC; ++i) s = fmaf(to_f(de[i]), to_f(oe[i]), s);
      }
    }
    for (int off = lanes / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (r < rows && part == 0) delta[((long long)b * H + h) * Nq + n] = s;
  }
}

// The lanes of a row in fa_bwd_delta_kernel: its 16-byte vectors rounded up to a power of two, at most 32.
int delta_lanes(int D, int elem_bytes) {
  int lanes = 1;
  while (lanes < 32 && lanes * 16 < D * elem_bytes) lanes <<= 1;
  return lanes;
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int THREADS = 384;             // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = THREADS - 128;
constexpr int OWN = 128;                 // the block's own rows: queries in dq, keys in dk/dv (2 x 64)
constexpr int LOOP = 64;                 // rows of each tile the block loops over
constexpr int STAGES = 4;
constexpr int BOX = 64;                  // columns of a TMA box (128 bytes: one 128-byte swizzle row)
constexpr int OWN_BYTES = OWN * BOX * 2, LOOP_BYTES = LOOP * BOX * 2;  // one box of an own / loop tile

struct alignas(hw::SMEM_ALIGN) DqSmem {
  __nv_bfloat16 q[OWN * BOX], dout[OWN * BOX];
  __nv_bfloat16 k[STAGES][LOOP * BOX], v[STAGES][LOOP * BOX];
  uint64_t own_full, own_empty, full[STAGES], empty[STAGES];
};

struct alignas(hw::SMEM_ALIGN) DkvSmem {
  __nv_bfloat16 k[OWN * BOX], v[OWN * BOX];
  __nv_bfloat16 q[STAGES][LOOP * BOX], dout[STAGES][LOOP * BOX];
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
__device__ __forceinline__ void issue_pair(float (&x)[LOOP / 2], float (&y)[LOOP / 2], const uint32_t (&a)[BOX / 16][4],
                                           uint32_t b, const uint32_t (&c)[BOX / 16][4], uint32_t d) {
  hw::fence_regs(x);
  hw::fence_regs(y);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BOX / 16; ++kk) {
    hw::wgmma_m64n64k16_rs<0>(x, a[kk], hw::desc_k_major(b + kk * 32), kk > 0);
    hw::wgmma_m64n64k16_rs<0>(y, c[kk], hw::desc_k_major(d + kk * 32), kk > 0);
  }
  hw::wgmma_commit();
}

// dq += ds k for one consumer's 64 rows: 4 k-steps of 16 keys, ds from registers, k read MN-major (rows =
// keys). One wgmma group.
__device__ __forceinline__ void issue_ds_k(float (&acc)[BOX / 2], uint32_t (&a)[LOOP / 16][4], uint32_t k_addr) {
  hw::fence_regs(acc);
  hw::fence_regs(a);
  hw::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < LOOP / 16; ++kc)
    hw::wgmma_m64n64k16_rs<1>(acc, a[kc], hw::desc_mn_major(k_addr + kc * 16 * BOX * 2), 1);
  hw::wgmma_commit();
}

// dv += p^T dO and dk += ds^T q for one consumer's 64 keys: 4 k-steps of 16 queries, p^T and ds^T from
// registers, dO and q read MN-major (rows = queries). One wgmma group.
__device__ __forceinline__ void issue_dkv(float (&dv_acc)[BOX / 2], float (&dk_acc)[BOX / 2], uint32_t (&pa)[LOOP / 16][4],
                                          uint32_t (&sa)[LOOP / 16][4], uint32_t do_addr, uint32_t q_addr) {
  hw::fence_regs(dv_acc);
  hw::fence_regs(dk_acc);
  hw::fence_regs(pa);
  hw::fence_regs(sa);
  hw::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < LOOP / 16; ++kc) {
    hw::wgmma_m64n64k16_rs<1>(dv_acc, pa[kc], hw::desc_mn_major(do_addr + kc * 16 * BOX * 2), 1);
    hw::wgmma_m64n64k16_rs<1>(dk_acc, sa[kc], hw::desc_mn_major(q_addr + kc * 16 * BOX * 2), 1);
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
// buffer at once), which hides each item's pipeline fill and epilogue. D = DS when DS is not 0 (64, built as a
// constant, as the forward's), else head_dim.
template <int DS>
__global__ void __launch_bounds__(THREADS, 1) fa_bwd_dq_bf16_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int B, int H,
    int Nq, int Nk, int head_dim, float scale, float scale_log2) {
  const int D = DS > 0 ? DS : head_dim;
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
      float acc[BOX / 2];
#pragma unroll
      for (int i = 0; i < BOX / 2; ++i) acc[i] = 0.f;
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
      uint32_t qa[BOX / 16][4], da[BOX / 16][4];
      hw::mbar_wait(&sm.own_full, own_phase);
      hw::load_a_frags(qa, sm.q + cwg * 64 * BOX, warp, lane);
      hw::load_a_frags(da, sm.dout + cwg * 64 * BOX, warp, lane);
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
      for (int c = 0; c < BOX / 8; ++c) {
        const int col = c * 8 + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (rows[r] < Nq && c * 8 < D)  // the columns past D are TMA's zeros
            *reinterpret_cast<uint32_t*>(op + (long long)rows[r] * H * D + col) =
                hw::pack_bf16x2(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
      }
    }
  }
}

// dk and dv: a persistent kernel whose work items are 128-key tiles; each loops over 64-query tiles. The
// producer runs ahead across items as in dq; D as in dq.
template <int DS>
__global__ void __launch_bounds__(THREADS, 1) fa_bwd_dkv_bf16_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int B, int H, int Nq, int Nk, int head_dim, float scale, float scale_log2) {
  const int D = DS > 0 ? DS : head_dim;
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
      float dk_acc[BOX / 2], dv_acc[BOX / 2];
#pragma unroll
      for (int i = 0; i < BOX / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
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
      uint32_t ka[BOX / 16][4], va[BOX / 16][4];
      hw::mbar_wait(&sm.own_full, own_phase);
      hw::load_a_frags(ka, sm.k + cwg * 64 * BOX, warp, lane);
      hw::load_a_frags(va, sm.v + cwg * 64 * BOX, warp, lane);
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
      for (int c = 0; c < BOX / 8; ++c) {
        const int col = c * 8 + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (keys[r] < Nk && c * 8 < D) {  // the columns past D are TMA's zeros
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
// bf16 at 64 < D <= 256: whole-width accumulators on the pipeline above (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int W_RING_BYTES = 200 * 1024;  // own tiles and the ring of loop tiles
constexpr int W_CHUNK = 128;              // output columns a work item covers: two 64-column boxes

// The kernels built for the padded head dim DP (128, 192 or 256): DP / 64 boxes per tile; a work item covers one
// 128-column chunk of its outputs (the last one 64 columns at DP = 192).
template <int DP>
struct WideCfg {
  static constexpr int BOXES = DP / BOX;
  static constexpr int OWN_TILE = OWN * DP * 2, LOOP_TILE = LOOP * DP * 2;  // bytes of one own / loop tile
  static constexpr int STAGES = (W_RING_BYTES - 2 * OWN_TILE) / (2 * LOOP_TILE);  // 4, 2 or 1
  static_assert(STAGES >= 1, "a ring slot");
};

template <int DP>
struct alignas(hw::SMEM_ALIGN) WideBwdSmem {
  __nv_bfloat16 own0[OWN * DP], own1[OWN * DP];  // q and dO (dq), k and v (dk/dv)
  __nv_bfloat16 loop0[WideCfg<DP>::STAGES][LOOP * DP], loop1[WideCfg<DP>::STAGES][LOOP * DP];  // k, v / q, dO
  // DP = 192: one 64-column box of zeros, the second atom of the last chunk's products (see issue_chunk)
  __nv_bfloat16 zeros[DP == 192 ? LOOP * BOX : 8];
  float lse[WideCfg<DP>::STAGES][LOOP], delta[WideCfg<DP>::STAGES][LOOP];  // dk/dv: lse in log2 units, 0 past Nq
  uint64_t own_full, own_empty, full[WideCfg<DP>::STAGES], empty[WideCfg<DP>::STAGES];
};

// Zero DP = 192's box of zeros (every thread a part) before the block's first product reads it; the caller then
// synchronises the block.
template <int DP>
__device__ __forceinline__ void zero_box(WideBwdSmem<DP>& sm) {
  if constexpr (DP == 192) {
    for (int i = threadIdx.x; i < LOOP * BOX / 8; i += blockDim.x) reinterpret_cast<uint4*>(sm.zeros)[i] = uint4{0, 0, 0, 0};
    hw::fence_proxy_async();
  }
}

// The byte offset from a chunk's first box in a loop tile (at m_addr) to its second: the next box, or at DP = 192
// for the last chunk, which is one box wide, the box of zeros, so that every chunk is one m64n128 product (a run-time
// choice between an m64n128 and an m64n64 product on one accumulator makes ptxas serialise every wgmma).
template <int DP>
__device__ __forceinline__ uint32_t second_atom(const WideBwdSmem<DP>& sm, uint32_t m_addr, int chunk) {
  if constexpr (DP == 192) {
    if (chunk == 1) return hw::smem_u32(sm.zeros) - m_addr;
  }
  return LOOP * BOX * 2;
}

// A tile's DP / 64 boxes of `rows` rows at rows row0 of head h, batch b, side by side in dst.
template <int DP>
__device__ __forceinline__ void load_boxes(__nv_bfloat16* dst, const CUtensorMap* map, uint64_t* bar, int rows,
                                           int h, int row0, int b) {
#pragma unroll
  for (int box = 0; box < WideCfg<DP>::BOXES; ++box)
    hw::tma_load_4d(dst + box * rows * BOX, map, bar, box * BOX, h, row0, b);
}

// x = a b^T and y = c d^T over the whole padded head dim for one consumer's 64 own rows and a 64-row loop tile:
// DP / 16 k-steps of 16, every operand K-major in shared memory (box kk / 4, 32 bytes a k-step inside its swizzled
// rows); a and c are the consumer's rows of the own tiles (OWN rows a box), b and d the loop tiles (LOOP rows a
// box). One wgmma group, committed.
template <int DP>
__device__ __forceinline__ void issue_pair_ss(float (&x)[LOOP / 2], float (&y)[LOOP / 2], uint32_t a, uint32_t b,
                                              uint32_t c, uint32_t d) {
  hw::fence_regs(x);
  hw::fence_regs(y);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t own = (kk / 4) * OWN * BOX * 2 + (kk % 4) * 32, loop = (kk / 4) * LOOP * BOX * 2 + (kk % 4) * 32;
    hw::wgmma_m64n64k16_ss<0, 0>(x, hw::desc_k_major(a + own), hw::desc_k_major(b + loop), kk > 0);
    hw::wgmma_m64n64k16_ss<0, 0>(y, hw::desc_k_major(c + own), hw::desc_k_major(d + loop), kk > 0);
  }
  hw::wgmma_commit();
}

// The same with a and c from registers (the consumer's own rows of a DP = 128 tile, read once per item): only b and
// d are read from shared memory. One wgmma group, committed.
template <int DP>
__device__ __forceinline__ void issue_pair_rs(float (&x)[LOOP / 2], float (&y)[LOOP / 2],
                                              const uint32_t (&a)[DP / 16][4], uint32_t b,
                                              const uint32_t (&c)[DP / 16][4], uint32_t d) {
  hw::fence_regs(x);
  hw::fence_regs(y);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t loop = (kk / 4) * LOOP * BOX * 2 + (kk % 4) * 32;
    hw::wgmma_m64n64k16_rs<0>(x, a[kk], hw::desc_k_major(b + loop), kk > 0);
    hw::wgmma_m64n64k16_rs<0>(y, c[kk], hw::desc_k_major(d + loop), kk > 0);
  }
  hw::wgmma_commit();
}

// acc += a m[:, chunk] over 4 k-steps of 16 loop rows: a from registers (ds or p^T, ds^T in bf16), m read MN-major
// from the chunk's boxes of a loop tile (m_addr: its first box; LOOP rows a box; `atom`: the byte offset of its
// second, second_atom), one m64n128 product per k-step. Not committed: the caller may add another product to the group.
__device__ __forceinline__ void issue_chunk(float (&acc)[W_CHUNK / 2], uint32_t (&a)[LOOP / 16][4], uint32_t m_addr,
                                            uint32_t atom) {
#pragma unroll
  for (int kc = 0; kc < LOOP / 16; ++kc)
    hw::wgmma_m64n128k16_rs<1>(acc, a[kc], hw::desc_mn_major(m_addr + kc * 16 * BOX * 2, atom), 1);
}

// The persistent kernels' work item: (128-column chunk, 128-row own tile, head, batch), chunk fastest, so the blocks
// working at one time share their own and loop tiles in L2.
struct WideItem {
  int chunk, tile, h, b;
};
__device__ __forceinline__ WideItem decode_wide(int item, int chunks, int tiles, int H) {
  const int rest = item / chunks;
  return WideItem{item % chunks, rest % tiles, (rest / tiles) % H, rest / (tiles * H)};
}

// dq, D > 64: items of one 128-column chunk of dq over 128 queries, each looping over 64-key tiles: tile j's s and dp,
// then ds, then dq += ds k[:, chunk], before tile j + 1's products are issued (overlapping tile j + 1's s and dp with
// tile j's dq product, as the D <= 64 kernel does, takes more registers than a consumer has here: ptxas then
// serialised the products and spilled). The two consumers issue independently (PERF.md section 6).
template <int DP>
__global__ void __launch_bounds__(THREADS, 1) fa_bwd_dq_wide_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int B, int H,
    int Nq, int Nk, int D, float scale, float scale_log2) {
  using Cfg = WideCfg<DP>;
  constexpr int ST = Cfg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  WideBwdSmem<DP>& sm = *reinterpret_cast<WideBwdSmem<DP>*>(hw::align_smem(smem_raw));
  const int tid = threadIdx.x;
  const int chunks = (D + W_CHUNK - 1) / W_CHUNK, q_tiles = (Nq + OWN - 1) / OWN, n_items = chunks * q_tiles * H * B;
  const int n_tiles = (Nk + LOOP - 1) / LOOP;
  if (tid == 0) {
    hw::mbar_init(&sm.own_full, 1);
    hw::mbar_init(&sm.own_empty, CONSUMERS);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      hw::mbar_init(&sm.full[s], 1);
      hw::mbar_init(&sm.empty[s], CONSUMERS);
    }
    hw::fence_barrier_init();
  }
  zero_box<DP>(sm);
  __syncthreads();

  if (tid < 128) {  // producer
    hw::setmaxnreg_dec<40>();
    if (tid == 0) {
      int s = 0;
      uint32_t phase = 0, own_phase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const WideItem it = decode_wide(item, chunks, q_tiles, H);
        hw::mbar_wait(&sm.own_empty, own_phase ^ 1);  // the consumers are done with the last item's own tiles
        hw::mbar_arrive_expect_tx(&sm.own_full, 2 * Cfg::OWN_TILE);
        load_boxes<DP>(sm.own0, &qmap, &sm.own_full, OWN, it.h, it.tile * OWN, it.b);
        load_boxes<DP>(sm.own1, &domap, &sm.own_full, OWN, it.h, it.tile * OWN, it.b);
        own_phase ^= 1;
        for (int j = 0; j < n_tiles; ++j) {
          hw::mbar_wait(&sm.empty[s], phase ^ 1);
          hw::mbar_arrive_expect_tx(&sm.full[s], 2 * Cfg::LOOP_TILE);
          load_boxes<DP>(sm.loop0[s], &kmap, &sm.full[s], LOOP, it.h, j * LOOP, it.b);
          load_boxes<DP>(sm.loop1[s], &vmap, &sm.full[s], LOOP, it.h, j * LOOP, it.b);
          if (++s == ST) s = 0, phase ^= 1;
        }
      }
    }
  } else {  // consumers: 64 queries each
    hw::setmaxnreg_inc<232>();
    const int ctid = tid - 128, cwg = ctid >> 7, warp = (ctid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_addr = hw::smem_u32(sm.own0) + cwg * 64 * BOX * 2, do_addr = hw::smem_u32(sm.own1) + cwg * 64 * BOX * 2;
    int s = 0;
    uint32_t phase = 0, own_phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const WideItem it = decode_wide(item, chunks, q_tiles, H);
      const uint32_t box = 2 * it.chunk * LOOP * BOX * 2;  // the chunk's first box in a loop tile
      const int row0 = it.tile * OWN + cwg * 64 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
      const int rows[2] = {row0, row0 + 8};
      const long long stat = ((long long)it.b * H + it.h) * Nq;
      float lse2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = rows[r] < Nq ? lse[stat + rows[r]] * LOG2E : 0.f;
        dl[r] = rows[r] < Nq ? delta[stat + rows[r]] : 0.f;
      }
      float acc[W_CHUNK / 2];  // dq's chunk: m64n128
#pragma unroll
      for (int i = 0; i < W_CHUNK / 2; ++i) acc[i] = 0.f;
      float sc[LOOP / 2], dp[LOOP / 2];
      auto ds_tile = [&](int k0) {  // ds = p * (dp - delta) * scale; keys past Nk get p = 0, as in the D <= 64 kernel
        const bool ragged = k0 + LOOP > Nk;
#pragma unroll
        for (int i = 0; i < LOOP / 2; ++i) {
          const int r = (i >> 1) & 1;
          float p = hw::exp2_ftz(fmaf(sc[i], scale_log2, -lse2[r]));
          if (ragged && k0 + (i >> 2) * 8 + 2 * t + (i & 1) >= Nk) p = 0.f;
          sc[i] = p * (dp[i] - dl[r]) * scale;
        }
      };
      auto issue_dq = [&](uint32_t (&a)[LOOP / 16][4], int slot) {
        hw::fence_regs(acc);
        hw::fence_regs(a);
        hw::wgmma_fence();
        const uint32_t m_addr = hw::smem_u32(sm.loop0[slot]) + box;
        issue_chunk(acc, a, m_addr, second_atom<DP>(sm, m_addr, it.chunk));
        hw::wgmma_commit();
      };

      uint32_t a[LOOP / 16][4];  // ds in bf16: the register A operand of ds k
      hw::mbar_wait(&sm.own_full, own_phase);
      own_phase ^= 1;
      // DP = 128: q and dO as register A operands, read once, so the own tiles are free for the next item's loads at
      // once; above, they stay in shared memory for the item (the registers hold dq's chunk, s, dp and ds).
      constexpr int QF = DP == 128 ? DP / 16 : 1;
      uint32_t qa[QF][4], da[QF][4];
      if constexpr (DP == 128) {
#pragma unroll
        for (int bx = 0; bx < DP / BOX; ++bx) {
          hw::load_a_frags(*reinterpret_cast<uint32_t(*)[4][4]>(&qa[4 * bx]), sm.own0 + (bx * OWN + cwg * 64) * BOX,
                           warp, lane);
          hw::load_a_frags(*reinterpret_cast<uint32_t(*)[4][4]>(&da[4 * bx]), sm.own1 + (bx * OWN + cwg * 64) * BOX,
                           warp, lane);
        }
        hw::mbar_arrive(&sm.own_empty);
      }
      for (int j = 0; j < n_tiles; ++j) {
        hw::mbar_wait(&sm.full[s], phase);
        if constexpr (DP == 128)
          issue_pair_rs<DP>(sc, dp, qa, hw::smem_u32(sm.loop0[s]), da, hw::smem_u32(sm.loop1[s]));
        else
          issue_pair_ss<DP>(sc, dp, q_addr, hw::smem_u32(sm.loop0[s]), do_addr, hw::smem_u32(sm.loop1[s]));
        hw::wgmma_wait<0>();
        hw::fence_regs(sc);
        hw::fence_regs(dp);
        if (DP != 128 && j == n_tiles - 1) hw::mbar_arrive(&sm.own_empty);  // the item's last read of q and dO
        ds_tile(j * LOOP);
        hw::pack_a<LOOP>(a, sc);
        issue_dq(a, s);
        hw::wgmma_wait<0>();
        hw::fence_regs(acc);
        hw::mbar_arrive(&sm.empty[s]);
        if (++s == ST) s = 0, phase ^= 1;
      }

      __nv_bfloat16* op = dq + ((long long)it.b * Nq * H + it.h) * D + it.chunk * W_CHUNK;  // dq: contiguous (B, Nq, H, D)
#pragma unroll
      for (int c = 0; c < W_CHUNK / 8; ++c) {
        const int col = c * 8 + 2 * t;
        if (it.chunk * W_CHUNK + c * 8 >= D) continue;  // the columns past D: the zero fill's, or the box of zeros'
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (rows[r] < Nq)
            *reinterpret_cast<uint32_t*>(op + (long long)rows[r] * H * D + col) =
                hw::pack_bf16x2(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
      }
    }
  }
}

// dk and dv, D > 64: items of one 128-column chunk of dk and dv over 128 keys, each looping over 64-query tiles
// (with their lse and delta, staged in the slot by the producer warp as in the D <= 64 kernel). A consumer holds its
// keys' dk and dv chunks (m64n128 each), so tile j's s^T and dp^T are formed and used before tile j + 1's are issued
// (no overlap inside a consumer; the two consumers issue independently). s^T and dp^T read the own k and v from shared
// memory over the whole DP.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1) fa_bwd_dkv_wide_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int B, int H, int Nq, int Nk, int D, float scale, float scale_log2) {
  using Cfg = WideCfg<DP>;
  constexpr int ST = Cfg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  WideBwdSmem<DP>& sm = *reinterpret_cast<WideBwdSmem<DP>*>(hw::align_smem(smem_raw));
  const int tid = threadIdx.x;
  const int chunks = (D + W_CHUNK - 1) / W_CHUNK, k_tiles = (Nk + OWN - 1) / OWN, n_items = chunks * k_tiles * H * B;
  const int n_tiles = (Nq + LOOP - 1) / LOOP;
  if (tid == 0) {
    hw::mbar_init(&sm.own_full, 1);
    hw::mbar_init(&sm.own_empty, CONSUMERS);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      hw::mbar_init(&sm.full[s], 33);  // lane 0 with the TMA bytes, then the producer warp's 32 lanes
      hw::mbar_init(&sm.empty[s], CONSUMERS);
    }
    hw::fence_barrier_init();
  }
  zero_box<DP>(sm);
  __syncthreads();

  if (tid < 128) {  // producer: warp 0
    hw::setmaxnreg_dec<40>();
    if (tid < 32) {
      const int lane = tid;
      int s = 0;
      uint32_t phase = 0, own_phase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const WideItem it = decode_wide(item, chunks, k_tiles, H);
        if (lane == 0) {
          hw::mbar_wait(&sm.own_empty, own_phase ^ 1);
          hw::mbar_arrive_expect_tx(&sm.own_full, 2 * Cfg::OWN_TILE);
          load_boxes<DP>(sm.own0, &kmap, &sm.own_full, OWN, it.h, it.tile * OWN, it.b);
          load_boxes<DP>(sm.own1, &vmap, &sm.own_full, OWN, it.h, it.tile * OWN, it.b);
        }
        own_phase ^= 1;
        const long long stat = ((long long)it.b * H + it.h) * Nq;
        for (int j = 0; j < n_tiles; ++j) {
          hw::mbar_wait(&sm.empty[s], phase ^ 1);
          if (lane == 0) {
            hw::mbar_arrive_expect_tx(&sm.full[s], 2 * Cfg::LOOP_TILE);
            load_boxes<DP>(sm.loop0[s], &qmap, &sm.full[s], LOOP, it.h, j * LOOP, it.b);
            load_boxes<DP>(sm.loop1[s], &domap, &sm.full[s], LOOP, it.h, j * LOOP, it.b);
          }
#pragma unroll
          for (int i = lane; i < LOOP; i += 32) {
            const int qi = j * LOOP + i;
            sm.lse[s][i] = qi < Nq ? lse[stat + qi] * LOG2E : 0.f;
            sm.delta[s][i] = qi < Nq ? delta[stat + qi] : 0.f;
          }
          hw::mbar_arrive(&sm.full[s]);
          if (++s == ST) s = 0, phase ^= 1;
        }
      }
    }
  } else {  // consumers: 64 keys each
    hw::setmaxnreg_inc<232>();
    const int ctid = tid - 128, cwg = ctid >> 7, warp = (ctid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t k_addr = hw::smem_u32(sm.own0) + cwg * 64 * BOX * 2, v_addr = hw::smem_u32(sm.own1) + cwg * 64 * BOX * 2;
    int s = 0;
    uint32_t phase = 0, own_phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const WideItem it = decode_wide(item, chunks, k_tiles, H);
      const uint32_t box = 2 * it.chunk * LOOP * BOX * 2;  // the chunk's first box in a loop tile
      const int key0 = it.tile * OWN + cwg * 64 + warp * 16 + g;  // this thread's keys: key0 and key0 + 8
      const int keys[2] = {key0, key0 + 8};
      float dk_acc[W_CHUNK / 2], dv_acc[W_CHUNK / 2];  // the chunk of dk and dv
#pragma unroll
      for (int i = 0; i < W_CHUNK / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      hw::mbar_wait(&sm.own_full, own_phase);
      own_phase ^= 1;
      for (int j = 0; j < n_tiles; ++j) {
        float st[LOOP / 2], dpt[LOOP / 2];
        uint32_t pa[LOOP / 16][4], sa[LOOP / 16][4];
        hw::mbar_wait(&sm.full[s], phase);
        const uint32_t q_addr = hw::smem_u32(sm.loop0[s]), do_addr = hw::smem_u32(sm.loop1[s]);
        issue_pair_ss<DP>(st, dpt, k_addr, q_addr, v_addr, do_addr);
        hw::wgmma_wait<0>();
        hw::fence_regs(st);
        hw::fence_regs(dpt);
        if (j == n_tiles - 1) hw::mbar_arrive(&sm.own_empty);  // the item's last read of k and v
        // p^T and ds^T; no mask, as in the D <= 64 kernel (a query past Nq has q = dO = 0 and lse = delta = 0)
#pragma unroll
        for (int i = 0; i < LOOP / 2; ++i) {
          const int qc = (i >> 2) * 8 + 2 * t + (i & 1);
          const float p = hw::exp2_ftz(fmaf(st[i], scale_log2, -sm.lse[s][qc]));
          dpt[i] = p * (dpt[i] - sm.delta[s][qc]) * scale;
          st[i] = p;
        }
        hw::pack_a<LOOP>(pa, st);
        hw::pack_a<LOOP>(sa, dpt);
        hw::fence_regs(dv_acc);
        hw::fence_regs(dk_acc);
        hw::fence_regs(pa);
        hw::fence_regs(sa);
        hw::wgmma_fence();
        issue_chunk(dv_acc, pa, do_addr + box, second_atom<DP>(sm, do_addr + box, it.chunk));  // dv += p^T dO[:, chunk]
        issue_chunk(dk_acc, sa, q_addr + box, second_atom<DP>(sm, q_addr + box, it.chunk));   // dk += ds^T q[:, chunk]
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(dv_acc);
        hw::fence_regs(dk_acc);
        hw::mbar_arrive(&sm.empty[s]);
        if (++s == ST) s = 0, phase ^= 1;
      }

      const long long base = ((long long)it.b * Nk * H + it.h) * D + it.chunk * W_CHUNK;  // dk, dv: contiguous (B, Nk, H, D)
#pragma unroll
      for (int c = 0; c < W_CHUNK / 8; ++c) {
        const int col = c * 8 + 2 * t;
        if (it.chunk * W_CHUNK + c * 8 >= D) continue;
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
// fp32 at D > 16: error-compensated TF32 (3xTF32) on wgmma (see "fp32" in the note at the top)
// ---------------------------------------------------------------------------

constexpr int F_BOX = 32;                  // fp32 columns of a TMA box: one 128-byte swizzle row
constexpr int F_OWN = 128;                 // own rows per unit: 64 per consumer
constexpr int F_LOOP = 64;                 // rows of each loop tile
constexpr int F_RING_BYTES = 224 * 1024;   // the resident own tiles and the ring
constexpr int F_PREP_THREADS = 256;
constexpr int F32_SMALL_DP = 16;           // D <= 16 keeps the CUDA-core kernels below

// The position of loop row p (0-7) of an 8-row group in a transposed plane: the register A operand of an 8-wide
// k-step holds the accumulator's columns 2t and 2t + 1 in its columns t and t + 4 (flash_attention.cu vt_key).
__host__ __device__ constexpr int t_key(int p) { return p < 4 ? 2 * p : 2 * p - 7; }

// The kernels built for the padded head dim DP (32, 64, 128 or 256), dq (DKV false) or dk/dv (DKV true). A unit is
// 128 own rows (64 per consumer) and NCO of the output's columns; the loop tiles are 64 rows. Up to DP = 64 (RES) the
// unit's own tiles, both tensors in hi and lo, stay in shared memory, and a ring slot carries SC columns of a loop tile
// (an S step) or NP rows of a transposed plane (a piece of the output product); above, the own boxes travel through the
// ring with the loop boxes, 32 columns an S step.
template <int DP, bool DKV>
struct Tf32BwdCfg {
  static constexpr bool RES = DP <= 64;
  static constexpr int NCO = DKV ? (DP < 64 ? DP : 64) : (DP < 128 ? DP : 128);  // output columns a unit covers
  static constexpr int NP = DP < 64 ? DP : 64;          // output columns a piece
  static constexpr int SC = RES ? DP : F_BOX;           // D columns an S step
  static constexpr int OWN_BOX = 2 * F_OWN * 128;       // a 32-column box of an own tensor, hi and lo
  static constexpr int LOOP_BOX = 2 * F_LOOP * 128;     // a 32-column box of a loop tensor, hi and lo
  static constexpr int PIECE = 2 * 2 * NP * 128;        // NP rows of a transposed plane over a loop tile, hi and lo
  static constexpr int SSTEP = RES ? (SC / F_BOX) * LOOP_BOX : OWN_BOX + LOOP_BOX;
  static constexpr int SLOT = SSTEP > PIECE ? SSTEP : PIECE;
  static constexpr int OWN_BYTES = RES ? 2 * (DP / F_BOX) * OWN_BOX : 0;
  static constexpr int STAGES = (F_RING_BYTES - OWN_BYTES) / SLOT;
  static constexpr int BAR_OFF = OWN_BYTES + STAGES * SLOT;
  static constexpr int SMEM = BAR_OFF + 8 * (2 + 2 * STAGES) + hw::SMEM_ALIGN;
  static constexpr int ACC = (DKV ? 2 : 1) * NCO / 2;    // accumulator registers a consumer thread
  static_assert(STAGES >= 3 && SMEM <= 232448, "the block's shared memory");
};

// x = the three products of k-step kk (8 columns of a 32-column box) of A B^T for one consumer's 64 rows and a 64-row
// loop tile: hi.lo, lo.hi, then hi.hi, both operands K-major in shared memory. One wgmma group, committed.
__device__ __forceinline__ void tf32_ss_kstep(float (&x)[F_LOOP / 2], uint32_t ah, uint32_t al, uint32_t bh, uint32_t bl,
                                              int kk) {
  hw::fence_regs(x);
  hw::wgmma_fence();
  hw::wgmma_m64n64k8_tf32_ss(x, hw::desc_k_major(ah + kk * 32), hw::desc_k_major(bl + kk * 32), 0);
  hw::wgmma_m64n64k8_tf32_ss(x, hw::desc_k_major(al + kk * 32), hw::desc_k_major(bh + kk * 32), 1);
  hw::wgmma_m64n64k8_tf32_ss(x, hw::desc_k_major(ah + kk * 32), hw::desc_k_major(bh + kk * 32), 1);
  hw::wgmma_commit();
}

// x = the three products of k-step kc (8 loop rows) of X^T-piece: a hi and lo from registers, the piece's transposed
// plane K-major (bh: its hi part, bl: its lo part, each two 32-row boxes of NP rows). One wgmma group, committed.
template <int NP>
__device__ __forceinline__ void tf32_rs_kstep(float (&y)[NP / 2], uint32_t (&ah)[4], uint32_t (&al)[4], uint32_t bh,
                                              uint32_t bl, int kc) {
  const uint32_t off = (kc / 4) * NP * 128 + (kc % 4) * 32;
  hw::fence_regs(y);
  hw::wgmma_fence();
  if constexpr (NP == 64) {
    hw::wgmma_m64n64k8_tf32_rs(y, ah, hw::desc_k_major(bl + off), 0);
    hw::wgmma_m64n64k8_tf32_rs(y, al, hw::desc_k_major(bh + off), 1);
    hw::wgmma_m64n64k8_tf32_rs(y, ah, hw::desc_k_major(bh + off), 1);
  } else {
    hw::wgmma_m64n32k8_tf32_rs(y, ah, hw::desc_k_major(bl + off), 0);
    hw::wgmma_m64n32k8_tf32_rs(y, al, hw::desc_k_major(bh + off), 1);
    hw::wgmma_m64n32k8_tf32_rs(y, ah, hw::desc_k_major(bh + off), 1);
  }
  hw::wgmma_commit();
}

// The chain in x added to acc in fp32 (round to nearest), once it has landed: the chain issued last may still run
// (PENDING = 1) or none (0).
template <int PENDING, int N>
__device__ __forceinline__ void add_products(float* acc, float (&x)[N]) {
  hw::wgmma_wait<PENDING>();
  hw::fence_regs(x);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += x[i];
}

// acc = A B^T over the first D columns, for one consumer's 64 own rows and the loop tile in the ring: ceil(D / SC) S
// steps of the ring, each 8-wide k-step its own chain (tf32_ss_kstep) added to acc. Within a 32-column box the k-steps
// alternate between the chain buffers x0 and x1, so that one k-step's products run while the last one's are added.
// own: the own tensor's hi boxes (RES; its lo boxes F_OWN rows further, boxes OWN_BOX apart), else unused (the own
// box is in the slot).
template <int DP, bool DKV>
__device__ __forceinline__ void tf32_bwd_product(float (&acc)[F_LOOP / 2], float (&x0)[F_LOOP / 2],
                                                 float (&x1)[F_LOOP / 2], uint64_t* full, uint64_t* empty,
                                                 uint32_t ring, uint32_t own, int cwg, int D, int& s,
                                                 uint32_t& phase) {
  using Cfg = Tf32BwdCfg<DP, DKV>;
#pragma unroll
  for (int i = 0; i < F_LOOP / 2; ++i) acc[i] = 0.f;
  const int steps = (D + Cfg::SC - 1) / Cfg::SC;
  for (int c = 0; c < steps; ++c) {
    hw::mbar_wait(&full[s], phase);
    const uint32_t slot = ring + s * Cfg::SLOT;
#pragma unroll
    for (int bx = 0; bx < Cfg::SC / F_BOX; ++bx) {
      if (c * Cfg::SC + bx * F_BOX >= D) break;  // warpgroup-uniform: boxes past D are zeros
      const uint32_t ah = (Cfg::RES ? own + (c * Cfg::SC / F_BOX + bx) * Cfg::OWN_BOX : slot) + cwg * 64 * 128;
      const uint32_t bh = Cfg::RES ? slot + bx * Cfg::LOOP_BOX : slot + Cfg::OWN_BOX;
      const uint32_t al = ah + F_OWN * 128, bl = bh + F_LOOP * 128;
      tf32_ss_kstep(x0, ah, al, bh, bl, 0);
      tf32_ss_kstep(x1, ah, al, bh, bl, 1);
      add_products<1>(acc, x0);
      tf32_ss_kstep(x0, ah, al, bh, bl, 2);
      add_products<1>(acc, x1);
      tf32_ss_kstep(x1, ah, al, bh, bl, 3);
      add_products<1>(acc, x0);
      add_products<0>(acc, x1);
    }
    hw::mbar_arrive(&empty[s]);
    if (++s == Cfg::STAGES) s = 0, phase ^= 1;
  }
}

// A k-step's register A operand: its columns t and t + 4 hold the accumulator's columns 2t and 2t + 1 (t_key), split
// into tf32 hi and lo.
__device__ __forceinline__ void split_a(uint32_t (&ah)[4], uint32_t (&al)[4], const float (&a)[F_LOOP / 2], int kc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = a[4 * kc + ((i & 1) << 1) + (i >> 1)];
    const float hi = hw::tf32_rna(v);
    ah[i] = __float_as_uint(hi);
    al[i] = __float_as_uint(hw::tf32_rna(v - hi));
  }
}

// Keeps a k-step's A operand registers live (unchanged) up to this point: after the wait that retires its products.
__device__ __forceinline__ void keep(uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(ah[i]), "+r"(al[i])::"memory");
}

// acc[piece] += a^T-piece: the NP columns of the piece in the ring slot, 8 k-steps of 8 loop rows, a (an m64n64
// accumulator: p, ds, or their transposes) split into tf32 hi and lo in registers before each k-step's products. The
// k-steps alternate between two chain buffers and two sets of A operands, each kept until its products have landed.
template <int DP, bool DKV>
__device__ __forceinline__ void tf32_bwd_piece(float* acc, const float (&a)[F_LOOP / 2], uint64_t* full, uint64_t* empty,
                                               uint32_t ring, int& s, uint32_t& phase) {
  using Cfg = Tf32BwdCfg<DP, DKV>;
  constexpr int NP = Cfg::NP;
  float y0[NP / 2], y1[NP / 2];
  uint32_t ah0[4], al0[4], ah1[4], al1[4];
  hw::mbar_wait(&full[s], phase);
  const uint32_t bh = ring + s * Cfg::SLOT, bl = bh + 2 * NP * 128;
  split_a(ah0, al0, a, 0);
  tf32_rs_kstep<NP>(y0, ah0, al0, bh, bl, 0);
#pragma unroll
  for (int kc = 1; kc < F_LOOP / 8; ++kc) {
    if (kc & 1) {
      split_a(ah1, al1, a, kc);
      tf32_rs_kstep<NP>(y1, ah1, al1, bh, bl, kc);
      add_products<1>(acc, y0);
      keep(ah0, al0);
    } else {
      split_a(ah0, al0, a, kc);
      tf32_rs_kstep<NP>(y0, ah0, al0, bh, bl, kc);
      add_products<1>(acc, y1);
      keep(ah1, al1);
    }
  }
  add_products<0>(acc, y1);  // k-step 7's chain
  keep(ah1, al1);
  hw::mbar_arrive(&empty[s]);
  if (++s == Cfg::STAGES) s = 0, phase ^= 1;
}

// The work unit `item` of the fp32 kernels: (output chunk, own tile, b * H + h), chunk fastest.
struct F32Item {
  int chunk, tile, bh;
};
__device__ __forceinline__ F32Item f32_item(int item, int chunks, int tiles) {
  return F32Item{item % chunks, (item / chunks) % tiles, item / (chunks * tiles)};
}

// dq (DKV false): units of 128 queries, looping over 64-key tiles; dk and dv (DKV true): units of 128 keys, looping
// over 64-query tiles. maps: the own tensors' row planes (q, dO; or k, v) in 128-row boxes, the loop tensors' (k, v; or
// q, dO) in 64-row boxes, and the transposed planes of the output products' B operands (kT; or dOT, qT) in NP-row
// boxes. Per loop tile each consumer computes S and dP (tf32_bwd_product), p and ds in fp32 (the Pallas kernels'
// numerics; keys past Nk, or queries past Nq, get p = 0), then its output products piece by piece. D <= DP is the
// real head dim, a multiple of 8.
template <int DP, bool DKV>
__global__ void __launch_bounds__(THREADS, 1) fa_bwd_tf32_kernel(
    const __grid_constant__ CUtensorMap own0, const __grid_constant__ CUtensorMap own1,
    const __grid_constant__ CUtensorMap loop0, const __grid_constant__ CUtensorMap loop1,
    const __grid_constant__ CUtensorMap tr0, const __grid_constant__ CUtensorMap tr1,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ out0,
    float* __restrict__ out1, int B, int H, int Nq, int Nk, int D, float scale, float scale_log2) {
  using Cfg = Tf32BwdCfg<DP, DKV>;
  constexpr int ST = Cfg::STAGES, NCO = Cfg::NCO, NP = Cfg::NP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = hw::align_smem(smem_raw);
  uint8_t* own = base;                       // RES: own0's boxes (hi, lo), then own1's
  uint8_t* ring = base + Cfg::OWN_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + Cfg::BAR_OFF);
  uint64_t *own_full = bars, *own_empty = bars + 1, *full = bars + 2, *empty = bars + 2 + ST;
  const int tid = threadIdx.x, BH = B * H;
  const int n_own = DKV ? Nk : Nq, n_loop = DKV ? Nq : Nk;
  const int chunks = (D + NCO - 1) / NCO, own_tiles = (n_own + F_OWN - 1) / F_OWN;
  const int n_items = chunks * own_tiles * BH, n_tiles = (n_loop + F_LOOP - 1) / F_LOOP;
  const int n_boxes = (D + F_BOX - 1) / F_BOX;

  if (tid == 0) {
    hw::mbar_init(own_full, 1);
    hw::mbar_init(own_empty, CONSUMERS);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], CONSUMERS);  // every consumer thread releases the slot
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues every load
    hw::setmaxnreg_dec<40>();
    if (tid == 0) {
      int s = 0;
      uint32_t phase = 0, own_phase = 0;
      auto slot = [&]() {
        uint8_t* p = ring + s * Cfg::SLOT;
        hw::mbar_wait(&empty[s], phase ^ 1);  // the first pass over the ring finds every slot free
        return p;
      };
      auto next = [&]() {
        if (++s == ST) s = 0, phase ^= 1;
      };
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const F32Item it = f32_item(item, chunks, own_tiles);
        const int r0 = it.tile * F_OWN;
        if constexpr (Cfg::RES) {
          hw::mbar_wait(own_empty, own_phase ^ 1);  // the first unit finds the own tiles free
          hw::mbar_arrive_expect_tx(own_full, 2 * n_boxes * Cfg::OWN_BOX);
          for (int t = 0; t < 2; ++t)
            for (int c = 0; c < n_boxes; ++c)
              for (int part = 0; part < 2; ++part)  // hi, lo
                hw::tma_load_3d(own + (t * (DP / F_BOX) + c) * Cfg::OWN_BOX + part * F_OWN * 128, t ? &own1 : &own0,
                                own_full, c * F_BOX, r0, part * BH + it.bh);
          own_phase ^= 1;
        }
        const int pieces = ((D - it.chunk * NCO < NCO ? D - it.chunk * NCO : NCO) + NP - 1) / NP;
        for (int j = 0; j < n_tiles; ++j) {
          for (int t = 0; t < 2; ++t) {  // S's steps, then dP's
            for (int c = 0; c < (D + Cfg::SC - 1) / Cfg::SC; ++c) {
              uint8_t* p = slot();
              hw::mbar_arrive_expect_tx(&full[s], Cfg::SSTEP);
              if constexpr (Cfg::RES) {
                for (int bx = 0; bx < Cfg::SC / F_BOX; ++bx)
                  for (int part = 0; part < 2; ++part)
                    hw::tma_load_3d(p + bx * Cfg::LOOP_BOX + part * F_LOOP * 128, t ? &loop1 : &loop0, &full[s],
                                    c * Cfg::SC + bx * F_BOX, j * F_LOOP, part * BH + it.bh);
              } else {
                for (int part = 0; part < 2; ++part) {
                  hw::tma_load_3d(p + part * F_OWN * 128, t ? &own1 : &own0, &full[s], c * F_BOX, r0,
                                  part * BH + it.bh);
                  hw::tma_load_3d(p + Cfg::OWN_BOX + part * F_LOOP * 128, t ? &loop1 : &loop0, &full[s], c * F_BOX,
                                  j * F_LOOP, part * BH + it.bh);
                }
              }
              next();
            }
          }
          for (int pc = 0; pc < pieces; ++pc) {
            for (int t = 0; t < (DKV ? 2 : 1); ++t) {  // dq: kT; dk/dv: dOT (dv), then qT (dk)
              uint8_t* p = slot();
              hw::mbar_arrive_expect_tx(&full[s], Cfg::PIECE);
              for (int part = 0; part < 2; ++part)
                for (int half = 0; half < 2; ++half)  // loop rows [0, 32), [32, 64) of the tile
                  hw::tma_load_3d(p + (2 * part + half) * NP * 128, t ? &tr1 : &tr0, &full[s],
                                  j * F_LOOP + half * 32, it.chunk * NCO + pc * NP, part * BH + it.bh);
              next();
            }
          }
        }
      }
    }
  } else {  // consumers: 64 own rows each
    hw::setmaxnreg_inc<232>();
    const int ctid = tid - 128, cwg = ctid >> 7, warp = (ctid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t ring_addr = hw::smem_u32(ring), own_addr = hw::smem_u32(own);
    int s = 0;
    uint32_t phase = 0, own_phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const F32Item it = f32_item(item, chunks, own_tiles);
      const int row0 = it.tile * F_OWN + cwg * 64 + warp * 16 + g;  // this thread's own rows: row0 and row0 + 8
      const int rows[2] = {row0, row0 + 8};
      const long long stat = (long long)it.bh * Nq;
      float st0[2] = {0.f, 0.f}, st1[2] = {0.f, 0.f};  // dq: lse (log2 units) and delta of the own rows
      if constexpr (!DKV) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (rows[r] < Nq) st0[r] = lse[stat + rows[r]] * LOG2E, st1[r] = delta[stat + rows[r]];
      }
      const int pieces = ((D - it.chunk * NCO < NCO ? D - it.chunk * NCO : NCO) + NP - 1) / NP;
      float acc[Cfg::ACC];  // dq's chunk; or dv's (first NCO / 2) and dk's
#pragma unroll
      for (int i = 0; i < Cfg::ACC; ++i) acc[i] = 0.f;
      if constexpr (Cfg::RES) hw::mbar_wait(own_full, own_phase);

      for (int j = 0; j < n_tiles; ++j) {
        float sc[F_LOOP / 2], dp[F_LOOP / 2], x0[F_LOOP / 2], x1[F_LOOP / 2];
        const uint32_t own1_addr = own_addr + (DP / F_BOX) * Cfg::OWN_BOX;
        tf32_bwd_product<DP, DKV>(sc, x0, x1, full, empty, ring_addr, own_addr, cwg, D, s, phase);
        tf32_bwd_product<DP, DKV>(dp, x0, x1, full, empty, ring_addr, own1_addr, cwg, D, s, phase);
        if (Cfg::RES && j == n_tiles - 1) hw::mbar_arrive(own_empty);  // the unit's last read of its own tiles
        if constexpr (!DKV) {  // p = exp(s scale - lse), ds = p (dp - delta) scale; keys past Nk get p = 0
          const bool ragged = (j + 1) * F_LOOP > Nk;
#pragma unroll
          for (int i = 0; i < F_LOOP / 2; ++i) {
            const int r = (i >> 1) & 1;
            float p = hw::exp2_ftz(fmaf(sc[i], scale_log2, -st0[r]));
            if (ragged && j * F_LOOP + (i >> 2) * 8 + 2 * t + (i & 1) >= Nk) p = 0.f;
            sc[i] = p * (dp[i] - st1[r]) * scale;
          }
#pragma unroll
          for (int pc = 0; pc < NCO / NP; ++pc)  // unrolled, so that acc's indices are constants
            if (pc < pieces) tf32_bwd_piece<DP, DKV>(&acc[pc * (NP / 2)], sc, full, empty, ring_addr, s, phase);
        } else {  // p^T and ds^T: the column is the query, its lse and delta from the forward
#pragma unroll
          for (int i = 0; i < F_LOOP / 2; ++i) {
            const int qc = j * F_LOOP + (i >> 2) * 8 + 2 * t + (i & 1);
            const bool in = qc < Nq;
            const float l2 = in ? lse[stat + qc] * LOG2E : 0.f, dl = in ? delta[stat + qc] : 0.f;
            const float p = in ? hw::exp2_ftz(fmaf(sc[i], scale_log2, -l2)) : 0.f;
            dp[i] = p * (dp[i] - dl) * scale;
            sc[i] = p;
          }
          static_assert(!DKV || NCO == NP, "one piece of dv and of dk a unit");
          if (pieces > 0) {
            tf32_bwd_piece<DP, DKV>(&acc[0], sc, full, empty, ring_addr, s, phase);   // dv += p^T dO
            tf32_bwd_piece<DP, DKV>(&acc[NCO / 2], dp, full, empty, ring_addr, s, phase);  // dk += ds^T q
          }
        }
      }
      if constexpr (Cfg::RES) own_phase ^= 1;

      // the outputs: contiguous (B, N, H, D) fp32, columns past D not written
      const int b = it.bh / H, h = it.bh % H;
#pragma unroll
      for (int o = 0; o < (DKV ? 2 : 1); ++o) {
        float* gp = (o == 0 ? out0 : out1) + ((long long)b * n_own * H + h) * D + it.chunk * NCO;
#pragma unroll
        for (int c = 0; c < NCO / 8; ++c) {
          if (it.chunk * NCO + c * 8 >= D) continue;
          const float* xv = &acc[o * (NCO / 2) + 4 * c];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (rows[r] < n_own)
              *reinterpret_cast<float2*>(gp + (long long)rows[r] * H * D + c * 8 + 2 * t) =
                  make_float2(xv[2 * r], xv[2 * r + 1]);
        }
      }
    }
  }
}

// One operand of the split pre-pass: a strided (B, N, H, D) fp32 tensor, the workspace planes it is written to and
// its blocks of the pre-pass's grid.
struct SplitJob {
  const float* src;
  Strides s;
  float* dst;
  int n;
  long long blocks;
};
constexpr int F_ROW_JOBS = 4, F_JOBS = 7;  // q, dO, k, v as row planes; then q, dO, k transposed
struct SplitJobs {
  SplitJob job[F_JOBS];
};

// The split pre-pass: job i takes blocks [sum of the earlier jobs' blocks, + its own). A row job writes its tensor as
// (2, B * H, N, D) planes, hi = tf32(x) in plane bh and lo = tf32(x - hi) in plane B * H + bh, one float4 a thread; a
// transposed job as (2, B * H, D, N8) planes (N8 = N rounded up to 8, zeros past N), the rows in t_key order within
// each 8, a 32 x 32 tile through shared memory a block.
__global__ void __launch_bounds__(F_PREP_THREADS) k3_split_kernel(const SplitJobs jobs, int B, int H, int D) {
  long long blk = blockIdx.x;
  int jid = 0;
  SplitJob J = jobs.job[0];
#pragma unroll
  for (int i = 0; i + 1 < F_JOBS; ++i) {
    if (jid == i && blk >= J.blocks) {
      blk -= J.blocks;
      jid = i + 1;
      J = jobs.job[i + 1];
    }
  }
  const long long BH = (long long)B * H;
  if (jid < F_ROW_JOBS) {
    const long long e = blk * F_PREP_THREADS + threadIdx.x, d4s = D / 4;
    if (e >= BH * J.n * d4s) return;
    const long long r = e / d4s;  // (b, n, h) in (B, N, H) order: the source's
    const int d = (int)(e - r * d4s) * 4, h = (int)(r % H), n = (int)((r / H) % J.n), b = (int)(r / ((long long)H * J.n));
    const float4 x = *reinterpret_cast<const float4*>(J.src + b * J.s.b + n * J.s.n + h * J.s.h + d);
    const float4 hi = make_float4(hw::tf32_rna(x.x), hw::tf32_rna(x.y), hw::tf32_rna(x.z), hw::tf32_rna(x.w));
    const float4 lo = make_float4(hw::tf32_rna(x.x - hi.x), hw::tf32_rna(x.y - hi.y), hw::tf32_rna(x.z - hi.z),
                                  hw::tf32_rna(x.w - hi.w));
    const long long off = ((long long)b * H + h) * J.n * D + (long long)n * D + d;
    *reinterpret_cast<float4*>(J.dst + off) = hi;
    *reinterpret_cast<float4*>(J.dst + BH * J.n * D + off) = lo;
    return;
  }
  __shared__ float tile[32][33];
  const long long N8 = (J.n + 7) / 8 * 8, n_tiles = (N8 + 31) / 32, d_tiles = (D + 31) / 32;
  const int nt = (int)(blk % n_tiles), dt = (int)((blk / n_tiles) % d_tiles);
  const long long bh = blk / (n_tiles * d_tiles);
  const int b = (int)(bh / H), h = (int)(bh % H), x = threadIdx.x & 31, y = threadIdx.x >> 5;
#pragma unroll
  for (int r = y; r < 32; r += F_PREP_THREADS / 32) {
    const int n = nt * 32 + r, d = dt * 32 + x;
    tile[r][x] = n < J.n && d < D ? J.src[b * J.s.b + (long long)n * J.s.n + h * J.s.h + d] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int r = y; r < 32; r += F_PREP_THREADS / 32) {
    const int d = dt * 32 + r, np = nt * 32 + x;
    if (d >= D || np >= N8) continue;
    const float val = tile[(x & ~7) | t_key(x & 7)][r];
    const float hi = hw::tf32_rna(val);
    const long long off = bh * D * N8 + (long long)d * N8 + np;
    J.dst[off] = hi;
    J.dst[BH * D * N8 + off] = hw::tf32_rna(val - hi);
  }
}

// The fp32 workspace (ops/flash_attention.py k3_tf32_workspace_floats): the row planes of q, dO, k and v, then the
// transposed planes of q, dO and k.
struct F32Planes {
  float *q, *dout, *k, *v, *qt, *dot, *kt;
};
inline F32Planes f32_planes(float* ws, long long BH, int Nq, int Nk, int D) {
  const long long Nq8 = (Nq + 7) / 8 * 8;
  F32Planes p;
  p.q = ws;
  p.dout = p.q + 2 * BH * Nq * D;
  p.k = p.dout + 2 * BH * Nq * D;
  p.v = p.k + 2 * BH * Nk * D;
  p.qt = p.v + 2 * BH * Nk * D;
  p.dot = p.qt + 2 * BH * D * Nq8;
  p.kt = p.dot + 2 * BH * D * Nq8;
  return p;
}

// The 3-D fp32 tensor map of (2 B H) planes of `rows` x `cols` (cols contiguous) in boxes of 32 columns and `box_rows`
// rows, 128-byte swizzled.
inline int plane_map(CUtensorMap* map, const float* base, long long planes, long long rows, long long cols,
                     int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4, (cuuint64_t)(rows * cols * 4)};
  const cuuint32_t box[3] = {F_BOX, (cuuint32_t)box_rows, 1};
  return hw::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The split pre-pass, then the dq and the dk/dv 3xTF32 kernels built for DP on their persistent grids.
template <int DP>
int launch_bwd_tf32(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                    const float* delta, float* dq, float* dk, float* dv, void* ws, int B, int H, int Nq, int Nk, int D,
                    Strides qs, Strides ks, Strides vs, Strides dos, float scale, float scale_log2, cudaStream_t st) {
  using DqCfg = Tf32BwdCfg<DP, false>;
  using DkvCfg = Tf32BwdCfg<DP, true>;
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  const long long BH = (long long)B * H, Nq8 = (Nq + 7) / 8 * 8, Nk8 = (Nk + 7) / 8 * 8;
  const F32Planes p = f32_planes(static_cast<float*>(ws), BH, Nq, Nk, D);
  SplitJobs jobs;
  const float* srcs[F_JOBS] = {q, dout, k, v, q, dout, k};
  const Strides strides[F_JOBS] = {qs, dos, ks, vs, qs, dos, ks};
  float* dsts[F_JOBS] = {p.q, p.dout, p.k, p.v, p.qt, p.dot, p.kt};
  const int ns[F_JOBS] = {Nq, Nq, Nk, Nk, Nq, Nq, Nk};
  long long total = 0;
  for (int i = 0; i < F_JOBS; ++i) {
    const long long n8 = (ns[i] + 7) / 8 * 8;
    const long long blocks = i < F_ROW_JOBS ? (BH * ns[i] * (D / 4) + F_PREP_THREADS - 1) / F_PREP_THREADS
                                            : BH * ((n8 + 31) / 32) * ((D + 31) / 32);
    jobs.job[i] = SplitJob{srcs[i], strides[i], dsts[i], ns[i], blocks};
    total += blocks;
  }
  const long long dq_items = (long long)((D + DqCfg::NCO - 1) / DqCfg::NCO) * ((Nq + F_OWN - 1) / F_OWN) * BH;
  const long long dkv_items = (long long)((D + DkvCfg::NCO - 1) / DkvCfg::NCO) * ((Nk + F_OWN - 1) / F_OWN) * BH;
  if (total > 0x7fffffff || dq_items > 0x7fffffff || dkv_items > 0x7fffffff || 2 * BH > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[10];  // dq: q, dO (own), k, v (loop), kT; dk/dv: k, v (own), q, dO (loop), dOT, qT
  int status = plane_map(&m[0], p.q, 2 * BH, Nq, D, F_OWN);
  if (status == 0) status = plane_map(&m[1], p.dout, 2 * BH, Nq, D, F_OWN);
  if (status == 0) status = plane_map(&m[2], p.k, 2 * BH, Nk, D, F_LOOP);
  if (status == 0) status = plane_map(&m[3], p.v, 2 * BH, Nk, D, F_LOOP);
  if (status == 0) status = plane_map(&m[4], p.kt, 2 * BH, D, Nk8, DqCfg::NP);
  if (status == 0) status = plane_map(&m[5], p.k, 2 * BH, Nk, D, F_OWN);
  if (status == 0) status = plane_map(&m[6], p.v, 2 * BH, Nk, D, F_OWN);
  if (status == 0) status = plane_map(&m[7], p.q, 2 * BH, Nq, D, F_LOOP);
  if (status == 0) status = plane_map(&m[8], p.dout, 2 * BH, Nq, D, F_LOOP);
  if (status == 0) status = plane_map(&m[9], p.dot, 2 * BH, D, Nq8, DkvCfg::NP);
  CUtensorMap qt_map;
  if (status == 0) status = plane_map(&qt_map, p.qt, 2 * BH, D, Nq8, DkvCfg::NP);
  static bool dq_set[64], dkv_set[64];
  if (status == 0) status = hw::allow_smem(fa_bwd_tf32_kernel<DP, false>, DqCfg::SMEM, dq_set);
  if (status == 0) status = hw::allow_smem(fa_bwd_tf32_kernel<DP, true>, DkvCfg::SMEM, dkv_set);
  int sms = 0;
  if (status == 0) status = hw::sm_count(&sms);
  if (status != 0) return status;
  k3_split_kernel<<<(unsigned)total, F_PREP_THREADS, 0, st>>>(jobs, B, H, D);
  fa_bwd_tf32_kernel<DP, false><<<(int)(dq_items < sms ? dq_items : sms), THREADS, DqCfg::SMEM, st>>>(
      m[0], m[1], m[2], m[3], m[4], m[4], lse, delta, dq, nullptr, B, H, Nq, Nk, D, scale, scale_log2);
  fa_bwd_tf32_kernel<DP, true><<<(int)(dkv_items < sms ? dkv_items : sms), THREADS, DkvCfg::SMEM, st>>>(
      m[5], m[6], m[7], m[8], m[9], qt_map, lse, delta, dv, dk, B, H, Nq, Nk, D, scale, scale_log2);
  return 0;
}

// ---------------------------------------------------------------------------
// fp32 at D <= 16: CUDA cores, full precision (see "fp32" in the note at the top)
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 128;

// TPR lanes share a row, each holding DT = DP / TPR of its columns: 4-wide groups interleaved across the row's
// lanes (group i of lane `part` is columns 4 (TPR i + part) .. + 3), so the lanes of a pair read neighbouring words
// of a shared-memory row. TILE rows per staged shared-memory tile.
template <int DP, int TPR>
struct F32Cfg {
  static constexpr int DT = DP / TPR, ROWS = F32_THREADS / TPR, TILE = 32;
  static_assert(DT % 4 == 0 && DT <= 32, "a thread's share of the row");
};

template <int TPR>
__device__ __forceinline__ int chunk(int i, int part) { return 4 * (TPR * i + part); }

template <int DP, int TPR>
__device__ __forceinline__ void load_part(float (&x)[DP / TPR], const float* p, bool in, int part, int D) {
#pragma unroll
  for (int i = 0; i < DP / TPR / 4; ++i) {
    const int c = chunk<TPR>(i, part);
    const float4 v = in && c < D ? *reinterpret_cast<const float4*>(p + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    x[4 * i] = v.x, x[4 * i + 1] = v.y, x[4 * i + 2] = v.z, x[4 * i + 3] = v.w;
  }
}

template <int DP, int TPR>
__device__ __forceinline__ void store_part(float* p, const float (&x)[DP / TPR], int part, int D) {
#pragma unroll
  for (int i = 0; i < DP / TPR / 4; ++i) {
    const int c = chunk<TPR>(i, part);
    if (c < D) *reinterpret_cast<float4*>(p + c) = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  }
}

// The full dot product of this thread's part of a row with a shared-memory row; the row's lanes add their parts
// by a butterfly of shuffles, so all of them hold the same sum.
template <int DP, int TPR>
__device__ __forceinline__ float dot_part(const float (&x)[DP / TPR], const float* row, int part) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < DP / TPR / 4; ++i) {
    const float4 y = *reinterpret_cast<const float4*>(row + chunk<TPR>(i, part));
    s = fmaf(x[4 * i], y.x, s);
    s = fmaf(x[4 * i + 1], y.y, s);
    s = fmaf(x[4 * i + 2], y.z, s);
    s = fmaf(x[4 * i + 3], y.w, s);
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <int DP, int TPR>
__device__ __forceinline__ void axpy_part(float (&acc)[DP / TPR], float a, const float* row, int part) {
#pragma unroll
  for (int i = 0; i < DP / TPR / 4; ++i) {
    const float4 y = *reinterpret_cast<const float4*>(row + chunk<TPR>(i, part));
    acc[4 * i] = fmaf(a, y.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(a, y.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(a, y.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(a, y.w, acc[4 * i + 3]);
  }
}

// Stage rows [r0, r0 + TILE) of two strided (rows x D) fp32 matrices as (TILE, DP); rows at or past n and columns
// at or past D are zero.
template <int DP, int TILE>
__device__ __forceinline__ void stage_pair_f32(float (*a_s)[DP], float (*b_s)[DP], const float* a, long long a_n,
                                               const float* b, long long b_n, int r0, int n, int D) {
  for (int c = threadIdx.x; c < TILE * DP / 4; c += blockDim.x) {
    const int r = c / (DP / 4), d4 = (c % (DP / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (r0 + r < n && d4 < D) {
      x = *reinterpret_cast<const float4*>(a + (long long)(r0 + r) * a_n + d4);
      y = *reinterpret_cast<const float4*>(b + (long long)(r0 + r) * b_n + d4);
    }
    *reinterpret_cast<float4*>(&a_s[r][d4]) = x;
    *reinterpret_cast<float4*>(&b_s[r][d4]) = y;
  }
}

template <int DP, int TPR>
__global__ void __launch_bounds__(F32_THREADS) fa_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int Nq, int Nk, int D, Strides qs, Strides ks, Strides vs, Strides dos,
    float scale, float scale_log2) {
  using Cfg = F32Cfg<DP, TPR>;
  constexpr int DT = Cfg::DT, TILE = Cfg::TILE;
  __shared__ __align__(16) float k_s[TILE][DP];
  __shared__ __align__(16) float v_s[TILE][DP];

  const int part = threadIdx.x % TPR;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * Cfg::ROWS + threadIdx.x / TPR;
  const bool in = row < Nq;
  float qr[DT], dor[DT], acc[DT];
  load_part<DP, TPR>(qr, q + b * qs.b + h * qs.h + (long long)row * qs.n, in, part, D);
  load_part<DP, TPR>(dor, dout + b * dos.b + h * dos.h + (long long)row * dos.n, in, part, D);
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i] = 0.f;
  const long long stat = ((long long)b * H + h) * Nq + row;
  const float lse2 = in ? lse[stat] * LOG2E : 0.f;
  const float dl = in ? delta[stat] : 0.f;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;

  for (int k0 = 0; k0 < Nk; k0 += TILE) {
    __syncthreads();
    stage_pair_f32<DP, TILE>(k_s, v_s, kp, ks.n, vp, vs.n, k0, Nk, D);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < TILE; ++j) {
      const float s = dot_part<DP, TPR>(qr, k_s[j], part);
      const float dp = dot_part<DP, TPR>(dor, v_s[j], part);
      const float p = (in && k0 + j < Nk) ? exp2f(fmaf(s, scale_log2, -lse2)) : 0.f;
      axpy_part<DP, TPR>(acc, p * (dp - dl) * scale, k_s[j], part);
    }
  }
  if (in) store_part<DP, TPR>(dq + (((long long)b * Nq + row) * H + h) * D, acc, part, D);
}

template <int DP, int TPR>
__global__ void __launch_bounds__(F32_THREADS) fa_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Nq, int Nk, int D, Strides qs, Strides ks, Strides vs,
    Strides dos, float scale, float scale_log2) {
  using Cfg = F32Cfg<DP, TPR>;
  constexpr int DT = Cfg::DT, TILE = Cfg::TILE;
  __shared__ __align__(16) float q_s[TILE][DP];
  __shared__ __align__(16) float do_s[TILE][DP];
  __shared__ float lse_s[TILE], delta_s[TILE];

  const int part = threadIdx.x % TPR;
  const int b = blockIdx.z, h = blockIdx.y;
  const int key = blockIdx.x * Cfg::ROWS + threadIdx.x / TPR;
  const bool in = key < Nk;
  float kr[DT], vr[DT], dk_acc[DT], dv_acc[DT];
  load_part<DP, TPR>(kr, k + b * ks.b + h * ks.h + (long long)key * ks.n, in, part, D);
  load_part<DP, TPR>(vr, v + b * vs.b + h * vs.h + (long long)key * vs.n, in, part, D);
#pragma unroll
  for (int i = 0; i < DT; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* dop = dout + b * dos.b + h * dos.h;
  const long long stat = ((long long)b * H + h) * Nq;

  for (int q0 = 0; q0 < Nq; q0 += TILE) {
    __syncthreads();
    stage_pair_f32<DP, TILE>(q_s, do_s, qp, qs.n, dop, dos.n, q0, Nq, D);
    for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
      const bool qin = q0 + i < Nq;
      lse_s[i] = qin ? lse[stat + q0 + i] * LOG2E : 0.f;
      delta_s[i] = qin ? delta[stat + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < TILE; ++i) {
      const float s = dot_part<DP, TPR>(kr, q_s[i], part);
      const float dp = dot_part<DP, TPR>(vr, do_s[i], part);
      const float p = (in && q0 + i < Nq) ? exp2f(fmaf(s, scale_log2, -lse_s[i])) : 0.f;
      axpy_part<DP, TPR>(dv_acc, p, do_s[i], part);
      axpy_part<DP, TPR>(dk_acc, p * (dp - delta_s[i]) * scale, q_s[i], part);
    }
  }
  if (in) {
    const long long off = (((long long)b * Nk + key) * H + h) * D;
    store_part<DP, TPR>(dk + off, dk_acc, part, D);
    store_part<DP, TPR>(dv + off, dv_acc, part, D);
  }
}

template <int DP, int TPR>
void launch_bwd_f32(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                    const float* delta, float* dq, float* dk, float* dv, int B, int H, int Nq, int Nk, int D,
                    Strides qs, Strides ks, Strides vs, Strides dos, float scale, float scale_log2, cudaStream_t st) {
  constexpr int ROWS = F32Cfg<DP, TPR>::ROWS;
  fa_bwd_dq_f32_kernel<DP, TPR><<<dim3((Nq + ROWS - 1) / ROWS, H, B), F32_THREADS, 0, st>>>(
      q, k, v, dout, lse, delta, dq, H, Nq, Nk, D, qs, ks, vs, dos, scale, scale_log2);
  fa_bwd_dkv_f32_kernel<DP, TPR><<<dim3((Nk + ROWS - 1) / ROWS, H, B), F32_THREADS, 0, st>>>(
      q, k, v, dout, lse, delta, dk, dv, H, Nq, Nk, D, qs, ks, vs, dos, scale, scale_log2);
}

// The bf16 dq and dk/dv kernels on their persistent grids: those of D <= 64 (DP = 64; DS = 64 or 0, as the
// kernels take it), or the whole-width kernels of DP = 128, 192 or 256 (128-column chunks). m: the eight tensor maps in
// uc_flash_attention_bwd's order.
template <int DP, int DS = 0>
int launch_bwd_bf16(const CUtensorMap (&m)[8], const float* ls, const float* dl, __nv_bfloat16* dq,
                    __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int H, int Nq, int Nk, int D, float scale,
                    float scale_log2, cudaStream_t st) {
  int sms = 0;
  int status = hw::sm_count(&sms);
  if (status != 0) return status;
  static bool dq_set[64], dkv_set[64];
  const long long q_tiles = (Nq + OWN - 1) / OWN, k_tiles = (Nk + OWN - 1) / OWN;
  if constexpr (DP == BOX) {
    constexpr int DQ_SMEM = smem_bytes<DqSmem>(), DKV_SMEM = smem_bytes<DkvSmem>();
    status = hw::allow_smem(fa_bwd_dq_bf16_kernel<DS>, DQ_SMEM, dq_set);
    if (status == 0) status = hw::allow_smem(fa_bwd_dkv_bf16_kernel<DS>, DKV_SMEM, dkv_set);
    if (status != 0) return status;
    const long long dq_items = q_tiles * H * B, dkv_items = k_tiles * H * B;
    if (dq_items > 0x7fffffff || dkv_items > 0x7fffffff) return (int)cudaErrorInvalidValue;
    fa_bwd_dq_bf16_kernel<DS><<<(int)(dq_items < sms ? dq_items : sms), THREADS, DQ_SMEM, st>>>(
        m[0], m[1], m[2], m[3], ls, dl, dq, B, H, Nq, Nk, D, scale, scale_log2);
    fa_bwd_dkv_bf16_kernel<DS><<<(int)(dkv_items < sms ? dkv_items : sms), THREADS, DKV_SMEM, st>>>(
        m[6], m[4], m[5], m[7], ls, dl, dk, dv, B, H, Nq, Nk, D, scale, scale_log2);
  } else {
    constexpr int SMEM = smem_bytes<WideBwdSmem<DP>>();
    status = hw::allow_smem(fa_bwd_dq_wide_kernel<DP>, SMEM, dq_set);
    if (status == 0) status = hw::allow_smem(fa_bwd_dkv_wide_kernel<DP>, SMEM, dkv_set);
    if (status != 0) return status;
    const long long chunks = (D + W_CHUNK - 1) / W_CHUNK;
    const long long dq_items = chunks * q_tiles * H * B, dkv_items = chunks * k_tiles * H * B;
    if (dq_items > 0x7fffffff || dkv_items > 0x7fffffff) return (int)cudaErrorInvalidValue;
    fa_bwd_dq_wide_kernel<DP><<<(int)(dq_items < sms ? dq_items : sms), THREADS, SMEM, st>>>(
        m[0], m[1], m[2], m[3], ls, dl, dq, B, H, Nq, Nk, D, scale, scale_log2);
    fa_bwd_dkv_wide_kernel<DP><<<(int)(dkv_items < sms ? dkv_items : sms), THREADS, SMEM, st>>>(
        m[6], m[4], m[5], m[7], ls, dl, dk, dv, B, H, Nq, Nk, D, scale, scale_log2);
  }
  return 0;
}

}  // namespace

// The element strides (b, n, h) of a tensor from its tensor-map layout (byte strides of h, n, b).
static Strides layout_strides(const long long* L, int elem_bytes) {
  return Strides{L[6] / elem_bytes, L[5] / elem_bytes, L[4] / elem_bytes};
}

// dtype: 0 = float32, 1 = bfloat16; head_dim: a multiple of 8 up to 256 (ops/flash_attention.py pads any other
// into a copy). `layouts` holds eight tensor-map layouts, 11 ints each (hopper.cuh
// LAYOUT_INTS): q, k, v, dO with the dq kernel's boxes (128 query rows, 64 key rows), then k, v, q, dO with
// the dk/dv kernel's (128 key rows, 64 query rows); the fp32 kernels and the delta kernel take their element
// strides from them (d has unit stride). o is a contiguous (B, Nq, H, D) tensor, lse a contiguous (B, H, Nq)
// float32 tensor from the forward, delta a (B, H, Nq) float32 scratch tensor; dq (B, Nq, H, D) and dk, dv
// (B, Nk, H, D) are contiguous outputs in the input dtype; ws, for float32 above D = 16, the split operands' workspace
// (ops/flash_attention.py k3_tf32_workspace_floats), else null. Launches the delta kernel, (fp32 above D = 16) the
// split pre-pass, and the dq and dk/dv kernels on the stream. Returns a cudaError_t.
extern "C" int uc_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                      const void* lse, void* delta, void* dq, void* dk, void* dv, void* ws, int dtype, int B,
                                      int H, int Nq, int Nk, int head_dim, const long long* layouts, float scale,
                                      void* stream) {
  const int D = head_dim;
  if (D < 8 || D > 256 || D % 8 != 0 || B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
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
  const int lanes = delta_lanes(D, es);
  const long long want = (rows * lanes + 255) / 256;  // `lanes` threads per row
  const int delta_blocks = (int)(want < 65536 ? want : 65536);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    CUtensorMap m[8];
    const int boxes[8] = {OWN, LOOP, LOOP, OWN, OWN, OWN, LOOP, LOOP};
    const void* bases[8] = {q, k, v, dout, k, v, q, dout};
    int status = 0;
    for (int i = 0; i < 8 && status == 0; ++i) status = hw::encode_tile_map(&m[i], bases[i], L[i], boxes[i]);
    if (status != 0) return status;
    fa_bwd_delta_kernel<bf><<<delta_blocks, 256, 0, st>>>(static_cast<const bf*>(dout), static_cast<const bf*>(o), dl,
                                                            H, Nq, D, lanes, rows, dos);
    bf *gq = static_cast<bf*>(dq), *gk = static_cast<bf*>(dk), *gv = static_cast<bf*>(dv);
    if (D == 64)
      status = launch_bwd_bf16<64, 64>(m, ls, dl, gq, gk, gv, B, H, Nq, Nk, D, scale, scale_log2, st);
    else if (D < 64)
      status = launch_bwd_bf16<64>(m, ls, dl, gq, gk, gv, B, H, Nq, Nk, D, scale, scale_log2, st);
    else if (D <= 128)
      status = launch_bwd_bf16<128>(m, ls, dl, gq, gk, gv, B, H, Nq, Nk, D, scale, scale_log2, st);
    else if (D <= 192)
      status = launch_bwd_bf16<192>(m, ls, dl, gq, gk, gv, B, H, Nq, Nk, D, scale, scale_log2, st);
    else
      status = launch_bwd_bf16<256>(m, ls, dl, gq, gk, gv, B, H, Nq, Nk, D, scale, scale_log2, st);
    if (status != 0) return status;
  } else {
    const auto *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
               *fv = static_cast<const float*>(v), *fdo = static_cast<const float*>(dout);
    auto *gq = static_cast<float*>(dq), *gk = static_cast<float*>(dk), *gv = static_cast<float*>(dv);
    fa_bwd_delta_kernel<float><<<delta_blocks, 256, 0, st>>>(fdo, static_cast<const float*>(o), dl, H, Nq, D, lanes,
                                                              rows, dos);
    int status = 0;
    if (D <= F32_SMALL_DP)
      launch_bwd_f32<F32_SMALL_DP, 2>(fq, fk, fv, fdo, ls, dl, gq, gk, gv, B, H, Nq, Nk, D, qs, ks, vs, dos, scale,
                                      scale_log2, st);
    else if (D <= 32)
      status = launch_bwd_tf32<32>(fq, fk, fv, fdo, ls, dl, gq, gk, gv, ws, B, H, Nq, Nk, D, qs, ks, vs, dos, scale,
                                   scale_log2, st);
    else if (D <= 64)
      status = launch_bwd_tf32<64>(fq, fk, fv, fdo, ls, dl, gq, gk, gv, ws, B, H, Nq, Nk, D, qs, ks, vs, dos, scale,
                                   scale_log2, st);
    else if (D <= 128)
      status = launch_bwd_tf32<128>(fq, fk, fv, fdo, ls, dl, gq, gk, gv, ws, B, H, Nq, Nk, D, qs, ks, vs, dos, scale,
                                    scale_log2, st);
    else
      status = launch_bwd_tf32<256>(fq, fk, fv, fdo, ls, dl, gq, gk, gv, ws, B, H, Nq, Nk, D, qs, ks, vs, dos, scale,
                                    scale_log2, st);
    if (status != 0) return status;
  }
  return (int)cudaGetLastError();
}
