// Flash attention forward (non-causal, no mask) over (B, N, H, D) tensors, D in {32, 64, 80, 96, 128, 512}.
//
// Replaces: uniception_tpu/ops/flash_attention.py: flash_attention /
//   _flash_attention_impl with the bodies _fa_single_kernel and _fa_kernel
//   (forward; with_lse=True when an LSE pointer is given). The Pallas kernel
//   takes any D (its _plan); this one takes the head dims of the encoders the
//   repository builds: 32 (E-RADIO's windows), 64 (CroCo, DINOv2/v3, RADIO-b/l/g,
//   PE-B/L, Pixio-B/L/1B), 80 (RADIO-h, Pixio-H), 96 (PE-G, Pixio-5B), 128
//   (DINOv3-7b) and 512 (the Cosmos tokenizer's single-head mid-block attention,
//   models/libs/cosmos_tokenizer/modules/layers2d.py AttnBlock, for which the
//   Pallas _plan shrinks its tiles).
//
// What bounds it on the H100: each (b, h) pair does 4*N*N*D flops on 4*N*D*2
//   bytes of q/k/v/o, N/2 flops per byte in bf16 whatever D: 512 at N = 1024,
//   516 at N = 1033 (RADIO-h's D = 80), 132 at N = 264 (Pixio-H at 256). Above
//   the card's ridge of ~295 the tensor-core issue rate and the exp/max/sum work
//   of the online softmax between the two products bound it, not HBM; below it,
//   at a few hundred keys, the bytes and the launch. Only wgmma reaches the full
//   tensor-core rate.
//
// What the design does about it (bf16; the outline of FlashAttention-3):
//   * A persistent kernel: one block per SM walks the (128-query tile, head,
//     batch) work items, three warpgroups each. Warpgroup 0 is the producer:
//     it gives up registers (setmaxnreg.dec) and one thread issues TMA loads
//     (hopper.cuh) of each item's Q and of its 128-key K and V tiles into a
//     ring of STAGES slots, each with a "full" mbarrier (TMA bytes landed) and
//     an "empty" one (both consumers done with the slot). It runs ahead across
//     items, so the next item's Q and first K/V tiles load while the consumers
//     finish the current one: the tensor cores never wait on a synchronous
//     copy, and an item's pipeline fill and epilogue are hidden.
//   * Warpgroups 1 and 2 are consumers (setmaxnreg.inc), 64 query rows each.
//     Each reads its Q rows into wgmma register A operands once per item (and
//     frees the Q buffer for the next item). S = Q.K^T is DP/16 wgmma
//     m64n128k16 with K read K-major from shared memory; the online softmax
//     runs on the fp32 accumulator registers; P is rounded to bf16 in registers
//     (as the TPU kernel casts p to v's dtype) and is the register A operand of
//     O += P.V (8 wgmma m64nDPk16), with V read MN-major through the transpose
//     bit straight from its TMA tile: no hand transpose of V.
//   * Inside a consumer, tile j's Q.K^T and tile j-1's P.V are issued back to
//     back and tile j's softmax runs while P.V is still in flight
//     (FlashAttention-3's intra-warpgroup pipeline), each wgmma group behind
//     its own fence so ptxas never serialises them. Between the consumers,
//     named barriers give the tensor cores to one at a time (ping-pong), so
//     one consumer's softmax overlaps the other's products.
//   * q/k/v are read through 4-D tensor maps (D, H, N, B) with the views' byte
//     strides (ops/flash_attention.py tma_layout), so the q/k/v views of a
//     fused qkv projection need no copy. TMA fills rows past N with zeros; keys
//     past Nk are still masked to -inf (the TPU kernel's -1e30) and rows past
//     Nq are not written.
//   * Head dims. The kernel is built for a padded head dim DP: 64 for D = 32
//     and 64, 128 for D = 80, 96 and 128. Every tile is DP / 64 boxes of 64
//     columns (128 bytes, one 128-byte swizzle row), each a 1024-byte-aligned
//     atom of its own; TMA writes zeros into the columns past D, so S over DP
//     columns is S over the real D, and P.V's columns past D are zeros that are
//     never stored. P.V runs at N = DP, not at D rounded up to 16: an MN-major
//     operand under the 128-byte swizzle is a whole number of 64-column atoms
//     (CUTLASS's canonical layouts), which 80 and 96 are not. D = 32 takes
//     DP = 64 through the same zero fill rather than a 64-byte swizzle, so it
//     runs the D = 64 code as it stands. What the padding costs: S and P.V do
//     DP / D of the needed products, 2x at D = 32, 1.6x at D = 80, 1.33x at
//     D = 96. At DP = 128, Q (32 KB) and three stages of K and V (192 KB) would
//     leave about 1 KB of the 227 KB a block may use, so the ring has two
//     stages there; the consumers hold O (64 fp32 registers at N = 128), S (64)
//     and their Q (32) and P (32) operands within setmaxnreg's 232 (the build
//     log's ptxas line shows the registers and that nothing spills).
//   * Numerics as before: fp32 scores, running max and sum; the sum takes p
//     before its bf16 rounding (the Pallas kernel's order); o = acc / l in q's
//     dtype. p is the MUFU's 2^x with subnormals flushed (hopper.cuh
//     exp2_ftz), as in the backward. With an LSE pointer (training), each row's logsumexp m + log(l)
//     is written in fp32, (B, H, Nq) contiguous, for the backward (K3,
//     flash_attention_bwd.cu); with a null pointer nothing more is written.
//   * fp32: full fp32 FMA math on the CUDA cores, no TF32 (the TPU kernel runs
//     fp32 at HIGHEST precision): the parity path. A thread holds its query row
//     and its accumulator in registers: the whole row for D <= 64 (one row per
//     thread, as before), half of it for D = 80, 96 and 128 (two neighbouring
//     lanes per row, whose partial dot products meet in one shuffle; both then
//     hold the same score, so the softmax stays exact), so no D spills the
//     2 x D registers a row needs.
//   * Later work: a third consumer warpgroup, a TMA store of the output, P.V at
//     N = D where the swizzle allows it.
//
// D = 512 (bf16, fa_fwd_bf16_wide_kernel): the kernel above cannot hold it. A
//   consumer's 64 x 512 fp32 accumulator would be 256 registers a thread and its
//   Q operands 128 more, over the 255 a thread may have. So the two consumer
//   warpgroups split O's columns instead of the query rows: a work item is 64
//   query rows of one (b, h), and consumer c owns O's columns [256c, 256c + 256)
//   (two m64n128 accumulators, 128 registers). Each consumer computes the same
//   S = Q.K^T over the full 512 (32 wgmma m64n64k16 with both operands in shared
//   memory: Q is too wide for registers), so both hold the same scores and run
//   the same online softmax with no exchange, then O += P.V over its own half of
//   V (8 wgmma m64n128k16, P from registers, V MN-major through the transpose
//   bit). That is 1.5x the minimum tensor-core work (S twice). Shared memory:
//   Q (64 KB), one 64-key K tile (64 KB) and one V tile (64 KB), 8 boxes of 64
//   columns each, 192 KB of the 227 KB; K and V have separate barriers, so the
//   next K tile loads while the consumers run the softmax and P.V, and the next
//   V tile while they run the next S. No ping-pong and no overlap of S with P.V
//   inside a consumer: the simple, correct first design. With one head the grid
//   is B * Nq / 64 items (32 at B = 2, N = 1024: a quarter of the 132 SMs); a
//   split over the keys is later work. fp32 at D = 512: the fp32 kernel below
//   with eight lanes per query row (their partial dot products meet in a
//   three-step butterfly of shuffles, so all eight hold the same score), each
//   lane's 64 columns interleaved in 4-wide groups so the lanes of a row read
//   neighbouring words of a key row, and 8-key shared-memory tiles (32 KB).
//
// K8, the S.V diagnostic, is the same bf16 kernel at D = DP = 64 with the softmax
// compiled out (fa_fwd_bf16_kernel<false, 64, 64>, entry point uc_sv_only):
//   out = bf16(sum over key tiles of float(bf16(q k^T in fp32)) . v), no
//   scale, no mask, no max or sum, one rounding of O at the end.
// Replaces: scripts/sweep_attention.py: mxu_only with the body _mxu_only_kernel
//   (the "MXU-only" yardstick of the attention sweep). It does K1's two
//   products in K1's schedule, so K1's time minus K8's is what the softmax
//   costs K1. Keys past Nk add nothing: TMA zero-fills their K and V rows, and
//   their scores on the ragged last tile are set to 0 all the same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>

#include "fa_common.cuh"
#include "hopper.cuh"

namespace {

using namespace uc_fa;
namespace hw = uc_hopper;

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int BQ = 128;                 // query rows per block: two consumer warpgroups x 64
constexpr int BK = 128;                 // keys per K / V tile
constexpr int THREADS = 384;            // producer warpgroup + two consumer warpgroups
constexpr int BOX_COLS = 64;            // columns of one TMA box: one 128-byte swizzle row
constexpr int ATOM_BYTES = BK * 128;    // one box of a Q, K or V tile (BQ == BK rows of 128 bytes)

// The layout of the kernel built for the padded head dim DP (64 or 128): DP / 64 boxes per tile.
template <int DP>
struct FwdCfg {
  static_assert(DP == 64 || DP == 128, "padded head dim");
  static constexpr int BOXES = DP / BOX_COLS;
  static constexpr int STAGES = DP == 128 ? 2 : 3;  // K / V ring slots
  static constexpr int TILE_BYTES = BK * DP * 2;    // one K or V tile
};

template <int DP>
struct alignas(hw::SMEM_ALIGN) FwdSmem {
  __nv_bfloat16 q[BQ * DP];
  __nv_bfloat16 k[FwdCfg<DP>::STAGES][BK * DP];
  __nv_bfloat16 v[FwdCfg<DP>::STAGES][BK * DP];
  uint64_t q_full, q_empty, full[FwdCfg<DP>::STAGES], empty[FwdCfg<DP>::STAGES];
};
template <int DP>
constexpr int fwd_smem_bytes() {
  return sizeof(FwdSmem<DP>) + hw::SMEM_ALIGN > hw::MIN_SMEM_BYTES ? sizeof(FwdSmem<DP>) + hw::SMEM_ALIGN
                                                                   : hw::MIN_SMEM_BYTES;
}

// S = Q K^T for one consumer's 64 rows and a 128-key tile: DP / 16 k-steps of 16 over the padded head dim, Q
// from registers, K read K-major from shared memory (box kk / 4, 32 bytes a k-step inside its swizzled rows);
// the first k-step overwrites S. One wgmma group, committed.
template <int DP>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], const uint32_t (&qa)[DP / 16][4], uint32_t k_addr) {
  hw::fence_regs(sc);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    hw::wgmma_m64n128k16_rs<0>(sc, qa[kk], hw::desc_k_major(k_addr + (kk / 4) * ATOM_BYTES + (kk % 4) * 32), kk > 0);
  hw::wgmma_commit();
}

// O += P V: 8 k-steps of 16 keys, P from registers, V read MN-major (rows = keys) with the transpose bit, N = DP
// (at DP = 128 the two boxes of the tile are the MN-major operand's two atoms, ATOM_BYTES apart). One wgmma
// group, committed.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 2], uint32_t (&pa)[BK / 16][4], uint32_t v_addr) {
  hw::fence_regs(acc);
  hw::fence_regs(pa);
  hw::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    if constexpr (DP == 64)
      hw::wgmma_m64n64k16_rs<1>(acc, pa[kc], hw::desc_mn_major(v_addr + kc * 16 * 128), 1);
    else
      hw::wgmma_m64n128k16_rs<1>(acc, pa[kc], hw::desc_mn_major(v_addr + kc * 16 * 128, ATOM_BYTES), 1);
  }
  hw::wgmma_commit();
}

// The register A operands of this consumer's 64 Q rows over the padded head dim: 4 k-steps from each box.
template <int DP>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[DP / 16][4], const __nv_bfloat16* q, int cwg, int warp,
                                             int lane) {
#pragma unroll
  for (int box = 0; box < DP / BOX_COLS; ++box)
    hw::load_a_frags(*reinterpret_cast<uint32_t(*)[4][4]>(&qa[4 * box]), q + box * BQ * BOX_COLS + cwg * 64 * BOX_COLS,
                     warp, lane);
}

// The scores of tile j's keys past Nk set to `fill`, on the ragged last tile only. NS: the accumulator's
// registers, so the tile holds 2 NS keys (128 in the kernel above, 64 in the D = 512 one).
template <int NS>
__device__ __forceinline__ void mask_keys(float (&sc)[NS], int j, int Nk, int t, float fill) {
  constexpr int KT = 2 * NS;
  if ((j + 1) * KT > Nk) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (j * KT + (i >> 2) * 8 + 2 * t + (i & 1) >= Nk) sc[i] = fill;
  }
}

// The online softmax of tile j on S in place: the row max of the raw scores over the 4 lanes of a row (keys
// past Nk masked to -inf, on the last tile only), the new running max m in log2 units of the scaled scores,
// the rescale corr of O and l, and p = exp2(s * scale_log2 - m), added to l before its bf16 rounding (the TPU
// kernel's order). The scale is positive, so the max of the raw scores scales to the max of the scaled ones.
template <int NS>
__device__ __forceinline__ void online_softmax(float (&sc)[NS], float (&m)[2], float (&l)[2], float (&corr)[2],
                                               int j, int Nk, int t, float scale_log2) {
  mask_keys(sc, j, Nk, t, -INFINITY);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);  // finite: every tile holds at least one key < Nk
    corr[r] = hw::exp2_ftz(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float p = hw::exp2_ftz(fmaf(sc[i], scale_log2, neg_m[(i >> 1) & 1]));
    sc[i] = p;
    l[(i >> 1) & 1] += p;
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&corr)[2]) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    acc[4 * c] *= corr[0];
    acc[4 * c + 1] *= corr[0];
    acc[4 * c + 2] *= corr[1];
    acc[4 * c + 3] *= corr[1];
  }
}

// Persistent: gridDim.x blocks (at most one per SM) walk the (query tile, head, batch) work items, query tile
// fastest, so that the blocks working at one time share K and V in L2. The producer runs ahead across work
// items: the next item's Q (released by the consumers as soon as they hold it in registers) and its first K/V
// tiles load while the consumers finish the current item, which hides each item's pipeline fill and epilogue.
// kSoftmax: K1 (attention); without it K8 (S.V: raw scores rounded to bf16, no scale, O summed over every
// key tile and rounded once; lse and scale_log2 unused). DP: the padded head dim (64 or 128); D <= DP the
// real one, the columns of o written (a compile-time constant too, so D = 64 compiles to the kernel it was
// before the padding came in).
template <bool kSoftmax, int DP, int D>
__global__ void __launch_bounds__(THREADS, 1) fa_fwd_bf16_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int B, int H,
    int Nq, int Nk, float scale_log2) {
  static_assert(D <= DP && D % 16 == 0, "the real head dim");
  using Cfg = FwdCfg<DP>;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  FwdSmem<DP>& sm = *reinterpret_cast<FwdSmem<DP>*>(hw::align_smem(smem_raw));
  const int tid = threadIdx.x;
  const int q_tiles = (Nq + BQ - 1) / BQ, n_items = q_tiles * H * B;
  const int n_tiles = (Nk + BK - 1) / BK;

  if (tid == 0) {
    hw::mbar_init(&sm.q_full, 1);
    hw::mbar_init(&sm.q_empty, THREADS - 128);  // every consumer thread, once it holds its Q rows in registers
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
      uint32_t phase = 0, q_phase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int qt = item % q_tiles, h = (item / q_tiles) % H, b = item / (q_tiles * H);
        hw::mbar_wait(&sm.q_empty, q_phase ^ 1);  // the first item finds the Q buffer free
        hw::mbar_arrive_expect_tx(&sm.q_full, BQ * DP * 2);
#pragma unroll
        for (int box = 0; box < Cfg::BOXES; ++box)
          hw::tma_load_4d(sm.q + box * BQ * BOX_COLS, &qmap, &sm.q_full, box * BOX_COLS, h, qt * BQ, b);
        q_phase ^= 1;
        for (int j = 0; j < n_tiles; ++j) {
          hw::mbar_wait(&sm.empty[s], phase ^ 1);  // the first pass over the ring finds every slot free
          hw::mbar_arrive_expect_tx(&sm.full[s], 2 * Cfg::TILE_BYTES);
#pragma unroll
          for (int box = 0; box < Cfg::BOXES; ++box) {
            hw::tma_load_4d(sm.k[s] + box * BK * BOX_COLS, &kmap, &sm.full[s], box * BOX_COLS, h, j * BK, b);
            hw::tma_load_4d(sm.v[s] + box * BK * BOX_COLS, &vmap, &sm.full[s], box * BOX_COLS, h, j * BK, b);
          }
          if (++s == STAGES) s = 0, phase ^= 1;
        }
      }
    }
  } else {  // consumer warpgroups: 64 query rows each
    hw::setmaxnreg_inc<232>();
    const int ctid = tid - 128, cwg = ctid >> 7, warp = (ctid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // Ping-pong between the consumers (named barriers 1 and 2, 256 threads): each issues its wgmma groups
    // only in its turn and hands the turn over right after, so one consumer's softmax overlaps the
    // other's products. Consumer 0 goes first; consumer 1's last hand-over is never waited for. K8 keeps it
    // too: on the H100 it was faster with it than without at nine of ten readings (PERF.md section 6, K8).
    const int my_turn = 1 + cwg, other_turn = 2 - cwg;
    if (cwg == 1) hw::named_bar_arrive(1, 256);
    int s = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int qt = item % q_tiles, h = (item / q_tiles) % H, b = item / (q_tiles * H);
      const bool last_item = item + gridDim.x >= n_items;
      const int row0 = qt * BQ + cwg * 64 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
      const int row1 = row0 + 8;

      float acc[DP / 2];  // O: m64nDP accumulator
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // running max of rows row0 / row1 (log2 units)
      float l[2] = {0.f, 0.f};              // this thread's share of the running sums

      // Q as register A operands, read once: each Q.K^T then reads only K from shared memory, and the Q
      // buffer is free for the next item at once.
      uint32_t qa[DP / 16][4];
      hw::mbar_wait(&sm.q_full, q_phase);
      load_q_frags<DP>(qa, sm.q, cwg, warp, lane);
      hw::mbar_arrive(&sm.q_empty);
      q_phase ^= 1;

      // Software pipeline inside the warpgroup (FlashAttention-3's order): tile j's S = Q K^T is issued, O
      // is rescaled for tile j-1's max, tile j-1's O += P V is issued, and tile j's softmax runs while that
      // P.V is still on the tensor cores. Each group of wgmma has its own fence, so no register they read or
      // write is defined by other instructions inside it. K8 keeps the order, with S in place of P.
      uint32_t pa[BK / 16][4];  // P of the previous tile in bf16: the register A operand of P.V
      float sc[BK / 2];         // S of this tile
      float corr[2];            // the previous tile's rescale of O
      hw::mbar_wait(&sm.full[s], phase);
      hw::named_bar_sync(my_turn, 256);
      issue_qk<DP>(sc, qa, hw::smem_u32(sm.k[s]));
      hw::named_bar_arrive(other_turn, 256);
      hw::wgmma_wait<0>();
      hw::fence_regs(sc);
      if (kSoftmax)
        online_softmax(sc, m, l, corr, 0, Nk, t, scale_log2);
      else
        mask_keys(sc, 0, Nk, t, 0.f);
      hw::pack_a<BK>(pa, sc);
      int prev = s;
      if (++s == STAGES) s = 0, phase ^= 1;
      for (int j = 1; j < n_tiles; ++j) {
        hw::mbar_wait(&sm.full[s], phase);
        hw::named_bar_sync(my_turn, 256);
        issue_qk<DP>(sc, qa, hw::smem_u32(sm.k[s]));
        if (kSoftmax) rescale(acc, corr);
        issue_pv<DP>(acc, pa, hw::smem_u32(sm.v[prev]));
        hw::named_bar_arrive(other_turn, 256);
        hw::wgmma_wait<1>();  // S has landed; P.V may still run
        hw::fence_regs(sc);
        if (kSoftmax)
          online_softmax(sc, m, l, corr, j, Nk, t, scale_log2);
        else
          mask_keys(sc, j, Nk, t, 0.f);
        hw::wgmma_wait<0>();  // the previous P.V is done: release its slot
        hw::fence_regs(acc);
        hw::mbar_arrive(&sm.empty[prev]);
        hw::pack_a<BK>(pa, sc);
        prev = s;
        if (++s == STAGES) s = 0, phase ^= 1;
      }
      if (kSoftmax) rescale(acc, corr);
      hw::named_bar_sync(my_turn, 256);
      issue_pv<DP>(acc, pa, hw::smem_u32(sm.v[prev]));  // the last tile's O += P V
      if (cwg == 0 || !last_item) hw::named_bar_arrive(other_turn, 256);
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
      hw::mbar_arrive(&sm.empty[prev]);

      if (kSoftmax) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        }
#pragma unroll
        for (int c = 0; c < DP / 8; ++c) {
          acc[4 * c] /= l[0];
          acc[4 * c + 1] /= l[0];
          acc[4 * c + 2] /= l[1];
          acc[4 * c + 3] /= l[1];
        }
      }
      __nv_bfloat16* op = o + ((long long)b * Nq * H + h) * D;  // o is contiguous (B, Nq, H, D)
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        const int col = c * 8 + 2 * t;
        if (c * 8 < D) {  // the columns past D are the padding's zeros (a compile-time test)
          if (row0 < Nq)
            *reinterpret_cast<uint32_t*>(op + (long long)row0 * H * D + col) =
                hw::pack_bf16x2(acc[4 * c], acc[4 * c + 1]);
          if (row1 < Nq)
            *reinterpret_cast<uint32_t*>(op + (long long)row1 * H * D + col) =
                hw::pack_bf16x2(acc[4 * c + 2], acc[4 * c + 3]);
        }
      }
      if (kSoftmax && lse != nullptr && t == 0) {  // m is in log2 units of the scaled scores
        float* lp = lse + ((long long)b * H + h) * Nq;
        if (row0 < Nq) lp[row0] = m[0] * LN2 + logf(l[0]);
        if (row1 < Nq) lp[row1] = m[1] * LN2 + logf(l[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at D = 512: the consumers split O's columns (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int W_D = 512;                     // the head dim
constexpr int W_BQ = 64;                     // query rows per work item, shared by both consumers
constexpr int W_BK = 64;                     // keys per K / V tile
constexpr int W_BOXES = W_D / BOX_COLS;      // 8 boxes of 64 columns per tile
constexpr int W_BOX_BYTES = 64 * 128;        // one box: 64 rows of 128 bytes
constexpr int W_TILE_BYTES = W_BQ * W_D * 2; // one Q, K or V tile (W_BQ == W_BK)

struct alignas(hw::SMEM_ALIGN) WideSmem {
  __nv_bfloat16 q[W_BQ * W_D];
  __nv_bfloat16 k[W_BK * W_D];
  __nv_bfloat16 v[W_BK * W_D];
  uint64_t q_full, q_empty, k_full, k_empty, v_full, v_empty;
};
constexpr int wide_smem_bytes() { return sizeof(WideSmem) + hw::SMEM_ALIGN; }
static_assert(wide_smem_bytes() <= 232448, "the block's shared memory");
static_assert(wide_smem_bytes() >= hw::MIN_SMEM_BYTES, "one block per SM");

// One box after another: `boxes` TMA boxes of 64 columns at rows row0 of head h, batch b, into consecutive
// W_BOX_BYTES slots of dst.
__device__ __forceinline__ void load_wide_tile(__nv_bfloat16* dst, const CUtensorMap* map, uint64_t* bar, int h,
                                               int row0, int b) {
#pragma unroll
  for (int box = 0; box < W_BOXES; ++box)
    hw::tma_load_4d(dst + box * W_BQ * BOX_COLS, map, bar, box * BOX_COLS, h, row0, b);
}

// Persistent: gridDim.x blocks walk the (64-query tile, head, batch) items, query tile fastest. Warpgroup 0's
// thread 0 loads each item's Q, then for each key tile K and V, each behind its own full/empty barrier pair (one
// slot each). Consumer c (warpgroups 1 and 2) computes S over the full head dim, the online softmax, and O's
// columns [256c, 256c + 256). With an LSE pointer, consumer 0 writes each row's logsumexp.
__global__ void __launch_bounds__(THREADS, 1) fa_fwd_bf16_wide_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int B, int H,
    int Nq, int Nk, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  WideSmem& sm = *reinterpret_cast<WideSmem*>(hw::align_smem(smem_raw));
  const int tid = threadIdx.x;
  const int q_tiles = (Nq + W_BQ - 1) / W_BQ, n_items = q_tiles * H * B;
  const int n_tiles = (Nk + W_BK - 1) / W_BK;

  if (tid == 0) {
    hw::mbar_init(&sm.q_full, 1);
    hw::mbar_init(&sm.k_full, 1);
    hw::mbar_init(&sm.v_full, 1);
    hw::mbar_init(&sm.q_empty, THREADS - 128);  // every consumer thread releases each buffer
    hw::mbar_init(&sm.k_empty, THREADS - 128);
    hw::mbar_init(&sm.v_empty, THREADS - 128);
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues every load
    hw::setmaxnreg_dec<40>();
    if (tid == 0) {
      uint32_t q_phase = 0, kv_phase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int qt = item % q_tiles, h = (item / q_tiles) % H, b = item / (q_tiles * H);
        hw::mbar_wait(&sm.q_empty, q_phase ^ 1);  // the first item finds the Q buffer free
        hw::mbar_arrive_expect_tx(&sm.q_full, W_TILE_BYTES);
        load_wide_tile(sm.q, &qmap, &sm.q_full, h, qt * W_BQ, b);
        q_phase ^= 1;
        for (int j = 0; j < n_tiles; ++j) {
          hw::mbar_wait(&sm.k_empty, kv_phase ^ 1);  // both consumers are done with the last K tile's S
          hw::mbar_arrive_expect_tx(&sm.k_full, W_TILE_BYTES);
          load_wide_tile(sm.k, &kmap, &sm.k_full, h, j * W_BK, b);
          hw::mbar_wait(&sm.v_empty, kv_phase ^ 1);  // ... and with the last V tile's P.V
          hw::mbar_arrive_expect_tx(&sm.v_full, W_TILE_BYTES);
          load_wide_tile(sm.v, &vmap, &sm.v_full, h, j * W_BK, b);
          kv_phase ^= 1;
        }
      }
    }
  } else {  // consumer warpgroups: the item's 64 rows, half of O's columns each
    hw::setmaxnreg_inc<232>();
    const int ctid = tid - 128, cwg = ctid >> 7, warp = (ctid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_addr = hw::smem_u32(sm.q), k_addr = hw::smem_u32(sm.k);
    const uint32_t v_addr = hw::smem_u32(sm.v) + cwg * 4 * W_BOX_BYTES;  // this consumer's four boxes of V
    uint32_t q_phase = 0, kv_phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int qt = item % q_tiles, h = (item / q_tiles) % H, b = item / (q_tiles * H);
      const int row0 = qt * W_BQ + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
      const int row1 = row0 + 8;

      float acc0[64], acc1[64];  // O's columns [256c, 256c + 128) and [256c + 128, 256c + 256): m64n128 each
#pragma unroll
      for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // running max of rows row0 / row1 (log2 units)
      float l[2] = {0.f, 0.f};              // this thread's share of the running sums
      float sc[W_BK / 2];                   // S of this tile: m64n64
      uint32_t pa[W_BK / 16][4];            // P in bf16: the register A operand of P.V
      float corr[2];

      hw::mbar_wait(&sm.q_full, q_phase);
      q_phase ^= 1;
      for (int j = 0; j < n_tiles; ++j) {
        // S = Q K^T: 32 k-steps of 16 over the 8 boxes, both operands K-major in shared memory
        hw::mbar_wait(&sm.k_full, kv_phase);
        hw::fence_regs(sc);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < W_D / 16; ++kk) {
          const uint32_t off = (kk / 4) * W_BOX_BYTES + (kk % 4) * 32;
          hw::wgmma_m64n64k16_ss<0, 0>(sc, hw::desc_k_major(q_addr + off), hw::desc_k_major(k_addr + off), kk > 0);
        }
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(sc);
        hw::mbar_arrive(&sm.k_empty);
        if (j == n_tiles - 1) hw::mbar_arrive(&sm.q_empty);  // the item's last read of Q

        online_softmax(sc, m, l, corr, j, Nk, t, scale_log2);
        hw::pack_a<W_BK>(pa, sc);
        rescale(acc0, corr);
        rescale(acc1, corr);

        // O += P V over this consumer's 256 columns: 4 k-steps of 16 keys, two m64n128 products each
        hw::mbar_wait(&sm.v_full, kv_phase);
        hw::fence_regs(acc0);
        hw::fence_regs(acc1);
        hw::fence_regs(pa);
        hw::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < W_BK / 16; ++kc) {
          hw::wgmma_m64n128k16_rs<1>(acc0, pa[kc], hw::desc_mn_major(v_addr + kc * 16 * 128, W_BOX_BYTES), 1);
          hw::wgmma_m64n128k16_rs<1>(acc1, pa[kc],
                                     hw::desc_mn_major(v_addr + 2 * W_BOX_BYTES + kc * 16 * 128, W_BOX_BYTES), 1);
        }
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(acc0);
        hw::fence_regs(acc1);
        hw::mbar_arrive(&sm.v_empty);
        kv_phase ^= 1;
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      __nv_bfloat16* op = o + ((long long)b * Nq * H + h) * W_D + cwg * 256;  // o is contiguous (B, Nq, H, D)
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = c * 8 + 2 * t;
        if (row0 < Nq) {
          __nv_bfloat16* p0 = op + (long long)row0 * H * W_D + col;
          *reinterpret_cast<uint32_t*>(p0) = hw::pack_bf16x2(acc0[4 * c] / l[0], acc0[4 * c + 1] / l[0]);
          *reinterpret_cast<uint32_t*>(p0 + 128) = hw::pack_bf16x2(acc1[4 * c] / l[0], acc1[4 * c + 1] / l[0]);
        }
        if (row1 < Nq) {
          __nv_bfloat16* p1 = op + (long long)row1 * H * W_D + col;
          *reinterpret_cast<uint32_t*>(p1) = hw::pack_bf16x2(acc0[4 * c + 2] / l[1], acc0[4 * c + 3] / l[1]);
          *reinterpret_cast<uint32_t*>(p1 + 128) = hw::pack_bf16x2(acc1[4 * c + 2] / l[1], acc1[4 * c + 3] / l[1]);
        }
      }
      if (lse != nullptr && cwg == 0 && t == 0) {  // m is in log2 units of the scaled scores
        float* lp = lse + ((long long)b * H + h) * Nq;
        if (row0 < Nq) lp[row0] = m[0] * LN2 + logf(l[0]);
        if (row1 < Nq) lp[row1] = m[1] * LN2 + logf(l[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full precision
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 128;
constexpr int F32_BK = 32;    // key rows per shared-memory tile
constexpr int F32_CHUNK = 16; // keys scored before each rescale of the accumulator

// TPR threads per query row (1; 2 for D = 80, 96 and 128, neighbouring lanes each with half of the row's D; 8 for
// D = 512), so a thread holds DT = D / TPR elements of q and of the accumulator: at most 64 of each. With TPR <= 2
// a thread's columns are contiguous; with 8 they are 4-wide groups interleaved across the row's lanes, so the 8
// lanes read 128 neighbouring bytes of a key or value row. KB: key rows per shared-memory tile (8 at D = 512, so
// K and V stay within the 48 KB of static shared memory).
template <int D, int TPR, int KB = F32_BK>
__global__ void __launch_bounds__(F32_THREADS) fa_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int H, int Nq, int Nk, Strides qs, Strides ks, Strides vs,
    float scale_log2) {
  constexpr int DT = D / TPR, ROWS = F32_THREADS / TPR;
  constexpr int CHUNK = KB < F32_CHUNK ? KB : F32_CHUNK;
  constexpr int STEP = TPR > 2 ? 4 * TPR : 4;  // columns between a thread's 4-wide groups
  static_assert(DT % 4 == 0 && DT <= 64 && KB % CHUNK == 0, "a thread's share of the row");
  __shared__ __align__(16) float k_s[KB][D];
  __shared__ __align__(16) float v_s[KB][D];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * ROWS + tid / TPR;
  const int d0 = TPR > 2 ? (tid % TPR) * 4 : (tid % TPR) * DT;  // the column of this thread's first group
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;

  float qr[DT], acc[DT];
  const float* qp = q + b * qs.b + h * qs.h + (long long)row * qs.n + d0;
#pragma unroll
  for (int d = 0; d < DT; d += 4) {
    const float4 x =
        row < Nq ? *reinterpret_cast<const float4*>(qp + (d / 4) * STEP) : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[d] = x.x, qr[d + 1] = x.y, qr[d + 2] = x.z, qr[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += KB) {
    __syncthreads();
    for (int c = tid; c < KB * D / 4; c += blockDim.x) {
      const int r = c / (D / 4), d4 = (c % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < Nk) {
        kx = *reinterpret_cast<const float4*>(kp + (long long)(k0 + r) * ks.n + d4);
        vx = *reinterpret_cast<const float4*>(vp + (long long)(k0 + r) * vs.n + d4);
      }
      *reinterpret_cast<float4*>(&k_s[r][d4]) = kx;
      *reinterpret_cast<float4*>(&v_s[r][d4]) = vx;
    }
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < KB; c0 += CHUNK) {
      float s[CHUNK];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DT; d += 4) {  // the rows of a warp read the same key row: a shared-memory broadcast
          const float4 kx = *reinterpret_cast<const float4*>(&k_s[c0 + i][d0 + (d / 4) * STEP]);
          dot = fmaf(qr[d], kx.x, dot);
          dot = fmaf(qr[d + 1], kx.y, dot);
          dot = fmaf(qr[d + 2], kx.z, dot);
          dot = fmaf(qr[d + 3], kx.w, dot);
        }
        // a butterfly over the row's lanes: every lane ends with the same sum (a + b == b + a at each step)
#pragma unroll
        for (int x = 1; x < TPR; x <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, x);
        s[i] = k0 + c0 + i < Nk ? dot * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i]);
      }
      const float m_new = fmaxf(m, mx);  // finite: the first chunk holds key 0
      const float corr = exp2f(m - m_new);
      m = m_new;
      l *= corr;
#pragma unroll
      for (int d = 0; d < DT; ++d) acc[d] *= corr;
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        const float p = exp2f(s[i] - m);
        l += p;
#pragma unroll
        for (int d = 0; d < DT; d += 4) {
          const float4 vx = *reinterpret_cast<const float4*>(&v_s[c0 + i][d0 + (d / 4) * STEP]);
          acc[d] = fmaf(p, vx.x, acc[d]);
          acc[d + 1] = fmaf(p, vx.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vx.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vx.w, acc[d + 3]);
        }
      }
    }
  }

  if (row < Nq) {
    float* op = o + (((long long)b * Nq + row) * H + h) * D + d0;
#pragma unroll
    for (int d = 0; d < DT; d += 4)
      *reinterpret_cast<float4*>(op + (d / 4) * STEP) =
          make_float4(acc[d] / l, acc[d + 1] / l, acc[d + 2] / l, acc[d + 3] / l);
    if (lse != nullptr && tid % TPR == 0) lse[((long long)b * H + h) * Nq + row] = m * LN2 + logf(l);
  }
}

template <int D, int TPR, int KB = F32_BK>
void launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Nq, int Nk,
                Strides qs, Strides ks, Strides vs, float scale_log2, cudaStream_t st) {
  constexpr int ROWS = F32_THREADS / TPR;
  const dim3 grid((Nq + ROWS - 1) / ROWS, H, B);
  fa_fwd_f32_kernel<D, TPR, KB><<<grid, F32_THREADS, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Nq, Nk, qs, ks, vs, scale_log2);
}

// The bf16 kernel on its persistent grid: K1 (kSoftmax) or K8, built for the padded head dim DP and the real one
// D. `layouts` as uc_flash_attention_fwd takes them.
template <bool kSoftmax, int DP, int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Nq, int Nk,
                const long long* layouts, float scale_log2, cudaStream_t st) {
  CUtensorMap qm, km, vm;
  int status = hw::encode_tile_map(&qm, q, layouts, BQ);
  if (status == 0) status = hw::encode_tile_map(&km, k, layouts + hw::LAYOUT_INTS, BK);
  if (status == 0) status = hw::encode_tile_map(&vm, v, layouts + 2 * hw::LAYOUT_INTS, BK);
  static bool smem_set[64];
  if (status == 0) status = hw::allow_smem(fa_fwd_bf16_kernel<kSoftmax, DP, D>, fwd_smem_bytes<DP>(), smem_set);
  if (status != 0) return status;
  const long long items = (long long)((Nq + BQ - 1) / BQ) * H * B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int sms = 0;
  status = hw::sm_count(&sms);
  if (status != 0) return status;
  const int grid = (int)(items < sms ? items : sms);
  fa_fwd_bf16_kernel<kSoftmax, DP, D><<<grid, THREADS, fwd_smem_bytes<DP>(), st>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), B, H, Nq, Nk, scale_log2);
  return 0;
}

// The D = 512 bf16 kernel on its persistent grid (boxes of 64 rows).
int launch_bf16_wide(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Nq, int Nk,
                     const long long* layouts, float scale_log2, cudaStream_t st) {
  CUtensorMap qm, km, vm;
  int status = hw::encode_tile_map(&qm, q, layouts, W_BQ);
  if (status == 0) status = hw::encode_tile_map(&km, k, layouts + hw::LAYOUT_INTS, W_BK);
  if (status == 0) status = hw::encode_tile_map(&vm, v, layouts + 2 * hw::LAYOUT_INTS, W_BK);
  static bool smem_set[64];
  if (status == 0) status = hw::allow_smem(fa_fwd_bf16_wide_kernel, wide_smem_bytes(), smem_set);
  if (status != 0) return status;
  const long long items = (long long)((Nq + W_BQ - 1) / W_BQ) * H * B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int sms = 0;
  status = hw::sm_count(&sms);
  if (status != 0) return status;
  const int grid = (int)(items < sms ? items : sms);
  fa_fwd_bf16_wide_kernel<<<grid, THREADS, wide_smem_bytes(), st>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), B, H, Nq, Nk, scale_log2);
  return 0;
}

}  // namespace

// The element strides (b, n, h) of a tensor from its tensor-map layout (byte strides of h, n, b).
static Strides layout_strides(const long long* L, int elem_bytes) {
  return Strides{L[6] / elem_bytes, L[5] / elem_bytes, L[4] / elem_bytes};
}

// dtype: 0 = float32, 1 = bfloat16; head_dim: 32, 64, 80, 96, 128 or 512. `layouts` holds the tensor-map layouts
// of q, k and v, 11 ints each (hopper.cuh LAYOUT_INTS; boxes of 64 columns and 128 rows, 64 rows at D = 512),
// from which the fp32 kernel takes its element
// strides; d has unit stride. o is a contiguous (B, Nq, H, D) tensor; lse, when not null, a
// contiguous (B, H, Nq) float32 tensor. Returns a cudaError_t.
extern "C" int uc_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
                                      int B, int H, int Nq, int Nk, int head_dim, const long long* layouts,
                                      float scale, void* stream) {
  const int D = head_dim;
  if ((D != 32 && D != 64 && D != 80 && D != 96 && D != 128 && D != 512) || B <= 0 || H <= 0 || Nq <= 0 ||
      Nk <= 0)
    return (int)cudaErrorInvalidValue;
  const long long *lq = layouts, *lk = layouts + hw::LAYOUT_INTS, *lv = layouts + 2 * hw::LAYOUT_INTS;
  const float scale_log2 = scale * LOG2E;  // exp(x) = exp2(x * log2(e))
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    int status;
    switch (D) {
      case 32: status = launch_bf16<true, 64, 32>(q, k, v, o, lse, B, H, Nq, Nk, layouts, scale_log2, st); break;
      case 64: status = launch_bf16<true, 64, 64>(q, k, v, o, lse, B, H, Nq, Nk, layouts, scale_log2, st); break;
      case 80: status = launch_bf16<true, 128, 80>(q, k, v, o, lse, B, H, Nq, Nk, layouts, scale_log2, st); break;
      case 96: status = launch_bf16<true, 128, 96>(q, k, v, o, lse, B, H, Nq, Nk, layouts, scale_log2, st); break;
      case 128: status = launch_bf16<true, 128, 128>(q, k, v, o, lse, B, H, Nq, Nk, layouts, scale_log2, st); break;
      default: status = launch_bf16_wide(q, k, v, o, lse, B, H, Nq, Nk, layouts, scale_log2, st); break;
    }
    if (status != 0) return status;
  } else if (dtype == 0) {
    const Strides qs = layout_strides(lq, 4), ks = layout_strides(lk, 4), vs = layout_strides(lv, 4);
    switch (D) {
      case 32: launch_f32<32, 1>(q, k, v, o, lse, B, H, Nq, Nk, qs, ks, vs, scale_log2, st); break;
      case 64: launch_f32<64, 1>(q, k, v, o, lse, B, H, Nq, Nk, qs, ks, vs, scale_log2, st); break;
      case 80: launch_f32<80, 2>(q, k, v, o, lse, B, H, Nq, Nk, qs, ks, vs, scale_log2, st); break;
      case 96: launch_f32<96, 2>(q, k, v, o, lse, B, H, Nq, Nk, qs, ks, vs, scale_log2, st); break;
      case 128: launch_f32<128, 2>(q, k, v, o, lse, B, H, Nq, Nk, qs, ks, vs, scale_log2, st); break;
      default: launch_f32<512, 8, 8>(q, k, v, o, lse, B, H, Nq, Nk, qs, ks, vs, scale_log2, st); break;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K8: S.V without the softmax over bf16 q (B, Nq, H, 64) and k, v (B, Nk, H, 64), read through their
// tensor-map layouts as uc_flash_attention_fwd takes them (boxes of 128 rows); o is a contiguous (B, Nq, H, 64)
// bf16 tensor. Returns a cudaError_t.
extern "C" int uc_sv_only(const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int Nk,
                          int head_dim, const long long* layouts, void* stream) {
  if (head_dim != 64 || B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  const int status = launch_bf16<false, 64, 64>(q, k, v, o, nullptr, B, H, Nq, Nk, layouts, 0.f,
                                                 static_cast<cudaStream_t>(stream));
  return status != 0 ? status : (int)cudaGetLastError();
}

// Nanoseconds per bf16 tensor-map encoding of `layout` (128-row box) over `iters` encodings, or -1 on
// failure: the host cost each K1 / K3 call pays per map.
extern "C" double uc_tensor_map_encode_ns(const void* base, const long long* layout, int iters) {
  CUtensorMap map;
  if (iters <= 0 || hw::encode_tile_map(&map, base, layout, BQ) != 0) return -1.0;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) hw::encode_tile_map(&map, base, layout, BQ);
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / iters;
}

extern "C" const char* uc_error_string(int status) { return cudaGetErrorString(static_cast<cudaError_t>(status)); }
