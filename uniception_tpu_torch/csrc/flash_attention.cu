// Flash attention forward (non-causal, no mask) over (B, N, H, D) tensors, D a multiple of 8 up to 512.
//
// Replaces: uniception_tpu/ops/flash_attention.py: flash_attention /
//   _flash_attention_impl with the bodies _fa_single_kernel and _fa_kernel
//   (forward; with_lse=True when an LSE pointer is given). The Pallas kernel
//   takes any D (its _plan); so does this one up to 512, D passed at run time
//   to one build per padded head dim DP (64, 128, 192, 256, 512), the wrapper
//   (ops/flash_attention.py) padding a D that is not a multiple of 8 into a
//   copy. The repository's heads: 16 (the training example's defaults), 32
//   (E-RADIO's windows), 64 (CroCo, DINOv2/v3, RADIO-b/l/g, PE-B/L, Pixio-B/L/1B),
//   80 (RADIO-h, Pixio-H), 96 (PE-G, Pixio-5B), 128 (DINOv3-7b), 192 (PE-G's
//   attention pooling) and 512 (the Cosmos tokenizer's single-head mid-block
//   attention, models/libs/cosmos_tokenizer/modules/layers2d.py AttnBlock, for
//   which the Pallas _plan shrinks its tiles).
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
//   * Head dims. The kernel is built for a padded head dim DP: 64 for D <= 64,
//     128 for 64 < D <= 128, D itself passed at run time (the columns of o
//     written, o's row length), but for D = 64, built as a constant. Every
//     tile is DP / 64 boxes of 64
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
//   * fp32: see "fp32" below.
//   * Later work: a third consumer warpgroup, a TMA store of the output, P.V at
//     N = D where the swizzle allows it.
//
// 128 < D <= 512 (bf16, fa_fwd_bf16_wide_kernel<DP>, DP = 192, 256 or 512): the kernel above cannot hold it. At
//   D = 512 a consumer's 64 x 512 fp32 accumulator would be 256 registers a thread and its Q operands 128 more, over the
//   255 a thread may have; at DP = 256 Q (128 rows, 64 KB) and two 128-key K/V stages (128 KB) leave no room. So the
//   two consumer warpgroups split O's columns: a work unit is 64 query rows of one (b, h), consumer 0 owns O's first
//   ceil(DP / 128) boxes of 64 columns, consumer 1 the rest (at D = 512 [256c, 256c + 256), two m64n128 accumulators,
//   128 registers; at DP = 192 box 2, whose m64n128 product takes a box of zeros as its second atom, so that both
//   consumers issue the same instruction: a run-time choice between an m64n128 and an m64n64 product on one
//   accumulator made ptxas serialise every wgmma of K3's wide kernels, C7520). S = Q.K^T is wgmma m64n64k16 with Q
//   and K read K-major from shared memory (Q is too wide for registers); P.V takes P from registers and V MN-major
//   through the transpose bit.
//   * S once at DP = 512: consumer c takes S's k-steps [16c, 16c + 16), and the two add each other's partial scores
//     through shared memory (two 64 x 64 fp32 buffers, named barriers for full and free). S0 + S1 == S1 + S0, so both
//     hold the same bits and run the same online softmax with no further exchange. At DP = 192 and 256 each consumer
//     computes the whole S (the same bits in both, 1.5x the tensor-core work): there S once measured slower (0.0305-
//     0.0322 against 0.0274-0.0279 ms at (2,1024,1024,4,256), H100, PERF.md section 6), since the exchange holds the
//     two consumers in step and neither one's softmax then overlaps the other's products.
//   * What bounds it: neither the tensor cores nor the loads alone. At (2,4096,1,512) a 64-key tile takes 2.4 us
//     against 1.1 us of tensor-core work; without the exchange and the softmax (a diagnostic, its output wrong) 0.13
//     ms against 0.15, without the K and V loads 0.14: the tile's chain S -> exchange -> softmax -> P.V runs in turn.
//     Overlapping the next S with P.V there needs S and P beside O's 128 registers: ptxas spilled 208 bytes and it ran
//     1.3x slower. A cluster of two CTAs sharing each K and V tile by TMA multicast (half the L2 reads) ran 1.4x
//     slower, and 128-row units (64 per consumer, O over every column) at DP = 192-256 1.2x slower.
//   * Each consumer runs a tile's S, softmax and P.V in turn. Issuing tile j's S before tile j - 1's P.V (the order
//     of the kernel above) measured slower at PE-G's pool (DP = 192) and 1-2% faster on a synthetic DP = 256 shape
//     that no path runs in bf16, so it is not built. Warps 0, 1 and 2 of the producer warpgroup each load one operand
//     (Q, K, V), so a load waits only on its own slot; K and V have rings of three slots at DP = 192, two at 256, one
//     at 512 (there Q, K and V take 192 KB and the exchange 32 KB of the 227 KB).
//   * A split over the keys when the units would fill less than a wave of the SMs (ops/flash_attention.py
//     k1_wide_tiles_per_split: PE-G's attention pool has 16 units of one query each, (2,1024,1,512) 32): a unit is
//     then (64 query rows, a range of key tiles); each writes its fp32 O, unnormalised, its row max and its row sum
//     into a workspace the wrapper allocates (k1_wide_workspace_floats), and fa_wide_combine_kernel merges the splits
//     in split order into o and, when asked, the logsumexp (K3's input at D = 192 and 256). No atomics: two calls
//     give the same bits.
//   The plan (shared memory per DP, the registers, the splits and the workspace) is in
//   tests/test_torch_kernel_layouts.py (k1_wide_plan), the schedule emulated in tests/test_torch_k1_wide.py.
//   Measured: PERF.md section 6 (chip_smoke.py phase 47).
//
// fp32 (fa_fwd_tf32_kernel<DP>, DP = 32, 64, 128, 256 or 512; D at run time; D <= 16
//   takes fa_fwd_f32_small_kernel below, one CUDA-core thread a query row: at the
//   JAX training example's 4 tokens a head its single launch is twice as fast): the
//   Pallas kernel runs fp32 at Precision.HIGHEST (a multi-pass product on the
//   TPU). Full fp32 on the CUDA cores peaks at 67 TFLOP/s, and the earlier
//   kernel there reached 15% of it (6.80 ms at (2,4096,1,512), 3.8x SDPA fp32):
//   a 128-thread block served 16 query rows, so every byte of K and V was read
//   for 16 queries, and every FMA waited on a shared-memory load.
//   What bounds it now: the tensor cores' TF32 rate, 495 TFLOP/s, at three
//   products for each needed one (165 TFLOP/s of the needed products), and at
//   DP = 512 the 64-row work items' L2 traffic.
//   * Numerics (error-compensated TF32, "3xTF32"): each operand x is split into
//     hi = tf32(x) (cvt.rna) and lo = tf32(x - hi), and each product is taken as
//     hi.hi' + hi.lo' + lo.hi' (about 22 of fp32's 24 bits; lo.lo' is below fp32's
//     rounding). wgmma reads the top 19 bits of an operand, so hi and lo are
//     formed explicitly, each in a tile of its own. The tensor cores sum a chain
//     of products with truncation toward zero, a bias: chained over a whole key
//     tile's P.V it reached 7.7e-6 of ||O|| (the bar is 2e-6), and chained over a
//     32-column box of S and a tile's P.V it still moved an fp32 training step's
//     near-cancelling gradients (attention biases) 8x farther from the plain path
//     than FMA does (1.6e-4 against the 1e-4 bar; an unbiased error cancels in
//     them, a bias adds up). So every 8-wide k-step is a chain of its own (the two
//     correction products first, hi.hi last) into fresh registers, added to S or O
//     in fp32 with round to nearest: 0.7-0.9e-6 of ||O||, and 3.1e-5 on that step
//     (FMA: 2.0e-5). The row split alternates two chain buffers so one k-step's
//     products run while the other's are added; the column split has one.
//     The softmax runs in fp32 on the accumulators as in bf16 (online_softmax);
//     P is split in registers before P.V. tests/test_torch_tf32_split.py emulates
//     these numerics on the CPU against the plain version and the Pallas kernel.
//   * Layouts: tf32 wgmma takes only K-major shared-memory operands. A split
//     pre-pass (tf32_split_kernel, launched by the same entry point) writes q
//     and k as (2, B H, N, D) hi/lo planes and v transposed, (2, B H, D, Nk8)
//     (keys contiguous: K-major as the B operand of P.V, and in vt_key order
//     within each 8 keys, the order P's register A operand holds them in), into
//     a workspace the wrapper allocates (ops/flash_attention.py
//     tf32_workspace_floats; 100 MB at (2,4096,1,512)). The kernel reads it
//     through 3-D fp32 tensor maps in 32-column (128-byte) boxes.
//   * Shape: the bf16 kernels' persistent grid, TMA producer and ring of full /
//     empty mbarriers, two consumer warpgroups. Up to DP = 128 a work item is
//     128 query rows, 64 per consumer, with the item's Q resident in shared
//     memory and the ring carrying each key tile's ceil(D / 32) K boxes (hi and
//     lo) and ceil(D / 64) V chunks (64 of O's columns, hi and lo): every byte of K
//     and V serves 128 queries. S is m64n64k8 with both operands in shared
//     memory, P.V m64n64k8 (m64n32k8 at DP = 32) with P from registers. Above 128
//     a 64 x DP fp32 O does not fit a consumer's registers (256 at DP = 512), so
//     both consumers share 64 query rows: consumer c takes the S boxes and V
//     chunks of parity c, the two exchange their partial scores through shared
//     memory (S0 + S1 == S1 + S0, so both hold the same S and P), and P goes to
//     shared memory (consumer 0 its hi part, consumer 1 its lo part) so that the
//     registers hold O's 128 columns; the ring then carries Q's boxes with K's.
//     No product is computed twice. The plan per DP is in
//     tests/test_torch_kernel_layouts.py (k1_f32_plan).
//   * Measured (H100 80GB HBM3, 700 W, CUDA graphs; chip_smoke.py phase 47):
//     see PERF.md section 6.
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
// real one (a multiple of 8), the columns of o written: DS when it is not 0 (D = 64 is built as a constant,
// as it was before other head dims came in: a D taken at run time cost the main path a few percent), else
// head_dim.
template <bool kSoftmax, int DP, int DS>
__global__ void __launch_bounds__(THREADS, 1) fa_fwd_bf16_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int B, int H,
    int Nq, int Nk, int head_dim, float scale_log2) {
  using Cfg = FwdCfg<DP>;
  const int D = DS > 0 ? DS : head_dim;
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
        if (c * 8 < D) {  // the columns past D are the padding's zeros
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
// bf16 at 128 < D <= 512 (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int W_BQ = 64;                     // query rows per work unit, shared by both consumers
constexpr int W_BK = 64;                     // keys per K / V tile
constexpr int W_BOX_BYTES = 64 * 128;        // one box: 64 rows of 128 bytes
constexpr int W_XCH_FULL = 1, W_XCH_FREE = 2;  // named barriers of the score exchange (W_XCH_FREE + consumer)

// The kernel built for the padded head dim DP (192, 256 or 512): DP / 64 boxes per tile; consumer 0 owns the first A0
// boxes of O's columns, consumer 1 the rest (2 and 1 at DP = 192, beside a box of zeros, so that both issue the same
// m64n128 products; 2 and 2 at 256, 4 and 4 at 512). SONCE: each S computed once, consumer c taking S's k-steps
// [c KH, c KH + KH) and the two exchanging their partial scores; else each consumer computes the whole S (the same
// bits in both). The K / V ring has what the block's memory leaves room for.
template <int DP>
struct WideCfg {
  static constexpr int BOXES = DP / BOX_COLS;
  static constexpr int A0 = (BOXES + 1) / 2;
  static constexpr bool SONCE = DP == 512;
  static constexpr int KH = SONCE ? DP / 32 : DP / 16;       // S's k-steps of 16 per consumer
  static constexpr int STAGES = DP == 512 ? 1 : DP == 256 ? 2 : 3;
  static constexpr int TILE_BYTES = W_BQ * DP * 2;           // one Q, K or V tile (W_BQ == W_BK)
};

template <int DP>
struct alignas(hw::SMEM_ALIGN) WideSmem {
  __nv_bfloat16 q[W_BQ * DP];
  __nv_bfloat16 k[WideCfg<DP>::STAGES][W_BK * DP];
  __nv_bfloat16 v[WideCfg<DP>::STAGES][W_BK * DP];
  __nv_bfloat16 zeros[DP == 192 ? W_BK * BOX_COLS : 8];   // DP = 192: consumer 1's second atom of P.V
  float xch[WideCfg<DP>::SONCE ? 2 * W_BQ * W_BK : 1];   // SONCE: each consumer's partial scores of a tile
  uint64_t q_full, q_empty, k_full[WideCfg<DP>::STAGES], k_empty[WideCfg<DP>::STAGES], v_full[WideCfg<DP>::STAGES],
      v_empty[WideCfg<DP>::STAGES];
};
template <int DP>
constexpr int wide_smem_bytes() {
  return sizeof(WideSmem<DP>) + hw::SMEM_ALIGN > hw::MIN_SMEM_BYTES ? sizeof(WideSmem<DP>) + hw::SMEM_ALIGN
                                                                    : hw::MIN_SMEM_BYTES;
}
static_assert(wide_smem_bytes<512>() <= 232448 && wide_smem_bytes<256>() <= 232448 && wide_smem_bytes<192>() <= 232448,
              "the block's shared memory");

// One box after another: the DP / 64 TMA boxes of 64 columns at rows row0 of head h, batch b, into consecutive
// W_BOX_BYTES slots of dst (boxes past D arrive as zeros).
template <int DP>
__device__ __forceinline__ void load_wide_tile(__nv_bfloat16* dst, const CUtensorMap* map, uint64_t* bar, int h,
                                               int row0, int b) {
#pragma unroll
  for (int box = 0; box < WideCfg<DP>::BOXES; ++box)
    hw::tma_load_4d(dst + box * W_BQ * BOX_COLS, map, bar, box * BOX_COLS, h, row0, b);
}

// This consumer's S = Q K^T for the unit's rows and a key tile: KH k-steps of 16 over the padded head dim (SONCE: its
// half, [c KH, c KH + KH); else all of them), both operands K-major in shared memory (box k / 4, 32 bytes a k-step
// inside its swizzled rows); the first overwrites S. One wgmma group, committed.
template <int DP>
__device__ __forceinline__ void wide_s(float (&sc)[W_BK / 2], uint32_t q_addr, uint32_t k_addr, int c) {
  using Cfg = WideCfg<DP>;
  hw::fence_regs(sc);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Cfg::KH; ++kk) {
    const int k = (Cfg::SONCE ? c * Cfg::KH : 0) + kk;
    const uint32_t off = (k / 4) * W_BOX_BYTES + (k % 4) * 32;
    hw::wgmma_m64n64k16_ss<0, 0>(sc, hw::desc_k_major(q_addr + off), hw::desc_k_major(k_addr + off), kk > 0);
  }
  hw::wgmma_commit();
}

// O += P V over this consumer's A0 boxes of O's columns: 4 k-steps of 16 keys, one m64n128 product per pair of boxes,
// P from registers, V MN-major through the transpose bit (v_addr: the consumer's first box; atom: the byte offset of
// the second atom of its last pair, the box of zeros for consumer 1 at DP = 192). acc holds box a's 64 columns in
// registers [32a, 32a + 32). One wgmma group, committed.
template <int DP>
__device__ __forceinline__ void wide_pv(float (&acc)[WideCfg<DP>::A0 * 32], uint32_t (&pa)[W_BK / 16][4],
                                        uint32_t v_addr, uint32_t atom) {
  constexpr int A0 = WideCfg<DP>::A0;
  static_assert(A0 % 2 == 0, "pairs of boxes");
  hw::fence_regs(acc);
  hw::fence_regs(pa);
  hw::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < W_BK / 16; ++kc)
#pragma unroll
    for (int a = 0; a < A0; a += 2)
      hw::wgmma_m64n128k16_rs<1>(*reinterpret_cast<float(*)[64]>(&acc[32 * a]), pa[kc],
                                 hw::desc_mn_major(v_addr + a * W_BOX_BYTES + kc * 16 * 128,
                                                   a + 2 < A0 ? W_BOX_BYTES : atom), 1);
  hw::wgmma_commit();
}

// SONCE: the other consumer's partial scores of this tile added to this one's through shared memory: both then hold
// the same bits (S0 + S1 == S1 + S0), so both run the same online softmax with no further exchange. Consumer c writes
// its partial once the other has read its last one (barrier W_XCH_FREE + c, which the other arrives at after each
// read), then both wait for both partials (W_XCH_FULL). `grant`: false on the block's last exchange, whose read nobody
// waits for.
__device__ __forceinline__ void exchange_scores(float (&sc)[W_BK / 2], float* xch, int c, int lt, bool grant) {
  hw::named_bar_sync(W_XCH_FREE + c, 256);
  float* mine = xch + c * W_BQ * W_BK;
  const float* other = xch + (c ^ 1) * W_BQ * W_BK;
#pragma unroll
  for (int i = 0; i < W_BK / 2; ++i) mine[i * 128 + lt] = sc[i];
  hw::named_bar_sync(W_XCH_FULL, 256);
#pragma unroll
  for (int i = 0; i < W_BK / 2; ++i) sc[i] += other[i * 128 + lt];
  if (grant) hw::named_bar_arrive(W_XCH_FREE + (c ^ 1), 256);
}

// The work unit `u`: (64-query tile, key split, head, batch), query tile fastest; its key tiles [t0, t1).
struct WideUnit {
  int qt, split, h, b, t0, t1;
};
__device__ __forceinline__ WideUnit wide_unit(int u, int q_tiles, int splits, int H, int tps, int n_tiles) {
  const int rest = u / q_tiles, split = rest % splits, hb = rest / splits;
  const int t0 = split * tps, t1 = t0 + tps < n_tiles ? t0 + tps : n_tiles;
  return WideUnit{u % q_tiles, split, hb % H, hb / H, t0, t1};
}

// Persistent: gridDim.x blocks walk the units (64-query tile, key split of `tps` key tiles, head, batch). The
// producer warpgroup's warps 0, 1 and 2 each load one operand: each unit's Q, and each key tile's K and V into their
// rings, so that no load waits on another operand's release. Each consumer (warpgroups 1 and 2) computes S (SONCE: its
// half, exchanged with the other's), runs the online softmax and adds P V over its boxes of O's columns, each tile's
// steps in turn. With one split, o (and the logsumexp, with an LSE pointer) is written here; with more, each
// unit writes its fp32 O, unnormalised, and its row max (log2 units) and sum into ws for fa_wide_combine_kernel. D <=
// DP is the real head dim (a multiple of 8): o's row length and the columns written.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1) fa_fwd_bf16_wide_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    float* __restrict__ ws, int B, int H, int Nq, int Nk, int D, int tps, float scale_log2) {
  using Cfg = WideCfg<DP>;
  constexpr int A0 = Cfg::A0, ST = Cfg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  WideSmem<DP>& sm = *reinterpret_cast<WideSmem<DP>*>(hw::align_smem(smem_raw));
  const int tid = threadIdx.x;
  const int q_tiles = (Nq + W_BQ - 1) / W_BQ, n_tiles = (Nk + W_BK - 1) / W_BK, splits = (n_tiles + tps - 1) / tps;
  const int n_units = q_tiles * splits * H * B;

  if (tid == 0) {
    hw::mbar_init(&sm.q_full, 1);
    hw::mbar_init(&sm.q_empty, THREADS - 128);  // every consumer thread releases each buffer
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      hw::mbar_init(&sm.k_full[s], 1);
      hw::mbar_init(&sm.v_full[s], 1);
      hw::mbar_init(&sm.k_empty[s], THREADS - 128);
      hw::mbar_init(&sm.v_empty[s], THREADS - 128);
    }
    hw::fence_barrier_init();
  }
  if constexpr (DP == 192) {
    for (int i = tid; i < W_BK * BOX_COLS / 8; i += THREADS) reinterpret_cast<uint4*>(sm.zeros)[i] = uint4{0, 0, 0, 0};
    hw::fence_proxy_async();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: lane 0 of warps 0, 1, 2 loads Q, K, V
    hw::setmaxnreg_dec<40>();
    const int role = tid >> 5;
    if ((tid & 31) == 0 && role < 3) {
      int s = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const WideUnit w = wide_unit(u, q_tiles, splits, H, tps, n_tiles);
        if (role == 0) {
          hw::mbar_wait(&sm.q_empty, phase ^ 1);  // the first unit finds the Q buffer free
          hw::mbar_arrive_expect_tx(&sm.q_full, Cfg::TILE_BYTES);
          load_wide_tile<DP>(sm.q, &qmap, &sm.q_full, w.h, w.qt * W_BQ, w.b);
          phase ^= 1;
          continue;
        }
        for (int j = w.t0; j < w.t1; ++j) {
          uint64_t* empty = role == 1 ? &sm.k_empty[s] : &sm.v_empty[s];
          uint64_t* full = role == 1 ? &sm.k_full[s] : &sm.v_full[s];
          hw::mbar_wait(empty, phase ^ 1);  // the first pass over the ring finds every slot free
          hw::mbar_arrive_expect_tx(full, Cfg::TILE_BYTES);
          load_wide_tile<DP>(role == 1 ? sm.k[s] : sm.v[s], role == 1 ? &kmap : &vmap, full, w.h, j * W_BK, w.b);
          if (++s == ST) s = 0, phase ^= 1;
        }
      }
    }
  } else {  // consumer warpgroups: the unit's 64 rows, a share of O's columns each
    hw::setmaxnreg_inc<232>();
    const int ctid = tid - 128, cwg = ctid >> 7, warp = (ctid >> 5) & 3, lane = tid & 31, lt = ctid & 127;
    const int g = lane >> 2, t = lane & 3;
    const int box0 = cwg * A0;  // this consumer's first box of O's columns
    const uint32_t q_addr = hw::smem_u32(sm.q);
    auto v_box = [&](int s) { return hw::smem_u32(sm.v[s]) + box0 * W_BOX_BYTES; };
    // the byte offset from the consumer's last pair's first box to its second: the next box, or the box of zeros
    auto atom = [&](int s) -> uint32_t {
      if (DP == 192 && cwg == 1) return hw::smem_u32(sm.zeros) - v_box(s);
      return W_BOX_BYTES;
    };
    if constexpr (Cfg::SONCE) hw::named_bar_arrive(W_XCH_FREE + (cwg ^ 1), 256);  // the first partial's grant
    int ks = 0, vs = 0;
    uint32_t kph = 0, vph = 0, q_phase = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const WideUnit w = wide_unit(u, q_tiles, splits, H, tps, n_tiles);
      const bool last_unit = u + gridDim.x >= n_units;
      const int row0 = w.qt * W_BQ + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
      const int row1 = row0 + 8;

      float acc[A0 * 32];  // O's columns of this consumer's boxes: box a in registers [32a, 32a + 32)
#pragma unroll
      for (int i = 0; i < A0 * 32; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // running max of rows row0 / row1 (log2 units)
      float l[2] = {0.f, 0.f};              // this thread's share of the running sums
      float sc[W_BK / 2];                   // S of this tile: m64n64
      uint32_t pa[W_BK / 16][4];            // P in bf16: the register A operand of P.V
      float corr[2];

      hw::mbar_wait(&sm.q_full, q_phase);
      q_phase ^= 1;
      for (int j = w.t0; j < w.t1; ++j) {  // each tile's S, softmax and P.V in turn
        hw::mbar_wait(&sm.k_full[ks], kph);
        wide_s<DP>(sc, q_addr, hw::smem_u32(sm.k[ks]), cwg);
        hw::wgmma_wait<0>();
        hw::fence_regs(sc);
        hw::mbar_arrive(&sm.k_empty[ks]);
        if (j == w.t1 - 1) hw::mbar_arrive(&sm.q_empty);  // the unit's last read of Q
        if (++ks == ST) ks = 0, kph ^= 1;
        if constexpr (Cfg::SONCE) exchange_scores(sc, sm.xch, cwg, lt, !(last_unit && j == w.t1 - 1));
        online_softmax(sc, m, l, corr, j, Nk, t, scale_log2);
        hw::pack_a<W_BK>(pa, sc);
        rescale(acc, corr);
        hw::mbar_wait(&sm.v_full[vs], vph);
        wide_pv<DP>(acc, pa, v_box(vs), atom(vs));
        hw::wgmma_wait<0>();
        hw::fence_regs(acc);
        hw::mbar_arrive(&sm.v_empty[vs]);
        if (++vs == ST) vs = 0, vph ^= 1;
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const bool split = splits > 1;
      const long long stat = ((long long)w.b * H + w.h) * Nq;  // the row's (b, h, n) index, less n
      const long long rows = (long long)B * H * Nq;
      // one split: o is contiguous (B, Nq, H, D); more: the unit's fp32 O in ws, (splits, B, H, Nq, D)
      __nv_bfloat16* op = o + ((long long)w.b * Nq * H + w.h) * D;
      float* wp = split ? ws + ((long long)w.split * rows + stat) * D : nullptr;
#pragma unroll
      for (int a = 0; a < A0; ++a) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = (box0 + a) * 64 + c * 8;  // the columns past D are the padding's zeros
          if (col >= D) continue;
          const float* x = &acc[32 * a + 4 * c];
          if (split) {
            if (row0 < Nq) *reinterpret_cast<float2*>(wp + (long long)row0 * D + col + 2 * t) = make_float2(x[0], x[1]);
            if (row1 < Nq) *reinterpret_cast<float2*>(wp + (long long)row1 * D + col + 2 * t) = make_float2(x[2], x[3]);
          } else {
            if (row0 < Nq)
              *reinterpret_cast<uint32_t*>(op + (long long)row0 * H * D + col + 2 * t) =
                  hw::pack_bf16x2(x[0] / l[0], x[1] / l[0]);
            if (row1 < Nq)
              *reinterpret_cast<uint32_t*>(op + (long long)row1 * H * D + col + 2 * t) =
                  hw::pack_bf16x2(x[2] / l[1], x[3] / l[1]);
          }
        }
      }
      if (cwg == 0 && t == 0) {  // m is in log2 units of the scaled scores
        if (split) {
          float* mp = ws + (long long)splits * rows * D + (long long)w.split * rows + stat;
          float* lp = mp + (long long)splits * rows;
          if (row0 < Nq) mp[row0] = m[0], lp[row0] = l[0];
          if (row1 < Nq) mp[row1] = m[1], lp[row1] = l[1];
        } else if (lse != nullptr) {
          float* lp = lse + stat;
          if (row0 < Nq) lp[row0] = m[0] * LN2 + logf(l[0]);
          if (row1 < Nq) lp[row1] = m[1] * LN2 + logf(l[1]);
        }
      }
    }
  }
}

constexpr int COMBINE_THREADS = 256;

// The key splits merged, in split order: per row, M = max m_s, L = sum l_s 2^(m_s - M), o = sum O_s 2^(m_s - M) / L in
// bf16 and, with an LSE pointer, M ln 2 + log L. One thread a row's 4 columns; ws as fa_fwd_bf16_wide_kernel writes it.
__global__ void __launch_bounds__(COMBINE_THREADS) fa_wide_combine_kernel(const float* __restrict__ ws,
                                                                          __nv_bfloat16* __restrict__ o,
                                                                          float* __restrict__ lse, int B, int H, int Nq,
                                                                          int D, int splits) {
  const long long rows = (long long)B * H * Nq, d4 = D / 4;
  const long long e = (long long)blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (e >= rows * d4) return;
  const long long r = e / d4;  // (b, h, n)
  const int c = (int)(e - r * d4) * 4;
  const float* mp = ws + (long long)splits * rows * D + r;
  const float* lp = mp + (long long)splits * rows;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, mp[s * rows]);
  float L = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float wgt = hw::exp2_ftz(mp[s * rows] - M);
    L += lp[s * rows] * wgt;
    const float4 x = __ldg(reinterpret_cast<const float4*>(ws + (s * rows + r) * D + c));
    acc.x += x.x * wgt, acc.y += x.y * wgt, acc.z += x.z * wgt, acc.w += x.w * wgt;
  }
  const int n = (int)(r % Nq), h = (int)((r / Nq) % H), b = (int)(r / ((long long)Nq * H));
  __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(o + (((long long)b * Nq + n) * H + h) * D + c);
  op[0] = __floats2bfloat162_rn(acc.x / L, acc.y / L);
  op[1] = __floats2bfloat162_rn(acc.z / L, acc.w / L);
  if (lse != nullptr && c == 0) lse[r] = M * LN2 + logf(L);
}

// ---------------------------------------------------------------------------
// fp32: error-compensated TF32 (3xTF32) on wgmma (see "fp32" in the note at the top)
// ---------------------------------------------------------------------------

constexpr int T_BOX = 32;               // fp32 columns of a TMA box: one 128-byte swizzle row
constexpr int T_BK = 64;                // keys per key tile
constexpr int T_RING_BYTES = 224 * 1024;  // the resident Q, the exchange buffers and the ring
constexpr int T_PREP_THREADS = 256;

// The position of key p (0-7) of an 8-key group in the split, transposed values (Vt): P's register A operand holds
// the accumulator's columns 2t and 2t + 1 of each 8-key k-step in its columns t and t + 4, so Vt's column t holds key
// 2t and column t + 4 key 2t + 1. The product sums over the keys, so the order changes nothing else.
__host__ __device__ constexpr int vt_key(int p) { return p < 4 ? 2 * p : 2 * p - 7; }

// The kernel built for the padded head dim DP (32, 64, 128, 256 or 512). Up to 128 a work item is 128 query rows,
// 64 per consumer, each consumer computing all of S and O for its rows, with the item's Q resident in shared memory,
// the ring carrying K boxes and V chunks, and P as register A operands. Above 128 (COLSPLIT) a work item is 64 query
// rows shared by both consumers: consumer c takes the S boxes and V chunks of parity c (partial scores exchanged
// through shared memory, so both hold the same S and P), the ring carries Q with K, and P goes through shared memory
// (consumer 0 writes its hi part, consumer 1 its lo part), which leaves the registers to O's 128 columns.
template <int DP>
struct Tf32Cfg {
  static constexpr bool COLSPLIT = DP > 128;
  static constexpr int ROWS = COLSPLIT ? 64 : 128;                 // query rows per work item
  static constexpr int NC = DP < 64 ? DP : 64;                     // O columns per V chunk
  static constexpr int MAX_CHUNKS = DP / NC;
  static constexpr int QBOX = 2 * ROWS * 128;                      // one Q box, hi and lo
  static constexpr int KBOX = 2 * T_BK * 128;                      // one K box, hi and lo
  static constexpr int CHUNK = 4 * NC * 128;                       // one V chunk: hi and lo, two 32-key boxes each
  static constexpr int SBOX = KBOX + (COLSPLIT ? QBOX : 0);        // what one S box of the ring carries
  static constexpr int SLOT = SBOX > CHUNK ? SBOX : CHUNK;
  static constexpr int Q_BYTES = COLSPLIT ? 0 : (DP / T_BOX) * QBOX;  // the item's Q (row split)
  static constexpr int XCH_BYTES = COLSPLIT ? 2 * 64 * T_BK * 4 : 0;  // partial S of each consumer
  static constexpr int P_BYTES = COLSPLIT ? 2 * 64 * T_BK * 4 : 0;    // P in tf32 hi and lo, two 32-key boxes each
  static constexpr int STAGES = (T_RING_BYTES - Q_BYTES - XCH_BYTES - P_BYTES) / SLOT;
  static constexpr int ACC = COLSPLIT ? DP / 4 : DP / 2;             // O registers per consumer thread
  static constexpr int BAR_OFF = STAGES * SLOT + Q_BYTES + XCH_BYTES + P_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 + 2 * STAGES) + hw::SMEM_ALIGN;
  static_assert(STAGES >= 3 && SMEM <= 232448, "the block's shared memory");
};

// The split pre-pass. Blocks [0, qb) split q, [qb, qb + kb) k, the rest transpose v. q and k are written as
// (2, B * H, N, D) planes, hi = tf32(x) in plane bh and lo = tf32(x - hi) in plane B * H + bh; v as (2, B * H, D, Nk8)
// planes of Vt, keys padded to Nk8 = Nk rounded up to 8 (zeros) and in vt_key order within each 8 keys.
__global__ void __launch_bounds__(T_PREP_THREADS) tf32_split_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ ws,
    int B, int H, int Nq, int Nk, int D, Strides qs, Strides ks, Strides vs, long long qb, long long kb) {
  const long long BH = (long long)B * H, Nk8 = (Nk + 7) / 8 * 8;
  float* qw = ws;
  float* kw = qw + 2 * BH * Nq * D;
  float* vw = kw + 2 * BH * Nk * D;
  const long long blk = blockIdx.x;
  if (blk < qb + kb) {  // q or k: one float4 a thread
    const bool is_q = blk < qb;
    const int N = is_q ? Nq : Nk;
    const Strides s = is_q ? qs : ks;
    const float* src = is_q ? q : k;
    float* dst = is_q ? qw : kw;
    const long long e = (is_q ? blk : blk - qb) * T_PREP_THREADS + threadIdx.x, d4s = D / 4;
    if (e >= BH * N * d4s) return;
    const long long r = e / d4s;  // (b, n, h) in (B, N, H) order: the source's
    const int d = (int)(e - r * d4s) * 4, h = (int)(r % H), n = (int)((r / H) % N), b = (int)(r / ((long long)H * N));
    const float4 x = *reinterpret_cast<const float4*>(src + b * s.b + n * s.n + h * s.h + d);
    const float4 hi = make_float4(hw::tf32_rna(x.x), hw::tf32_rna(x.y), hw::tf32_rna(x.z), hw::tf32_rna(x.w));
    const float4 lo = make_float4(hw::tf32_rna(x.x - hi.x), hw::tf32_rna(x.y - hi.y), hw::tf32_rna(x.z - hi.z),
                                  hw::tf32_rna(x.w - hi.w));
    const long long off = ((long long)b * H + h) * N * D + (long long)n * D + d;
    *reinterpret_cast<float4*>(dst + off) = hi;
    *reinterpret_cast<float4*>(dst + BH * N * D + off) = lo;
    return;
  }
  // v: a 32-key x 32-column tile through shared memory, read along D and written along the keys
  __shared__ float tile[32][33];
  const long long vblk = blk - qb - kb, k_tiles = (Nk8 + 31) / 32, d_tiles = (D + 31) / 32;
  const int kt = (int)(vblk % k_tiles), dt = (int)((vblk / k_tiles) % d_tiles);
  const long long bh = vblk / (k_tiles * d_tiles);
  const int b = (int)(bh / H), h = (int)(bh % H), x = threadIdx.x & 31, y = threadIdx.x >> 5;
#pragma unroll
  for (int r = y; r < 32; r += T_PREP_THREADS / 32) {
    const int key = kt * 32 + r, d = dt * 32 + x;
    tile[r][x] = key < Nk && d < D ? v[b * vs.b + (long long)key * vs.n + h * vs.h + d] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int r = y; r < 32; r += T_PREP_THREADS / 32) {
    const int d = dt * 32 + r, kp = kt * 32 + x;
    if (d >= D || kp >= Nk8) continue;
    const float val = tile[(x & ~7) | vt_key(x & 7)][r];
    const float hi = hw::tf32_rna(val);
    const long long off = bh * D * Nk8 + (long long)d * Nk8 + kp;
    vw[off] = hi;
    vw[BH * D * Nk8 + off] = hw::tf32_rna(val - hi);
  }
}

// Each 8-wide k-step of S and of P.V is a chain of three products into fresh registers, added to S or O in fp32 with
// round to nearest (see "Numerics" under fp32 in the note at the top: the tensor cores' chained sums truncate).

// x = the three products of k-step kk (8 columns of a 32-column box) of Q K^T for one consumer's 64 rows and a 64-key
// tile: hi.lo, lo.hi, then hi.hi, both operands K-major in shared memory. One wgmma group, committed.
__device__ __forceinline__ void tf32_s_kstep(float (&x)[T_BK / 2], uint32_t qh, uint32_t ql, uint32_t kh, uint32_t kl,
                                             int kk) {
  hw::fence_regs(x);
  hw::wgmma_fence();
  hw::wgmma_m64n64k8_tf32_ss(x, hw::desc_k_major(qh + kk * 32), hw::desc_k_major(kl + kk * 32), 0);
  hw::wgmma_m64n64k8_tf32_ss(x, hw::desc_k_major(ql + kk * 32), hw::desc_k_major(kh + kk * 32), 1);
  hw::wgmma_m64n64k8_tf32_ss(x, hw::desc_k_major(qh + kk * 32), hw::desc_k_major(kh + kk * 32), 1);
  hw::wgmma_commit();
}

// x = the three products of k-step kc (8 keys) of P V[:, chunk]: Phi.Vlo, Plo.Vhi, then Phi.Vhi, P from registers (the
// row split), Vt K-major (its NC rows are O's columns; two 32-key boxes per part). One wgmma group, committed.
template <int NC>
__device__ __forceinline__ void tf32_pv_kstep_rs(float (&x)[NC / 2], uint32_t (&ph)[4], uint32_t (&pl)[4], uint32_t vh,
                                                 uint32_t vl, int kc) {
  const uint32_t off = (kc / 4) * NC * 128 + (kc % 4) * 32;
  hw::fence_regs(x);
  hw::wgmma_fence();
  if constexpr (NC == 64) {
    hw::wgmma_m64n64k8_tf32_rs(x, ph, hw::desc_k_major(vl + off), 0);
    hw::wgmma_m64n64k8_tf32_rs(x, pl, hw::desc_k_major(vh + off), 1);
    hw::wgmma_m64n64k8_tf32_rs(x, ph, hw::desc_k_major(vh + off), 1);
  } else {
    hw::wgmma_m64n32k8_tf32_rs(x, ph, hw::desc_k_major(vl + off), 0);
    hw::wgmma_m64n32k8_tf32_rs(x, pl, hw::desc_k_major(vh + off), 1);
    hw::wgmma_m64n32k8_tf32_rs(x, ph, hw::desc_k_major(vh + off), 1);
  }
  hw::wgmma_commit();
}

// The same with P read K-major from shared memory (the column split): its hi part at ph, its lo part at pl, each two
// 32-key boxes of 64 rows. One wgmma group, committed.
__device__ __forceinline__ void tf32_pv_kstep_ss(float (&x)[32], uint32_t ph, uint32_t pl, uint32_t vh, uint32_t vl,
                                                 int kc) {
  const uint32_t off = (kc / 4) * 64 * 128 + (kc % 4) * 32;  // the same offset in P's and in Vt's boxes
  hw::fence_regs(x);
  hw::wgmma_fence();
  hw::wgmma_m64n64k8_tf32_ss(x, hw::desc_k_major(ph + off), hw::desc_k_major(vl + off), 0);
  hw::wgmma_m64n64k8_tf32_ss(x, hw::desc_k_major(pl + off), hw::desc_k_major(vh + off), 1);
  hw::wgmma_m64n64k8_tf32_ss(x, hw::desc_k_major(ph + off), hw::desc_k_major(vh + off), 1);
  hw::wgmma_commit();
}

template <int N>
__device__ __forceinline__ void add_chain(float (&acc)[N], float (&x)[N]) {
  hw::fence_regs(x);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += x[i];
}

// Persistent: gridDim.x blocks walk the (query tile, head, batch) items, query tile fastest. Per key tile the producer
// loads ceil(D / 32) S boxes (K, and Q above DP = 128) and ceil(D / NC) V chunks into the ring, in that order; each
// consumer accumulates S over its boxes, runs the online softmax on it (bf16's online_softmax: the same fp32 steps),
// splits P into hi and lo in registers and adds P.V over its chunks. D <= DP is the real head dim, a multiple of 8.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1) fa_fwd_tf32_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, float* __restrict__ o, float* __restrict__ lse, int B, int H, int Nq,
    int Nk, int D, float scale_log2) {
  using Cfg = Tf32Cfg<DP>;
  constexpr bool COLSPLIT = Cfg::COLSPLIT;
  constexpr int ROWS = Cfg::ROWS, NC = Cfg::NC, STAGES = Cfg::STAGES;
  constexpr bool TWO = !COLSPLIT;  // two chain buffers of each kind: the column split's O leaves no room
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = hw::align_smem(smem_raw);
  uint8_t* ring = base;
  uint8_t* qres = base + STAGES * Cfg::SLOT;
  float* xch = reinterpret_cast<float*>(qres + Cfg::Q_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + Cfg::BAR_OFF);
  uint64_t *q_full = bars, *q_empty = bars + 1, *full = bars + 2, *empty = bars + 2 + STAGES;
  const int tid = threadIdx.x;
  const int BH = B * H;
  const int q_tiles = (Nq + ROWS - 1) / ROWS, n_items = q_tiles * H * B;
  const int n_tiles = (Nk + T_BK - 1) / T_BK, n_boxes = (D + T_BOX - 1) / T_BOX, n_chunks = (D + NC - 1) / NC;

  if (tid == 0) {
    hw::mbar_init(q_full, 1);
    hw::mbar_init(q_empty, THREADS - 128);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], THREADS - 128);  // every consumer thread releases the slot
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
        const int qt = item % q_tiles, bh = item / q_tiles;  // bh = b * H + h
        if constexpr (!COLSPLIT) {
          hw::mbar_wait(q_empty, q_phase ^ 1);  // the first item finds the Q buffer free
          hw::mbar_arrive_expect_tx(q_full, n_boxes * Cfg::QBOX);
          for (int c = 0; c < n_boxes; ++c) {
            hw::tma_load_3d(qres + c * Cfg::QBOX, &qmap, q_full, c * T_BOX, qt * ROWS, bh);
            hw::tma_load_3d(qres + c * Cfg::QBOX + ROWS * 128, &qmap, q_full, c * T_BOX, qt * ROWS, BH + bh);
          }
          q_phase ^= 1;
        }
        for (int j = 0; j < n_tiles; ++j) {
          for (int c = 0; c < n_boxes; ++c) {
            uint8_t* slot = ring + s * Cfg::SLOT;
            hw::mbar_wait(&empty[s], phase ^ 1);  // the first pass over the ring finds every slot free
            hw::mbar_arrive_expect_tx(&full[s], Cfg::SBOX);
            hw::tma_load_3d(slot, &kmap, &full[s], c * T_BOX, j * T_BK, bh);
            hw::tma_load_3d(slot + T_BK * 128, &kmap, &full[s], c * T_BOX, j * T_BK, BH + bh);
            if constexpr (COLSPLIT) {
              hw::tma_load_3d(slot + Cfg::KBOX, &qmap, &full[s], c * T_BOX, qt * ROWS, bh);
              hw::tma_load_3d(slot + Cfg::KBOX + ROWS * 128, &qmap, &full[s], c * T_BOX, qt * ROWS, BH + bh);
            }
            if (++s == STAGES) s = 0, phase ^= 1;
          }
          for (int v = 0; v < n_chunks; ++v) {
            uint8_t* slot = ring + s * Cfg::SLOT;
            hw::mbar_wait(&empty[s], phase ^ 1);
            hw::mbar_arrive_expect_tx(&full[s], Cfg::CHUNK);
#pragma unroll
            for (int part = 0; part < 2; ++part)  // hi, lo
#pragma unroll
              for (int half = 0; half < 2; ++half)  // keys [0, 32), [32, 64) of the tile
                hw::tma_load_3d(slot + (2 * part + half) * NC * 128, &vmap, &full[s], j * T_BK + half * 32, v * NC,
                                part * BH + bh);
            if (++s == STAGES) s = 0, phase ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroups
    hw::setmaxnreg_inc<232>();
    const int ctid = tid - 128, cwg = ctid >> 7, warp = (ctid >> 5) & 3, lane = tid & 31, lt = ctid & 127;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t ring_addr = hw::smem_u32(ring), q_addr = hw::smem_u32(qres) + (COLSPLIT ? 0 : cwg * 64 * 128);
    float* pbuf = xch + Cfg::XCH_BYTES / 4;  // the column split's P: hi (2 boxes), then lo
    const uint32_t p_addr = hw::smem_u32(pbuf);
    int s = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int qt = item % q_tiles, bh = item / q_tiles, b = bh / H, h = bh % H;
      const int row0 = qt * ROWS + (COLSPLIT ? 0 : cwg * 64) + warp * 16 + g;  // this thread's rows: row0, row0 + 8
      const int row1 = row0 + 8;
      float acc[Cfg::ACC];  // O: chunk a of this consumer in registers [a NC / 2, (a + 1) NC / 2)
#pragma unroll
      for (int i = 0; i < Cfg::ACC; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
      if constexpr (!COLSPLIT) hw::mbar_wait(q_full, q_phase);

      for (int j = 0; j < n_tiles; ++j) {
        // S, and the chain buffers of S's and of P.V's k-steps (two of each in the row split, one in the column split)
        float sc[T_BK / 2], x0[T_BK / 2], x1[TWO ? T_BK / 2 : 1], y0[NC / 2], y1[TWO ? NC / 2 : 1];
#pragma unroll
        for (int i = 0; i < T_BK / 2; ++i) sc[i] = 0.f;
        for (int c = 0; c < n_boxes; ++c) {
          hw::mbar_wait(&full[s], phase);
          if (!COLSPLIT || (c & 1) == cwg) {  // warpgroup-uniform
            const uint32_t slot = ring_addr + s * Cfg::SLOT;
            const uint32_t qh = COLSPLIT ? slot + Cfg::KBOX : q_addr + c * Cfg::QBOX, ql = qh + ROWS * 128;
            const uint32_t kh = slot, kl = slot + T_BK * 128;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              if constexpr (TWO) {  // k-step kk into x0 or x1 while the other one's products are added
                if (kk & 1) tf32_s_kstep(x1, qh, ql, kh, kl, kk); else tf32_s_kstep(x0, qh, ql, kh, kl, kk);
                if (kk > 0) {
                  hw::wgmma_wait<1>();
                  if (kk & 1) add_chain(sc, x0); else add_chain(sc, x1);
                }
              } else {
                tf32_s_kstep(x0, qh, ql, kh, kl, kk);
                hw::wgmma_wait<0>();
                add_chain(sc, x0);
              }
            }
            if constexpr (TWO) {
              hw::wgmma_wait<0>();
              add_chain(sc, x1);
            }
          }
          hw::mbar_arrive(&empty[s]);
          if (++s == STAGES) s = 0, phase ^= 1;
        }
        if constexpr (!COLSPLIT) {
          if (j == n_tiles - 1) hw::mbar_arrive(q_empty);  // the item's last read of Q
        } else {  // the partial scores of the other consumer's boxes: S0 + S1 == S1 + S0, so both hold the same S
          float* mine = xch + cwg * (T_BK / 2) * 128;
          const float* other = xch + (cwg ^ 1) * (T_BK / 2) * 128;
#pragma unroll
          for (int i = 0; i < T_BK / 2; ++i) mine[i * 128 + lt] = sc[i];
          hw::named_bar_sync(1, 256);
#pragma unroll
          for (int i = 0; i < T_BK / 2; ++i) sc[i] += other[i * 128 + lt];
        }

        online_softmax(sc, m, l, corr, j, Nk, t, scale_log2);
        rescale(acc, corr);
        // P in tf32 hi and lo, k-step kc's columns t and t + 4 holding keys 2t and 2t + 1 (vt_key): as register A
        // operands (row split), or written K-major into the 128-byte-swizzled boxes of pbuf (column split: consumer
        // 0 the hi part, consumer 1 the lo part)
        uint32_t ph[T_BK / 8][4], pl[T_BK / 8][4];
#pragma unroll
        for (int kc = 0; kc < T_BK / 8; ++kc)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = sc[4 * kc + ((i & 1) << 1) + (i >> 1)];
            const float hi = hw::tf32_rna(p);
            if constexpr (COLSPLIT) {
              const int row = warp * 16 + g + 8 * (i & 1), pos = (kc % 4) * 8 + t + 4 * (i >> 1);  // pos in its box
              const int word = (((pos >> 2) ^ (row & 7)) << 2) | (pos & 3);
              pbuf[cwg * 64 * T_BK + (kc / 4) * 64 * 32 + row * 32 + word] = cwg == 0 ? hi : hw::tf32_rna(p - hi);
            } else {
              ph[kc][i] = __float_as_uint(hi);
              pl[kc][i] = __float_as_uint(hw::tf32_rna(p - hi));
            }
          }
        if constexpr (COLSPLIT) {
          hw::fence_proxy_async();  // the writes above are wgmma operands
          hw::named_bar_sync(2, 256);
        }

#pragma unroll
        for (int v = 0; v < Cfg::MAX_CHUNKS; ++v) {
          if (v >= n_chunks) break;
          hw::mbar_wait(&full[s], phase);
          if (!COLSPLIT || (v & 1) == cwg) {
            const uint32_t vh = ring_addr + s * Cfg::SLOT, vl = vh + 2 * NC * 128;
            float(&o_chunk)[NC / 2] = *reinterpret_cast<float(*)[NC / 2]>(&acc[(COLSPLIT ? v >> 1 : v) * (NC / 2)]);
#pragma unroll
            for (int kc = 0; kc < T_BK / 8; ++kc) {
              if constexpr (COLSPLIT) {
                tf32_pv_kstep_ss(y0, p_addr, p_addr + 64 * T_BK * 4, vh, vl, kc);
                hw::wgmma_wait<0>();
                add_chain(o_chunk, y0);
              } else {  // k-step kc into y0 or y1 while the other one's products are added
                if (kc & 1) tf32_pv_kstep_rs<NC>(y1, ph[kc], pl[kc], vh, vl, kc);
                else tf32_pv_kstep_rs<NC>(y0, ph[kc], pl[kc], vh, vl, kc);
                if (kc > 0) {
                  hw::wgmma_wait<1>();
                  if (kc & 1) add_chain(o_chunk, y0); else add_chain(o_chunk, y1);
                }
              }
            }
            if constexpr (!COLSPLIT) {
              hw::wgmma_wait<0>();
              add_chain(o_chunk, y1);
            }
          }
          hw::mbar_arrive(&empty[s]);
          if (++s == STAGES) s = 0, phase ^= 1;
        }
      }
      if constexpr (!COLSPLIT) q_phase ^= 1;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      float* op = o + ((long long)b * Nq * H + h) * D;  // o is contiguous (B, Nq, H, D)
#pragma unroll
      for (int a = 0; a < Cfg::ACC / (NC / 2); ++a) {
        const int chunk = COLSPLIT ? 2 * a + cwg : a;
#pragma unroll
        for (int c = 0; c < NC / 8; ++c) {
          const int col = chunk * NC + c * 8 + 2 * t;  // the columns past D are the padding's zeros
          if (col >= D) continue;
          const float* x = &acc[a * (NC / 2) + 4 * c];
          if (row0 < Nq) *reinterpret_cast<float2*>(op + (long long)row0 * H * D + col) = make_float2(x[0] / l[0], x[1] / l[0]);
          if (row1 < Nq) *reinterpret_cast<float2*>(op + (long long)row1 * H * D + col) = make_float2(x[2] / l[1], x[3] / l[1]);
        }
      }
      if (lse != nullptr && (!COLSPLIT || cwg == 0) && t == 0) {  // m is in log2 units of the scaled scores
        float* lp = lse + ((long long)b * H + h) * Nq;
        if (row0 < Nq) lp[row0] = m[0] * LN2 + logf(l[0]);
        if (row1 < Nq) lp[row1] = m[1] * LN2 + logf(l[1]);
      }
    }
  }
}

// The split pre-pass and the kernel built for DP on its persistent grid. ws: the workspace of
// ops/flash_attention.py tf32_workspace_floats (2 B H (Nq D + Nk D + D Nk8) floats).
template <int DP>
int launch_tf32(const void* q, const void* k, const void* v, void* o, void* lse, void* ws, int B, int H, int Nq,
                int Nk, int D, Strides qs, Strides ks, Strides vs, float scale_log2, cudaStream_t st) {
  using Cfg = Tf32Cfg<DP>;
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  const long long BH = (long long)B * H, Nk8 = (Nk + 7) / 8 * 8;
  const long long qb = (BH * Nq * (D / 4) + T_PREP_THREADS - 1) / T_PREP_THREADS;
  const long long kb = (BH * Nk * (D / 4) + T_PREP_THREADS - 1) / T_PREP_THREADS;
  const long long vb = BH * ((Nk8 + 31) / 32) * ((D + 31) / 32);
  const long long items = (long long)((Nq + Cfg::ROWS - 1) / Cfg::ROWS) * H * B;
  if (qb + kb + vb > 0x7fffffff || items > 0x7fffffff || 2 * BH > 0x7fffffff) return (int)cudaErrorInvalidValue;
  float* qw = static_cast<float*>(ws);
  float* kw = qw + 2 * BH * Nq * D;
  float* vw = kw + 2 * BH * Nk * D;
  CUtensorMap qm, km, vm;
  const cuuint64_t qd[3] = {(cuuint64_t)D, (cuuint64_t)Nq, (cuuint64_t)(2 * BH)};
  const cuuint64_t qst[2] = {(cuuint64_t)D * 4, (cuuint64_t)Nq * D * 4};
  const cuuint32_t qbox[3] = {T_BOX, Cfg::ROWS, 1};
  const cuuint64_t kd[3] = {(cuuint64_t)D, (cuuint64_t)Nk, (cuuint64_t)(2 * BH)};
  const cuuint64_t kst[2] = {(cuuint64_t)D * 4, (cuuint64_t)Nk * D * 4};
  const cuuint32_t kbox[3] = {T_BOX, T_BK, 1};
  const cuuint64_t vd[3] = {(cuuint64_t)Nk8, (cuuint64_t)D, (cuuint64_t)(2 * BH)};
  const cuuint64_t vst[2] = {(cuuint64_t)Nk8 * 4, (cuuint64_t)D * Nk8 * 4};
  const cuuint32_t vbox[3] = {T_BOX, Cfg::NC, 1};
  constexpr auto F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int status = hw::encode_map(&qm, F32, 3, qw, qd, qst, qbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (status == 0) status = hw::encode_map(&km, F32, 3, kw, kd, kst, kbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (status == 0) status = hw::encode_map(&vm, F32, 3, vw, vd, vst, vbox, CU_TENSOR_MAP_SWIZZLE_128B);
  static bool smem_set[64];
  if (status == 0) status = hw::allow_smem(fa_fwd_tf32_kernel<DP>, Cfg::SMEM, smem_set);
  int sms = 0;
  if (status == 0) status = hw::sm_count(&sms);
  if (status != 0) return status;
  tf32_split_kernel<<<(unsigned)(qb + kb + vb), T_PREP_THREADS, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), qw, B, H, Nq, Nk, D,
      qs, ks, vs, qb, kb);
  fa_fwd_tf32_kernel<DP><<<(int)(items < sms ? items : sms), THREADS, Cfg::SMEM, st>>>(
      qm, km, vm, static_cast<float*>(o), static_cast<float*>(lse), B, H, Nq, Nk, D, scale_log2);
  return 0;
}

// ---------------------------------------------------------------------------
// fp32 at D <= 16: CUDA cores, full precision (see "fp32" in the note at the top)
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 128;  // query rows per block: one a thread
constexpr int F32_BK = 32;        // key rows per shared-memory tile
constexpr int F32_CHUNK = 16;     // keys scored before each rescale of the accumulator
constexpr int F32_SMALL_DP = 16;  // the head dims this kernel takes (D <= 16, columns past D loaded as zeros)

// The JAX training example's heads (D = 16) over a few tokens: a thread holds its query row and its accumulator in
// registers, K and V pass through shared memory in 32-key tiles. One launch and no split operands: at 4 tokens the
// 3xTF32 kernel's pre-pass and 128-row tiles cost more than the products. D <= 16 is a multiple of 4.
__global__ void __launch_bounds__(F32_THREADS) fa_fwd_f32_small_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int H, int Nq, int Nk, int D, Strides qs, Strides ks, Strides vs, float scale_log2) {
  constexpr int DP = F32_SMALL_DP;
  __shared__ __align__(16) float k_s[F32_BK][DP];
  __shared__ __align__(16) float v_s[F32_BK][DP];
  const int tid = threadIdx.x, b = blockIdx.z, h = blockIdx.y, row = blockIdx.x * F32_THREADS + tid;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;
  float qr[DP], acc[DP];
  const float* qp = q + b * qs.b + h * qs.h + (long long)row * qs.n;
#pragma unroll
  for (int d = 0; d < DP; d += 4) {
    const float4 x = row < Nq && d < D ? *reinterpret_cast<const float4*>(qp + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[d] = x.x, qr[d + 1] = x.y, qr[d + 2] = x.z, qr[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < Nk; k0 += F32_BK) {
    __syncthreads();
    for (int c = tid; c < F32_BK * DP / 4; c += blockDim.x) {
      const int r = c / (DP / 4), d4 = (c % (DP / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < Nk && d4 < D) {
        kx = *reinterpret_cast<const float4*>(kp + (long long)(k0 + r) * ks.n + d4);
        vx = *reinterpret_cast<const float4*>(vp + (long long)(k0 + r) * vs.n + d4);
      }
      *reinterpret_cast<float4*>(&k_s[r][d4]) = kx;
      *reinterpret_cast<float4*>(&v_s[r][d4]) = vx;
    }
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < F32_BK; c0 += F32_CHUNK) {
      float s[F32_CHUNK];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < F32_CHUNK; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DP; d += 4) {  // the rows of a warp read the same key row: a shared-memory broadcast
          const float4 kx = *reinterpret_cast<const float4*>(&k_s[c0 + i][d]);
          dot = fmaf(qr[d], kx.x, dot);
          dot = fmaf(qr[d + 1], kx.y, dot);
          dot = fmaf(qr[d + 2], kx.z, dot);
          dot = fmaf(qr[d + 3], kx.w, dot);
        }
        s[i] = k0 + c0 + i < Nk ? dot * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i]);
      }
      const float m_new = fmaxf(m, mx);  // finite: the first chunk holds key 0
      const float corr = exp2f(m - m_new);
      m = m_new;
      l *= corr;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] *= corr;
#pragma unroll
      for (int i = 0; i < F32_CHUNK; ++i) {
        const float p = exp2f(s[i] - m);
        l += p;
#pragma unroll
        for (int d = 0; d < DP; d += 4) {
          const float4 vx = *reinterpret_cast<const float4*>(&v_s[c0 + i][d]);
          acc[d] = fmaf(p, vx.x, acc[d]);
          acc[d + 1] = fmaf(p, vx.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vx.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vx.w, acc[d + 3]);
        }
      }
    }
  }
  if (row < Nq) {
    float* op = o + (((long long)b * Nq + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < DP; d += 4)
      if (d < D) *reinterpret_cast<float4*>(op + d) = make_float4(acc[d] / l, acc[d + 1] / l, acc[d + 2] / l, acc[d + 3] / l);
    if (lse != nullptr) lse[((long long)b * H + h) * Nq + row] = m * LN2 + logf(l);
  }
}

// The bf16 kernel on its persistent grid: K1 (kSoftmax) or K8, built for the padded head dim DP (64 or 128) and
// the real one DS (0: D at run time). `layouts` as uc_flash_attention_fwd takes them.
template <bool kSoftmax, int DP, int DS>
int launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Nq, int Nk, int D,
                const long long* layouts, float scale_log2, cudaStream_t st) {
  CUtensorMap qm, km, vm;
  int status = hw::encode_tile_map(&qm, q, layouts, BQ);
  if (status == 0) status = hw::encode_tile_map(&km, k, layouts + hw::LAYOUT_INTS, BK);
  if (status == 0) status = hw::encode_tile_map(&vm, v, layouts + 2 * hw::LAYOUT_INTS, BK);
  static bool smem_set[64];
  if (status == 0) status = hw::allow_smem(fa_fwd_bf16_kernel<kSoftmax, DP, DS>, fwd_smem_bytes<DP>(), smem_set);
  if (status != 0) return status;
  const long long items = (long long)((Nq + BQ - 1) / BQ) * H * B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int sms = 0;
  status = hw::sm_count(&sms);
  if (status != 0) return status;
  const int grid = (int)(items < sms ? items : sms);
  fa_fwd_bf16_kernel<kSoftmax, DP, DS><<<grid, THREADS, fwd_smem_bytes<DP>(), st>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), B, H, Nq, Nk, D, scale_log2);
  return 0;
}

// The wide bf16 kernel built for DP (192, 256 or 512) on its persistent grid (boxes of 64 rows), over key splits of
// `tps` 64-key tiles (ops/flash_attention.py k1_wide_tiles_per_split), then, with more than one split, the combine.
// ws: with more than one split, the workspace of ops/flash_attention.py k1_wide_workspace_floats.
template <int DP>
int launch_bf16_wide(const void* q, const void* k, const void* v, void* o, void* lse, void* ws, int B, int H, int Nq,
                     int Nk, int D, int tps, const long long* layouts, float scale_log2, cudaStream_t st) {
  const int n_tiles = (Nk + W_BK - 1) / W_BK;
  if (tps < 1 || tps > n_tiles) return (int)cudaErrorInvalidValue;
  const int splits = (n_tiles + tps - 1) / tps;
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  int status = hw::encode_tile_map(&qm, q, layouts, W_BQ);
  if (status == 0) status = hw::encode_tile_map(&km, k, layouts + hw::LAYOUT_INTS, W_BK);
  if (status == 0) status = hw::encode_tile_map(&vm, v, layouts + 2 * hw::LAYOUT_INTS, W_BK);
  static bool smem_set[64];
  if (status == 0) status = hw::allow_smem(fa_fwd_bf16_wide_kernel<DP>, wide_smem_bytes<DP>(), smem_set);
  if (status != 0) return status;
  const long long units = (long long)((Nq + W_BQ - 1) / W_BQ) * splits * H * B;
  const long long combine_threads = (long long)B * H * Nq * (D / 4);
  if (units > 0x7fffffff || combine_threads / COMBINE_THREADS >= 0x7fffffff) return (int)cudaErrorInvalidValue;
  int sms = 0;
  status = hw::sm_count(&sms);
  if (status != 0) return status;
  const int grid = (int)(units < sms ? units : sms);
  fa_fwd_bf16_wide_kernel<DP><<<grid, THREADS, wide_smem_bytes<DP>(), st>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), static_cast<float*>(ws), B, H, Nq, Nk, D,
      tps, scale_log2);
  if (splits > 1)
    fa_wide_combine_kernel<<<(unsigned)((combine_threads + COMBINE_THREADS - 1) / COMBINE_THREADS), COMBINE_THREADS,
                             0, st>>>(static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(o),
                                      static_cast<float*>(lse), B, H, Nq, D, splits);
  return 0;
}

}  // namespace

// The element strides (b, n, h) of a tensor from its tensor-map layout (byte strides of h, n, b).
static Strides layout_strides(const long long* L, int elem_bytes) {
  return Strides{L[6] / elem_bytes, L[5] / elem_bytes, L[4] / elem_bytes};
}

// dtype: 0 = float32, 1 = bfloat16; head_dim: a multiple of 8 up to 512 (ops/flash_attention.py pads any other
// into a copy). `layouts` holds the tensor-map layouts of q, k and v, 11 ints each (hopper.cuh LAYOUT_INTS; boxes of
// 64 columns and 128 rows, 64 rows above D = 128: ops/flash_attention.py fwd_rows), from which the fp32 kernel's
// pre-pass takes its element strides; d has unit stride. o is a contiguous (B, Nq, H, D) tensor; lse, when not null,
// a contiguous (B, H, Nq) float32 tensor. tps: bf16 above D = 128, the 64-key tiles of each key split (all of them
// for one split; ops/flash_attention.py k1_wide_tiles_per_split), else ignored. ws: for float32, the split operands'
// workspace (ops/flash_attention.py tf32_workspace_floats); for bf16 above D = 128 with more than one key split, the
// splits' workspace (k1_wide_workspace_floats); else null. Returns a cudaError_t.
extern "C" int uc_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, void* ws,
                                      int dtype, int B, int H, int Nq, int Nk, int head_dim, int tps,
                                      const long long* layouts, float scale, void* stream) {
  const int D = head_dim;
  if (D < 8 || D > 512 || D % 8 != 0 || B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  const long long *lq = layouts, *lk = layouts + hw::LAYOUT_INTS, *lv = layouts + 2 * hw::LAYOUT_INTS;
  const float scale_log2 = scale * LOG2E;  // exp(x) = exp2(x * log2(e))
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    int status;
    if (D == 64)
      status = launch_bf16<true, 64, 64>(q, k, v, o, lse, B, H, Nq, Nk, D, layouts, scale_log2, st);
    else if (D < 64)
      status = launch_bf16<true, 64, 0>(q, k, v, o, lse, B, H, Nq, Nk, D, layouts, scale_log2, st);
    else if (D <= 128)
      status = launch_bf16<true, 128, 0>(q, k, v, o, lse, B, H, Nq, Nk, D, layouts, scale_log2, st);
    else if (D <= 192)
      status = launch_bf16_wide<192>(q, k, v, o, lse, ws, B, H, Nq, Nk, D, tps, layouts, scale_log2, st);
    else if (D <= 256)
      status = launch_bf16_wide<256>(q, k, v, o, lse, ws, B, H, Nq, Nk, D, tps, layouts, scale_log2, st);
    else
      status = launch_bf16_wide<512>(q, k, v, o, lse, ws, B, H, Nq, Nk, D, tps, layouts, scale_log2, st);
    if (status != 0) return status;
  } else if (dtype == 0) {
    const Strides qs = layout_strides(lq, 4), ks = layout_strides(lk, 4), vs = layout_strides(lv, 4);
    int status = 0;
    if (D <= F32_SMALL_DP)
      fa_fwd_f32_small_kernel<<<dim3((Nq + F32_THREADS - 1) / F32_THREADS, H, B), F32_THREADS, 0, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
          static_cast<float*>(o), static_cast<float*>(lse), H, Nq, Nk, D, qs, ks, vs, scale_log2);
    else if (D <= 32)
      status = launch_tf32<32>(q, k, v, o, lse, ws, B, H, Nq, Nk, D, qs, ks, vs, scale_log2, st);
    else if (D <= 64)
      status = launch_tf32<64>(q, k, v, o, lse, ws, B, H, Nq, Nk, D, qs, ks, vs, scale_log2, st);
    else if (D <= 128)
      status = launch_tf32<128>(q, k, v, o, lse, ws, B, H, Nq, Nk, D, qs, ks, vs, scale_log2, st);
    else if (D <= 256)
      status = launch_tf32<256>(q, k, v, o, lse, ws, B, H, Nq, Nk, D, qs, ks, vs, scale_log2, st);
    else
      status = launch_tf32<512>(q, k, v, o, lse, ws, B, H, Nq, Nk, D, qs, ks, vs, scale_log2, st);
    if (status != 0) return status;
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
  const int status = launch_bf16<false, 64, 64>(q, k, v, o, nullptr, B, H, Nq, Nk, 64, layouts, 0.f,
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
