// Flash attention forward (non-causal, no mask) over (B, N, H, D) tensors, D = 64.
//
// Replaces: uniception_tpu/ops/flash_attention.py: flash_attention /
//   _flash_attention_impl with the bodies _fa_single_kernel and _fa_kernel
//   (forward; with_lse=True when an LSE pointer is given).
//
// What bounds it on the H100: at the main-path shapes (N = 1024 queries and
//   keys, D = 64) each (b, h) pair does 4*N*N*D flops on 4*N*D*2 bytes of
//   q/k/v/o, ~256 flops per byte in bf16: at the knee of the roofline, so the
//   tensor-core issue rate and the exp/max/sum work of the online softmax
//   between the two products bound it, not HBM. Only wgmma reaches the full
//   tensor-core rate on this card.
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
//     frees the Q buffer for the next item). S = Q.K^T is 4 wgmma m64n128k16
//     with K read K-major from shared memory; the online softmax runs on the
//     fp32 accumulator registers; P is rounded to bf16 in registers (as the
//     TPU kernel casts p to v's dtype) and is the register A operand of
//     O += P.V (8 wgmma m64n64k16), with V read MN-major through the transpose
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
//   * Numerics as before: fp32 scores, running max and sum; the sum takes p
//     before its bf16 rounding (the Pallas kernel's order); o = acc / l in q's
//     dtype. p is the MUFU's 2^x with subnormals flushed (hopper.cuh
//     exp2_ftz), as in the backward. With an LSE pointer (training), each row's logsumexp m + log(l)
//     is written in fp32, (B, H, Nq) contiguous, for the backward (K3,
//     flash_attention_bwd.cu); with a null pointer nothing more is written.
//   * fp32: full fp32 FMA math on the CUDA cores, one query row per thread,
//     no TF32 (the TPU kernel runs fp32 at HIGHEST precision): the parity path.
//   * Later work: a third consumer warpgroup, a TMA store of the output.
//
// K8, the S.V diagnostic, is the same bf16 kernel with the softmax compiled
// out (fa_fwd_bf16_kernel<false>, entry point uc_sv_only):
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
constexpr int STAGES = 3;               // K / V ring slots
constexpr int THREADS = 384;            // producer warpgroup + two consumer warpgroups
constexpr int TILE_BYTES = BK * D * 2;  // one K or V tile: 128 rows of 128 bytes

struct alignas(hw::SMEM_ALIGN) FwdSmem {
  __nv_bfloat16 q[BQ * D];
  __nv_bfloat16 k[STAGES][BK * D];
  __nv_bfloat16 v[STAGES][BK * D];
  uint64_t q_full, q_empty, full[STAGES], empty[STAGES];
};
constexpr int FWD_SMEM = sizeof(FwdSmem) + hw::SMEM_ALIGN > hw::MIN_SMEM_BYTES ? sizeof(FwdSmem) + hw::SMEM_ALIGN
                                                                               : hw::MIN_SMEM_BYTES;

// S = Q K^T for one consumer's 64 rows and a 128-key tile: 4 k-steps of 16 over D, Q from registers, K read
// K-major from shared memory; the first k-step overwrites S. One wgmma group, committed.
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], const uint32_t (&qa)[D / 16][4], uint32_t k_addr) {
  hw::fence_regs(sc);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hw::wgmma_m64n128k16_rs<0>(sc, qa[kk], hw::desc_k_major(k_addr + kk * 32), kk > 0);
  hw::wgmma_commit();
}

// O += P V: 8 k-steps of 16 keys, P from registers, V read MN-major (rows = keys) with the transpose bit.
// One wgmma group, committed.
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], uint32_t (&pa)[BK / 16][4], uint32_t v_addr) {
  hw::fence_regs(acc);
  hw::fence_regs(pa);
  hw::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
    hw::wgmma_m64n64k16_rs<1>(acc, pa[kc], hw::desc_mn_major(v_addr + kc * 16 * D * 2), 1);
  hw::wgmma_commit();
}

// The scores of tile j's keys past Nk set to `fill`, on the ragged last tile only.
__device__ __forceinline__ void mask_keys(float (&sc)[BK / 2], int j, int Nk, int t, float fill) {
  if ((j + 1) * BK > Nk) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if (j * BK + (i >> 2) * 8 + 2 * t + (i & 1) >= Nk) sc[i] = fill;
  }
}

// The online softmax of tile j on S in place: the row max of the raw scores over the 4 lanes of a row (keys
// past Nk masked to -inf, on the last tile only), the new running max m in log2 units of the scaled scores,
// the rescale corr of O and l, and p = exp2(s * scale_log2 - m), added to l before its bf16 rounding (the TPU
// kernel's order). The scale is positive, so the max of the raw scores scales to the max of the scaled ones.
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
                                               int j, int Nk, int t, float scale_log2) {
  mask_keys(sc, j, Nk, t, -INFINITY);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
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
  for (int i = 0; i < BK / 2; ++i) {
    const float p = hw::exp2_ftz(fmaf(sc[i], scale_log2, neg_m[(i >> 1) & 1]));
    sc[i] = p;
    l[(i >> 1) & 1] += p;
  }
}

__device__ __forceinline__ void rescale(float (&acc)[D / 2], const float (&corr)[2]) {
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
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
// key tile and rounded once; lse and scale_log2 unused).
template <bool kSoftmax>
__global__ void __launch_bounds__(THREADS, 1) fa_fwd_bf16_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int B, int H,
    int Nq, int Nk, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(hw::align_smem(smem_raw));
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
        hw::mbar_arrive_expect_tx(&sm.q_full, BQ * D * 2);
        hw::tma_load_4d(sm.q, &qmap, &sm.q_full, 0, h, qt * BQ, b);
        q_phase ^= 1;
        for (int j = 0; j < n_tiles; ++j) {
          hw::mbar_wait(&sm.empty[s], phase ^ 1);  // the first pass over the ring finds every slot free
          hw::mbar_arrive_expect_tx(&sm.full[s], 2 * TILE_BYTES);
          hw::tma_load_4d(sm.k[s], &kmap, &sm.full[s], 0, h, j * BK, b);
          hw::tma_load_4d(sm.v[s], &vmap, &sm.full[s], 0, h, j * BK, b);
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

      float acc[D / 2];  // O: m64n64 accumulator
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // running max of rows row0 / row1 (log2 units)
      float l[2] = {0.f, 0.f};              // this thread's share of the running sums

      // Q as register A operands, read once: each Q.K^T then reads only K from shared memory, and the Q
      // buffer is free for the next item at once.
      uint32_t qa[D / 16][4];
      hw::mbar_wait(&sm.q_full, q_phase);
      hw::load_a_frags(qa, sm.q + cwg * 64 * D, warp, lane);
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
      issue_qk(sc, qa, hw::smem_u32(sm.k[s]));
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
        issue_qk(sc, qa, hw::smem_u32(sm.k[s]));
        if (kSoftmax) rescale(acc, corr);
        issue_pv(acc, pa, hw::smem_u32(sm.v[prev]));
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
      issue_pv(acc, pa, hw::smem_u32(sm.v[prev]));  // the last tile's O += P V
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
        for (int c = 0; c < D / 8; ++c) {
          acc[4 * c] /= l[0];
          acc[4 * c + 1] /= l[0];
          acc[4 * c + 2] /= l[1];
          acc[4 * c + 3] /= l[1];
        }
      }
      __nv_bfloat16* op = o + ((long long)b * Nq * H + h) * D;  // o is contiguous (B, Nq, H, D)
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const int col = c * 8 + 2 * t;
        if (row0 < Nq)
          *reinterpret_cast<uint32_t*>(op + (long long)row0 * H * D + col) =
              hw::pack_bf16x2(acc[4 * c], acc[4 * c + 1]);
        if (row1 < Nq)
          *reinterpret_cast<uint32_t*>(op + (long long)row1 * H * D + col) =
              hw::pack_bf16x2(acc[4 * c + 2], acc[4 * c + 3]);
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
// fp32: CUDA cores, full precision
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 128;   // one query row per thread
constexpr int F32_BK = 32;    // key rows per shared-memory tile
constexpr int F32_CHUNK = 16; // keys scored before each rescale of the accumulator

__global__ void __launch_bounds__(F32_BQ) fa_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int H, int Nq, int Nk, Strides qs, Strides ks, Strides vs,
    float scale_log2) {
  __shared__ __align__(16) float k_s[F32_BK][D];
  __shared__ __align__(16) float v_s[F32_BK][D];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * F32_BQ + tid;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;

  float qr[D], acc[D];
  const float* qp = q + b * qs.b + h * qs.h + (long long)row * qs.n;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 x = row < Nq ? *reinterpret_cast<const float4*>(qp + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[d] = x.x, qr[d + 1] = x.y, qr[d + 2] = x.z, qr[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += F32_BK) {
    __syncthreads();
    for (int c = tid; c < F32_BK * D / 4; c += blockDim.x) {
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
    for (int c0 = 0; c0 < F32_BK; c0 += F32_CHUNK) {
      float s[F32_CHUNK];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < F32_CHUNK; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {  // every thread reads the same key row: a shared-memory broadcast
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
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int i = 0; i < F32_CHUNK; ++i) {
        const float p = exp2f(s[i] - m);
        l += p;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
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
    for (int d = 0; d < D; d += 4)
      *reinterpret_cast<float4*>(op + d) = make_float4(acc[d] / l, acc[d + 1] / l, acc[d + 2] / l, acc[d + 3] / l);
    if (lse != nullptr) lse[((long long)b * H + h) * Nq + row] = m * LN2 + logf(l);
  }
}

// The bf16 kernel on its persistent grid: K1 (kSoftmax) or K8. `layouts` as uc_flash_attention_fwd takes them.
template <bool kSoftmax>
int launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Nq, int Nk,
                const long long* layouts, float scale_log2, cudaStream_t st) {
  CUtensorMap qm, km, vm;
  int status = hw::encode_tile_map(&qm, q, layouts, BQ);
  if (status == 0) status = hw::encode_tile_map(&km, k, layouts + hw::LAYOUT_INTS, BK);
  if (status == 0) status = hw::encode_tile_map(&vm, v, layouts + 2 * hw::LAYOUT_INTS, BK);
  static bool smem_set[64];
  if (status == 0) status = hw::allow_smem(fa_fwd_bf16_kernel<kSoftmax>, FWD_SMEM, smem_set);
  if (status != 0) return status;
  const long long items = (long long)((Nq + BQ - 1) / BQ) * H * B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int sms = 0;
  status = hw::sm_count(&sms);
  if (status != 0) return status;
  const int grid = (int)(items < sms ? items : sms);
  fa_fwd_bf16_kernel<kSoftmax><<<grid, THREADS, FWD_SMEM, st>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), B, H, Nq, Nk, scale_log2);
  return 0;
}

}  // namespace

// The element strides (b, n, h) of a tensor from its tensor-map layout (byte strides of h, n, b).
static Strides layout_strides(const long long* L, int elem_bytes) {
  return Strides{L[6] / elem_bytes, L[5] / elem_bytes, L[4] / elem_bytes};
}

// dtype: 0 = float32, 1 = bfloat16. `layouts` holds the tensor-map layouts of q, k and v, 11 ints each
// (hopper.cuh LAYOUT_INTS; boxes of 128 rows), from which the fp32 kernel takes its element strides; d has
// unit stride. o is a contiguous (B, Nq, H, D) tensor; lse, when not null, a contiguous (B, H, Nq) float32
// tensor. Returns a cudaError_t.
extern "C" int uc_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
                                      int B, int H, int Nq, int Nk, int head_dim, const long long* layouts,
                                      float scale, void* stream) {
  if (head_dim != D || B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  const long long *lq = layouts, *lk = layouts + hw::LAYOUT_INTS, *lv = layouts + 2 * hw::LAYOUT_INTS;
  const float scale_log2 = scale * LOG2E;  // exp(x) = exp2(x * log2(e))
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int status = launch_bf16<true>(q, k, v, o, lse, B, H, Nq, Nk, layouts, scale_log2, st);
    if (status != 0) return status;
  } else if (dtype == 0) {
    const dim3 grid((Nq + F32_BQ - 1) / F32_BQ, H, B);
    fa_fwd_f32_kernel<<<grid, F32_BQ, 0, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                static_cast<const float*>(v), static_cast<float*>(o),
                                                static_cast<float*>(lse), H, Nq, Nk, layout_strides(lq, 4),
                                                layout_strides(lk, 4), layout_strides(lv, 4), scale_log2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K8: S.V without the softmax over bf16 q (B, Nq, H, D) and k, v (B, Nk, H, D), D = 64, read through their
// tensor-map layouts as uc_flash_attention_fwd takes them (boxes of 128 rows); o is a contiguous (B, Nq, H, D)
// bf16 tensor. Returns a cudaError_t.
extern "C" int uc_sv_only(const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int Nk,
                          int head_dim, const long long* layouts, void* stream) {
  if (head_dim != D || B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  const int status =
      launch_bf16<false>(q, k, v, o, nullptr, B, H, Nq, Nk, layouts, 0.f, static_cast<cudaStream_t>(stream));
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
