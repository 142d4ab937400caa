// Hopper (sm_90a) plumbing shared by the wgmma kernels: mbarriers, TMA tile
// loads into 128-byte-swizzled shared memory, wgmma shared-memory descriptors
// and instructions, named barriers, setmaxnreg, the persistent
// warp-specialised GEMM of K4 and K5's projection (gemm_kernel, below), and on
// the host the tensor-map encoding and the SM count of a persistent grid.
//
// Tiles. Every operand tile is a (rows x 64) bf16 matrix with 128-byte rows,
// loaded by one TMA box of (64, 1, rows, 1) over a 4-D tensor map of a
// (B, N, H, D = 64) view (dims innermost first: D, H, N, B) with
// CU_TENSOR_MAP_SWIZZLE_128B. Within each 1024-byte group of 8 rows the
// hardware XORs the 16-byte chunk index with the row index (mod 8). Tiles
// start on 1024-byte boundaries, so a descriptor's base offset is 0. Other
// kernels read other tensors through encode_map (3-D and 4-D maps, bf16 or
// 8-bit elements): the conv's NHWC boxes and HWIO weight tiles (128-byte
// rows, as above), int8 key tiles of 64-byte rows under
// CU_TENSOR_MAP_SWIZZLE_64B (8-row groups of 512 bytes, desc_k_major_64b), and
// the GEMM's row-major operands through 2-D maps in boxes of 128-byte rows
// (128 int8 or 64 bf16 values of K). 8-bit wgmma has no transpose bit: both
// of its operands are K-major; a k-step of 32 int8 is 32 bytes, as one of 16
// bf16.
//
// Descriptors (64 bits): start address >> 4 in bits 0-13, leading byte offset
// >> 4 in bits 16-29, stride byte offset >> 4 in bits 32-45, layout type in
// bits 62-63 (1 = 128-byte swizzle).
//   * K-major (the tile's 64 contiguous elements are the reduction dim: K as
//     the B operand of Q.K^T): 8-row groups are 1024 bytes apart (SBO); the
//     leading offset is unused under the swizzle. A k-step of 16 elements
//     advances the start address by 32 bytes inside the swizzled row.
//   * MN-major (the 64 contiguous elements are the N dim, the rows the
//     reduction dim: V in P.V, read with the transpose bit): 8-row groups of
//     the reduction dim are 1024 bytes apart. N = 64 is one swizzle atom wide,
//     so the offset between atoms along N is never used; both offsets are set
//     to 1024. A k-step of 16 rows advances the start address by 2048 bytes.
//
// Fragments. The m64nN f32 (or s32) accumulator of a warpgroup: thread (warp
// w, lane l), g = l / 4, t = l % 4, holds d[4c + 2i + j] = D[16w + g + 8i][8c +
// 2t + j].
// The register A operand of m64nNk16 (4 x 32-bit, two bf16 each) holds
// A[16w + g][2t..], A[16w + g + 8][2t..], A[16w + g][2t + 8..],
// A[16w + g + 8][2t + 8..] of its 16-wide k-step: exactly the accumulator's
// chunks 2kc and 2kc + 1 packed to bf16 in order (pack_a below), so a product's
// rounded result feeds the next product without leaving registers. A tile a
// block keeps for its whole work item (Q in the forward) is read into that
// layout once (load_a_frags), so each later wgmma reads only B from shared
// memory.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace uc_hopper {

constexpr int SMEM_ALIGN = 1024;  // a 128-byte-swizzle atom: 8 rows of 128 bytes
// Dynamic shared memory a warp-specialised block asks for at least: more than half of the SM's 227 KB, so
// two blocks never share an SM (their setmaxnreg.inc would wait on each other's registers, and a persistent
// grid of one block per SM would leave SMs idle).
constexpr int MIN_SMEM_BYTES = 116 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((SMEM_ALIGN - (a & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1));
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and the other threads; then __syncthreads.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also tells the barrier to wait for `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A fresh barrier is in phase 0, so waiting on
// parity 1 passes at once (the "previous" phase counts as complete): a producer's first wait on an empty slot.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One box of a 2-D tensor map into shared memory at coordinates (c0, c1), innermost first.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// One box of a 3-D tensor map into shared memory at coordinates (c0, c1, c2), innermost first.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// One box of a 4-D tensor map into shared memory at coordinates (c0, c1, c2, c3), innermost first; the
// bytes complete a transaction on `bar`. Out-of-range elements of the box are written as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// layout: 1 = 128-byte swizzle, 2 = 64-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout = 1) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// A 128-byte-swizzled tile whose contiguous elements run along the reduction dim.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) { return make_desc(addr, 16, 1024); }

// A 128-byte-swizzled tile whose rows run along the reduction dim (64 contiguous N elements per row).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) { return make_desc(addr, 1024, 1024); }

// The same for N wider than one swizzle atom: the tile is N / 64 atoms (each rows x 128 bytes, as one TMA box
// of 64 elements loads it) `atom_bytes` apart. The leading byte offset steps along N from atom to atom, the
// stride byte offset along the reduction dim from one 8-row group to the next (CUTLASS's canonical MN-major
// layout ((T, 8, m), (8, k)) : ((1, T, LBO), (8T, SBO))).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t atom_bytes) {
  return make_desc(addr, atom_bytes, 1024);
}

// A 64-byte-swizzled 8-bit tile of 64-byte rows whose contiguous elements run along the reduction dim (int8
// keys of D = 64 as the B operand of Q.K^T): 8-row groups are 512 bytes apart; a k-step of 32 advances the
// start address by 32 bytes inside the swizzled row.
__device__ __forceinline__ uint64_t desc_k_major_64b(uint32_t addr) { return make_desc(addr, 16, 512, 2); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across the asynchronous instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Named barriers (ids 1-15; 0 is __syncthreads): sync waits until `threads` threads have arrived, arrive
// counts this warp's threads without waiting.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// 2^x on the MUFU alone: exp2f also scales subnormal inputs and results around it, and a p below 2^-126 is
// zero to every sum and bf16 rounding these kernels take.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The register A operand of this thread for rows [16w, 16w + 16) of a 128-byte-swizzled (rows x 64) bf16 tile
// (the tile of its warpgroup's 64 rows, 1024-byte aligned; w = its warp in the warpgroup): the 4 k-steps of
// 16 over the 64 contiguous elements. Read once, it turns a K-major shared-memory A operand that a loop
// re-reads into registers, so each later wgmma reads only B from shared memory.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4], const void* tile, int w, int lane) {
  const uint8_t* base = static_cast<const uint8_t*>(tile);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * w + g + 8 * (i & 1), byte = (16 * kk + 2 * t + 8 * (i >> 1)) * 2;
      a[kk][i] = *reinterpret_cast<const uint32_t*>(base + row * 128 + (((byte >> 4) ^ (row & 7)) << 4) + (byte & 15));
    }
}

// The register A operands of the K / 16 k-steps of an m64 x K accumulator, rounded to bf16.
template <int K>
__device__ __forceinline__ void pack_a(uint32_t (&a)[K / 16][4], const float (&d)[K / 2]) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kc][i] = pack_bf16x2(d[8 * kc + 2 * i], d[8 * kc + 2 * i + 1]);
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], both operands in shared memory (descriptors);
// TA / TB: 0 = K-major, 1 = MN-major (transposed). scale_d = 0 overwrites D.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], both operands in shared memory (descriptors);
// TA / TB: 0 = K-major, 1 = MN-major (transposed). scale_d = 0 overwrites D.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A from registers (the accumulator layout packed to
// bf16 pairs), B in shared memory; TB: 0 = K-major, 1 = MN-major. scale_d = 0 overwrites D.
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A from registers (the accumulator layout packed to
// bf16 pairs), B in shared memory; TB: 0 = K-major, 1 = MN-major. scale_d = 0 overwrites D.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// D[64 x 256] (+)= A[64 x 16] * B[16 x 256], both operands in shared memory (descriptors);
// TA / TB: 0 = K-major, 1 = MN-major (transposed). scale_d = 0 overwrites D.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x 128] (+)= A[64 x 32] * B[32 x 128] in int8 with int32 sums: A from registers (the m16n8k32 layout per
// warp, 4 x 32-bit of four int8), B K-major in shared memory (8-bit operands have no transpose). scale_d = 0
// overwrites D.
__device__ __forceinline__ void wgmma_m64n128k32_s8_rs(int (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 32] * B[32 x 64] in int8 with int32 sums: A from registers (the m16n8k32 layout per
// warp, 4 x 32-bit of four int8), B K-major in shared memory (8-bit operands have no transpose). scale_d = 0
// overwrites D.
__device__ __forceinline__ void wgmma_m64n64k32_s8_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 256] (+)= A[64 x 32] * B[32 x 256] in int8 with int32 sums, both operands K-major in shared memory
// (descriptors). scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n256k32_s8_ss(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 32] * B[32 x 128] in int8 with int32 sums, both operands K-major in shared memory
// (descriptors). scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k32_s8_ss(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// A persistent, warp-specialised GEMM: C[M x N] = A[M x K] . B[N x K]^T, A and B row-major (K-major), in
// 8-bit integers (int32 sums) or bf16 (fp32 sums), with the epilogue a functor of the caller's
// ---------------------------------------------------------------------------
//
// Work items (gemm_item; ops/gemm.py gemm_items is its plain twin): a 128 x BN output tile and a range of the K
// loop, in k-blocks of 128 bytes (128 int8 or 64 bf16 values: one 128-byte swizzle row). m-tiles run fastest, so
// the blocks working at one time share B's tiles in L2. N may be cut into `sections` of `sec_n` columns, each
// with its own tensor map (K5's q, k and v weights); an n-tile never straddles two sections.
//
// One block per SM. Warpgroup 0 is the producer: one thread issues the TMA loads of each k-block's A box (128
// rows x 128 bytes) and B box (BN rows x 128 bytes) into a ring of GemmCfg<BN>::STAGES slots, each guarded by
// a "full" mbarrier (the bytes landed) and an "empty" one (both consumers are done with it), and runs ahead
// across items, so the next tile's loads overlap this tile's epilogue. TMA fills rows and columns past the
// tensor with zeros: ragged M, N and K add nothing. Warpgroups 1 and 2 are the consumers: each issues wgmma
// m64nBN over its 64 rows of the tile, both operands from shared memory (K-major, 128-byte swizzle), keeps one
// k-block's products in flight while the next k-block's operands arrive, releases each slot when its products
// are done, and hands its m64nBN accumulator to the epilogue: thread (warp w, lane l), g = l / 4, t = l % 4,
// holds acc[4c + 2i + j] = C[row0 + 8i][col0 + 8c + 2t + j] with row0 = m0 + 64 cwg + 16 w + g.
//
// Split-K (int8 only): with split > 1 each item adds its int32 partial sums into a zeroed (M, N) workspace and
// counts itself on its tile's counter; the item that counts last reads the total back and runs the epilogue.
// int32 addition is exact and associative, so the order in which the splits land changes no bit.

constexpr int GEMM_BM = 128;         // output rows per tile: two consumer warpgroups x 64
constexpr int GEMM_KB = 128;         // bytes of K per k-block
constexpr int GEMM_THREADS = 384;    // producer warpgroup + two consumer warpgroups
constexpr int GEMM_RING_BYTES = 192 * 1024;

template <int BN>
struct GemmCfg {
  static constexpr int A_BYTES = GEMM_BM * GEMM_KB, B_BYTES = BN * GEMM_KB;
  static constexpr int STAGES = GEMM_RING_BYTES / (A_BYTES + B_BYTES);  // 6 (BN = 128) or 4 (BN = 256)
};

template <int BN>
struct alignas(SMEM_ALIGN) GemmSmem {
  uint8_t a[GemmCfg<BN>::STAGES][GemmCfg<BN>::A_BYTES];
  uint8_t b[GemmCfg<BN>::STAGES][GemmCfg<BN>::B_BYTES];
  uint64_t full[GemmCfg<BN>::STAGES], empty[GemmCfg<BN>::STAGES];
  int last;  // split-K: whether the block's current item counted last on its tile
};

template <int BN>
constexpr int gemm_smem_bytes() {
  return sizeof(GemmSmem<BN>) + SMEM_ALIGN;
}

// A's tensor map and one B map per section.
struct GemmMaps {
  CUtensorMap a, b[3];
};

struct GemmParams {
  int M, sec_n, sections, kblocks, split;
  int m_tiles, n_tiles, tiles, items;  // n_tiles: per section
  int* ws;                             // split > 1: the (M, sections * sec_n) int32 workspace, zeroed; else null
  int* counters;                       // split > 1: one int per tile, zeroed
};

struct GemmItem {
  int tile, m0, section, col0, kb0, kb1;
};

template <int BN>
__device__ __forceinline__ GemmItem gemm_item(const GemmParams& g, int item) {
  GemmItem it;
  const int split = item / g.tiles;
  it.tile = item - split * g.tiles;
  const int nt = it.tile / g.m_tiles;
  it.m0 = (it.tile - nt * g.m_tiles) * GEMM_BM;
  it.section = nt / g.n_tiles;
  it.col0 = (nt - it.section * g.n_tiles) * BN;
  it.kb0 = split * g.kblocks / g.split;
  it.kb1 = (split + 1) * g.kblocks / g.split;
  return it;
}

template <bool S8>
struct GemmAcc {
  using T = int;
};
template <>
struct GemmAcc<false> {
  using T = float;
};

// One k-block (4 k-steps of 32 bytes) of a consumer's m64nBN product: A and B K-major in 128-byte-swizzled
// shared memory, the k-step advancing both start addresses by 32 bytes inside the swizzled rows.
template <bool S8, int BN>
__device__ __forceinline__ void gemm_kblock(typename GemmAcc<S8>::T (&acc)[BN / 2], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < GEMM_KB / 32; ++kk) {
    const uint64_t da = desc_k_major(a_addr + kk * 32), db = desc_k_major(b_addr + kk * 32);
    if constexpr (S8 && BN == 256)
      wgmma_m64n256k32_s8_ss(acc, da, db, 1);
    else if constexpr (S8)
      wgmma_m64n128k32_s8_ss(acc, da, db, 1);
    else if constexpr (BN == 256)
      wgmma_m64n256k16_ss<0, 0>(acc, da, db, 1);
    else
      wgmma_m64n128k16_ss<0, 0>(acc, da, db, 1);
  }
}

// The 4 x 4 transpose of 32-bit words across a quad of lanes (t = lane % 4): lane t's w[u] becomes lane u's
// w[t]. In the accumulator layout above, lane t holds columns 2t, 2t + 1 of each 8-column chunk, so after packing
// two columns to a word and transposing the words of 4 chunks, lane t holds all 8 columns of the t-th chunk: one
// 16-byte store (bf16) where there were four of 4 bytes. Two exchanges, each of the two words a lane replaces.
// Every lane of the warp must call it.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int t) {
  const bool b0 = t & 1, b1 = t & 2;
  uint32_t x0 = __shfl_xor_sync(0xffffffffu, b0 ? w[0] : w[1], 1);
  uint32_t x1 = __shfl_xor_sync(0xffffffffu, b0 ? w[2] : w[3], 1);
  if (b0)
    w[0] = x0, w[2] = x1;
  else
    w[1] = x0, w[3] = x1;
  x0 = __shfl_xor_sync(0xffffffffu, b1 ? w[0] : w[2], 2);
  x1 = __shfl_xor_sync(0xffffffffu, b1 ? w[1] : w[3], 2);
  if (b1)
    w[0] = x0, w[1] = x1;
  else
    w[2] = x0, w[3] = x1;
}

// Split-K: add this item's partial sums into the workspace and count the item on its tile. Returns true in the
// item that counted last, with the tile's total in acc; false in the others, whose work on the tile is done.
// Every consumer thread calls it (named barrier 1 spans the 256 of them).
template <int BN>
__device__ __forceinline__ bool gemm_split_total(int (&acc)[BN / 2], const GemmParams& g, const GemmItem& it,
                                                 int row0, int t, int ctid, int& last) {
  const int ld = g.sections * g.sec_n, cols = min(BN, g.sec_n - it.col0);
  int* base = g.ws + it.section * g.sec_n + it.col0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= g.M) continue;
    int* w = base + (long long)row * ld;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (8 * c + 2 * t + j < cols) atomicAdd(w + 8 * c + 2 * t + j, acc[4 * c + 2 * i + j]);
  }
  __threadfence();
  named_bar_sync(1, 256);
  if (ctid == 0) last = atomicAdd(g.counters + it.tile, 1) == g.split - 1;
  named_bar_sync(1, 256);
  if (!last) return false;
  __threadfence();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const int* w = base + (long long)row * ld;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * c + 2 * t + j;
        acc[4 * c + 2 * i + j] = row < g.M && col < cols ? __ldcg(w + col) : 0;
      }
  }
  return true;
}

// The epilogue functor: `typename Epi::State Epi::init(int t)` once per consumer thread (what it keeps across
// tiles), then `epi(acc, state, row0, section, col0, t)` per tile, with acc in the layout above.
template <bool S8, int BN, class Epi>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    gemm_kernel(const __grid_constant__ GemmMaps maps, const GemmParams g, const Epi epi) {
  using Cfg = GemmCfg<BN>;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  GemmSmem<BN>& sm = *reinterpret_cast<GemmSmem<BN>*>(align_smem(smem_raw));
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], GEMM_THREADS - 128);  // every consumer thread releases the slot
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (tid == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
        const GemmItem it = gemm_item<BN>(g, item);
        for (int kb = it.kb0; kb < it.kb1; ++kb) {
          const int k0 = kb * (S8 ? GEMM_KB : GEMM_KB / 2);
          mbar_wait(&sm.empty[s], phase ^ 1);  // the first pass over the ring finds every slot free
          mbar_arrive_expect_tx(&sm.full[s], Cfg::A_BYTES + Cfg::B_BYTES);
          tma_load_2d(sm.a[s], &maps.a, &sm.full[s], k0, it.m0);
          tma_load_2d(sm.b[s], &maps.b[it.section], &sm.full[s], k0, it.col0);
          if (++s == STAGES) s = 0, phase ^= 1;
        }
      }
    }
  } else {  // consumer warpgroups: 64 rows of the tile each
    setmaxnreg_inc<232>();
    const int ctid = tid - 128, cwg = ctid >> 7, warp = (ctid >> 5) & 3, lane = tid & 31, t = lane & 3;
    const typename Epi::State state = epi.init(t);
    int s = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
      const GemmItem it = gemm_item<BN>(g, item);
      typename GemmAcc<S8>::T acc[BN / 2];  // the m64nBN accumulator
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

      int prev = -1;
      for (int kb = it.kb0; kb < it.kb1; ++kb) {
        mbar_wait(&sm.full[s], phase);
        fence_regs(acc);
        wgmma_fence();
        gemm_kblock<S8, BN>(acc, smem_u32(sm.a[s]) + cwg * 64 * GEMM_KB, smem_u32(sm.b[s]));
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<1>();  // the previous k-block's products are done: release its slot
        if (prev >= 0) mbar_arrive(&sm.empty[prev]);
        prev = s;
        if (++s == STAGES) s = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&sm.empty[prev]);

      const int row0 = it.m0 + cwg * 64 + warp * 16 + (lane >> 2);
      if constexpr (S8) {
        if (g.split > 1 && !gemm_split_total<BN>(acc, g, it, row0, t, ctid, sm.last)) continue;
      }
      epi(acc, state, row0, it.section, it.col0, t);
    }
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

// A tensor map's description as the Python wrappers pass it (ops/flash_attention.py tma_layout): 11 ints,
// dims innermost first (D, H, N, B), the byte strides of H, N and B, and the box (64, 1, rows, 1).
constexpr int LAYOUT_INTS = 11;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t st = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t st = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (st == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Encode the bf16 tensor map of one (B, N, H, D) view from its layout, D a multiple of 16 up to 512, in boxes of
// 64 columns (one 128-byte swizzle row; a kernel loads a tile of D > 64 as D / 64 boxes rounded up, and TMA writes
// zeros into the columns past D); `rows` is the box height the kernel was built for, and a layout with any other box is
// refused (a box that does not match the kernel's expected transaction bytes would leave its barrier waiting
// for ever). Returns a cudaError_t.
inline int encode_tile_map(CUtensorMap* map, const void* base, const long long* layout, int rows) {
  const long long* L = layout;
  if (L[0] < 16 || L[0] > 512 || L[0] % 16 || L[7] != 64 || L[8] != 1 || L[9] != rows || L[10] != 1)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)L[0], (cuuint64_t)L[1], (cuuint64_t)L[2], (cuuint64_t)L[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)L[4], (cuuint64_t)L[5], (cuuint64_t)L[6]};
  const cuuint32_t box[4] = {(cuuint32_t)L[7], (cuuint32_t)L[8], (cuuint32_t)L[9], (cuuint32_t)L[10]};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Encode a tensor map of `rank` dims (innermost first) with the byte strides of dims 1.. and the box, in
// 8-bit (CU_TENSOR_MAP_DATA_TYPE_UINT8) or bf16 elements and the given swizzle. Elements outside the tensor,
// at negative coordinates too, load as zeros. Returns a cudaError_t.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base, const cuuint64_t* dims,
                      const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Allow `bytes` of dynamic shared memory for `kernel` on the current device (once per device).
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st != cudaSuccess) return (int)st;
  if (dev < 64 && done[dev]) return 0;
  st = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (st == cudaSuccess && dev < 64) done[dev] = true;
  return (int)st;
}

// The current device's SM count (cached per device): the grid of a persistent kernel.
inline int sm_count(int* sms) {
  static int cached[64];
  int dev = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st != cudaSuccess) return (int)st;
  if (dev < 64 && cached[dev] > 0) {
    *sms = cached[dev];
    return 0;
  }
  st = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (st == cudaSuccess && dev < 64) cached[dev] = *sms;
  return (int)st;
}


// The GEMM's tensor maps as ops/gemm.py gemm_maps describes them: 10 ints, A's dims (K, M), the byte stride
// of its rows and its box (128 bytes of K, 128 rows), then B's (K, sec_n), stride and box (128 bytes, BN rows).
constexpr int GEMM_MAP_INTS = 10;

// Encode A's map and one B map per section (the sections' bases in b) from the description, in 8-bit or bf16
// elements. A box other than the kernel's is refused: its full barrier would wait for other bytes than
// arrive. Returns a cudaError_t.
inline int encode_gemm_maps(GemmMaps* maps, CUtensorMapDataType type, int elem_bytes, const void* a,
                            const void* const* b, int sections, const long long* L, int bn) {
  if (L[3] * elem_bytes != GEMM_KB || L[4] != GEMM_BM || L[8] * elem_bytes != GEMM_KB || L[9] != bn ||
      L[0] != L[5] || L[2] % 16 || L[7] % 16 || sections < 1 || sections > 3)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 1 + sections; ++i) {
    const long long* l = i == 0 ? L : L + 5;
    const cuuint64_t dims[2] = {(cuuint64_t)l[0], (cuuint64_t)l[1]}, strides[1] = {(cuuint64_t)l[2]};
    const cuuint32_t box[2] = {(cuuint32_t)l[3], (cuuint32_t)l[4]};
    const int status = encode_map(i == 0 ? &maps->a : &maps->b[i - 1], type, 2, i == 0 ? a : b[i - 1], dims,
                                  strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (status != 0) return status;
  }
  return 0;
}

// The work of a GEMM of M rows, `sections` x sec_n columns and K of `k_bytes` bytes, in tiles of 128 x bn and
// `split` ranges of the K loop, none empty; with split > 1, ws holds the zeroed int32 workspace of M x
// sections x sec_n and then one counter per tile. Returns a cudaError_t.
inline int gemm_params(GemmParams* g, int M, int sec_n, int sections, long long k_bytes, int bn, int split, int* ws) {
  if (M <= 0 || sec_n <= 0 || k_bytes <= 0 || (bn != 128 && bn != 256)) return (int)cudaErrorInvalidValue;
  const long long kblocks = (k_bytes + GEMM_KB - 1) / GEMM_KB;
  if (split < 1 || split > kblocks || (split > 1 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  const long long m_tiles = (M + GEMM_BM - 1) / GEMM_BM, n_tiles = (sec_n + bn - 1) / bn;
  const long long tiles = m_tiles * n_tiles * sections;
  if (tiles * split > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  g->M = M, g->sec_n = sec_n, g->sections = sections, g->kblocks = (int)kblocks, g->split = split;
  g->m_tiles = (int)m_tiles, g->n_tiles = (int)n_tiles, g->tiles = (int)tiles, g->items = (int)(tiles * split);
  g->ws = split > 1 ? ws : nullptr;
  g->counters = split > 1 ? ws + (long long)M * sections * sec_n : nullptr;
  return 0;
}

// Launch the GEMM on a persistent grid of min(items, SMs) blocks. Returns a cudaError_t.
template <bool S8, int BN, class Epi>
inline int launch_gemm(const GemmMaps& maps, const GemmParams& g, const Epi& epi, cudaStream_t st) {
  static bool smem_set[64];
  int status = allow_smem(gemm_kernel<S8, BN, Epi>, gemm_smem_bytes<BN>(), smem_set);
  if (status != 0) return status;
  int sms = 0;
  status = sm_count(&sms);
  if (status != 0) return status;
  gemm_kernel<S8, BN, Epi><<<g.items < sms ? g.items : sms, GEMM_THREADS, gemm_smem_bytes<BN>(), st>>>(maps, g, epi);
  return (int)cudaGetLastError();
}

}  // namespace uc_hopper
