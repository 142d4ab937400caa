"""
What surrounds the port's shared Hopper GEMM (csrc/hopper.cuh ``gemm_kernel``),
on which K4 (the int8 matmul, csrc/int8_matmul.cu) and K5's projection (the
bf16 qkv GEMM, csrc/fused_attention.cu) run: C[M x N] = A[M x K] . B[N x K]^T,
both operands row-major (K-major), in 128 x BN output tiles and k-blocks of
128 bytes.

    * :func:`gemm_plan` — the tile width BN and the split of the K loop, by
      the makespan of the persistent grid;
    * :func:`gemm_maps` — the two tensor maps as the C entry points take them;
    * :func:`gemm_items` — the kernel's work items (``gemm_item``), in order.

Everything here is plain Python, so the CPU tests emulate the kernel's tiling
box by box.
"""

import ctypes
import functools

import torch

__all__ = ["SMS", "TILE_M", "K_BLOCK_BYTES", "ITEM_STEPS", "SPLIT_STEPS", "gemm_plan", "gemm_maps", "gemm_items",
           "sm_count"]

SMS = 132  # the H100's SMs: the planner's default wave
TILE_M = 128  # output rows per tile (hopper.cuh GEMM_BM)
K_BLOCK_BYTES = 128  # bytes of K per k-block: one 128-byte swizzle row (hopper.cuh GEMM_KB)
TILE_N = (256, 128)  # the widths the kernel is built for, the wider first (fewer items among equals)
ITEM_STEPS = 2  # an item's ring fill and epilogue, in k-blocks
# A split item's int32 partial sums added into the workspace by atomics (and the total read back), in k-blocks,
# for a full 128-row tile (a tile of fewer rows adds fewer): on the H100 the atomics of a full tile cost about
# as much as a few dozen k-blocks of its products (chip_smoke.py phase 11: the trunk shapes with the K loop split
# in two, and its split probe), so only tiles of a few rows over a long K loop split.
SPLIT_STEPS = 40


def _kblocks(K: int, elem_bytes: int) -> int:
    return -(-K * elem_bytes // K_BLOCK_BYTES)


def gemm_plan(M: int, N: int, K: int, elem_bytes: int, sms: int = SMS, sections: int = 1, split_k: bool = True,
              widths=TILE_N):
    """The GEMM's (bn, split) for M rows, ``sections`` x N columns and K values of ``elem_bytes`` bytes.

    An output tile is 128 rows by bn = 128 or 256 columns of one section; the
    K loop of ceil(K * elem_bytes / 128) k-blocks is cut into ``split``
    ranges, none empty (only with ``split_k``: the int8 GEMM, whose int32
    partial sums add exactly). The persistent grid gives each SM
    ceil(items / sms) items, each costing its longest K range plus ITEM_STEPS
    (and, when split, SPLIT_STEPS times the fullest tile's share of 128 rows)
    k-blocks, times bn / 128: the plan is the one with the least such
    makespan, then the fewest ranges, then the wider tile. ``widths``: the tile
    widths the caller takes (K5's padded heads of 256 columns take 256 only).
    """
    kblocks = _kblocks(K, elem_bytes)
    m_tiles = -(-M // TILE_M)
    best = None
    for bn in widths:
        tiles = m_tiles * sections * -(-N // bn)
        for split in range(1, (kblocks if split_k else 1) + 1):
            steps = -(-kblocks // split) + ITEM_STEPS + (SPLIT_STEPS * min(M, TILE_M) / TILE_M if split > 1 else 0)
            key = (-(-tiles * split // sms) * steps * bn / 128, split)
            if best is None or key < best[0]:
                best = (key, bn, split)
    return best[1], best[2]


def gemm_maps(M: int, K: int, n_rows: int, elem_bytes: int, bn: int):
    """The GEMM's two tensor maps as its C entry points take them (10 ints), for contiguous A and B.

    A (M, K): the dims innermost first (K, M), the byte stride of a row, and
    the box (128 bytes of K, 128 rows); B (n_rows, K), each section's weight:
    (K, n_rows), its row stride and the box (128 bytes of K, bn rows). TMA
    fills the box's elements past the tensor with zeros.
    """
    kb = K_BLOCK_BYTES // elem_bytes
    return (K, M, K * elem_bytes, kb, TILE_M, K, n_rows, K * elem_bytes, kb, bn)


@functools.lru_cache(maxsize=256)
def maps_array(*args):
    "The C array of :func:`gemm_maps` (it holds no pointer, so one array per shape is built and reused)."
    return (ctypes.c_longlong * 10)(*gemm_maps(*args))


def gemm_items(M: int, N: int, K: int, elem_bytes: int, bn: int, split: int, sections: int = 1):
    """The kernel's work items in order (hopper.cuh ``gemm_item``): (tile, m0, section, col0, kb0, kb1).

    m-tiles run fastest, then the n-tiles of each section, then the splits; split s of the K loop covers
    k-blocks [s * kblocks // split, (s + 1) * kblocks // split)."""
    kblocks = _kblocks(K, elem_bytes)
    m_tiles, n_tiles = -(-M // TILE_M), -(-N // bn)
    tiles = m_tiles * n_tiles * sections
    for item in range(tiles * split):
        s, tile = divmod(item, tiles)
        nt, mt = divmod(tile, m_tiles)
        section, ct = divmod(nt, n_tiles)
        yield tile, mt * TILE_M, section, ct * bn, s * kblocks // split, (s + 1) * kblocks // split


@functools.lru_cache(maxsize=8)
def sm_count(index: int) -> int:
    "The SM count of CUDA device ``index``: the planners' wave."
    return torch.cuda.get_device_properties(index).multi_processor_count
