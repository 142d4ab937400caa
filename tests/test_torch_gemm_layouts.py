"""
What surrounds the shared Hopper GEMM (csrc/hopper.cuh gemm_kernel) of K4
(the int8 matmul) and K5's projection, on the CPU: the planner's tiles and
splits at the trunk's shapes, the work items and tensor maps emulated box by
box with the int32 split sums against the int8 matmul's plain version, and
the wgmma accumulator layout that K5's RoPE epilogue pairs in registers.
"""

import numpy as np
import pytest
import torch

from uniception_tpu_torch.ops.gemm import (
    ITEM_STEPS,
    K_BLOCK_BYTES,
    SPLIT_STEPS,
    TILE_M,
    gemm_items,
    gemm_maps,
    gemm_plan,
)
from uniception_tpu_torch.ops.int8_matmul import int8_matmul_dynamic_ref, quantize_rows

SMS = 132
# (M tokens, K, N) of K4 at the trunk's shapes (chip_smoke.py K4_SHAPES): the encoder at batch 2 pairs, the
# decoder per view
K4_SHAPES = [(4096, 1024, 3072), (4096, 1024, 1024), (4096, 1024, 4096), (4096, 4096, 1024), (2048, 1024, 768),
             (2048, 768, 2304), (2048, 768, 768), (2048, 768, 3072), (2048, 3072, 768)]
# (M, C, H * 64 per section, sections) of K5's projection launches in DUSt3R 512: encoder self, decoder self,
# decoder cross (q, then k and v)
K5_SHAPES = [(4096, 1024, 1024, 3), (2048, 768, 768, 3), (2048, 768, 768, 1), (2048, 768, 768, 2)]


def _makespan(M, N, K, es, bn, split, sections):
    "The planner's cost: items per SM times an item's k-blocks (its longest K range, fill and epilogue) x bn / 128."
    kblocks = -(-K * es // K_BLOCK_BYTES)
    tiles = -(-M // TILE_M) * -(-N // bn) * sections
    steps = -(-kblocks // split) + ITEM_STEPS + (SPLIT_STEPS * min(M, TILE_M) / TILE_M if split > 1 else 0)
    return -(-tiles * split // SMS) * steps * bn / 128


def _check_cover(M, N, K, es, bn, split, sections):
    "Every output tile of every section appears once per split, and its K ranges partition the K loop, none empty."
    kblocks = -(-K * es // K_BLOCK_BYTES)
    ranges = {}
    for tile, m0, sec, col0, kb0, kb1 in gemm_items(M, N, K, es, bn, split, sections):
        assert 0 <= m0 < M and 0 <= col0 < N and 0 <= sec < sections and m0 % TILE_M == 0 and col0 % bn == 0
        assert kb0 < kb1, "an empty K range"
        ranges.setdefault((m0, sec, col0), []).append((tile, kb0, kb1))
    want = {(m0, s, c0) for m0 in range(0, M, TILE_M) for s in range(sections) for c0 in range(0, N, bn)}
    assert set(ranges) == want
    for parts in ranges.values():
        assert len({t for t, _, _ in parts}) == 1  # one tile index, the split counter's
        bounds = sorted((a, b) for _, a, b in parts)
        assert bounds[0][0] == 0 and bounds[-1][1] == kblocks
        assert all(b0[1] == b1[0] for b0, b1 in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("m,k,n,sections,es", [(*s, 1, 1) for s in K4_SHAPES] + [(m, c, hd, s, 2) for m, c, hd, s in K5_SHAPES])
def test_gemm_plan_covers_the_product_with_the_least_makespan(m, k, n, sections, es):
    split_k = es == 1  # only the int8 GEMM splits the K loop (its int32 partial sums add exactly)
    bn, split = gemm_plan(m, n, k, es, SMS, sections=sections, split_k=split_k)
    kblocks = -(-k * es // K_BLOCK_BYTES)
    assert bn in (128, 256) and 1 <= split <= kblocks and (split_k or split == 1)
    _check_cover(m, n, k, es, bn, split, sections)
    best = min(_makespan(m, n, k, es, b, s, sections) for b in (128, 256) for s in range(1, (kblocks if split_k else 1) + 1))
    assert _makespan(m, n, k, es, bn, split, sections) == best


def test_gemm_plan_choices():
    """Wide tiles at the encoder's shapes; 128-wide at the decoder's; the K loop split only where a few tiles of a
    few rows leave SMs idle (a split's int32 atomics cost in proportion to the tile's rows)."""
    assert gemm_plan(4096, 3072, 1024, 1, SMS) == (256, 1)
    assert gemm_plan(4096, 1024, 4096, 1, SMS) == (256, 1)
    assert gemm_plan(2048, 768, 3072, 1, SMS) == (128, 1)  # 96 tiles: one wave, no split pays
    assert gemm_plan(129, 768, 4096, 1, SMS) == (128, 1)  # 12 full tiles: their atomics cost more than 29 k-blocks
    assert gemm_plan(1, 768, 4096, 1, SMS) == (128, 16)  # 6 tiles of one row: 16 ranges of 2 k-blocks
    assert gemm_plan(1, 136, 16, 1, SMS) == (128, 1)
    assert gemm_plan(4096, 1024, 1024, 2, SMS, sections=3, split_k=False) == (256, 1)


def test_gemm_maps_layout():
    "A (M, K) by (k, row) in boxes of 128 bytes x 128 rows; B (n_rows, K) in boxes of 128 bytes x bn rows."
    assert gemm_maps(129, 48, 136, 1, 256) == (48, 129, 48, 128, 128, 48, 136, 48, 128, 256)
    assert gemm_maps(2048, 768, 768, 2, 128) == (768, 2048, 1536, 64, 128, 768, 768, 1536, 64, 128)


@pytest.mark.parametrize("m,n,k,sections", [(129, 136, 48, 1), (300, 192, 400, 1), (65, 192, 80, 3)])
def test_gemm_items_cover_ragged_shapes_at_every_plan(m, n, k, sections):
    kblocks = -(-k // K_BLOCK_BYTES)
    for bn in (128, 256):
        for split in range(1, kblocks + 1):
            _check_cover(m, n, k, 1, bn, split, sections)


def _tma_box(flat, dims, strides, box, coords, es):
    """One TMA box of a tensor map over ``flat`` (dims innermost first, the byte strides of dims 1.., the box) at
    ``coords``, zeros outside the tensor. Returns the box outermost dim first."""
    elem = [1] + [s // es for s in strides]
    grids = np.meshgrid(*[c + np.arange(n) for c, n in zip(coords[::-1], box[::-1])], indexing="ij")[::-1]
    valid, off = np.ones(grids[0].shape, bool), np.zeros(grids[0].shape, np.int64)
    for g, d, s in zip(grids, dims, elem):
        valid &= (g >= 0) & (g < d)
        off += g * s
    out = np.zeros(grids[0].shape, flat.dtype)
    out[valid] = flat[off[valid]]
    return out


def _emulate_k4(x_q, a_scale, w_nk, w_scale, bias, bn, split):
    """K4's GEMM (csrc/hopper.cuh gemm_kernel + int8_matmul.cu DequantBiasEpilogue): every work item loads its
    A and B boxes through the two tensor maps, k-block by k-block; with split > 1 each item adds its int32 partial
    sums into the workspace and the item that counts last on its tile reads the total and runs the epilogue,
    float32(acc) * (a_scale * w_scale) + bias, each operation rounded to float32."""
    M, K = x_q.shape
    N = w_nk.shape[0]
    maps = gemm_maps(M, K, N, 1, bn)
    ad, ast, abox, bd, bst, bbox = maps[0:2], maps[2:3], maps[3:5], maps[5:7], maps[7:8], maps[8:10]
    af, bf = x_q.reshape(-1).astype(np.int64), w_nk.reshape(-1).astype(np.int64)
    ws = np.zeros((M, N), np.int64)
    count = {}
    out = np.full((M, N), np.nan, np.float32)
    for tile, m0, _, col0, kb0, kb1 in gemm_items(M, N, K, 1, bn, split):
        acc = np.zeros((TILE_M, bn), np.int64)
        for kb in range(kb0, kb1):
            a = _tma_box(af, ad, ast, abox, (kb * K_BLOCK_BYTES, m0), 1)
            b = _tma_box(bf, bd, bst, bbox, (kb * K_BLOCK_BYTES, col0), 1)
            acc += a @ b.T
        rows, cols = min(TILE_M, M - m0), min(bn, N - col0)
        if split > 1:
            ws[m0:m0 + rows, col0:col0 + cols] += acc[:rows, :cols]
            count[tile] = count.get(tile, 0) + 1
            if count[tile] < split:
                continue
            acc[:rows, :cols] = ws[m0:m0 + rows, col0:col0 + cols]
        assert np.abs(acc).max() < 2**31  # int32 sums
        y = acc[:rows, :cols].astype(np.float32) * (a_scale[m0:m0 + rows, None] * w_scale[None, col0:col0 + cols])
        if bias is not None:
            y = y + bias[None, col0:col0 + cols]
        out[m0:m0 + rows, col0:col0 + cols] = y
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("m,k,n", [(129, 48, 136), (129, 400, 136)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_tiling_and_maps_compute_the_int8_matmul(m, k, n, dtype):
    "The description, box by box, with the split sums, gives int8_matmul_dynamic_ref's bits at every plan."
    rng = np.random.RandomState(m + k + n)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32) * 3).to(dtype)
    w_nk = rng.randint(-127, 128, size=(n, k)).astype(np.int8)
    w_scale = (rng.rand(n).astype(np.float32) * 1e-2 + 1e-4).astype(np.float32)
    bias = rng.randn(n).astype(np.float32)
    ref = int8_matmul_dynamic_ref(x, torch.from_numpy(w_nk).t(), torch.from_numpy(w_scale), torch.from_numpy(bias),
                                  out_dtype=torch.float32)
    x_q, a_scale = quantize_rows(x)
    kblocks = -(-k // K_BLOCK_BYTES)
    for bn in (128, 256):
        for split in range(1, kblocks + 1):
            got = _emulate_k4(x_q.numpy(), a_scale.numpy()[:, 0], w_nk, w_scale, bias, bn, split)
            assert torch.equal(torch.from_numpy(got), ref), (bn, split)


def _wgmma_acc(n, w, lane, r):
    "The (row, column) of the m64nNk16 accumulator that register r of thread (warp w, lane) holds (PTX ISA)."
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * ((r >> 1) & 1), 8 * (r >> 2) + 2 * t + (r & 1)


@pytest.mark.parametrize("bn", [128, 256])
def test_rope_pairs_share_a_thread_in_the_wgmma_accumulator(bn):
    """Every RoPE pair (d, d + 16) of every head of a bn-wide tile (heads of 64 columns: [u_Y v_Y u_X v_X]) lands on
    one thread, two n8 chunks (8 registers) apart; and the epilogue's index acc[4 (8 hh + nj) + 2 i + e] is head
    hh's column 8 nj + 2t + e of row g + 8 i (csrc/fused_attention.cu BiasRopeEpilogue)."""
    where = {}
    for w in range(4):
        for lane in range(32):
            for r in range(bn // 2):
                where[_wgmma_acc(bn, w, lane, r)] = (w, lane, r)
    assert len(where) == 64 * bn  # the warpgroup holds each element once
    for row in range(64):
        for hh in range(bn // 64):
            for d in range(64):
                if d % 32 >= 16:
                    continue  # a v column: its u partner is d - 16
                w, lane, r = where[(row, 64 * hh + d)]
                w2, lane2, r2 = where[(row, 64 * hh + d + 16)]
                assert (w, lane) == (w2, lane2) and r2 == r + 8
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for hh in range(bn // 64):
                for nj in range(8):
                    for i in range(2):
                        for e in range(2):
                            r = 4 * (8 * hh + nj) + 2 * i + e
                            assert _wgmma_acc(bn, w, lane, r) == (16 * w + g + 8 * i, 64 * hh + 8 * nj + 2 * t + e)


def _quad_transpose(words):
    "csrc/hopper.cuh quad_transpose on a quad's words[t][u]: two exchanges of the words each lane replaces."
    w = [list(r) for r in words]
    for bit, (keep, swap) in ((1, ((0, 2), (1, 3))), (2, ((0, 1), (2, 3)))):
        sent = [[w[t][k] for k in (keep if t & bit else swap)] for t in range(4)]
        for t in range(4):
            for k, x in zip(keep if t & bit else swap, sent[t ^ bit]):
                w[t][k] = x
    return w


@pytest.mark.parametrize("bn", [128, 256])
def test_quad_transpose_gives_each_lane_a_whole_chunk(bn):
    """The epilogues' 16-byte stores (int8_matmul.cu DequantBiasEpilogue, fused_attention.cu BiasRopeEpilogue):
    each lane packs its two columns of 4 consecutive 8-column chunks into 4 words, the quad transposes them, and
    lane t then holds columns 0-7 of the t-th chunk, in order, of its own row."""
    for w in range(4):
        for g in range(8):
            for i in range(2):
                for q in range(0, bn // 8, 4):
                    words = [[tuple(_wgmma_acc(bn, w, 4 * g + t, 4 * (q + u) + 2 * i + e) for e in range(2))
                              for u in range(4)] for t in range(4)]
                    for t, lane_words in enumerate(_quad_transpose(words)):
                        row = 16 * w + g + 8 * i
                        assert [c for pair in lane_words for c in pair] == [
                            (row, 8 * (q + t) + k) for k in range(8)]
