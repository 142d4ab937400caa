"""
What surrounds the K7 (3x3 conv), K6 (int8 attention) and K1 (flash attention)
kernels, on the CPU: K7's planner and tensor maps, with the kernel's tiling,
split K loop and fixed-order reduction emulated box by box against the plain
conv; the scratch layout of K6's prep (the int8 keys, the transposed int8
values in the order the score accumulators hold p, zeros past the keys); and
K1's tile plan at every head dim it takes (the box count and width, the zeros
TMA writes past D and past N, the ring's shared memory), with its tiles loaded
box by box and its online softmax emulated against the plain version.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from uniception_tpu_torch.ops.conv3x3 import ITEM_STEPS, TILE_PIXELS, conv3x3_maps, conv3x3_plan, conv3x3_reference
from uniception_tpu_torch.ops.flash_attention import (
    FWD_ROWS,
    HEAD_DIMS,
    INT8_CHUNK,
    WIDE_HEAD_DIM,
    flash_attention_int8_prep_ref,
    flash_attention_lse_ref,
    fwd_rows,
    int8_pv_keys,
    tma_layout,
)

SMS = 132
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100 (227 KB)
CSRC = Path(__file__).resolve().parents[1] / "uniception_tpu_torch" / "csrc"

# (H = W, C, Co) of the DPT head's eligible convs at 512 (chip_smoke.py K7_SHAPES), batch 2
K7_SHAPES = [(32, 384, 256), (16, 768, 256), (16, 256, 256), (32, 256, 256), (64, 256, 256), (128, 256, 256),
             (256, 256, 128)]


def _constant(source, pattern):
    "The integers one line of a CUDA source defines, read from the file so the plan below follows it."
    return re.search(pattern, (CSRC / source).read_text()).groups()


def k1_plan(head_dim):
    """K1's bf16 tiling for a head dim, from csrc/flash_attention.cu (FwdCfg, FwdSmem, fwd_smem_bytes; WideSmem and
    wide_smem_bytes at D = 512): (padded head dim DP, TMA boxes of BOX_COLS columns per Q, K or V tile, K / V ring
    stages, dynamic shared memory bytes). DP is 64 for D = 32 and 64, 128 up to 128, 512 at 512 (64-row tiles and
    one K and one V slot, each with its own barriers)."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not supported (other head dims: ROADMAP queue 2 item a)")
    box_cols, = map(int, _constant("flash_attention.cu", r"constexpr int BOX_COLS = (\d+);"))
    rows, = map(int, _constant("flash_attention.cu", r"constexpr int BQ = (\d+);"))
    big, small = map(int, _constant("flash_attention.cu", r"STAGES = DP == 128 \? (\d+) : (\d+);"))
    align, = map(int, _constant("hopper.cuh", r"constexpr int SMEM_ALIGN = (\d+);"))
    kib, unit = map(int, _constant("hopper.cuh", r"constexpr int MIN_SMEM_BYTES = (\d+) \* (\d+);"))
    if head_dim == WIDE_HEAD_DIM:
        wide_rows, = map(int, _constant("flash_attention.cu", r"constexpr int W_BQ = (\d+);"))
        tiles = 3 * wide_rows * head_dim * 2  # Q, K and V, bf16
        struct = -(-(tiles + 8 * 6) // align) * align  # + six mbarriers
        return head_dim, head_dim // box_cols, 1, max(struct + align, kib * unit)
    dp = 64 if head_dim <= 64 else 128
    stages = big if dp == 128 else small
    tiles = rows * dp * 2 * (1 + 2 * stages)  # Q, and K and V per stage, bf16
    struct = -(-(tiles + 8 * (2 + 2 * stages)) // align) * align  # + the mbarriers, padded to the struct's alignment
    return dp, dp // box_cols, stages, max(struct + align, kib * unit)


def _makespan(tiles, steps, split, sms):
    "K-steps on the busiest SM of the persistent grid (conv3x3_plan's cost model)."
    return -(-tiles * split // sms) * (-(-steps // split) + ITEM_STEPS)


@pytest.mark.parametrize("hw,c,co", K7_SHAPES)
def test_conv3x3_plan_balances_the_card_at_every_dpt_shape(hw, c, co):
    "Each DPT conv gets tiles of 128 pixels and the split of the least makespan, with no K range empty."
    tw, th, bn, split = conv3x3_plan(2, hw, hw, c, co, SMS)
    assert tw * th == TILE_PIXELS and tw & (tw - 1) == 0 and 8 <= tw <= 128 and tw >= min(hw, 128)
    assert bn in (128, 256) and (bn == 128 or co % 256 == 0)
    tiles = 2 * -(-hw // th) * -(-hw // tw) * -(-co // bn)
    steps = 9 * c // 64
    per = -(-steps // split)
    assert 1 <= split <= steps and (split - 1) * per < steps
    best = min(_makespan(tiles, steps, -(-steps // p), SMS) for p in range(1, steps + 1))
    assert _makespan(tiles, steps, split, SMS) == best
    assert split == 1 or tiles < SMS  # the K loop is split only where the tiles alone leave SMs idle


def test_conv3x3_plan_splits_only_the_small_levels():
    "The 64^2-256^2 levels keep the K loop whole; 16^2-32^2 split it and still fit one wave."
    assert conv3x3_plan(2, 128, 128, 256, 256, SMS) == (128, 1, 256, 1)
    assert conv3x3_plan(2, 256, 256, 256, 128, SMS) == (128, 1, 128, 1)
    assert conv3x3_plan(2, 64, 64, 256, 256, SMS) == (64, 2, 128, 1)
    assert conv3x3_plan(2, 16, 16, 256, 256, SMS) == (16, 8, 128, 12)  # 96 items of 3 steps, not 144 of 2
    assert conv3x3_plan(2, 32, 32, 384, 256, SMS) == (32, 4, 128, 4)  # 128 items of 14 steps, not 160 of 11
    assert conv3x3_plan(1, 5, 3, 64, 136, 1) == (8, 16, 128, 1)


def test_conv3x3_maps_layout():
    "The x map reads NHWC by (channel, column, row, image); the w map reads HWIO by (co, c, tap)."
    assert conv3x3_maps(2, 16, 24, 256, 136, 32, 4) == (
        256, 24, 16, 2, 512, 24 * 512, 16 * 24 * 512, 64, 32, 4, 1,
        136, 256, 9, 272, 256 * 272, 64, 64, 1)


def _tma_box(flat, dims, strides, box, coords, es=2):
    """One TMA box of a tensor map over ``flat`` (dims innermost first, the byte strides of dims 1.., the box) at
    ``coords``, zeros outside the tensor, negative coordinates included. Returns the box outermost dim first."""
    elem = [1] + [s // es for s in strides]
    grids = np.meshgrid(*[c + np.arange(n) for c, n in zip(coords[::-1], box[::-1])], indexing="ij")[::-1]
    valid, off = np.ones(grids[0].shape, bool), np.zeros(grids[0].shape, np.int64)
    for g, d, s in zip(grids, dims, elem):
        valid &= (g >= 0) & (g < d)
        off += g * s
    out = np.zeros(grids[0].shape, flat.dtype)
    out[valid] = flat[off[valid]]
    return out


def _emulate_k7(x, w, b, plan):
    """K7's data movement and sums (csrc/conv3x3.cu) in float64: every work item (pixel tile, output-channel tile,
    split) loads its A and B boxes through the two tensor maps, each split writes its partial sums, and the
    partials are added in split order, then the bias."""
    B, H, W, C = x.shape
    Co = w.shape[3]
    tw, th, bn, split = plan
    maps = conv3x3_maps(B, H, W, C, Co, tw, th)
    xd, xs, xb, wd, ws, wb = maps[0:4], maps[4:7], maps[7:11], maps[11:14], maps[14:16], maps[16:19]
    xf, wf = x.reshape(-1), w.reshape(-1)
    steps = 9 * C // 64
    per = -(-steps // split)
    partial = np.zeros((split, B, H, W, Co))
    for bi in range(B):
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                for co0 in range(0, Co, bn):
                    for sp in range(split):
                        acc = np.zeros((TILE_PIXELS, bn))
                        for k in range(sp * per, min(sp * per + per, steps)):
                            tap, c0 = k // (C // 64), k % (C // 64) * 64
                            a = _tma_box(xf, xd, xs, xb, (c0, x0 + tap % 3 - 1, y0 + tap // 3 - 1, bi))
                            bmat = np.concatenate([_tma_box(wf, wd, ws, wb, (co0 + 64 * j, c0, tap))[0]
                                                   for j in range(bn // 64)], axis=1)
                            acc += a.reshape(TILE_PIXELS, 64) @ bmat
                        for r in range(TILE_PIXELS):
                            px, py = x0 + r % tw, y0 + r // tw
                            if px < W and py < H:
                                partial[sp, bi, py, px, co0:co0 + bn] = acc[r, :min(bn, Co - co0)]
    out = partial[0]
    for sp in range(1, split):
        out = out + partial[sp]
    return out + (0 if b is None else b)


@pytest.mark.parametrize("b,h,w,c,co,sms", [
    (1, 5, 3, 64, 136, 132),   # image smaller than the rectangle, a tile past Co, K loop split in 9
    (2, 13, 31, 128, 8, 132),  # ragged rectangles, Co = 8
    (1, 9, 20, 128, 256, 1),   # one SM: no split, bn = 256
    (2, 4, 4, 192, 16, 16),    # three channel chunks per tap, split over taps and chunks
])
def test_conv3x3_tiling_and_maps_compute_the_conv(b, h, w, c, co, sms):
    rng = np.random.RandomState(h * w + co)
    x = rng.randn(b, h, w, c).astype(np.float32)
    wt = (rng.randn(3, 3, c, co) * (9 * c) ** -0.5).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    plan = conv3x3_plan(b, h, w, c, co, sms)
    got = _emulate_k7(x.astype(np.float64), wt.astype(np.float64), bias.astype(np.float64), plan)
    ref = conv3x3_reference(*(torch.from_numpy(a) for a in (x, wt, bias))).numpy()
    assert np.abs(got - ref).max() <= 1e-4, plan


def test_int8_pv_keys_is_the_score_accumulator_order():
    """Register i of the int8 P.V operand holds, in its 4 bytes, k positions 16 (i >> 1) + 4t .. + 3 of a 32-key
    step; K6 packs into them the score accumulator's columns 8c + 2t + j, c = 2 (i >> 1) + (e >> 1), j = e & 1.
    The transposed v8 must hold those keys at those positions."""
    keys = int8_pv_keys(32).tolist()
    for t in range(4):
        for half in range(2):
            for e in range(4):
                assert keys[16 * half + 4 * t + e] == 8 * (2 * half + (e >> 1)) + 2 * t + (e & 1)
    full = int8_pv_keys(INT8_CHUNK)
    for g in range(0, INT8_CHUNK, 32):
        assert sorted(full[g:g + 32].tolist()) == list(range(g, g + 32))


@pytest.mark.parametrize("nk", [1, 63, 65, 200])
@pytest.mark.parametrize("mode", ["int8", "int8pv"])
def test_int8_prep_ref_layout(nk, mode):
    "k8 (B, H, Nk_pad, D) and the transposed v8 (B, H, D, Nk_pad) in key order per 32, zeros past Nk."
    rng = np.random.RandomState(nk)
    k = torch.from_numpy(rng.randn(2, nk, 3, 64).astype(np.float32) + 0.5).bfloat16()
    v = torch.from_numpy(rng.randn(2, nk, 3, 64).astype(np.float32)).bfloat16()
    k8, ks, v8t, vs = flash_attention_int8_prep_ref(k, v, mode)
    nk_pad = -(-nk // INT8_CHUNK) * INT8_CHUNK
    assert k8.shape == (2, 3, nk_pad, 64) and k8.dtype == torch.int8 and ks.shape == (2, 3)
    assert not k8[:, :, nk:].any()
    centred = (k.double() - k.double().mean(dim=1, keepdim=True)).transpose(1, 2)  # (B, H, Nk, D)
    assert (k8[:, :, :nk].double() * ks.double()[..., None, None] - centred).abs().max() <= 0.51 * ks.max()
    assert k8.abs().amax(dim=(2, 3)).eq(127 if nk > 1 else 0).all()  # one key: k - mean is 0
    if mode == "int8":
        assert v8t is None and vs is None
        return
    assert v8t.shape == (2, 3, 64, nk_pad) and v8t.dtype == torch.int8 and vs.shape == (2, 3)
    keys = (torch.arange(0, nk_pad, 32)[:, None] + int8_pv_keys(32)[None]).flatten()
    v8 = torch.empty_like(v8t)
    v8[..., keys] = v8t  # back to key order
    assert not v8[..., nk:].any()
    want = torch.round(v.float() / vs[:, None, :, None]).to(torch.int8).permute(0, 2, 3, 1)
    assert torch.equal(v8[..., :nk], want)


@pytest.mark.parametrize("d,plan", [(32, (64, 1, 3)), (64, (64, 1, 3)), (80, (128, 2, 2)), (96, (128, 2, 2)),
                                    (128, (128, 2, 2)), (512, (512, 8, 1))])
def test_k1_plan_pads_the_head_dim_into_64_column_boxes(d, plan):
    """D = 32 and 64 take one 64-column box per tile (DP = 64), 80, 96 and 128 two (DP = 128) with a two-stage
    ring: the shared memory fits the block's 227 KB, and a third stage at DP = 128 would leave under 2 KB. D = 512
    takes eight boxes of 64-row tiles, one K and one V slot: a second slot of either would not fit."""
    dp, boxes, stages, smem = k1_plan(d)
    assert (dp, boxes, stages) == plan
    assert smem <= SMEM_LIMIT
    if dp == 128:
        assert SMEM_LIMIT - (smem + 2 * FWD_ROWS * dp * 2) < 2048
    if dp == 512:
        assert fwd_rows(d) == 64 and smem + fwd_rows(d) * dp * 2 > SMEM_LIMIT
    else:
        assert fwd_rows(d) == FWD_ROWS
    t = torch.zeros(2, 300, 3, d, dtype=torch.bfloat16)
    assert tma_layout(t, fwd_rows(d))[0] == d and tma_layout(t, fwd_rows(d))[7:] == (64, 1, fwd_rows(d), 1)
    with pytest.raises(ValueError, match="queue 2 item a"):
        k1_plan(d + 8)


def _k1_tile(flat, layout, d, head, row0):
    "One Q, K or V tile as K1 loads it: its boxes side by side, (rows, DP) with zeros past D and past N."
    dims, strides, box = layout[0:4], layout[4:7], layout[7:11]
    dp, boxes = k1_plan(d)[:2]
    tiles = [_tma_box(flat, dims, strides, box, (64 * i, head, row0, 0), es=4)[0, :, 0, :] for i in range(boxes)]
    return np.concatenate(tiles, axis=1)


def _emulate_k1(q, k, v, scale):
    """K1 on one (b, h) pair, tile by tile: q, k and v are head 1 of three views of one (N, 3, H = 2, D) projection,
    loaded box by box through their tensor maps (each view's base: its section of the projection); S over the
    padded DP columns, the keys past Nk masked, the online softmax, P.V over DP columns, and only the D real columns
    of o kept."""
    n, d = q.shape
    qkv = np.zeros((1, n, 3, 2, d), np.float32)
    qkv[0, :, 0, 1], qkv[0, :, 1, 1], qkv[0, :, 2, 1] = q, k, v
    flat = qkv.reshape(-1)
    tile = fwd_rows(d)
    q_map, k_map, v_map = (tma_layout(torch.from_numpy(qkv)[:, :, i], tile) for i in range(3))
    q_flat, k_flat, v_flat = (flat[i * 2 * d:] for i in range(3))  # each view's base
    out = np.zeros((n, d))
    for qt in range(0, n, tile):
        qtile = _k1_tile(q_flat, q_map, d, 1, qt).astype(np.float64)
        assert not qtile[:, d:].any() and not qtile[n - qt:].any()  # zeros past D and past N
        m, l, acc = np.full(tile, -np.inf), np.zeros(tile), np.zeros((tile, qtile.shape[1]))
        for kt in range(0, n, tile):
            ktile, vtile = _k1_tile(k_flat, k_map, d, 1, kt), _k1_tile(v_flat, v_map, d, 1, kt)
            s = qtile @ ktile.T * scale
            s[:, n - kt:] = -np.inf  # keys past Nk
            m_new = np.maximum(m, s.max(axis=1))
            p = np.exp(s - m_new[:, None])
            corr = np.exp(m - m_new)
            l, m = l * corr + p.sum(axis=1), m_new
            acc = acc * corr[:, None] + p @ vtile
        assert not acc[:, d:].any()  # the padding's columns of o are zeros, never stored
        rows = min(tile, n - qt)
        out[qt:qt + rows] = (acc[:, :d] / l[:, None])[:rows]
    return out


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k1_tiles_of_every_head_dim_compute_attention(d):
    "At every head dim, over a ragged second tile of 130 keys, the emulated tiles give the plain version's output."
    rng = np.random.RandomState(d)
    q, k, v = (rng.randn(130, d).astype(np.float32) for _ in range(3))
    scale = d**-0.5
    got = _emulate_k1(q, k, v, scale)
    ref = flash_attention_lse_ref(*(torch.from_numpy(a)[None, :, None] for a in (q, k, v)), scale)[0][0, :, 0]
    assert np.abs(got - ref.numpy()).max() <= 1e-5
