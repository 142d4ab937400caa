"""
What surrounds the K7 (3x3 conv) and K6 (int8 attention) kernels, on the CPU:
K7's planner and tensor maps, with the kernel's tiling, split K loop and
fixed-order reduction emulated box by box against the plain conv; and the
scratch layout of K6's prep (the int8 keys, the transposed int8 values in
the order the score accumulators hold p, zeros past the keys).
"""

import numpy as np
import pytest
import torch

from uniception_tpu_torch.ops.conv3x3 import ITEM_STEPS, TILE_PIXELS, conv3x3_maps, conv3x3_plan, conv3x3_reference
from uniception_tpu_torch.ops.flash_attention import (
    INT8_CHUNK,
    flash_attention_int8_prep_ref,
    int8_pv_keys,
)

SMS = 132
# (H = W, C, Co) of the DPT head's eligible convs at 512 (chip_smoke.py K7_SHAPES), batch 2
K7_SHAPES = [(32, 384, 256), (16, 768, 256), (16, 256, 256), (32, 256, 256), (64, 256, 256), (128, 256, 256),
             (256, 256, 128)]


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
