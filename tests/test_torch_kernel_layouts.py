"""
What surrounds the K7 (3x3 conv), K6 (int8 attention) and K1 (flash attention)
kernels, on the CPU: K7's planner and tensor maps, with the kernel's tiling,
split K loop and fixed-order reduction emulated box by box against the plain
conv; the scratch layout of K6's prep (the int8 keys, the transposed int8
values in the order the score accumulators hold p, zeros past the keys); and
K1's tile plan at every padded head dim it is built for (the box count and
width, the zeros TMA writes past D and past N, the ring's shared memory), with
its tiles loaded box by box and its online softmax emulated against the plain
version; K1's fp32 (3xTF32) plan at every padded head dim (boxes, V chunks, ring
stages, shared memory, accumulator registers, the split pre-pass's workspace and
its key order, which is the order P's register A operand holds the keys in); and
K3's whole-width plan above D = 64 with its work items walked over every output
row and column, and K6's shared memory at every head dim; K1's wide bf16 plan
above D = 128 (k1_wide_plan: shared memory, registers, the key splits, the
clusters of two CTAs, the splits' workspace) with its units walked over every key
and every output row and column; and K3's fp32 (3xTF32) plan at every padded head
dim (k3_f32_plan: shared memory, registers, the ring, the workspace's planes and
their row order) with its units walked over every output row and column.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from uniception_tpu_torch.ops.conv3x3 import ITEM_STEPS, TILE_PIXELS, conv3x3_maps, conv3x3_plan, conv3x3_reference
from uniception_tpu_torch.ops.flash_attention import (
    BWD_LOOP_ROWS,
    BWD_OWN_ROWS,
    F32_SMALL_HEAD_DIM,
    FWD_ROWS,
    INT8_CHUNK,
    MAX_HEAD_DIM,
    WIDE_ROWS,
    flash_attention_int8_prep_ref,
    flash_attention_lse_ref,
    fwd_rows,
    int8_pv_keys,
    int8_row_bytes,
    k1_wide_tiles_per_split,
    k1_wide_workspace_floats,
    k3_tf32_workspace_floats,
    tf32_workspace_floats,
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
    """K1's bf16 tiling for a head dim (a multiple of 8: the wrapper pads any other), from csrc/flash_attention.cu
    (FwdCfg, FwdSmem, fwd_smem_bytes; WideCfg, WideSmem and wide_smem_bytes above D = 128): (padded head dim DP,
    TMA boxes of BOX_COLS columns per Q, K or V tile, K / V ring stages, dynamic shared memory bytes). DP is 64 up to
    D = 64, 128 up to 128 (128-row tiles), then 192, 256 and 512 on the wide kernel (64-row tiles, k1_wide_plan)."""
    if not 1 <= head_dim <= MAX_HEAD_DIM["K1"]:
        raise ValueError(f"head dim {head_dim} not supported (other head dims: ROADMAP queue 2 item a)")
    box_cols, = map(int, _constant("flash_attention.cu", r"constexpr int BOX_COLS = (\d+);"))
    rows, = map(int, _constant("flash_attention.cu", r"constexpr int BQ = (\d+);"))
    big, small = map(int, _constant("flash_attention.cu", r"STAGES = DP == 128 \? (\d+) : (\d+);"))
    align, = map(int, _constant("hopper.cuh", r"constexpr int SMEM_ALIGN = (\d+);"))
    kib, unit = map(int, _constant("hopper.cuh", r"constexpr int MIN_SMEM_BYTES = (\d+) \* (\d+);"))
    dp = next(p for p in (64, 128, 192, 256, 512) if head_dim <= p)
    if dp > 128:
        wide = k1_wide_plan(head_dim)
        return dp, dp // box_cols, wide["stages"], wide["smem"]
    stages = big if dp == 128 else small
    tiles = rows * dp * 2 * (1 + 2 * stages)  # Q, and K and V per stage, bf16
    struct = -(-(tiles + 8 * (2 + 2 * stages)) // align) * align  # + the mbarriers, padded to the struct's alignment
    return dp, dp // box_cols, stages, max(struct + align, kib * unit)


def k1_f32_plan(head_dim):
    """K1's fp32 (3xTF32) kernel for a head dim (a multiple of 8), from csrc/flash_attention.cu (Tf32Cfg): a dict of
    the padded head dim DP, the column split (above DP = 128), query rows per work item, 32-column S boxes and V chunks
    of NC columns at this D, ring stages and slot bytes, dynamic shared memory, and the registers a consumer thread
    holds in accumulators (O, S and one chain's products) against its setmaxnreg budget."""
    box, = map(int, _constant("flash_attention.cu", r"constexpr int T_BOX = (\d+);"))
    bk, = map(int, _constant("flash_attention.cu", r"constexpr int T_BK = (\d+);"))
    ring, unit = map(int, _constant("flash_attention.cu", r"constexpr int T_RING_BYTES = (\d+) \* (\d+);"))
    budget, = map(int, _constant("flash_attention.cu", r"fa_fwd_tf32_kernel\([\s\S]*?setmaxnreg_inc<(\d+)>"))
    align, = map(int, _constant("hopper.cuh", r"constexpr int SMEM_ALIGN = (\d+);"))
    small, = map(int, _constant("flash_attention.cu", r"constexpr int F32_SMALL_DP = (\d+);"))
    assert small == F32_SMALL_HEAD_DIM
    if head_dim <= small:  # the CUDA-core kernel: no tiles, no workspace
        return dict(dp=small, kernel="small")
    dp = next(p for p in (32, 64, 128, 256, 512) if head_dim <= p)
    colsplit = dp > 128
    rows, nc = (64 if colsplit else 128), min(dp, 64)
    qbox, kbox, chunk = 2 * rows * 128, 2 * bk * 128, 4 * nc * 128
    slot = max(kbox + (qbox if colsplit else 0), chunk)
    q_bytes = 0 if colsplit else dp // box * qbox
    xch = p_bytes = 2 * 64 * bk * 4 if colsplit else 0
    stages = (ring * unit - q_bytes - xch - p_bytes) // slot
    smem = stages * slot + q_bytes + xch + p_bytes + 8 * (2 + 2 * stages) + align
    acc = dp // 4 if colsplit else dp // 2
    return dict(kernel="tf32", dp=dp, colsplit=colsplit, rows=rows, boxes=-(-head_dim // box), nc=nc, chunks=-(-head_dim // nc),
                stages=stages, slot=slot, smem=smem, regs=acc + bk // 2 + bk // 2, budget=budget)


def k1_wide_plan(head_dim):
    """K1's wide bf16 kernel above D = 128 (csrc/flash_attention.cu WideCfg, WideSmem): a dict of the padded head dim,
    the rows of a unit (shared by both consumers), whether S is computed once (S's k-steps split between the consumers,
    their partial scores exchanged) or by each consumer whole, S's k-steps of 16 per consumer, O's boxes of consumer 0
    (consumer 1 the rest; at DP = 192 one, beside a box of zeros), the K / V ring slots, the dynamic shared memory (Q,
    K and V, the box of zeros, the partial scores, the barriers) and the registers a consumer thread holds in O, S and
    P (bf16) against its setmaxnreg budget."""
    rows, = map(int, _constant("flash_attention.cu", r"constexpr int W_BQ = (\d+);"))
    keys, = map(int, _constant("flash_attention.cu", r"constexpr int W_BK = (\d+);"))
    sonce, = map(int, _constant("flash_attention.cu", r"SONCE = DP == (\d+);"))
    s512, s256, s192 = map(int, _constant("flash_attention.cu", r"STAGES = DP == 512 \? (\d+) : DP == 256 \? (\d+) : (\d+);"))
    budget, = map(int, _constant("flash_attention.cu", r"fa_fwd_bf16_wide_kernel\([\s\S]*?setmaxnreg_inc<(\d+)>"))
    align, = map(int, _constant("hopper.cuh", r"constexpr int SMEM_ALIGN = (\d+);"))
    kib, unit = map(int, _constant("hopper.cuh", r"constexpr int MIN_SMEM_BYTES = (\d+) \* (\d+);"))
    assert rows == keys == WIDE_ROWS
    dp = next(p for p in (192, 256, 512) if head_dim <= p)
    stages = {512: s512, 256: s256, 192: s192}[dp]
    once = dp == sonce
    tile = rows * dp * 2
    zeros = keys * 64 * 2 if dp == 192 else 16
    xch = 2 * rows * keys * 4 if once else 4
    struct = -(-(tile * (1 + 2 * stages) + zeros + xch + 8 * (2 + 4 * stages)) // align) * align
    boxes = (dp // 64 + 1) // 2
    return dict(dp=dp, rows=rows, once=once, ksteps=dp // 32 if once else dp // 16, boxes=boxes, stages=stages,
                smem=max(struct + align, kib * unit),
                regs=boxes * 32 + keys // 2 + keys // 4, budget=budget)


def k1_wide_items(B, H, Nq, Nk, D, tps):
    """What K1's wide kernel reads and writes, as wide_unit and the consumers' stores compute them: per unit (a 64-row
    query tile, then the key split, head, batch), its key tiles and each consumer thread's rows and columns of o (or
    of its split's fp32 O). Yields (split, b, h, key tiles, rows, cols)."""
    wide = k1_wide_plan(D)
    q_tiles, n_tiles = -(-Nq // WIDE_ROWS), -(-Nk // WIDE_ROWS)
    splits = -(-n_tiles // tps)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for u in range(q_tiles * splits * H * B):
        rest = u // q_tiles
        qt, split, hb = u % q_tiles, rest % splits, rest // splits
        tiles = range(split * tps, min(split * tps + tps, n_tiles))
        for cwg in range(2):
            for a in range(wide["boxes"]):
                for c in range(8):
                    col0 = (cwg * wide["boxes"] + a) * 64 + c * 8
                    if col0 >= D:  # the padding's columns, and consumer 1's box of zeros at DP = 192
                        continue
                    for warp in range(4):
                        row0 = qt * WIDE_ROWS + warp * 16 + g
                        for r in (row0, row0 + 8):
                            for j in range(2):
                                keep = r < Nq
                                yield split, hb // H, hb % H, tiles, r[keep], (col0 + 2 * t + j)[keep]


def k3_f32_plan(head_dim, dkv):
    """K3's fp32 (3xTF32) kernels (csrc/flash_attention_bwd.cu Tf32BwdCfg), dq (dkv False) or dk/dv: a dict of the
    padded head dim, whether the unit's own tiles stay resident, the output columns a unit covers (NCO) and a piece
    (NP), the D columns an S step covers, the ring's slots and slot bytes, the dynamic shared memory, and the registers
    a consumer thread holds (the output's chunk, S, dP and a chain of S's k-steps, a piece's chain, a k-step's hi and lo
    A operand) against its setmaxnreg budget. D <= 16 keeps the CUDA-core kernels: dict(kernel="small")."""
    box, = map(int, _constant("flash_attention_bwd.cu", r"constexpr int F_BOX = (\d+);"))
    own, = map(int, _constant("flash_attention_bwd.cu", r"constexpr int F_OWN = (\d+);"))
    loop, = map(int, _constant("flash_attention_bwd.cu", r"constexpr int F_LOOP = (\d+);"))
    ring, kib = map(int, _constant("flash_attention_bwd.cu", r"constexpr int F_RING_BYTES = (\d+) \* (\d+);"))
    small, = map(int, _constant("flash_attention_bwd.cu", r"constexpr int F32_SMALL_DP = (\d+);"))
    res_max, = map(int, _constant("flash_attention_bwd.cu", r"static constexpr bool RES = DP <= (\d+);"))
    dkv_nco, dq_nco = map(int, _constant("flash_attention_bwd.cu", r"NCO = DKV \? \(DP < (\d+) \? DP : \d+\) : "
                                                                     r"\(DP < (\d+) \? DP : \d+\);"))
    budget, = map(int, _constant("flash_attention_bwd.cu", r"fa_bwd_tf32_kernel\([\s\S]*?setmaxnreg_inc<(\d+)>"))
    align, = map(int, _constant("hopper.cuh", r"constexpr int SMEM_ALIGN = (\d+);"))
    assert small == F32_SMALL_HEAD_DIM and (own, loop) == (BWD_OWN_ROWS, BWD_LOOP_ROWS)
    if head_dim <= small:
        return dict(kernel="small")
    dp = next(p for p in (32, 64, 128, 256) if head_dim <= p)
    res = dp <= res_max
    nco = min(dp, dkv_nco if dkv else dq_nco)
    np_ = min(dp, 64)
    sc = dp if res else box
    own_box, loop_box, piece = 2 * own * 128, 2 * loop * 128, 2 * 2 * np_ * 128
    sstep = (sc // box) * loop_box if res else own_box + loop_box
    slot = max(sstep, piece)
    own_bytes = 2 * (dp // box) * own_box if res else 0
    stages = (ring * kib - own_bytes) // slot
    smem = own_bytes + stages * slot + 8 * (2 + 2 * stages) + align
    acc = (2 if dkv else 1) * nco // 2
    return dict(kernel="tf32", dp=dp, res=res, nco=nco, np=np_, sc=sc, slot=slot, stages=stages, smem=smem,
                regs=acc + 3 * (loop // 2) + np_ // 2 + 8, budget=budget)


def k3_f32_items(B, H, n_own, D, dkv):
    """The outputs K3's fp32 kernels write, as f32_item and the consumers' stores compute them: per unit (NCO-column
    chunk fastest, then the 128-row own tile, then b * H + h), each consumer thread's two rows and the columns of its
    chunk below D. Yields (b, h, rows, cols)."""
    nco = k3_f32_plan(D, dkv)["nco"]
    chunks, tiles = -(-D // nco), -(-n_own // BWD_OWN_ROWS)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for item in range(chunks * tiles * B * H):
        chunk, tile, bh = item % chunks, (item // chunks) % tiles, item // (chunks * tiles)
        for cwg in range(2):
            for warp in range(4):
                row0 = tile * BWD_OWN_ROWS + cwg * 64 + warp * 16 + g
                for r in (row0, row0 + 8):
                    for c in range(nco // 8):
                        if chunk * nco + c * 8 >= D:
                            continue
                        for j in range(2):
                            keep = r < n_own
                            yield bh // H, bh % H, r[keep], (chunk * nco + c * 8 + 2 * t + j)[keep]


def k3_plan(head_dim):
    """K3's bf16 whole-width kernels above D = 64 (csrc/flash_attention_bwd.cu WideCfg, WideBwdSmem): (DP, ring
    slots, dynamic shared memory bytes, 128-column chunks a work item covers one of)."""
    ring, unit = map(int, _constant("flash_attention_bwd.cu", r"constexpr int W_RING_BYTES = (\d+) \* (\d+);"))
    own, = map(int, _constant("flash_attention_bwd.cu", r"constexpr int OWN = (\d+);"))
    loop, = map(int, _constant("flash_attention_bwd.cu", r"constexpr int LOOP = (\d+);"))
    chunk, = map(int, _constant("flash_attention_bwd.cu", r"constexpr int W_CHUNK = (\d+);"))
    align, = map(int, _constant("hopper.cuh", r"constexpr int SMEM_ALIGN = (\d+);"))
    assert (own, loop) == (BWD_OWN_ROWS, BWD_LOOP_ROWS)
    dp = next(p for p in (128, 192, 256) if head_dim <= p)
    stages = (ring * unit - 2 * own * dp * 2) // (2 * loop * dp * 2)
    zeros = loop * 64 * 2 if dp == 192 else 16  # DP = 192's box of zeros (the last chunk's second atom)
    size = 2 * own * dp * 2 + stages * (2 * loop * dp * 2 + 2 * loop * 4) + zeros + 8 * (2 + 2 * stages)
    return dp, stages, -(-size // align) * align + align, -(-head_dim // chunk)


def k3_items(B, H, n_own, D):
    """The outputs K3's whole-width kernels write, as decode_wide and the consumers' stores compute them: per work item
    (128-column chunk fastest, then the 128-row own tile, head, batch), each consumer thread's two rows and the columns
    of its accumulator (an m64n128 product, or an m64n64 one for a chunk of 64 columns). Yields (b, h, rows, cols)."""
    chunk_cols, = map(int, _constant("flash_attention_bwd.cu", r"constexpr int W_CHUNK = (\d+);"))
    chunks, tiles = -(-D // chunk_cols), -(-n_own // BWD_OWN_ROWS)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for item in range(chunks * tiles * H * B):
        c, rest = item % chunks, item // chunks
        tile, h, b = rest % tiles, (rest // tiles) % H, rest // (tiles * H)
        wide = D - c * chunk_cols > 64
        for cwg in range(2):
            for warp in range(4):
                row0 = tile * BWD_OWN_ROWS + cwg * 64 + warp * 16 + g
                for r in (row0, row0 + 8):
                    for cc in range(chunk_cols // 8 if wide else 8):
                        for j in range(2):
                            col = c * chunk_cols + cc * 8 + 2 * t + j
                            keep = (r < n_own) & (c * chunk_cols + cc * 8 < D)
                            yield b, h, r[keep], col[keep]


def k6_plan(head_dim, pv8):
    """K6's attention kernel (csrc/flash_attention_int8.cu Fa8Cfg, Fa8Smem): (DK, output columns a sweep, sweeps, ring
    stages, dynamic shared memory bytes)."""
    ring, unit = map(int, _constant("flash_attention_int8.cu", r"constexpr int RING_BYTES = (\d+) \* (\d+);"))
    bq, = map(int, _constant("flash_attention_int8.cu", r"constexpr int BQ = (\d+);"))
    bk, = map(int, _constant("flash_attention_int8.cu", r"constexpr int BK = (\d+);"))
    align, = map(int, _constant("hopper.cuh", r"constexpr int SMEM_ALIGN = (\d+);"))
    dk = int8_row_bytes(head_dim)
    ow = 64 if dk == 64 else 128
    q_bytes, k_bytes, v_bytes = bq * dk * 2, bk * dk, ow * bk if pv8 else bk * ow * 2
    stages = 6 if dk == 64 else (ring * unit - q_bytes) // (k_bytes + v_bytes)
    size = q_bytes + stages * (k_bytes + v_bytes) + 8 * (2 + 2 * stages)
    return dk, ow, dk // ow, stages, -(-size // align) * align + align


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


@pytest.mark.parametrize("d,plan", [(8, (64, 1, 3)), (16, (64, 1, 3)), (32, (64, 1, 3)), (64, (64, 1, 3)),
                                    (72, (128, 2, 2)), (80, (128, 2, 2)), (96, (128, 2, 2)), (128, (128, 2, 2)),
                                    (136, (192, 3, 3)), (192, (192, 3, 3)), (200, (256, 4, 2)), (256, (256, 4, 2)),
                                    (264, (512, 8, 1)), (512, (512, 8, 1))])
def test_k1_plan_pads_the_head_dim_into_64_column_boxes(d, plan):
    """Every D up to 64 takes one 64-column box per tile (DP = 64), up to 128 two (DP = 128) with a two-stage ring: the
    shared memory fits the block's 227 KB, and a third stage at DP = 128 would leave under 2 KB. Above 128 a 128-row Q
    tile with two K/V stages does not fit, so DP = 192, 256 and 512 take the wide kernel's 64-row tiles, three, two and
    one K and V slots (at 512 a second slot of either would not fit). Only a head dim above 512 raises."""
    dp, boxes, stages, smem = k1_plan(d)
    assert (dp, boxes, stages) == plan
    assert smem <= SMEM_LIMIT
    if dp == 128:
        assert SMEM_LIMIT - (smem + 2 * FWD_ROWS * dp * 2) < 2048
    if dp > 128:
        assert fwd_rows(d) == 64 and FWD_ROWS * dp * 2 * (1 + 2 * 2) > SMEM_LIMIT
    else:
        assert fwd_rows(d) == FWD_ROWS
    if dp == 512:
        assert smem + fwd_rows(d) * dp * 2 > SMEM_LIMIT
    t = torch.zeros(2, 300, 3, d, dtype=torch.bfloat16)
    assert tma_layout(t, fwd_rows(d))[0] == d and tma_layout(t, fwd_rows(d))[7:] == (64, 1, fwd_rows(d), 1)
    if d + 8 <= 512:
        assert k1_plan(d + 8)[0] >= dp
    with pytest.raises(ValueError, match="queue 2 item a"):
        k1_plan(513)


@pytest.mark.parametrize("d,plan", [(72, (128, 4, 1)), (128, (128, 4, 1)), (136, (192, 2, 2)), (192, (192, 2, 2)),
                                    (200, (256, 1, 2)), (256, (256, 1, 2))])
def test_k3_chunk_kernels_fit_the_block(d, plan):
    """K3 above D = 64: the own tiles (128 rows of q and dO, or k and v, over DP) and the ring of 64-row loop tiles fit
    227 KB with 4, 2 and 1 slots at DP = 128, 192 and 256; a work item covers one of ceil(D / 128) column chunks, so
    at DP = 128 s and dp are computed once, and at 192 and 256 twice (1.25-1.5x the minimum work, not 2.5-3x)."""
    dp, stages, smem, chunks = k3_plan(d)
    assert (dp, stages, chunks) == plan
    assert smem <= SMEM_LIMIT


@pytest.mark.parametrize("b,h,n,d", [(2, 3, 200, 72), (1, 2, 129, 128), (2, 1, 300, 136), (1, 2, 65, 192),
                                     (1, 1, 130, 200), (2, 2, 64, 256)])
def test_k3_work_items_write_every_output_once(b, h, n, d):
    "The work items' decode and the consumers' stores cover every row and column of dq (or dk, dv) exactly once."
    seen = np.zeros((b, h, n, d), np.int32)
    for bi, hi, rows, cols in k3_items(b, h, n, d):
        np.add.at(seen, (bi, hi, rows, cols), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("d", [8, 16])
def test_k1_f32_plan_sends_the_smallest_heads_to_the_cuda_core_kernel(d):
    "D <= 16 (the JAX training example's heads) takes the CUDA-core kernel, which needs no split workspace."
    assert k1_f32_plan(d) == dict(dp=16, kernel="small")


@pytest.mark.parametrize("d,dp,colsplit,stages", [(24, 32, False, 12), (32, 32, False, 12),
                                                  (64, 64, False, 5), (80, 128, False, 3), (128, 128, False, 3),
                                                  (136, 256, True, 5), (256, 256, True, 5), (264, 512, True, 5),
                                                  (512, 512, True, 5)])
def test_k1_f32_plan_fits_the_block_and_the_registers(d, dp, colsplit, stages):
    """K1's fp32 kernel at every padded head dim: the ring (at least 3 slots) with the resident Q (row split) or the
    partial-score and P buffers (column split) fits 227 KB, and O, S and one chain's products fit a consumer's
    setmaxnreg budget: the column split halves O's columns per consumer where a 64 x DP fp32 O would not."""
    plan = k1_f32_plan(d)
    assert (plan["dp"], plan["colsplit"], plan["stages"]) == (dp, colsplit, stages)
    assert plan["stages"] >= 3 and plan["smem"] <= SMEM_LIMIT
    assert plan["regs"] <= plan["budget"]
    assert plan["boxes"] == -(-d // 32) and plan["chunks"] * plan["nc"] >= d
    if dp == 512:  # a full-width O of 64 rows would not fit beside S and a chain
        assert dp // 2 + plan["regs"] - dp // 4 > plan["budget"]


def test_k1_f32_workspace_and_key_order():
    """The split pre-pass writes q and k as (2, B H, N, D) hi/lo planes and v transposed as (2, B H, D, Nk8) planes
    (about 100 MB at the Cosmos shape); within each 8 keys Vt's column t holds key 2t and column t + 4 key 2t + 1,
    which is where P's register A operand (csrc/hopper.cuh: its columns t and t + 4 of a k-step) takes the
    accumulator's columns 2t and 2t + 1 (fa_fwd_tf32_kernel: register i of k-step kc from S register 4 kc + 2 (i & 1)
    + (i >> 1)), so the k-step sums each key's p times that key's v."""
    assert tf32_workspace_floats(2, 1, 4096, 4096, 512) * 4 == 2 * 2 * (4096 * 512 * 2 + 512 * 4096) * 4
    assert tf32_workspace_floats(1, 2, 5, 13, 16) == 2 * 2 * (5 * 16 + 13 * 16 + 16 * 16)  # Nk8 = 16
    src = (CSRC / "flash_attention.cu").read_text()
    assert "return p < 4 ? 2 * p : 2 * p - 7;" in src and "sc[4 * kc + ((i & 1) << 1) + (i >> 1)]" in src
    vt_key = [p * 2 if p < 4 else 2 * p - 7 for p in range(8)]
    assert sorted(vt_key) == list(range(8))
    for t in range(4):
        for i in range(4):
            s_reg = ((i & 1) << 1) + (i >> 1)  # S register 4 kc + s_reg: row g + 8 (s_reg >> 1), key 2t + (s_reg & 1)
            key = 2 * t + (s_reg & 1)
            a_col = t + 4 * (i >> 1)  # the A operand's column of register i
            assert (s_reg >> 1) == (i & 1) and vt_key[a_col] == key


@pytest.mark.parametrize("d", [16, 64, 72, 128, 136, 256])
@pytest.mark.parametrize("pv8", [False, True])
def test_k6_plan_fits_the_block(d, pv8):
    """K6's int8 rows: 64 bytes up to D = 64 (one 64-byte-swizzled box, the kernel as it was), 128 and 256 above, in P.V
    sweeps of 128 output columns (two at DK = 256); at least two ring stages within 227 KB."""
    dk, ow, sweeps, stages, smem = k6_plan(d, pv8)
    assert dk == (64 if d <= 64 else 128 if d <= 128 else 256) and ow * sweeps == dk
    assert stages >= 2 and smem <= SMEM_LIMIT
    if dk == 64:
        assert stages == 6


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


@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 128, 136, 192, 256, 512])
def test_k1_tiles_of_every_head_dim_compute_attention(d):
    "At every head dim, over a ragged second tile of 130 keys, the emulated tiles give the plain version's output."
    rng = np.random.RandomState(d)
    q, k, v = (rng.randn(130, d).astype(np.float32) for _ in range(3))
    scale = d**-0.5
    got = _emulate_k1(q, k, v, scale)
    ref = flash_attention_lse_ref(*(torch.from_numpy(a)[None, :, None] for a in (q, k, v)), scale)[0][0, :, 0]
    assert np.abs(got - ref.numpy()).max() <= 1e-5


@pytest.mark.parametrize("d", [136, 192, 200, 256, 264, 512])
def test_k1_wide_plan_fits_the_block_and_the_registers(d):
    """K1's wide kernel: 64-row units shared by both consumers; at DP = 512 S computed once (its k-steps split evenly
    between the consumers, the partial scores exchanged: 64 KB of Q, K and V each plus 32 KB leave one K and one V
    slot, a second would not fit); at 192 and 256 each consumer computes the whole S (measured faster there, PERF.md
    section 6) with three and two K / V slots. Each fits 227 KB, O's boxes, S and P a consumer's setmaxnreg
    budget."""
    plan = k1_wide_plan(d)
    assert plan["smem"] <= SMEM_LIMIT and plan["regs"] <= plan["budget"]
    assert plan["stages"] == {192: 3, 256: 2, 512: 1}[plan["dp"]] and plan["once"] == (plan["dp"] == 512)
    assert plan["ksteps"] * 16 * (2 if plan["once"] else 1) == plan["dp"]
    if plan["dp"] == 512:
        assert plan["smem"] + 2 * WIDE_ROWS * plan["dp"] * 2 > SMEM_LIMIT


@pytest.mark.parametrize("b,h,nq,nk,d", [(2, 8, 1, 1025, 192), (1, 2, 130, 700, 256), (2, 1, 1024, 1024, 512),
                                         (1, 1, 300, 1029, 512), (2, 3, 200, 520, 200), (1, 1, 65, 64, 136)])
def test_k1_wide_units_take_every_key_once_and_write_every_output_once(b, h, nq, nk, d):
    """Under the wrapper's plan (and with one tile a split): every query tile of every (b, h) is a unit of every key
    split, the splits' key tiles cover every key tile once, every row and column of o (or of each split's fp32 O in the
    workspace) is written once, and the workspace holds what the splits write (k1_wide_workspace_floats)."""
    n_tiles = -(-nk // WIDE_ROWS)
    for tps in sorted({k1_wide_tiles_per_split(b, h, nq, nk), 1}):
        splits = -(-n_tiles // tps)
        seen = np.zeros((splits, b, h, nq, d), np.int32)
        keys = {}
        for split, bi, hi, tiles, rows, cols in k1_wide_items(b, h, nq, nk, d, tps):
            np.add.at(seen, (split, bi, hi, rows, cols), 1)
            keys.setdefault((bi, hi, split), set(tiles))
        assert (seen == 1).all()
        for bi in range(b):
            for hi in range(h):
                got = sorted(t for split in range(splits) for t in keys[(bi, hi, split)])
                assert got == list(range(n_tiles))
        floats = k1_wide_workspace_floats(b, h, nq, nk, d, tps)
        assert floats == (0 if splits == 1 else splits * b * h * nq * (d + 2))


@pytest.mark.parametrize("d", [24, 32, 40, 64, 72, 128, 136, 256])
@pytest.mark.parametrize("dkv", [False, True])
def test_k3_f32_plan_fits_the_block_and_the_registers(d, dkv):
    """K3's fp32 kernels at every padded head dim: up to DP = 64 the own tiles (two tensors, hi and lo, 128 rows) stay
    resident beside a ring of at least 3 slots; above they travel through the ring with the loop boxes. dq keeps its
    whole width up to DP = 128 (128-column chunks above), dk and dv up to 64 (64-column chunks above): both within 227
    KB and the setmaxnreg budget, where whole-width dk and dv at DP = 128 would not fit the registers."""
    plan = k3_f32_plan(d, dkv)
    assert plan["stages"] >= 3 and plan["smem"] <= SMEM_LIMIT and plan["regs"] <= plan["budget"]
    assert plan["res"] == (plan["dp"] <= 64)
    assert plan["nco"] == min(plan["dp"], 64 if dkv else 128)
    if dkv and plan["dp"] == 128:
        assert plan["regs"] + plan["dp"] // 2 * 2 - plan["nco"] // 2 * 2 > plan["budget"]


@pytest.mark.parametrize("d", [8, 16])
def test_k3_f32_plan_sends_the_smallest_heads_to_the_cuda_core_kernels(d):
    assert k3_f32_plan(d, False) == k3_f32_plan(d, True) == dict(kernel="small")


@pytest.mark.parametrize("b,h,n,d", [(2, 3, 200, 24), (1, 2, 129, 64), (2, 1, 300, 80), (1, 2, 65, 192),
                                     (1, 1, 130, 200), (2, 2, 64, 256)])
@pytest.mark.parametrize("dkv", [False, True])
def test_k3_f32_units_write_every_output_once(b, h, n, d, dkv):
    "The fp32 kernels' units and the consumers' stores cover every row and column of dq (or dk, dv) exactly once."
    seen = np.zeros((b, h, n, d), np.int32)
    for bi, hi, rows, cols in k3_f32_items(b, h, n, d, dkv):
        np.add.at(seen, (bi, hi, rows, cols), 1)
    assert (seen == 1).all()


def test_k3_f32_workspace_planes_and_row_order():
    """The split pre-pass writes q, dO, k and v as (2, B H, N, D) hi/lo planes and q, dO and k transposed as (2, B H, D,
    N8) planes (14 planes of 16.8 MB at the fp32 trunk's (4, 1024, 16, 64): 235 MB); within each 8 rows of a transposed
    plane, column t holds row 2t and column t + 4 row 2t + 1, where the register A operand of p, ds or their transposes
    takes the accumulator's columns 2t and 2t + 1 (fa_bwd_tf32_kernel: register i of k-step kc from register
    4 kc + 2 (i & 1) + (i >> 1)), so each k-step sums each row's term with that row's operand."""
    assert k3_tf32_workspace_floats(4, 16, 1024, 1024, 64) * 4 == 14 * 4 * 16 * 1024 * 64 * 4
    assert k3_tf32_workspace_floats(1, 2, 5, 13, 16) == 2 * 2 * (2 * 5 * 16 + 2 * 13 * 16 + 16 * (2 * 8 + 16))
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    assert "return p < 4 ? 2 * p : 2 * p - 7;" in src and "a[4 * kc + ((i & 1) << 1) + (i >> 1)]" in src
    assert "tile[(x & ~7) | t_key(x & 7)][r]" in src
