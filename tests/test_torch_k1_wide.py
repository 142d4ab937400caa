"""
The schedule of K1's wide bf16 kernel (csrc/flash_attention.cu fa_fwd_bf16_wide_kernel, D > 128), emulated on the
CPU: each 64-key tile's scores, at D = 512 computed once as two halves of S's k-steps (one per consumer warpgroup)
added through the exchange, which gives both consumers the same bits in either order (up to D = 256 each consumer
computes the whole S, the same bits in both); the online softmax over 64-key tiles in log2
units with p rounded to bf16 before P.V; the keys split into ranges of whole tiles by the wrapper's plan
(ops/flash_attention.py k1_wide_tiles_per_split), each split's unnormalised O, row max and row sum kept, and the
splits merged in split order (fa_wide_combine_kernel). The emulation is held against the plain version
(flash_attention_lse_ref) and the JAX package's flash_attention in interpret mode at D = 192, 256 and 512, one query
over a ragged key count among the shapes, for o and the logsumexp. The kernel itself is held against the plain
version on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py phase 47).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniception_tpu.ops.flash_attention import _flash_attention_impl
from uniception_tpu_torch.ops.flash_attention import WIDE_ROWS, flash_attention_lse_ref, k1_wide_tiles_per_split

WIDE_HEAD_DIMS = [192, 256, 512]
K1_ULPS, K1_ULP_FLOOR = 8, 1 / 64  # chip_smoke.py's bar of the wide kernel on the card (K1_MV_ULPS)
LSE_BF16_TOL = 1e-4  # chip_smoke.py LSE_TOL["bf16"]
# (B, Nq, Nk, H): PE-G's pool (one query over 1025 keys), a ragged key count, two query tiles over 64 keys
SHAPES = [(2, 1, 1025, 2), (1, 70, 300, 2), (1, 130, 64, 1)]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("UNICEPTION_TPU_PALLAS_INTERPRET", "1")


def _dp(d):
    return next(p for p in (192, 256, 512) if d <= p)


def score_halves(q, k):
    """S = Q K^T of one key tile as the two consumers compute it at DP = 512: consumer c takes S's k-steps of 16 in
    [c DP / 32, (c + 1) DP / 32) over the padded head dim (zeros past D), each an fp32 sum. Returns (S0, S1)."""
    dp = _dp(q.shape[-1])
    qp, kp = (torch.nn.functional.pad(t.float(), (0, dp - t.shape[-1])) for t in (q, k))
    half = dp // 2
    return qp[..., :half] @ kp[..., :half].transpose(-1, -2), qp[..., half:] @ kp[..., half:].transpose(-1, -2)


def emulate_k1_wide(q, k, v, scale, tps, drop_first=False, final_max=False):
    """K1's wide kernel on bf16 (B, N, H, D) tensors with `tps` key tiles a split (``drop_first``, the control: the
    combine without the first split, whole tiles; ``final_max``, a diagnostic and not the kernel: p rounded against
    each row's final max instead of its running max). Returns (o in bf16, lse)."""
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, N, D), bf16
    scale_log2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    m_final = (qt.float() @ kt.float().transpose(-1, -2)).amax(-1) * scale_log2
    n_tiles = -(-Nk // WIDE_ROWS)
    parts = []
    for t0 in range(0, n_tiles, tps):  # the splits, each its own online softmax
        m = torch.full((B, H, Nq), -math.inf)
        l = torch.zeros(B, H, Nq)
        acc = torch.zeros(B, H, Nq, D)
        for j in range(t0, min(t0 + tps, n_tiles)):
            keys = slice(j * WIDE_ROWS, min((j + 1) * WIDE_ROWS, Nk))
            if _dp(D) == 512:
                s0, s1 = score_halves(qt, kt[:, :, keys])
                s = s0 + s1  # the exchange: consumer 0 adds S1 to S0, consumer 1 S0 to S1, the same bits
            else:  # each consumer over every k-step
                s = qt.float() @ kt[:, :, keys].float().transpose(-1, -2)
            m_new = m_final if final_max else torch.maximum(m, s.amax(-1) * scale_log2)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s * scale_log2 - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p.bfloat16().float() @ vt[:, :, keys].float()
            m = m_new
        parts.append((acc, m, l))
    if drop_first:
        parts = parts[1:]
    if len(parts) == 1:  # one split: o = acc / l in the kernel
        acc, m, l = parts[0]
        out = acc / l[..., None]
    else:  # the combine, in split order
        M = parts[0][1]
        for _, m, _ in parts[1:]:
            M = torch.maximum(M, m)
        l = torch.zeros_like(M)
        out = torch.zeros_like(parts[0][0])
        for acc, m, ls in parts:
            w = torch.exp2(m - M)
            l = l + ls * w
            out = out + acc * w[..., None]
        out, m = out / l[..., None], M
    lse = m * torch.tensor(math.log(2.0), dtype=torch.float32) + torch.log(l)
    return out.permute(0, 2, 1, 3).bfloat16(), lse


def _ulps(out, ref):
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(K1_ULP_FLOOR))) - 7)
    return ((out.float() - ref).abs() / ulp).max().item()


def _qkv(b, nq, nk, h, d, seed=0):
    rng = np.random.RandomState(seed + d + nk)
    return [torch.from_numpy(rng.randn(b, n, h, d).astype(np.float32)).bfloat16() for n in (nq, nk, nk)]


@pytest.mark.parametrize("d", [264, 320, 512])
def test_k1_wide_score_halves_sum_to_the_same_bits_in_either_order(d):
    """At DP = 512 each consumer adds the other's half of S to its own: S0 + S1 and S1 + S0 are the same bits, near
    the full S."""
    q, k, _ = _qkv(2, 64, 64, 2, d)
    s0, s1 = score_halves(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3))
    assert torch.equal(s0 + s1, s1 + s0)
    full = q.permute(0, 2, 1, 3).float() @ k.permute(0, 2, 1, 3).float().transpose(-1, -2)
    assert (s0 + s1 - full).abs().max().item() <= 1e-4 * full.abs().max().item()


@pytest.mark.parametrize("b,nq,nk,h", SHAPES)
@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
def test_k1_wide_key_splits_and_combine_match_plain_and_pallas(d, b, nq, nk, h):
    """The wrapper's key splits (and one split, and one tile a split) emulated with the combine: o within K1's 8 bf16
    ulps and the logsumexp within LSE_TOL of the plain version and of the Pallas kernel in interpret mode; without its
    first split (the control) o lands over 4 times the bar away."""
    q, k, v = _qkv(b, nq, nk, h, d)
    scale = d**-0.5
    ref, ref_lse = flash_attention_lse_ref(q, k, v, scale)
    jout, jlse = _flash_attention_impl(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)),
                                       scale, 1024, 1024)
    jout = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    jlse = torch.from_numpy(np.array(jlse))[..., :nq]
    n_tiles = -(-nk // WIDE_ROWS)
    plan = k1_wide_tiles_per_split(b, h, nq, nk)
    for tps in sorted({plan, n_tiles, 1}):
        out, lse = emulate_k1_wide(q, k, v, scale, tps)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        for want, want_lse in ((ref, ref_lse), (jout, jlse)):
            assert _ulps(out, want) <= K1_ULPS, tps
            assert (lse - want_lse).abs().max().item() <= LSE_BF16_TOL, tps
        if -(-n_tiles // tps) > 1:  # the control: a lost split misses the bar
            assert _ulps(emulate_k1_wide(q, k, v, scale, tps, drop_first=True)[0], ref) > 4 * K1_ULPS, tps


def test_k1_wide_plan_splits_the_pool_and_not_the_full_waves():
    "PE-G's pool (16 units of one query) splits its 17 key tiles; units that fill a wave keep one split."
    assert k1_wide_tiles_per_split(2, 8, 1, 1025) == 3  # 6 splits of 3 tiles: 96 units on 132 SMs
    assert k1_wide_tiles_per_split(2, 1, 1024, 1024) == 4  # 32 units: 4 splits of 4 tiles, 128 units
    assert k1_wide_tiles_per_split(2, 1, 4096, 4096) == 64  # 128 units: splitting would take two waves
    assert k1_wide_tiles_per_split(2, 8, 1024, 1024) == 16  # 256 units
    assert k1_wide_tiles_per_split(6, 1, 1024, 1024) == 16  # 96 units: 4 splits would take three waves


def p_rounding_bound(q, k, v, scale, ref, out):
    """Per element, the most o can differ from the plain version when each p is rounded to either of its bf16
    neighbours (2^-8 of p between the two) and both outputs are rounded to bf16 (half an ulp each, at most 2^-8 of
    |o|): 2^-8 (sum_j p_j |v_j| / l + |plain| + |o|), in fp32."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    pv = torch.einsum("bhnm,bmhd->bnhd", p, v.float().abs()) / p.sum(-1).transpose(1, 2)[..., None]
    return 2.0**-8 * (pv + ref.float().abs() + out.float().abs())


def test_k1_wide_few_keys_miss_the_ulp_bar_by_p_rounding_against_the_running_max():
    """At 260 keys (five tiles, the last of 4) and 16,480 rows of D = 136, the kernel's online softmax reads 9 ulps of
    the plain version (the card: 8.41, the earlier design of the kernel likewise), over K1's 8-ulp bar, which holds from
    a few hundred keys. The cause: the kernel rounds p to bf16 against the running max of the tiles seen so far, the
    plain version against the final max, so a p lands on the other bf16 neighbour; with few keys each term weighs
    more. Rounded against the final max, the same schedule reads under a third of that; either way o stays within
    the bound of p's rounding, and the control (the plain version without the last 64 keys) lands far outside it."""
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(2, n, 8, 136).astype(np.float32)).bfloat16() for n in (1030, 260, 260))
    scale = 136**-0.5
    ref = flash_attention_lse_ref(q, k, v, scale)[0]
    out = emulate_k1_wide(q, k, v, scale, 5)[0]
    running, final = _ulps(out, ref), _ulps(emulate_k1_wide(q, k, v, scale, 5, final_max=True)[0], ref)
    assert final <= K1_ULPS / 2 and running >= 3 * final, (running, final)
    err = (out.float() - ref.float()).abs()
    assert (err / p_rounding_bound(q, k, v, scale, ref, out)).max().item() <= 1
    control = flash_attention_lse_ref(q, k[:, :-64], v[:, :-64], scale)[0]
    ctrl = (control.float() - ref.float()).abs() / p_rounding_bound(q, k, v, scale, ref, control)
    assert ctrl.max().item() >= 8


@pytest.mark.parametrize("block_k,over_bar", [(64, True), (128, False), (1024, False)])
def test_pallas_k1_few_keys_reads_as_far_from_the_plain_version_as_its_key_tiles_make_it(block_k, over_bar):
    """The JAX package's Pallas K1 in interpret mode rounds p to bf16 against the running max as well
    (uniception_tpu/ops/flash_attention.py:82, :87), so at (2, 1030, 260, 8), D = 136, it stands as far from the
    final-max plain version as the port's kernel: over K1's 8-ulp bar with the wide kernel's 64-key tiles (9 ulps, as
    the emulation; the card read 8.41), at the bar with 128-key tiles, and well inside it with its own one-block plan
    (the running max is then the final max). Every tiling stays within the bound of p's rounding: the kernel follows
    the reference, and the bar at few keys is what p's rounding allows."""
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(2, n, 8, 136).astype(np.float32)).bfloat16() for n in (1030, 260, 260))
    scale = 136**-0.5
    ref = flash_attention_lse_ref(q, k, v, scale)[0]
    jout, _ = _flash_attention_impl(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)),
                                    scale, 1024, block_k)
    jout = torch.from_numpy(np.array(jout.astype(jnp.float32))).bfloat16()
    ulps = _ulps(jout, ref)
    assert (ulps > K1_ULPS) == over_bar and ulps <= 9, ulps
    if not over_bar and block_k == 1024:
        assert ulps <= K1_ULPS / 2, ulps
    bound = (jout.float() - ref.float()).abs() / p_rounding_bound(q, k, v, scale, ref, jout)
    assert bound.max().item() <= 1
