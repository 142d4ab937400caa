"""
The numerics of K1's fp32 kernel (csrc/flash_attention.cu fa_fwd_tf32_kernel), emulated on the CPU: error-compensated
TF32 ("3xTF32"). Each fp32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), tf32 being cvt.rna (round to
nearest, ties away from zero, to 10 mantissa bits) done here by bit arithmetic on int32 views; the tensor cores read
the top 19 bits of an operand (a truncation, exact on hi and lo). Each product is hi.hi' + hi.lo' + lo.hi' with fp32
sums, in the kernel's chains: every 8-wide k-step of S (over 32-column boxes) and of P.V (over 8 keys) is a fresh
chain, the two correction products first and hi.hi last, added to S or O in fp32; the online softmax runs over 64-key
tiles in fp32, with P split in registers. The emulation holds a quarter of the
card's bars (chip_smoke.py K1_FP32_TOL, LSE_TOL fp32) against the plain version (flash_attention_lse_ref) and the JAX
package's Pallas kernel in interpret mode, at D = 16-512 and a few hundred keys; one-term TF32 (hi.hi' only), the
control, misses them. The kernel itself is held against the plain version on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py phases 41 and 47).

K3's fp32 kernels (csrc/flash_attention_bwd.cu fa_bwd_tf32_kernel) take the same scheme for the backward's five
products (S and dP over D, dq over the keys, dk and dv over the queries), and are emulated here down to the tensor
cores' own sums: each wgmma (one product of an 8-wide k-step) adds its 8 exact products to its chain and truncates
toward zero to fp32; every k-step is a chain of its own into fresh registers, added to its accumulator in fp32 with
round to nearest; p and ds are split in registers before their products. The emulation holds a quarter of K3's fp32
bar (chip_smoke.py K3_REL_TOL) against the plain backward and the Pallas backward in interpret mode; one-term TF32
misses it; and chains over a whole 64-row tile, the control, bias a near-cancelling gradient where per-k-step chains
do not.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniception_tpu.ops.flash_attention import _flash_attention_bwd_pallas, _flash_attention_impl
from uniception_tpu_torch.ops.flash_attention import flash_attention_bwd_ref, flash_attention_lse_ref

K1_FP32_TOL, LSE_FP32_TOL = 2e-5, 1e-5  # chip_smoke.py's bars of the kernel on the card
BOX, BK, KSTEP = 32, 64, 8  # the kernel's S box columns, keys per tile and tf32 k-step (T_BOX, T_BK)
HEAD_DIMS = [16, 64, 80, 128, 512]
K3_FP32_REL_TOL = 1e-5  # chip_smoke.py K3_REL_TOL["fp32"]: max |kernel - plain| / max |plain| per gradient
K3_HEAD_DIMS = [16, 64, 80, 128, 256]
K3_TILE = 64  # K3's loop tiles (F_LOOP): the span of the control's chains


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("UNICEPTION_TPU_PALLAS_INTERPRET", "1")


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    "fp32 rounded to tf32 as cvt.rna.tf32.f32 does: add half of the 13 dropped bits' range to the magnitude, drop them."
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    "What a tf32 wgmma reads of a 32-bit operand: its top 19 bits."
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def chains(a_hi, a_lo, b_hi, b_lo, three: bool):
    """a @ b (a (..., M, K), b (..., K, N)) as the kernel sums it: each 8-wide k-step a fresh chain (its correction
    products, then hi.hi) added to the total, every sum in fp32. ``three=False`` (the control) takes hi.hi alone."""
    r = tf32_read
    total = torch.zeros(*a_hi.shape[:-1], b_hi.shape[-1], dtype=torch.float32)
    for k0 in range(0, a_hi.shape[-1], KSTEP):
        s = slice(k0, k0 + KSTEP)
        x = r(a_hi[..., s]) @ r(b_hi[..., s, :])
        if three:
            x = (r(a_hi[..., s]) @ r(b_lo[..., s, :]) + r(a_lo[..., s]) @ r(b_hi[..., s, :])) + x
        total = total + x
    return total


def emulate_k1_fp32(q, k, v, scale, three=True):
    """K1's fp32 kernel on (B, N, H, D) fp32 tensors. Returns (out (B, Nq, H, D), lse (B, H, Nq))."""
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    qt, kt, vt = (t.permute(0, 2, 1, 3).float() for t in (q, k, v))  # (B, H, N, D)
    (qh, ql), (kh, kl), (vh, vl) = split(qt), split(kt), split(vt)
    if not three:
        ql, kl, vl = (torch.zeros_like(t) for t in (ql, kl, vl))
    scale_log2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    m = torch.full((B, H, Nq), -math.inf, dtype=torch.float32)
    l = torch.zeros(B, H, Nq, dtype=torch.float32)
    acc = torch.zeros(B, H, Nq, D, dtype=torch.float32)
    for k0 in range(0, Nk, BK):
        ks = slice(k0, min(k0 + BK, Nk))
        s = torch.zeros(B, H, Nq, ks.stop - k0, dtype=torch.float32)
        for c0 in range(0, D, BOX):  # the kernel's 32-column boxes, k-step by k-step
            cs = slice(c0, c0 + BOX)
            s = s + chains(qh[..., cs], ql[..., cs], kh[:, :, ks, cs].transpose(-1, -2),
                           kl[:, :, ks, cs].transpose(-1, -2), three)
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        l = l * corr + p.sum(-1)
        m = m_new
        ph, pl = split(p)
        acc = acc * corr[..., None] + chains(ph, pl, vh[:, :, ks], vl[:, :, ks], three)
    out = (acc / l[..., None]).permute(0, 2, 1, 3)
    return out, m * torch.tensor(math.log(2.0), dtype=torch.float32) + torch.log(l)


def _qkv(d, nq=48, nk=300, b=1, h=2, seed=0):
    rng = np.random.RandomState(seed + d)
    return [rng.randn(b, n, h, d).astype(np.float32) for n in (nq, nk, nk)]


def test_tf32_rna_is_cvt_rna():
    "Round to nearest on the 13 dropped bits, ties away from zero, for both signs; tf32 values are kept."
    one = 1.0 + 2.0**-10  # a tf32 value: 1 + one ulp
    x = torch.tensor([1.0, one, 1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-11 - 2.0**-23, 1.0 + 3 * 2.0**-11])
    want = torch.tensor([1.0, one, one, -one, 1.0, 1.0 + 2 * 2.0**-10])
    assert torch.equal(tf32_rna(x), want)
    hi, lo = split(torch.tensor([math.pi, -math.e, 1e-3, 12345.678]))
    assert torch.equal(tf32_read(hi), hi) and torch.equal(tf32_read(lo), lo)  # both exact as operands
    assert ((hi + lo).double() - torch.tensor([math.pi, -math.e, 1e-3, 12345.678]).float().double()).abs().max() <= (
        2.0**-22 * 12345.678)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_3xtf32_holds_a_quarter_of_the_bars_against_the_plain_version_and_pallas(d):
    q, k, v = _qkv(d)
    scale = d**-0.5
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = emulate_k1_fp32(tq, tk, tv, scale)
    ref, ref_lse = flash_attention_lse_ref(tq, tk, tv, scale)
    assert (out - ref).abs().max().item() <= K1_FP32_TOL / 4
    assert (lse - ref_lse).abs().max().item() <= LSE_FP32_TOL / 4
    jout, jlse = _flash_attention_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, 1024, 1024)
    assert np.abs(out.numpy() - np.asarray(jout)).max() <= K1_FP32_TOL / 4
    assert np.abs(lse.numpy() - np.asarray(jlse)[..., : q.shape[1]]).max() <= LSE_FP32_TOL / 4


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_one_term_tf32_misses_the_bars(d):
    "The control: hi.hi' alone (plain TF32) lands outside the quarter bars the three-term products hold."
    q, k, v = (torch.from_numpy(a) for a in _qkv(d))
    out, lse = emulate_k1_fp32(q, k, v, d**-0.5, three=False)
    ref, ref_lse = flash_attention_lse_ref(q, k, v, d**-0.5)
    assert (out - ref).abs().max().item() > K1_FP32_TOL / 4
    assert (lse - ref_lse).abs().max().item() > LSE_FP32_TOL / 4


# --- K3's fp32 kernels -----------------------------------------------------------------------------------------------


def trunc32(x: torch.Tensor) -> torch.Tensor:
    "float64 to fp32 rounded toward zero, as a tensor core's chained sum rounds."
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def tc_chains(a, b, three: bool = True, span: int = KSTEP):
    """a @ b (a (..., M, K), b (..., K, N)) as K3's tensor cores sum it: each wgmma (one of a k-step's products, 8 wide)
    adds its 8 exact products to its chain and truncates toward zero; a chain spans ``span`` of K (the kernel's: one
    k-step) and is then added to the total in fp32, round to nearest. The products hi.lo', lo.hi', then hi.hi'
    (``three=False``, the control: hi.hi' alone)."""
    pad = -a.shape[-1] % span
    a, b = torch.nn.functional.pad(a, (0, pad)), torch.nn.functional.pad(b, (0, 0, 0, pad))
    (ah, al), (bh, bl) = split(a), split(b)
    terms = ((ah, bl), (al, bh), (ah, bh)) if three else ((ah, bh),)
    total = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for c0 in range(0, a.shape[-1], span):
        x = torch.zeros_like(total)
        for k0 in range(c0, c0 + span, KSTEP):
            s = slice(k0, k0 + KSTEP)
            for p, q in terms:
                x = trunc32(x.double() + p[..., s].double() @ q[..., s, :].double())
        total = total + x
    return total


def emulate_k3_fp32(q, k, v, out, lse, dout, scale, three=True, span=KSTEP):
    """K3's fp32 kernels on (B, N, H, D) fp32 tensors: delta = rowsum(dO O); the dq pass's S = q k^T and dP = dO v^T,
    p = exp2(s scale log2(e) - lse log2(e)), ds = p (dP - delta) scale, dq = ds k; the dk/dv pass's S^T = k q^T and
    dP^T = v dO^T (its own operand order), dv = p^T dO, dk = ds^T q. Returns (dq, dk, dv) as (B, N, H, D)."""
    qt, kt, vt, dot, ot = (t.permute(0, 2, 1, 3).float() for t in (q, k, v, dout, out))
    delta = (dot * ot).sum(-1)
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    lse2, sl2 = lse * log2e, torch.tensor(scale, dtype=torch.float32) * log2e
    s = tc_chains(qt, kt.transpose(-1, -2), three)
    p = torch.exp2(s * sl2 - lse2[..., None])
    ds = p * (tc_chains(dot, vt.transpose(-1, -2), three) - delta[..., None]) * scale
    dq = tc_chains(ds, kt, three, span)
    pt = torch.exp2(tc_chains(kt, qt.transpose(-1, -2), three) * sl2 - lse2[..., None, :])
    dst = pt * (tc_chains(vt, dot.transpose(-1, -2), three) - delta[..., None, :]) * scale
    dv, dk = tc_chains(pt, dot, three, span), tc_chains(dst, qt, three, span)
    return tuple(g.permute(0, 2, 1, 3).contiguous() for g in (dq, dk, dv))


def _k3_inputs(d, nq=48, nk=300, seed=1):
    rng = np.random.RandomState(seed + d)
    q, k, v, g = (rng.randn(1, n, 2, d).astype(np.float32) for n in (nq, nk, nk, nq))
    scale = d**-0.5
    out, lse = flash_attention_lse_ref(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    return q, k, v, g, scale, out, lse


def _rel(a, b):
    return (np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()).item()


def test_trunc32_rounds_toward_zero():
    x = torch.tensor([1.0 + 2.0**-30, -(1.0 + 2.0**-30), 1.0 - 2.0**-30, 3.0, -2.0**-25 * 3], dtype=torch.float64)
    want = torch.tensor([1.0, -1.0, 1.0 - 2.0**-24, 3.0, -2.0**-25 * 3], dtype=torch.float32)
    assert torch.equal(trunc32(x), want)


@pytest.mark.parametrize("d", K3_HEAD_DIMS)
def test_k3_3xtf32_holds_a_quarter_of_its_bar_against_the_plain_version_and_pallas(d):
    q, k, v, g, scale, out, lse = _k3_inputs(d)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    grads = emulate_k3_fp32(tq, tk, tv, out, lse, tg, scale)
    refs = flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, scale)
    jout, jlse = _flash_attention_impl(*(jnp.asarray(a) for a in (q, k, v)), scale, 1024, 1024)
    jrefs = _flash_attention_bwd_pallas(*(jnp.asarray(a) for a in (q, k, v)), jout, jlse[..., : q.shape[1]],
                                        jnp.asarray(g), scale, 1024, 1024)
    for got, ref, jref in zip(grads, refs, jrefs):
        assert got.shape == ref.shape
        assert _rel(got, ref) <= K3_FP32_REL_TOL / 4
        assert _rel(got, jref) <= K3_FP32_REL_TOL / 4


@pytest.mark.parametrize("d", K3_HEAD_DIMS)
def test_k3_one_term_tf32_misses_its_bar(d):
    "The control: hi.hi' alone (plain TF32) lands outside the quarter bar on every gradient."
    q, k, v, g, scale, out, lse = _k3_inputs(d)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    refs = flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, scale)
    for got, ref in zip(emulate_k3_fp32(tq, tk, tv, out, lse, tg, scale, three=False), refs):
        assert _rel(got, ref) > K3_FP32_REL_TOL / 4


@pytest.mark.parametrize("d", [16, 64, 128])
def test_k3_whole_tile_chains_bias_a_near_cancelling_gradient(d):
    """The control of the per-k-step chains: a value bias's gradient, the sum of dv = p^T dO over the keys, against the
    same gradient through the softmax's identity (sum over keys of p times dO): their difference is 0 in exact
    arithmetic. With dO of one sign (an activation after an offset), every chain of dv's sums runs one way, so the
    tensor cores' truncation toward zero adds up: chained over whole 64-query tiles it leaves about 5e-7 of the
    gradient, ten times what per-k-step chains leave (their truncation is one k-step deep, the rest round to nearest)."""
    rng = np.random.RandomState(d)
    p = torch.softmax(torch.from_numpy(rng.randn(1, 2, 4 * K3_TILE, 300).astype(np.float32)), -1)
    dout = torch.from_numpy(rng.randn(1, 2, 4 * K3_TILE, d).astype(np.float32) + 2.0)
    through_identity = (dout.double() * p.double().sum(-1, keepdim=True)).sum(-2)
    left = {}
    for span in (KSTEP, K3_TILE):
        dv_sum = tc_chains(p.transpose(-1, -2), dout, span=span).double().sum(-2)
        left[span] = ((dv_sum - through_identity).abs().max() / through_identity.abs().max()).item()
    assert left[KSTEP] <= 1e-7 < 2e-7 <= left[K3_TILE], left
