"""
The attention kernels at the head dims the Pallas kernels take beyond 64, on the CPU: the plain versions of K1
(with and without the logsumexp), K3 (the single-block and the split backward), K6 (both int8 modes) and K5 (self
and cross, with RoPE) against the JAX package's Pallas kernels in interpret mode at D = 16, 20, 48, 192 and 256
(K5 at 16 and 80); the zero padding of a head dim that is not a multiple of 8 (ops/flash_attention.py pad_head_dim)
against the unpadded plain versions; K5's padded pair layout (ops/fused_attention.py rope_pair_layout), its
projection and rotation emulated pair by pair against the plain projection; and the one rule of the head dims each
kernel takes (head_dim_rule). The CUDA kernels are held against the same plain versions on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py phase 41). Inputs come from numpy; B = 1, H = 2, N <= 48.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniception_tpu.models.utils.config import set_attention_quant as jax_set_attention_quant
from uniception_tpu.ops import fused_attention as jfa
from uniception_tpu.ops.flash_attention import _flash_attention_impl
from uniception_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from uniception_tpu_torch.ops import fused_attention as fa
from uniception_tpu_torch.ops.flash_attention import (
    HEAD_DIM_ITEM,
    MAX_HEAD_DIM,
    flash_attention_bwd_ref,
    flash_attention_int8_prep_ref,
    flash_attention_int8_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
    head_dim_rule,
    pad_head_dim,
)
from uniception_tpu_torch.ops.rope import _inv_freq

TOL = 5e-5  # fp32 max abs, the repo's parity bar
FUSED_TOL = 2e-5  # the JAX fused interpret test's bar
HEAD_DIMS = [16, 20, 48, 192, 256]  # K1's DP 64 (16, 20, 48), 192 and 256; 20 is not a multiple of 8
# int8 against the Pallas kernel: the same quantization, sums in another order (tests/test_torch_attention_int8.py)
INT8_ULP_FLOOR, INT8_FAR_SHARE, INT8_JAX_TOL = 1 / 64, {1: 1e-2, 2: 5e-3}, 8e-3


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("UNICEPTION_TPU_PALLAS_INTERPRET", "1")
    yield
    jax_set_attention_quant("none")


def _qkv(seed, nq, nk, d, b=1, h=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, n, h, d).astype(np.float32) for n in (nq, nk, nk)]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("block", [16, 1024])  # several key blocks (the online softmax) / one block
def test_k1_plain_matches_pallas_interpret(d, block):
    "K1's plain version and its logsumexp against the Pallas forward, Nq != Nk with a ragged key block."
    q, k, v = _qkv(d + block, 24, 40, d)
    out_ref, lse_ref = _flash_attention_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, block, block)
    no_lse = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, block, block))
    out, lse = flash_attention_lse_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    assert out.shape == (1, 24, 2, d)
    assert np.abs(out.numpy() - np.asarray(out_ref)).max() <= TOL
    assert np.abs(flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v))).numpy() - no_lse).max() <= TOL
    assert np.abs(lse.numpy() - np.asarray(lse_ref)[..., :24]).max() <= TOL


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("blocks", [(1024, 1024), (16, 16)], ids=["fused", "split"])
def test_k3_plain_matches_pallas_interpret(d, blocks):
    "K3's plain backward from the saved logsumexp against jax.vjp of the Pallas kernels (their backward)."
    q, k, v = _qkv(3 * d, 24, 40, d)
    g = np.random.RandomState(d).randn(1, 24, 2, d).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, 0.2, *blocks), *map(jnp.asarray, (q, k, v)))
    refs = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = flash_attention_lse_ref(tq, tk, tv, 0.2)
    for name, ref, got in zip(("dq", "dk", "dv"), refs, flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, 0.2)):
        assert got.shape == ref.shape, name
        assert np.abs(got.numpy() - ref).max() <= TOL, name


def _far_share(out, ref, ulps):
    ref = torch.from_numpy(np.array(ref, dtype=np.float32))
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(INT8_ULP_FLOOR))) - 7)
    return ((out.float() - ref).abs() > ulps * ulp).float().mean().item()


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("mode", ["int8", "int8pv"])
def test_k6_plain_matches_pallas_interpret(d, mode):
    """K6's plain version against the Pallas int8 kernel (one key block), both modes, bf16 inputs for both packages.
    48 queries and keys: the bar is a share of the outputs, and a code that the k scale's last bit moves (the jitted
    kernel multiplies by 1/127 where the port divides) moves its whole row; at 20 queries one such row is 2.5% of
    the outputs, over the share (measured at D = 48 and 256)."""
    arrays = _qkv(5 * d, 48, 48, d)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays)
    jax_set_attention_quant(mode)
    ref = np.asarray(jax_flash_attention(jq, jk, jv).astype(jnp.float32))
    out = flash_attention_int8_ref(q, k, v, mode=mode)
    assert out.shape == (1, 48, 2, d) and out.dtype == torch.bfloat16
    assert all(_far_share(out, ref, n) <= share for n, share in INT8_FAR_SHARE.items())
    assert np.abs(out.float().numpy() - ref).max() <= INT8_JAX_TOL


def _positions(B, H, W):
    y, x = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return np.broadcast_to(np.stack([y.ravel(), x.ravel()], -1), (B, H * W, 2)).astype(np.int32).copy()


@pytest.mark.parametrize("d", [16, 80])
def test_k5_self_plain_matches_pallas_interpret(d):
    "K5 self-attention with RoPE: 2 heads of d, 42 tokens on a 6 x 7 grid (JAX's (C, 3C) kernel, the port's (3C, C))."
    rng = np.random.RandomState(d)
    C, heads = 2 * d, 2
    x = rng.randn(1, 42, C).astype(np.float32)
    w = (rng.randn(C, 3 * C) * 0.05).astype(np.float32)
    b = (rng.randn(3 * C) * 0.1).astype(np.float32)
    pos = _positions(1, 6, 7)
    ref = jfa.fused_qkv_rope_attention(*map(jnp.asarray, (x, w, b, pos)), heads, d**-0.5, 100.0, 1.0)
    out = fa.fused_qkv_rope_attention_ref(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (x, w.T, b, pos)),
                                          heads, d**-0.5)
    assert out.shape == (1, 42, C)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FUSED_TOL, rtol=FUSED_TOL)


@pytest.mark.parametrize("d", [16, 80])
def test_k5_cross_plain_matches_pallas_interpret(d):
    "K5 cross-attention with RoPE on both sides: 30 queries on a 5 x 6 grid, 48 keys on 6 x 8."
    rng = np.random.RandomState(d + 1)
    C, heads = 2 * d, 2
    xq, xkv = rng.randn(1, 30, C).astype(np.float32), rng.randn(1, 48, C).astype(np.float32)
    wq, wkv = (rng.randn(C, C) * 0.05).astype(np.float32), (rng.randn(C, 2 * C) * 0.05).astype(np.float32)
    bq, bkv = (rng.randn(C) * 0.1).astype(np.float32), (rng.randn(2 * C) * 0.1).astype(np.float32)
    qpos, kpos = _positions(1, 5, 6), _positions(1, 6, 8)
    ref = jfa.fused_cross_rope_attention(*map(jnp.asarray, (xq, xkv, wq, wkv, bq, bkv, qpos, kpos)), heads, d**-0.5,
                                         100.0, 1.0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = fa.fused_cross_rope_attention_ref(t(xq), t(xkv), t(wq.T), t(wkv[:, :C].T), t(wkv[:, C:].T), t(bq),
                                            t(bkv[:C]), t(bkv[C:]), t(qpos), t(kpos), heads, d**-0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FUSED_TOL, rtol=FUSED_TOL)


@pytest.mark.parametrize("d", [4, 20, 36, 100])
def test_pad_head_dim_gives_the_unpadded_attention(d):
    """The wrappers' zero padding of D to a multiple of 8, with the caller's scale: the forward, its logsumexp, the
    backward (sliced back to D) and both int8 modes equal the unpadded plain versions; one copy is counted per call."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(d, 18, 30, d))
    g = torch.from_numpy(np.random.RandomState(d + 9).randn(1, 18, 2, d).astype(np.float32))
    before = pad_head_dim.copies
    pq, pk, pv, pg = pad_head_dim(q, k, v, g)
    assert pad_head_dim.copies == before + 1 and pq.shape[-1] == -(-d // 8) * 8 and pq.is_contiguous()
    assert torch.equal(pq[..., :d], q) and not pq[..., d:].any()
    scale = d**-0.5
    out, lse = flash_attention_lse_ref(q, k, v, scale)
    pout, plse = flash_attention_lse_ref(pq, pk, pv, scale)
    assert (pout[..., :d] - out).abs().max().item() <= 1e-6 and not pout[..., d:].any()
    assert (plse - lse).abs().max().item() <= 1e-6
    grads = flash_attention_bwd_ref(q, k, v, out, lse, g, scale)
    pgrads = flash_attention_bwd_ref(pq, pk, pv, pout, plse, pg, scale)
    for a, b in zip(grads, pgrads):
        assert (b[..., :d] - a).abs().max().item() <= 1e-6
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    pqb, pkb, pvb = pad_head_dim(qb, kb, vb)
    for mode in ("int8", "int8pv"):
        assert torch.equal(flash_attention_int8_ref(pqb, pkb, pvb, scale, mode)[..., :d],
                           flash_attention_int8_ref(qb, kb, vb, scale, mode))
        k8, ks, v8t, vs = flash_attention_int8_prep_ref(kb, vb, mode)
        pk8, pks, pv8t, pvs = flash_attention_int8_prep_ref(pkb, pvb, mode)
        assert torch.equal(pk8[..., :d], k8) and torch.equal(pks, ks)
    aligned = pad_head_dim(pq, pk)
    assert aligned[0] is pq and pad_head_dim.copies == before + 2  # a multiple of 8 is not copied


@pytest.mark.parametrize("d", [4, 16, 20, 64, 80, 96, 128, 192, 256])
def test_rope_pair_layout_projects_and_rotates_like_the_plain_version(d):
    """K5's bf16 projection at D != 64 runs on weights permuted into padded heads (rope_pair_layout): emulated pair by
    pair as PadRopeEpilogue computes (each pair's u and v 16 columns apart, rotated with the pair's frequency and
    written to its head columns), it gives the plain projection and RoPE; the padded head divides the GEMM's tile."""
    dpad, src = fa.rope_pair_layout(d)
    assert dpad in fa.PAD_WIDTHS and dpad >= d and (dpad <= 128 or dpad == 256)
    assert sorted(c for c in src if c >= 0) == list(range(d))
    rng = np.random.RandomState(d)
    H, C, N = 3, 40, 12
    x = torch.from_numpy(rng.randn(1, N, C).astype(np.float32))
    w = torch.from_numpy(rng.randn(H * d, C).astype(np.float32))
    b = torch.from_numpy(rng.randn(H * d).astype(np.float32))
    pos = torch.from_numpy(_positions(1, 3, 4))
    want = fa._project_ref(x, (w,), (b,), pos, (True,), H, 100.0, 1.0)[0][0]  # (N, H, d)
    wp, bp = fa._pad_heads(w, H, d), fa._pad_heads(b, H, d)
    y = (x[0] @ wp.t() + bp).reshape(N, H, dpad)  # the GEMM and the bias, fp32
    q = d // 4
    freq = _inv_freq(q, 100.0, 1.0, "cpu")
    got = torch.zeros(N, H, d)
    for p in range(2 * q):
        half, qi = divmod(p, q)
        col = 32 * (p // 16) + p % 16
        ang = pos[0, :, half].float() * freq[qi]
        cs, sn = ang.cos()[:, None], ang.sin()[:, None]
        u, v = y[:, :, col], y[:, :, col + 16]
        du = 2 * half * q + qi
        got[:, :, du], got[:, :, du + q] = u * cs - v * sn, v * cs + u * sn
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("kernel,ok,bad", [("K1", [1, 20, 192, 264, 512], [513, 1024]),
                                           ("K3", [8, 20, 136, 256], [264, 512]),
                                           ("K6", [16, 20, 80, 256], [264]),
                                           ("K5", [4, 16, 20, 80, 256], [18, 260, 512]),
                                           ("K8", [64], [32, 80])])
def test_each_kernel_has_one_head_dim_rule(kernel, ok, bad):
    "Every head dim of a kernel's rule passes; outside it the call raises, naming the ROADMAP item that would widen it."
    for d in ok:
        head_dim_rule("op", kernel, d)
    for d in bad:
        with pytest.raises(ValueError, match=f"head dim {d} .*{HEAD_DIM_ITEM}"):
            head_dim_rule("op", kernel, d)
    assert MAX_HEAD_DIM["K1"] == 512 and MAX_HEAD_DIM["K3"] == MAX_HEAD_DIM["K5"] == MAX_HEAD_DIM["K6"] == 256
