"""
The port's fused qkv + RoPE + attention (ops/fused_attention.py, the plain
versions of K5, and its dispatch in nn/blocks.py) and the S.V diagnostic
(ops/sv_only.py, K8's plain version) against the JAX package on the CPU. The
JAX side runs its Pallas kernels in interpret mode. Direct calls at the JAX
interpret test's shapes, gradients through the port's autograd Functions
against jax.grad of the fused call, the attention modules and a small
DUSt3R forward_pair in the "fused" implementation, and the routing rules.
Inputs come from numpy; weights go from the JAX modules to the port through
their torch-layout state dicts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from uniception_tpu.models.factory.dust3r import DUSt3R as JaxDUSt3R
from uniception_tpu.models.utils import config as jax_config
from uniception_tpu.nn import blocks as jblocks
from uniception_tpu.ops import fused_attention as jfa
from uniception_tpu.ops.rope import Rope2D as JaxRope2D
from uniception_tpu.utils.torch_compat import state_dict_from_module
from uniception_tpu_torch.models.factory.dust3r import DUSt3R
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions
from uniception_tpu_torch.nn import blocks
from uniception_tpu_torch.nn.quant import quantize_linears
from uniception_tpu_torch.ops import attention
from uniception_tpu_torch.ops import fused_attention as fa
from uniception_tpu_torch.ops.flash_attention import FWD_ROWS, flash_attention_int8_ref, flash_attention_ref
from uniception_tpu_torch.ops.rope import Rope2D, rope_2d
from uniception_tpu_torch.ops.sv_only import sv_only, sv_only_ref
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

TOL = 2e-5  # fp32, the JAX interpret test's bar (tests/ops/test_fused_attention_interpret.py)
GRAD_TOL = 5e-4  # the same file's gradient bar
MODULE_TOL = 5e-5  # fp32 max abs per module, the repo's parity bar
ENC = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4)
DEC = dict(info_sharing_dim=48, info_sharing_depth=2, info_sharing_num_heads=4)


@pytest.fixture(autouse=True)
def _fused_mode(monkeypatch):
    "JAX's Pallas kernels in interpret mode; both packages' implementation and quant mode restored afterwards."
    monkeypatch.setenv("UNICEPTION_TPU_PALLAS_INTERPRET", "1")
    yield
    jax_config.set_attention_impl("pallas")
    jax_config.set_attention_quant("none")
    config.set_attention_impl("kernel")
    config.set_attention_quant("none")


def _positions(B, H, W):
    y, x = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return np.broadcast_to(np.stack([y.ravel(), x.ravel()], -1), (B, H * W, 2)).astype(np.int32).copy()


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _self_case(rng, B, N, C, side_w):
    x = rng.randn(B, N, C).astype(np.float32)
    w = (rng.randn(C, 3 * C) * 0.05).astype(np.float32)  # the JAX (C, 3C) layout
    b = (rng.randn(3 * C) * 0.1).astype(np.float32)
    pos = _positions(B, -(-N // side_w), side_w)[:, :N]
    return x, w, b, pos


@pytest.mark.parametrize("N,C,heads", [(64, 96, 4), (49, 64, 2)])
@pytest.mark.parametrize("use_rope", [True, False])
def test_fused_self_plain_version_matches_jax(N, C, heads, use_rope):
    x, w, b, pos = _self_case(np.random.RandomState(0), 2, N, C, int(np.ceil(np.sqrt(N))))
    pos = pos if use_rope else None
    scale = (C // heads) ** -0.5
    ref = jfa.fused_qkv_rope_attention(_j(x), _j(w), _j(b), _j(pos), heads, scale, 100.0, 1.0)
    out = fa.fused_qkv_rope_attention_ref(_t(x), _t(w.T), _t(b), _t(pos), heads, scale)
    assert out.shape == (2, N, C) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    # the wrapper on a CPU tensor is the plain version and launches nothing
    before = fa.fused_qkv_rope_attention.launches
    assert torch.equal(fa.fused_qkv_rope_attention(_t(x), _t(w.T), _t(b), _t(pos), heads, scale), out)
    assert fa.fused_qkv_rope_attention.launches == before


def _cross_case(rng, B, Nq, Nk, C):
    xq, xkv = rng.randn(B, Nq, C).astype(np.float32), rng.randn(B, Nk, C).astype(np.float32)
    wq, wkv = (rng.randn(C, C) * 0.05).astype(np.float32), (rng.randn(C, 2 * C) * 0.05).astype(np.float32)
    bq, bkv = (rng.randn(C) * 0.1).astype(np.float32), (rng.randn(2 * C) * 0.1).astype(np.float32)
    return xq, xkv, wq, wkv, bq, bkv


def _port_cross_weights(wq, wkv, bq, bkv, C):
    "The JAX (C, H*D) / (C, 2*H*D) kernels as the port's (out, in) weights, k and v apart."
    return [_t(a) for a in (wq.T, wkv[:, :C].T, wkv[:, C:].T, bq, bkv[:C], bkv[C:])]


@pytest.mark.parametrize("Nq,Nk", [(48, 80), (64, 64)])
@pytest.mark.parametrize("use_rope", [True, False])
def test_fused_cross_plain_version_matches_jax(Nq, Nk, use_rope):
    B, C, heads = 2, 64, 4
    xq, xkv, wq, wkv, bq, bkv = _cross_case(np.random.RandomState(2), B, Nq, Nk, C)
    qpos, kpos = (_positions(B, 8, 8)[:, :Nq], _positions(B, 10, 8)[:, :Nk]) if use_rope else (None, None)
    scale = (C // heads) ** -0.5
    ref = jfa.fused_cross_rope_attention(*map(_j, (xq, xkv, wq, wkv, bq, bkv, qpos, kpos)), heads, scale, 100.0, 1.0)
    wq_t, wk_t, wv_t, bq_t, bk_t, bv_t = _port_cross_weights(wq, wkv, bq, bkv, C)
    out = fa.fused_cross_rope_attention_ref(_t(xq), _t(xkv), wq_t, wk_t, wv_t, bq_t, bk_t, bv_t, _t(qpos), _t(kpos),
                                            heads, scale)
    assert out.shape == (B, Nq, C)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_fused_plain_version_matches_jax_over_several_q_blocks(monkeypatch):
    "N = 96 with the JAX kernel forced to 32-row q-blocks: its k/v scratch carried across blocks."
    x, w, _, pos = _self_case(np.random.RandomState(3), 1, 96, 32, 8)
    b = np.zeros(96, np.float32)
    orig = jfa._plan_fused

    def small_blocks(Nq, Nk, head_dim, dtype):
        _, _, nk_pad, cd, prec = orig(Nq, Nk, head_dim, dtype)
        return 32, 96, nk_pad, cd, prec

    monkeypatch.setattr(jfa, "_plan_fused", small_blocks)
    ref = jfa.fused_qkv_rope_attention(_j(x), _j(w), _j(b), _j(pos), 2, 16**-0.5, 100.0, 1.0)
    out = fa.fused_qkv_rope_attention_ref(_t(x), _t(w.T), _t(b), _t(pos), 2, 16**-0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_fused_plain_version_rotates_like_k2():
    "q and k of the plain fused projection equal K2's plain version on the same rounded projection, in bf16."
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 12, 128).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.randn(384, 128) * 0.1).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.randn(384).astype(np.float32))
    pos = make_patch_positions(2, 3, 4)
    q, k, v = fa._project_ref(x, w.chunk(3), b.chunk(3), pos, (True, True, False), 2, 100.0, 1.0)
    proj = (x.float() @ w.float().t() + b).bfloat16().reshape(2, 12, 3, 2, 64)
    assert torch.equal(q, rope_2d(proj[:, :, 0], pos)) and torch.equal(k, rope_2d(proj[:, :, 1], pos))
    assert torch.equal(v, proj[:, :, 2]) and q.dtype == torch.bfloat16


def _grads_close(port, jax_grads):
    for g, r in zip(port, jax_grads):
        np.testing.assert_allclose(g, np.asarray(r), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_fused_self_gradients_match_jax():
    "The port's Function (backward: the unfused path's recompute) against jax.grad of the fused call."
    x, w, b, pos = _self_case(np.random.RandomState(1), 1, 32, 64, 8)
    heads, scale = 4, 16**-0.5
    g_j = jax.grad(lambda x_, w_, b_: jnp.sum(jfa.fused_qkv_rope_attention(x_, w_, b_, _j(pos), heads, scale) ** 2),
                   argnums=(0, 1, 2))(_j(x), _j(w), _j(b))
    xt, wt, bt = (_t(a).requires_grad_() for a in (x, w.T, b))
    out = fa.fused_qkv_rope_attention(xt, wt, bt, _t(pos), heads, scale)
    assert isinstance(out.grad_fn, fa.FusedSelfAttentionFunction._backward_cls)
    out.square().sum().backward()
    _grads_close([xt.grad.numpy(), wt.grad.numpy().T, bt.grad.numpy()], g_j)


def test_fused_cross_gradients_match_jax():
    B, Nq, Nk, C, heads = 1, 32, 40, 64, 4
    xq, xkv, wq, wkv, bq, bkv = _cross_case(np.random.RandomState(5), B, Nq, Nk, C)
    qpos, kpos = _positions(B, 4, 8), _positions(B, 5, 8)
    scale = 16**-0.5
    g_j = jax.grad(
        lambda *a: jnp.sum(jfa.fused_cross_rope_attention(*a, _j(qpos), _j(kpos), heads, scale) ** 2),
        argnums=tuple(range(6)),
    )(*map(_j, (xq, xkv, wq, wkv, bq, bkv)))
    leaves = [t.requires_grad_() for t in [_t(xq), _t(xkv), *_port_cross_weights(wq, wkv, bq, bkv, C)]]
    fa.fused_cross_rope_attention(*leaves, _t(qpos), _t(kpos), heads, scale).square().sum().backward()
    dxq, dxkv, dwq, dwk, dwv, dbq, dbk, dbv = (t.grad.numpy() for t in leaves)
    _grads_close([dxq, dxkv, dwq.T, np.concatenate([dwk.T, dwv.T], 1), dbq, np.concatenate([dbk, dbv])], g_j)


def _module_pair(jax_cls, torch_cls, **kw):
    "A JAX attention module and the port's with the JAX module's weights."
    jmod = jax_cls(dim=64, num_heads=4, custom_positional_encoding=JaxRope2D(freq=100.0), rngs=nnx.Rngs(0), **kw)
    tmod = torch_cls(dim=64, num_heads=4, custom_positional_encoding=Rope2D(freq=100.0), **kw)
    load_state_dict_numpy(tmod, state_dict_from_module(jmod))
    return jmod, tmod


def _fused():
    jax_config.set_attention_impl("fused")
    config.set_attention_impl("fused")


class _Spy:
    "Counts the calls of the fused wrappers that nn/blocks.py makes."

    def __init__(self, monkeypatch):
        self.calls = {"self": 0, "cross": 0}
        for kind, name in (("self", "fused_qkv_rope_attention"), ("cross", "fused_cross_rope_attention")):
            monkeypatch.setattr(blocks, name, self._wrap(kind, getattr(blocks, name)))

    def _wrap(self, kind, fn):
        def spy(*args, **kwargs):
            self.calls[kind] += 1
            return fn(*args, **kwargs)
        return spy


@pytest.mark.parametrize("kw", [dict(qkv_bias=True), dict(use_scalable_softmax=True, use_entropy_scaling=True)],
                         ids=["qkv_bias", "ssmax+entropy, no bias"])
def test_attention_module_fused_matches_jax(monkeypatch, kw):
    jmod, tmod = _module_pair(jblocks.Attention, blocks.Attention, **kw)
    x = np.random.RandomState(6).randn(2, 12, 64).astype(np.float32)
    pos = _positions(2, 3, 4)
    _fused()
    spy = _Spy(monkeypatch)
    assert jblocks._fused_attention_applicable(jmod, 12)
    ref = jmod(_j(x), _j(pos))
    with torch.no_grad():
        out = tmod(_t(x), _t(pos))
    assert spy.calls == {"self": 1, "cross": 0}
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=MODULE_TOL, rtol=0)


def test_cross_attention_module_fused_matches_jax(monkeypatch):
    jmod, tmod = _module_pair(jblocks.CrossAttention, blocks.CrossAttention, qkv_bias=True)
    rng = np.random.RandomState(7)
    x, y = rng.randn(2, 12, 64).astype(np.float32), rng.randn(2, 20, 64).astype(np.float32)
    xpos, ypos = _positions(2, 3, 4), _positions(2, 4, 5)
    _fused()
    spy = _Spy(monkeypatch)
    ref = jmod(_j(x), *[_j(y)] * 2, _j(xpos), _j(ypos))
    with torch.no_grad():
        yt = _t(y)
        out = tmod(_t(x), yt, yt, _t(xpos), _t(ypos))
        assert spy.calls == {"self": 0, "cross": 1}
        # key is not value: the unfused path, the same numbers
        unfused = tmod(_t(x), yt, yt.clone(), _t(xpos), _t(ypos))
    assert spy.calls == {"self": 0, "cross": 1}
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=MODULE_TOL, rtol=0)
    np.testing.assert_allclose(unfused.numpy(), np.asarray(ref), atol=MODULE_TOL, rtol=0)


def test_fused_dispatch_follows_the_jax_contract(monkeypatch):
    "K5 for eligible modules; not for int8 projections, Nk > 2048, other implementations or other encodings."
    attn = blocks.Attention(64, num_heads=4, qkv_bias=True, custom_positional_encoding=Rope2D(100.0))
    cross = blocks.CrossAttention(64, num_heads=4, custom_positional_encoding=Rope2D(100.0))
    plain_pe = blocks.Attention(64, num_heads=4, custom_positional_encoding=lambda t, p: t)
    x, pos = torch.randn(1, 12, 64), make_patch_positions(1, 3, 4)
    spy = _Spy(monkeypatch)
    for impl in ("kernel", "naive"):
        config.set_attention_impl(impl)
        assert not blocks._fused_attention_applicable(attn, 12)
    config.set_attention_impl("fused")
    assert blocks._fused_attention_applicable(attn, 2048) and not blocks._fused_attention_applicable(attn, 2049)
    assert not blocks._fused_attention_applicable(plain_pe, 12)
    with torch.no_grad():
        attn(x, pos)
        plain_pe(x, pos)
        long_y, long_pos = torch.randn(1, 2049, 64), make_patch_positions(1, 1, 2049)
        cross(x, long_y, long_y, pos, long_pos)
        assert spy.calls == {"self": 1, "cross": 0}
        assert quantize_linears(attn, min_params=0) == 2
        assert not blocks._fused_attention_applicable(attn, 12)
        attn(x, pos)
    assert spy.calls == {"self": 1, "cross": 0}
    with pytest.raises(ValueError, match="positions"):
        blocks.Attention(64, num_heads=4, custom_positional_encoding=Rope2D(100.0))(x)


def test_fused_fallback_is_exact_attention_under_int8_quant(monkeypatch):
    "Under 'fused' + attention quant int8, a layer outside the contract takes exact attention (JAX ops/attention.py:190-200)."
    attn = blocks.Attention(128, num_heads=2, qkv_bias=True, custom_positional_encoding=Rope2D(100.0)).bfloat16()
    assert quantize_linears(attn, min_params=0) == 2
    x, pos = torch.randn(1, 16, 128).bfloat16(), make_patch_positions(1, 4, 4)
    calls = []
    real = attention.scaled_dot_product_attention

    def spy(q, k, v, scale=None, impl=None):
        out = real(q, k, v, scale, impl)
        calls.append((out, flash_attention_ref(q, k, v, scale), flash_attention_int8_ref(q, k, v, scale, "int8")))
        return out

    monkeypatch.setattr(blocks, "scaled_dot_product_attention", spy)
    config.set_attention_quant("int8")
    config.set_attention_impl("fused")
    with torch.no_grad():
        attn(x, pos)
    config.set_attention_impl("kernel")
    with torch.no_grad():
        attn(x, pos)
    (fused_out, exact, _), (kernel_out, _, int8) = calls
    assert torch.equal(fused_out, exact) and not torch.equal(fused_out, int8)
    assert torch.equal(kernel_out, int8)


def test_forward_pair_fused_matches_jax(monkeypatch):
    "A small DUSt3R (test_torch_dust3r.py's sizes) in the 'fused' implementation, port against JAX."
    jmod = JaxDUSt3R(name="dust3r_small", img_size=(32, 48), rngs=nnx.Rngs(0), **ENC, **DEC)
    tmod = DUSt3R(name="dust3r_small", img_size=(32, 48), **ENC, **DEC)
    load_state_dict_numpy(tmod, state_dict_from_module(jmod))
    tmod.eval()
    rng = np.random.RandomState(3)
    img1, img2 = (rng.randn(2, 3, 32, 48).astype(np.float32) for _ in range(2))
    _fused()
    spy = _Spy(monkeypatch)
    ref1, ref2 = jmod.forward_pair(jnp.asarray(img1), jnp.asarray(img2))
    with torch.no_grad():
        out1, out2 = tmod.forward_pair(torch.from_numpy(img1), torch.from_numpy(img2))
    # the encoder's blocks on both views at once; per decoder depth and view one self and one cross
    depth, dec = ENC["enc_depth"], DEC["info_sharing_depth"]
    assert spy.calls == {"self": depth + 2 * dec, "cross": 2 * dec}
    for out, ref in ((out1, ref1), (out2, ref2)):
        assert sorted(out) == sorted(ref)
        for key in ref:
            r = np.asarray(ref[key])
            tol = 1e-4 * max(1.0, float(np.abs(r).max()))  # exp adaptors scale errors with the output
            assert np.abs(out[key].numpy() - r).max() <= tol, key


def test_sv_only_plain_version_matches_the_pallas_body():
    """K8's plain version against a jnp restatement of ``_mxu_only_kernel``'s
    body (scripts/sweep_attention.py:63-68): the JAX function is nested in that
    script's main() and cannot be imported. bf16 inputs; the scores rounded to
    bf16 before the fp32 product with v."""
    rng = np.random.RandomState(8)
    q, k, v = (rng.randn(2, n, 3, 64).astype(np.float32) for n in (40, 72, 72))
    jq, jk, jv = (jnp.transpose(jnp.asarray(a).astype(jnp.bfloat16), (0, 2, 1, 3)) for a in (q, k, v))
    s = jnp.einsum("bhnd,bhmd->bhnm", jq, jk, preferred_element_type=jnp.float32)
    ref = jnp.einsum("bhnm,bhmd->bhnd", s.astype(jnp.bfloat16), jv, preferred_element_type=jnp.float32)
    ref = np.asarray(jnp.transpose(ref.astype(jnp.bfloat16), (0, 2, 1, 3)).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out = sv_only_ref(tq, tk, tv)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 40, 3, 64)
    # the same bf16 scores and fp32 sums in another order, then one bf16 rounding: within 1 ulp of max(|ref|, 1)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1.0))) - 7)
    assert (np.abs(out.float().numpy() - ref) / ulp).max() <= 1
    before = sv_only.launches
    assert torch.equal(sv_only(tq, tk, tv), out) and sv_only.launches == before


def _sv_only_kernel_order(q, k, v, tile=FWD_ROWS):
    """K8's arithmetic order (csrc/flash_attention.cu ``fa_fwd_bf16_kernel<false, 64, 64>``), restated in torch: per key
    tile of the rows the wrapper's tensor maps are built for (FWD_ROWS), the fp32 scores of the bf16 inputs (exact
    products, fp32 sums: the tensor cores' Q.K^T) rounded to bf16, keys past Nk zero (TMA's zero fill of K and V),
    the tile's S.V in fp32 added to an fp32 O over the tiles; O rounded once. It documents the order the kernel
    follows and runs none of its code; the card tests of tests/test_torch_cuda_kernels.py hold the kernel."""
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    pad = -(-Nk // tile) * tile
    kf, vf = (torch.zeros(B, pad, H, D) for _ in range(2))
    kf[:, :Nk], vf[:, :Nk] = k.float(), v.float()
    o = torch.zeros(B, Nq, H, D)
    for j in range(0, pad, tile):
        s = torch.einsum("bnhd,bmhd->bhnm", q.float(), kf[:, j:j + tile])
        o = o + torch.einsum("bhnm,bmhd->bnhd", s.bfloat16().float(), vf[:, j:j + tile])
    return o.bfloat16()


@pytest.mark.parametrize("nk", [1, 100, 128, 129, 300])
def test_sv_only_kernel_order_matches_plain_and_pallas_body(nk):
    """K8's tiled order (a restatement of the kernel's arithmetic, at the wrapper's key tile FWD_ROWS) against
    its plain version and the jnp restatement of ``_mxu_only_kernel`` (scripts/sweep_attention.py:63-68) at
    ragged and full key tiles. With the plain version's scores (the same fp32 products and sums) only the order
    of the fp32 sums over the keys differs before one bf16 rounding: within 1 bf16 ulp of max(|ref|, 1)
    everywhere. XLA sums each score in another order, so a few scores round to the other bf16 neighbour, which
    moves their row by up to ulp(s) |v|: against jnp the same 1-ulp bar holds outside those rows, and
    ||out - ref|| / ||ref|| <= 1e-3 (chip_smoke.py K8_REL_TOL) overall."""
    rng = np.random.RandomState(nk)
    q, k, v = (rng.randn(2, n, 3, 64).astype(np.float32) for n in (40, nk, nk))
    jq, jk, jv = (jnp.transpose(jnp.asarray(a).astype(jnp.bfloat16), (0, 2, 1, 3)) for a in (q, k, v))
    s = jnp.einsum("bhnd,bhmd->bhnm", jq, jk, preferred_element_type=jnp.float32)
    jref = jnp.einsum("bhnm,bhmd->bhnd", s.astype(jnp.bfloat16), jv, preferred_element_type=jnp.float32)
    jref = torch.from_numpy(np.asarray(jnp.transpose(jref.astype(jnp.bfloat16), (0, 2, 1, 3)).astype(jnp.float32)))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out = _sv_only_kernel_order(tq, tk, tv).float()
    assert out.shape == (2, 40, 3, 64)

    def ulps(ref):
        return (out - ref).abs() / torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1.0))) - 7)

    assert ulps(sv_only_ref(tq, tk, tv).float()).max().item() <= 1
    ts = torch.einsum("bnhd,bmhd->bhnm", tq.float(), tk.float())
    flipped = (torch.from_numpy(np.asarray(s.astype(jnp.bfloat16).astype(jnp.float32))) != ts.bfloat16().float())
    flipped_rows = flipped.any(-1).transpose(1, 2)[..., None]  # (B, Nq, H, 1)
    assert not ((ulps(jref) > 1) & ~flipped_rows).any()
    assert ((out - jref).norm() / jref.norm()).item() <= 1e-3
