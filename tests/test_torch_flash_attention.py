"""
The port's flash attention (uniception_tpu_torch/ops/flash_attention.py) on
the CPU: its plain versions against the JAX Pallas kernels run in interpret
mode (single-step, multi-step and masked key blocks; the forward with its
logsumexp; the fused single-block and the split dq / dk-dv backward), the
autograd Function, the attention dispatch, and the TMA tensor-map layouts the
bf16 kernels are handed (with the checks that refuse what a map cannot take). The forward and its logsumexp are held at every head dim K1
takes (32, 64, 80, 96, 128 and 512). The CUDA kernels are held against the same
plain versions on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniception_tpu.ops.flash_attention import _flash_attention_impl
from uniception_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.ops.attention import scaled_dot_product_attention
from uniception_tpu_torch.ops.flash_attention import (
    BWD_LOOP_ROWS,
    BWD_OWN_ROWS,
    FWD_ROWS,
    FlashAttentionFunction,
    _check,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
    tma_layout,
)

TOL = 5e-5  # fp32 max abs, the repo's parity bar


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("UNICEPTION_TPU_PALLAS_INTERPRET", "1")


def _qkv(seed, b, nq, nk, h, d=64, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return rng.randn(b, nq, h, d).astype(dtype), rng.randn(b, nk, h, d).astype(dtype), rng.randn(b, nk, h, d).astype(dtype)


# every head dim K1 is built for (ops/flash_attention.py HEAD_DIMS): the encoders' 32, 64, 80, 96 and 128, and the
# Cosmos tokenizer's 512
HEAD_DIMS = [32, 64, 80, 96, 128, 512]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("block_k", [16, 1024])  # multi-step online softmax / one key block
@pytest.mark.parametrize("nq,nk", [(32, 32), (36, 36), (48, 48), (24, 40)])  # 36: padded and masked; 24/40: Nq != Nk
def test_plain_matches_pallas_interpret(nq, nk, block_k, d):
    q, k, v = _qkv(nq + nk, 2, nq, nk, 2, d)
    ref = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 16, block_k))
    out = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= TOL


def test_plain_matches_pallas_interpret_scale_and_strided_views():
    "An explicit scale, and q/k/v as strided views of one (B, N, 3, H, D) projection."
    qkv = np.random.RandomState(7).randn(2, 36, 3, 3, 64).astype(np.float32)
    q, k, v = (qkv[:, :, i] for i in range(3))
    ref = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3, 16, 16))
    t = torch.from_numpy(qkv)
    out = flash_attention_ref(t[:, :, 0], t[:, :, 1], t[:, :, 2], 0.3).numpy()
    assert np.abs(out - ref).max() <= TOL


def test_plain_bf16_matches_pallas_interpret():
    """bf16 in, one key block: both round p to bf16 before P.V and return bf16,
    so nearly every element agrees bit for bit (without the p rounding about
    a third would differ) and none by more than one bf16 ulp."""
    q, k, v = _qkv(3, 1, 40, 40, 2)
    to_bf16 = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    ref = jax_flash_attention(to_bf16(q), to_bf16(k), to_bf16(v), None, 16, 1024)
    ref = np.asarray(ref.astype(jnp.float32))
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    out = flash_attention_ref(tb(q), tb(k), tb(v))
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    assert (out == ref).mean() >= 0.99
    assert np.all(np.abs(out - ref) <= 2.0**-7 * np.maximum(np.abs(ref), 1.0))


@pytest.mark.parametrize("impl", ["kernel", "naive"])
def test_dispatch_on_cpu_takes_plain_version(impl):
    "A CPU tensor takes the plain version under either impl, and the kernel counter stays put."
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 20, 28, 2))
    before = flash_attention.launches
    prev = config.get_attention_impl()
    config.set_attention_impl(impl)
    try:
        out = scaled_dot_product_attention(q, k, v, scale=0.125)
        direct = flash_attention(q, k, v, 0.125)
    finally:
        config.set_attention_impl(prev)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, 0.125), rtol=0, atol=0)
    torch.testing.assert_close(direct, out, rtol=0, atol=0)
    assert flash_attention.launches == before


def test_invalid_impl_rejected():
    with pytest.raises(ValueError):
        config.set_attention_impl("pallas")
    q = torch.zeros(1, 4, 1, 64)
    with pytest.raises(ValueError):
        scaled_dot_product_attention(q, q, q, impl="xla")


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("block", [16, 1024])  # several query/key blocks / one block
@pytest.mark.parametrize("nq,nk", [(36, 36), (24, 40)])
def test_lse_matches_pallas_interpret(nq, nk, block, d):
    q, k, v = _qkv(5 * nq + nk, 2, nq, nk, 2, d)
    out_ref, lse_ref = _flash_attention_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.2, block, block)
    out, lse = flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 0.2)
    assert lse.shape == (2, 2, nq) and lse.dtype == torch.float32
    assert np.abs(lse.numpy() - np.asarray(lse_ref)[..., :nq]).max() <= TOL
    assert np.abs(out.numpy() - np.asarray(out_ref)).max() <= TOL


def _jax_grads(q, k, v, g, scale, block_q, block_k, dtype=jnp.float32):
    "jax.vjp of the Pallas flash attention (its Pallas backward in interpret mode)."
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_attention(q_, k_, v_, scale, block_q, block_k), *args)
    return [np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g).astype(dtype))]


# (block_q, block_k): one block (_fa_bwd_fused_kernel) or several (_fa_bwd_dq_kernel / _fa_bwd_dkv_kernel)
@pytest.mark.parametrize("blocks", [(1024, 1024), (16, 16)], ids=["fused", "split"])
@pytest.mark.parametrize("nq,nk", [(32, 32), (36, 36), (24, 40), (1, 7)])
def test_backward_matches_pallas_interpret(nq, nk, blocks):
    """flash_attention_bwd_ref, the CPU route of the K3 wrapper, and autograd
    through FlashAttentionFunction against jax.vjp of the Pallas kernels:
    fp32, within the repo's 5e-5 parity bar."""
    q, k, v = _qkv(nq * 3 + nk, 2, nq, nk, 2)
    g = np.random.RandomState(nq + 7 * nk).randn(2, nq, 2, 64).astype(np.float32)
    refs = _jax_grads(q, k, v, g, 0.2, *blocks)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = flash_attention_lse_ref(tq, tk, tv, 0.2)
    plain = flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, 0.2)
    wrapper = flash_attention_bwd(tq, tk, tv, out, lse, tg, 0.2)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(FlashAttentionFunction.apply(*leaves, 0.2), leaves, tg)
    for name, ref, *outs in zip(("dq", "dk", "dv"), refs, plain, wrapper, auto):
        for o in outs:
            assert o.shape == ref.shape and o.is_contiguous(), name
            assert np.abs(o.numpy() - ref).max() <= TOL, name


@pytest.mark.parametrize("blocks", [(1024, 1024), (16, 16)], ids=["fused", "split"])
def test_backward_bf16_matches_pallas_interpret(blocks):
    """bf16: both round p to dO's dtype for dv and ds to k's/q's dtype for dq/dk
    and return bf16, so they agree to within one bf16 ulp of the gradient's
    magnitude (sums of fp32 products in another order can move a rounding)."""
    q, k, v = _qkv(11, 2, 36, 40, 2)
    g = np.random.RandomState(12).randn(2, 36, 2, 64).astype(np.float32)
    refs = _jax_grads(q, k, v, g, None, *blocks, dtype=jnp.bfloat16)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, g)]
    out, lse = flash_attention_lse_ref(*tb[:3])
    grads = flash_attention_bwd_ref(*tb[:3], out, lse, tb[3])
    for name, ref, got in zip(("dq", "dk", "dv"), refs, grads):
        assert got.dtype == torch.bfloat16, name
        err = np.abs(got.float().numpy() - ref)
        assert err.max() <= 2.0**-8 * np.abs(ref).max(), name


def test_function_takes_the_lse_path_only_with_grad():
    "flash_attention: the autograd Function when a gradient is needed, the plain forward otherwise."
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 12, 20, 2))
    assert flash_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_()
    out = flash_attention(qg, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    with torch.no_grad():
        assert flash_attention(qg, k, v).grad_fn is None
    (dq,) = torch.autograd.grad(out, qg, torch.ones_like(out))
    (ref,) = torch.autograd.grad(flash_attention_ref(qg, k, v), qg, torch.ones_like(out))
    assert (dq - ref).abs().max().item() <= 1e-6


# The tensor maps of the bf16 kernels (csrc/hopper.cuh): dims innermost first (D, H, N, B), the byte strides of
# H, N and B, and a box of one head's rows. The kernels cannot run here; what they are handed can.
@pytest.mark.parametrize("dtype,es", [(torch.bfloat16, 2), (torch.float32, 4)])
def test_tma_layout_qkv_view(dtype, es):
    "q/k/v as views of one (B, N, 3, H, D) projection: strided rows, no copy."
    x = torch.zeros(2, 196, 3, 12, 64, dtype=dtype)
    for i in range(3):
        assert tma_layout(x[:, :, i], 128) == (64, 12, 196, 2, 64 * es, 3 * 12 * 64 * es, 196 * 3 * 12 * 64 * es,
                                               64, 1, 128, 1)
    _check("flash_attention", x[:, :, 0], x[:, :, 1], x[:, :, 2])


def test_tma_layout_kv_view_and_contiguous():
    "k/v as views of a (B, N, 2, H, D) projection, q contiguous, and the boxes of both backward kernels."
    kv = torch.zeros(1, 1000, 2, 16, 64, dtype=torch.bfloat16)
    q = torch.zeros(1, 300, 16, 64, dtype=torch.bfloat16)
    assert tma_layout(kv[:, :, 1], BWD_LOOP_ROWS) == (64, 16, 1000, 1, 128, 2 * 16 * 128, 1000 * 2 * 16 * 128,
                                                      64, 1, 64, 1)
    assert tma_layout(q, BWD_OWN_ROWS) == (64, 16, 300, 1, 128, 16 * 128, 300 * 16 * 128, 64, 1, 128, 1)
    assert FWD_ROWS == BWD_OWN_ROWS == 2 * BWD_LOOP_ROWS == 128
    _check("flash_attention", q, kv[:, :, 0], kv[:, :, 1])


def test_tma_layout_size_one_dims_take_contiguous_strides():
    "A dim of size 1 is never stepped: its stride is the contiguous one, whatever the view holds (here 0)."
    q = torch.zeros(64, dtype=torch.bfloat16).as_strided((1, 1, 1, 64), (0, 0, 0, 1))
    assert tma_layout(q, 128) == (64, 1, 1, 1, 128, 128, 128, 64, 1, 128, 1)
    assert all(s % 16 == 0 for s in tma_layout(q, 128)[4:7])


@pytest.mark.parametrize("what", ["base", "n-stride", "h-stride", "b-stride"])
def test_check_refuses_what_a_tensor_map_cannot_take(what):
    "A base or a (b, n, h) byte stride that is not a multiple of 16 bytes is refused, with the reason."
    if what == "base":
        t = torch.zeros(2 * 8 * 2 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 8, 2, 64)  # 2-byte offset
    elif what == "n-stride":
        t = torch.zeros(2, 8, 2 * 64 + 1, dtype=torch.bfloat16)[..., :128].unflatten(-1, (2, 64))
    elif what == "h-stride":
        t = torch.zeros(2, 8, 2, 65, dtype=torch.bfloat16)[..., :64]
    else:
        t = torch.zeros(2 * 8 * 2 * 64 + 8, dtype=torch.bfloat16)
        t = t.as_strided((2, 8, 2, 64), (8 * 2 * 64 + 4, 2 * 64, 64, 1))
    assert any(s * 2 % 16 for s in t.stride()[:3]) or t.data_ptr() % 16
    ok = torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16)
    _check("flash_attention", ok, ok, ok)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check("flash_attention", t, ok, ok)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check("flash_attention", ok, ok, t)
