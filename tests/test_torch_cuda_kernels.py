"""
The port's CUDA kernels against their plain PyTorch versions on a GPU, at
small and ragged shapes (the main-path shapes run in chip_smoke.py): the
flash-attention forward (K1, with and without the logsumexp), its backward
(K3; the bf16 kernels also at the edges of their TMA boxes and ring, on every
q/k/v layout, and K3's determinism), RoPE2D (K2) forward and backward, gradients through attention layers
on the kernel path, the int8 matmul (K4), the int8 attention (K6), the
3x3 conv (K7) with its gradient, the fused qkv + RoPE + attention (K5, self
and cross, with its gradient) and the S.V diagnostic (K8, K1's kernel without
the softmax, at the same TMA and ring edges); K1 at the head dims 32, 80, 96,
128 and 512 at its TMA and ring edges and at the encoder zoo's and the Cosmos
tokenizer's shapes, a bf16 Cosmos encoder on K1 and K7 with exact launches, the raise of
K3, K5 and K6 at every head dim up to 256 (and D = 20, padded) with their raise
above it (K1 above 512, K8 at any D but 64), the new paths' shapes, and K2 on the patch tokens of a
DINOv3 projection (a strided view); K7 at the DPT-Large head's shapes over
DINOv2-L/14 at 518 and its 18 launches per head pass, K2 on the differential
attention's sub-heads and a differential block against the plain path with
exact launches; K1's fp32 kernel (3xTF32) at every padded head dim, the Cosmos
shape and the routing of D <= 16 to the CUDA-core kernel, with a dropped-tile
control, and K3's whole-width kernels above D = 64, bit for bit across two
calls; GPTQ (nn/gptq.py) on the card against its CPU float64 version, and a K4
forward on calibrated codes; K1 at the Cosmos video tokenizer's mid-block shapes
with a dropped-tile control, its 3D spatial attention block on one K1 launch,
and PE's masked attentions (the text tower's, the Llama Attention's causal one)
on no kernel. Every test here needs a CUDA device and skips without one.

On a machine with a GPU and without jax, run them without the repo's
conftest (which configures jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import time

import pytest
import torch

from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions
from uniception_tpu_torch.nn.blocks import Attention, CrossAttention
from uniception_tpu_torch.nn.common import LinearX
from uniception_tpu_torch.nn.dpt_parts import Conv2dTorch
from uniception_tpu_torch.nn.quant import Int8Linear
from uniception_tpu_torch.ops.attention import scaled_dot_product_attention
from uniception_tpu_torch.ops import fused_attention as fused
from uniception_tpu_torch.ops.conv3x3 import conv3x3_nhwc, conv3x3_plan, conv3x3_reference
from uniception_tpu_torch.ops.flash_attention import (
    F32_SMALL_HEAD_DIM,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_int8,
    flash_attention_int8_prep,
    flash_attention_int8_prep_ref,
    flash_attention_int8_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
    tf32_workspace_floats,
)
from uniception_tpu_torch.ops.gemm import K_BLOCK_BYTES, gemm_plan
from uniception_tpu_torch.ops.int8_matmul import int8_gemm, int8_matmul_dynamic, int8_matmul_dynamic_ref, quantize_rows
from uniception_tpu_torch.ops.rope import Rope2D, rope_2d, rope_2d_kernel
from uniception_tpu_torch.ops.sv_only import sv_only, sv_only_ref

pytestmark = pytest.mark.cuda

BF16_TOL = 2e-2  # max abs vs the plain version in fp32 from the same bf16 inputs
K6_ULPS, K6_ULP_FLOOR = 2, 1 / 64  # K6 vs its plain version, in bf16 ulps of max(|plain|, 1/64)
FP32_TOL = 2e-5
LSE_TOL = {torch.bfloat16: 1e-4, torch.float32: 1e-5}  # fp32 max and sum in another order, from the same inputs
# K3, max |kernel - plain| / max |plain| per gradient. bf16: p and ds rounded
# to bf16 before their products (2^-9 relative each) and bf16 outputs; fp32:
# sums over up to 1030 keys or queries in another order.
BWD_REL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
RAGGED = [(1, 1, 1, 1), (2, 7, 7, 3), (1, 63, 63, 2), (2, 65, 65, 2), (1, 129, 129, 2), (1, 1030, 1030, 2),
          (2, 7, 65, 3), (1, 129, 63, 2), (1, 200, 1030, 4)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the plain conv of K7's comparisons in full fp32
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,nq,nk,h", [(1, 1, 1, 1), (2, 7, 65, 3), (1, 129, 63, 2), (2, 64, 64, 2), (1, 200, 1030, 4)]
)
def test_flash_attention_matches_plain(gen, b, nq, nk, h, dtype):
    q = torch.randn(b, nq, 3, h, 64, device="cuda", generator=gen).to(dtype)[:, :, 0]
    kv = torch.randn(b, nk, 2, h, 64, device="cuda", generator=gen).to(dtype)
    k, v = kv[:, :, 0], kv[:, :, 1]
    out = flash_attention(q, k, v, 0.2)
    ref = flash_attention_ref(q.float(), k.float(), v.float(), 0.2)
    assert out.dtype == dtype and out.shape == (b, nq, h, 64) and out.is_contiguous()
    assert (out.float() - ref).abs().max().item() <= (BF16_TOL if dtype == torch.bfloat16 else FP32_TOL)


def test_flash_attention_rejects_what_it_does_not_take(gen):
    x = torch.randn(1, 8, 2, 520, device="cuda", generator=gen)  # D = 520: above the 512 K1 takes
    with pytest.raises(ValueError, match="head dim 520"):
        flash_attention(x, x, x)
    y = torch.randn(1, 8, 2, 128, device="cuda", generator=gen)[..., ::2]  # D = 64, stride 2
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention(y, y, y)
    z = torch.randn(1, 8, 2, 64, device="cuda", generator=gen).half()
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(z, z, z)


def test_dispatch_counts_kernel_launches(gen):
    q = torch.randn(2, 16, 2, 64, device="cuda", generator=gen)
    before = flash_attention.launches
    out = scaled_dot_product_attention(q, q, q)
    assert flash_attention.launches == before + 1
    prev = config.get_attention_impl()
    config.set_attention_impl("naive")
    try:
        ref = scaled_dot_product_attention(q, q, q)
    finally:
        config.set_attention_impl(prev)
    assert flash_attention.launches == before + 1
    assert (out - ref).abs().max().item() <= FP32_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,h,d", [(1, 5, 1, 16), (2, 37, 3, 64), (1, 10, 2, 128)])
def test_rope_matches_plain(gen, b, n, h, d, dtype):
    x = torch.randn(b, n, 3, h, d, device="cuda", generator=gen).to(dtype)[:, :, 1]
    pos = torch.randint(0, 40, (b, n, 2), device="cuda", generator=gen, dtype=torch.int32)
    out, ref = rope_2d_kernel(x, pos), rope_2d(x, pos)
    assert out.dtype == dtype and out.is_contiguous()
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() <= 1e-5
    else:
        ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(2.0**-126))) - 7)
        assert ((out.float() - ref.float()).abs() / ulp).max().item() <= 1


def test_rope_inverse_and_launch_count(gen):
    x = torch.randn(2, 64, 4, 64, device="cuda", generator=gen)
    pos = make_patch_positions(2, 8, 8, device="cuda")
    before = rope_2d_kernel.launches
    back = rope_2d_kernel(rope_2d_kernel(x, pos), pos, f0=-1.0)
    assert rope_2d_kernel.launches == before + 2
    assert (back - x).abs().max().item() <= 1e-5


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def _strided_qkv(gen, b, nq, nk, h, dtype):
    "q from a (B, Nq, 3, H, D) projection, k and v from a (B, Nk, 2, H, D) one: strided views, as the model makes them."
    q = torch.randn(b, nq, 3, h, 64, device="cuda", generator=gen).to(dtype)[:, :, 0]
    kv = torch.randn(b, nk, 2, h, 64, device="cuda", generator=gen).to(dtype)
    return q, kv[:, :, 0], kv[:, :, 1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nk,h", RAGGED)
def test_flash_attention_lse_matches_plain(gen, b, nq, nk, h, dtype):
    q, k, v = _strided_qkv(gen, b, nq, nk, h, dtype)
    lse_before = flash_attention.lse_launches
    out, lse = flash_attention_fwd(q, k, v, 0.2, with_lse=True)
    assert flash_attention.lse_launches == lse_before + 1
    no_lse, none = flash_attention_fwd(q, k, v, 0.2)
    assert none is None and flash_attention.lse_launches == lse_before + 1
    torch.testing.assert_close(out, no_lse, rtol=0, atol=0)  # the LSE write changes nothing else
    _, ref = flash_attention_lse_ref(q.float(), k.float(), v.float(), 0.2)
    assert lse.shape == (b, h, nq) and lse.dtype == torch.float32 and lse.is_contiguous()
    assert (lse - ref).abs().max().item() <= LSE_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nk,h", RAGGED)
def test_flash_attention_bwd_matches_plain(gen, b, nq, nk, h, dtype):
    q, k, v = _strided_qkv(gen, b, nq, nk, h, dtype)
    dout = torch.randn(b, nq, h, 64, device="cuda", generator=gen).to(dtype)
    out, lse = flash_attention_fwd(q, k, v, 0.2, with_lse=True)
    before = flash_attention_bwd.launches
    grads = flash_attention_bwd(q, k, v, out, lse, dout, 0.2)
    assert flash_attention_bwd.launches == before + 1
    f = [t.float() for t in (q, k, v, out, lse, dout)]
    refs = flash_attention_bwd_ref(*f, 0.2)
    # and autograd through the plain forward in fp32 from the same inputs
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    auto = torch.autograd.grad(flash_attention_ref(qf, kf, vf, 0.2), (qf, kf, vf), dout.float())
    for name, g, r, a, x in zip(("dq", "dk", "dv"), grads, refs, auto, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape and g.is_contiguous(), name
        assert torch.isfinite(g).all().item(), name
        if nk == 1 and name != "dv":  # a softmax over one key passes no gradient to q or k: both are rounding noise
            assert g.abs().max().item() <= 1e-5 and r.abs().max().item() <= 1e-5, name
            continue
        assert _rel(g, r) <= BWD_REL_TOL[dtype], (name, _rel(g, r))
        assert _rel(g, a) <= BWD_REL_TOL[dtype], (name, _rel(g, a))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_backward_through_autograd(gen, dtype):
    "flash_attention with grad: the LSE forward, then K3; a non-contiguous dO is taken."
    q, k, v = (t.detach().requires_grad_() for t in _strided_qkv(gen, 2, 65, 65, 2, dtype))
    fwd, lse_fwd, bwd = flash_attention.launches, flash_attention.lse_launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v)
    dout = torch.randn(2, 65, 64, 2, device="cuda", generator=gen).to(dtype).transpose(2, 3)  # non-contiguous
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    assert (flash_attention.launches, flash_attention.lse_launches, flash_attention_bwd.launches) == (
        fwd + 1, lse_fwd + 1, bwd + 1)
    refs = flash_attention_bwd_ref(*(t.detach().float() for t in (q, k, v, out)),
                                   flash_attention_lse_ref(q.float(), k.float(), v.float())[1], dout.float())
    for g, r in zip((dq, dk, dv), refs):
        assert _rel(g, r) <= BWD_REL_TOL[dtype]


def test_flash_attention_grad_rejects_what_it_does_not_take(gen):
    x = torch.randn(1, 8, 2, 264, device="cuda", generator=gen, requires_grad=True)  # K1 takes 264, K3 up to 256
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(x, x, x).sum().backward()
    y = torch.randn(1, 8, 2, 64, device="cuda", generator=gen)
    out, lse = flash_attention_fwd(y, y, y, with_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(y, y, y, out, lse[:, :, :4], out)


def _layout_qkv(gen, layout, nq, nk, h):
    """bf16 q, k, v at B = 1: views of (B, N, 3, H, D) projections ("qkv"), a contiguous q beside views of a
    (B, Nk, 2, H, D) k/v projection ("kv"), or three contiguous tensors."""
    def randn(*shape):
        return torch.randn(*shape, 64, device="cuda", generator=gen).bfloat16()

    if layout == "qkv":
        xq = randn(1, nq, 3, h)
        xkv = xq if nq == nk else randn(1, nk, 3, h)
        return xq[:, :, 0], xkv[:, :, 1], xkv[:, :, 2]
    if layout == "kv":
        kv = randn(1, nk, 2, h)
        return randn(1, nq, h), kv[:, :, 0], kv[:, :, 1]
    return randn(1, nq, h), randn(1, nk, h), randn(1, nk, h)


# The bf16 kernels' edges: one key or query, a ragged last 64- or 128-row TMA box, a ring of 2 slots that
# wraps several times (1000 and 1024 keys: 8 K/V tiles in K1, 16 in K3's dq pass), and every q/k/v layout.
@pytest.mark.parametrize("layout", ["qkv", "kv", "contiguous"])
@pytest.mark.parametrize("h", [12, 16])
@pytest.mark.parametrize("nq", [1, 300, 1024])
@pytest.mark.parametrize("nk", [1, 7, 196, 1000, 1024])
def test_bf16_kernels_at_tma_and_ring_edges(gen, nk, nq, h, layout):
    q, k, v = _layout_qkv(gen, layout, nq, nk, h)
    dout = torch.randn(1, nq, h, 64, device="cuda", generator=gen).bfloat16()
    out, lse = flash_attention_fwd(q, k, v, 0.125, with_lse=True)
    torch.testing.assert_close(out, flash_attention_fwd(q, k, v, 0.125)[0], rtol=0, atol=0)
    ref, lse_ref = flash_attention_lse_ref(q.float(), k.float(), v.float(), 0.125)
    assert (out.float() - ref).abs().max().item() <= BF16_TOL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL[torch.bfloat16]
    grads = flash_attention_bwd(q, k, v, out, lse, dout, 0.125)
    refs = flash_attention_bwd_ref(*(t.float() for t in (q, k, v, out, lse, dout)), 0.125)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert torch.isfinite(g).all().item(), name
        if nk == 1 and name != "dv":
            # A softmax over one key passes no gradient to q or k: both are rounding noise of dp - delta, summed
            # over up to 1024 queries for dk, so they are held to the bf16 bar at the scale of dv instead.
            bar = BWD_REL_TOL[torch.bfloat16] * refs[2].abs().max().item()
            assert g.float().abs().max().item() <= bar and r.abs().max().item() <= bar, name
            continue
        assert _rel(g, r) <= BWD_REL_TOL[torch.bfloat16], (name, _rel(g, r))


@pytest.mark.parametrize("b,nq,nk,h", [(2, 1024, 1024, 16), (1, 300, 1000, 12)])
def test_flash_attention_bwd_is_deterministic(gen, b, nq, nk, h):
    "K3 adds no atomics: two calls on the same inputs give the same bits."
    q, k, v = _strided_qkv(gen, b, nq, nk, h, torch.bfloat16)
    dout = torch.randn(b, nq, h, 64, device="cuda", generator=gen).bfloat16()
    out, lse = flash_attention_fwd(q, k, v, with_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, dout)
    second = flash_attention_bwd(q, k, v, out, lse, dout)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_backward_matches_plain(gen, dtype):
    x = torch.randn(2, 37, 3, 3, 64, device="cuda", generator=gen).to(dtype)[:, :, 1].requires_grad_()
    pos = torch.randint(0, 40, (2, 37, 2), device="cuda", generator=gen, dtype=torch.int32)
    g = torch.randn(2, 37, 3, 64, device="cuda", generator=gen).to(dtype)
    fwd, bwd = rope_2d_kernel.launches, rope_2d_kernel.backward_launches
    (grad,) = torch.autograd.grad(rope_2d_kernel(x, pos), x, g)
    assert (rope_2d_kernel.launches, rope_2d_kernel.backward_launches) == (fwd + 1, bwd + 1)
    (ref,) = torch.autograd.grad(rope_2d(x, pos), x, g)
    if dtype == torch.float32:
        assert (grad - ref).abs().max().item() <= 1e-5
    else:  # both take fp32 products of the same bf16 sin/cos and round once
        ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(2.0**-126))) - 7)
        assert ((grad.float() - ref.float()).abs() / ulp).max().item() <= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_layers_train_through_the_kernels(gen, dtype):
    """loss.backward() through the kernel path gives the qkv, projq, projk and
    projv weights gradients that match the plain path's (a kernel output
    without autograd would leave them at zero)."""
    torch.manual_seed(0)
    rope = Rope2D(100.0)
    self_attn = Attention(128, num_heads=2, qkv_bias=True, custom_positional_encoding=rope, device="cuda").to(dtype)
    cross = CrossAttention(128, num_heads=2, qkv_bias=True, custom_positional_encoding=rope, device="cuda").to(dtype)
    x = torch.randn(2, 48, 128, device="cuda", generator=gen).to(dtype)
    y = torch.randn(2, 80, 128, device="cuda", generator=gen).to(dtype)
    xpos, ypos = make_patch_positions(2, 6, 8, device="cuda"), make_patch_positions(2, 8, 10, device="cuda")

    def grads(impl):
        prev = config.get_attention_impl()
        config.set_attention_impl(impl)
        try:
            for m in (self_attn, cross):
                m.zero_grad(set_to_none=True)
            loss = cross(self_attn(x, xpos), y, y, xpos, ypos).float().square().mean()
            loss.backward()
        finally:
            config.set_attention_impl(prev)
        named = [("qkv", self_attn.qkv), ("projq", cross.projq), ("projk", cross.projk), ("projv", cross.projv)]
        return {n: m.weight.grad.float().clone() for n, m in named}

    bwd = flash_attention_bwd.launches
    kern = grads("kernel")
    assert flash_attention_bwd.launches == bwd + 2
    plain = grads("naive")
    assert flash_attention_bwd.launches == bwd + 2
    for name in kern:
        assert kern[name].abs().max().item() > 0, name
        rel = ((kern[name] - plain[name]).norm() / plain[name].norm()).item()
        assert rel <= (2e-2 if dtype == torch.bfloat16 else 1e-5), (name, rel)


def _ulps(out, ref, mantissa_bits, floor=2.0**-126):
    "Max |out - ref| in units of the last place of max(|ref|, floor) (bf16: 7 mantissa bits, fp32: 23)."
    ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(floor))) - mantissa_bits)
    return ((out.float() - ref.float()).abs() / ulp).max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,bias", [(300, 4096, 200, True), (129, 1024, 3080, False), (5, 48, 7, True)])
def test_int8_matmul_matches_plain(gen, m, k, n, bias, dtype):
    "K4 at M and N off the 128 tile: the same int8 codes and int32 sums as the plain version, so <= 1 ulp."
    x = torch.randn(3, m, k, device="cuda", generator=gen).to(dtype)
    w_q = torch.randint(-127, 128, (n, k), device="cuda", generator=gen, dtype=torch.int8).t()  # (K, N) view
    w_scale = torch.rand(1, n, device="cuda", generator=gen) * 1e-2 + 1e-4
    b = torch.randn(n, device="cuda", generator=gen) if bias else None
    before = int8_matmul_dynamic.launches
    out = int8_matmul_dynamic(x, w_q, w_scale, b)
    assert int8_matmul_dynamic.launches == before + 1
    ref = int8_matmul_dynamic_ref(x, w_q, w_scale, b)
    assert out.shape == (3, m, n) and out.dtype == dtype
    assert _ulps(out, ref, 7 if dtype == torch.bfloat16 else 23) <= 1
    # a contiguous (K, N) weight is taken too (copied to the kernel's layout)
    assert torch.equal(int8_matmul_dynamic(x, w_q.contiguous(), w_scale, b), out)


@pytest.mark.parametrize("k", [16, 48, 4096])
@pytest.mark.parametrize("n", [136, 768])
@pytest.mark.parametrize("m", [1, 127, 129])
def test_int8_gemm_at_every_plan(gen, m, n, k):
    """K4's GEMM at ragged M, N and K under every tile width and split of the K loop: each plan gives the bits of
    the planner's (int32 sums are exact in any order), two calls the same bits, and <= 1 ulp of the plain version."""
    x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
    w_nk = torch.randint(-127, 128, (n, k), device="cuda", generator=gen, dtype=torch.int8)
    w_scale = torch.rand(n, device="cuda", generator=gen) * 1e-2 + 1e-4
    b = torch.randn(n, device="cuda", generator=gen)
    out = int8_matmul_dynamic(x, w_nk.t(), w_scale, b)
    assert _ulps(out, int8_matmul_dynamic_ref(x, w_nk.t(), w_scale, b), 7) <= 1
    x_q, a_scale = quantize_rows(x)
    assert torch.equal(int8_gemm(x_q, a_scale, w_nk, w_scale, b, plan=gemm_plan(m, n, k, 1)), out)
    for bn in (128, 256):
        for split in range(1, -(-k // K_BLOCK_BYTES) + 1):
            got = int8_gemm(x_q, a_scale, w_nk, w_scale, b, plan=(bn, split))
            assert torch.equal(got, out), (bn, split)
            assert torch.equal(int8_gemm(x_q, a_scale, w_nk, w_scale, b, plan=(bn, split)), got), (bn, split)


@pytest.mark.parametrize("mode", ["int8", "int8pv"])
@pytest.mark.parametrize("b,nq,nk,h", [(2, 7, 1, 3), (2, 50, 36, 3), (1, 300, 1000, 2), (1, 1024, 1024, 2)])
def test_flash_attention_int8_matches_plain(gen, b, nq, nk, h, mode):
    q, k, v = _strided_qkv(gen, b, nq, nk, h, torch.bfloat16)
    before = flash_attention_int8.launches
    out = flash_attention_int8(q, k, v, mode=mode)
    assert flash_attention_int8.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (b, nq, h, 64) and out.is_contiguous()
    ref = flash_attention_int8_ref(q, k, v, mode=mode)
    # the same codes and the same fp32 products; the sums of p and P.V run in
    # another order before o is rounded to bf16: within K6_ULPS
    assert _ulps(out, ref, 7, floor=K6_ULP_FLOOR) <= K6_ULPS
    if nk > 1:
        exact = flash_attention_ref(q.float(), k.float(), v.float())
        rel = ((out.float() - exact).norm() / exact.norm()).item()
        rel_plain = ((ref.float() - exact).norm() / exact.norm()).item()
        assert rel < (2e-2 if mode == "int8" else 3e-2), rel  # the bound of the JAX package's test
        assert abs(rel - rel_plain) <= 1e-3, (rel, rel_plain)
        # controls: exact attention and the other int8 mode are told apart from the plain version
        other = flash_attention_int8_ref(q, k, v, mode="int8pv" if mode == "int8" else "int8")
        for control in (flash_attention_ref(q, k, v), other):
            assert _ulps(control, ref, 7, floor=K6_ULP_FLOOR) > K6_ULPS


def test_int8_attention_dispatch(gen):
    "The quant mode sends single-block inference calls to K6; fp32, gradients and Nk > 1024 stay on K1."
    q, k, v = _strided_qkv(gen, 1, 64, 64, 2, torch.bfloat16)
    q32 = q.float()
    long_k, long_v = (torch.randn(1, 1030, 2, 64, device="cuda", generator=gen).bfloat16() for _ in range(2))
    config.set_attention_quant("int8")
    try:
        k1, k6 = flash_attention.launches, flash_attention_int8.launches
        scaled_dot_product_attention(q, k, v)
        assert (flash_attention.launches, flash_attention_int8.launches) == (k1, k6 + 1)
        scaled_dot_product_attention(q32, q32, q32)
        scaled_dot_product_attention(q, long_k, long_v)
        qg = q.detach().clone().requires_grad_()
        scaled_dot_product_attention(qg, k, v)
        assert (flash_attention.launches, flash_attention_int8.launches) == (k1 + 3, k6 + 1)
    finally:
        config.set_attention_quant("none")


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("b,h,w,c,co", [(1, 13, 31, 128, 64), (2, 16, 16, 256, 256), (1, 5, 3, 64, 136)])
def test_conv3x3_matches_plain_and_its_gradient(gen, b, h, w, c, co, bias):
    x = torch.randn(b, h, w, c, device="cuda", generator=gen).bfloat16()
    wt = (torch.randn(3, 3, c, co, device="cuda", generator=gen) * 0.05).bfloat16()
    bb = torch.randn(co, device="cuda", generator=gen) if bias else None
    before = conv3x3_nhwc.launches
    out = conv3x3_nhwc(x, wt, bb)
    assert conv3x3_nhwc.launches == before + 1
    ref = conv3x3_reference(x, wt, bb)
    assert out.shape == (b, h, w, co) and out.dtype == torch.bfloat16
    # fp32 sums over 9 * C products in another order, then one bf16 rounding: 1 ulp, counted at
    # |ref| >= 1/16, since where the bias cancels the sum the order's error is relative to the terms
    assert _ulps(out, ref, 7, floor=1 / 16) <= 1
    # the gradient: the exact gradient of the plain conv, as the JAX custom VJP
    xs, ws = x.clone().requires_grad_(), wt.clone().requires_grad_()
    bs = bb.clone().requires_grad_() if bias else None
    g = torch.randn(b, h, w, co, device="cuda", generator=gen).bfloat16()
    got = torch.autograd.grad(conv3x3_nhwc(xs, ws, bs), [t for t in (xs, ws, bs) if t is not None], g)
    assert conv3x3_nhwc.launches == before + 2
    want = torch.autograd.grad(conv3x3_reference(xs, ws, bs), [t for t in (xs, ws, bs) if t is not None], g)
    for a, r in zip(got, want):
        assert a.dtype == r.dtype and _rel(a, r) <= 1e-2, _rel(a, r)


K7_SHAPES = [(32, 384, 256), (16, 768, 256), (16, 256, 256), (32, 256, 256), (64, 256, 256), (128, 256, 256),
             (256, 256, 128)]  # (H = W, C, Co) of the DPT head's eligible convs at 512, batch 2


def _conv_inputs(gen, b, h, w, c, co, bias_dtype=torch.float32):
    x = torch.randn(b, h, w, c, device="cuda", generator=gen).bfloat16()
    wt = (torch.randn(3, 3, c, co, device="cuda", generator=gen) * (9 * c) ** -0.5).bfloat16()
    bb = None if bias_dtype is None else (torch.randn(co, device="cuda", generator=gen) * 0.1).to(bias_dtype)
    return x, wt, bb


# K7's edges: images smaller than the output rectangle (1x1, 5x3, 13x31), H * W off the tile, C = 768 at 16^2,
# Co = 136 (a 128-wide tile past Co), a bf16 bias, and the K loop split or not.
@pytest.mark.parametrize("b,h,w,c,co,bias_dtype", [
    (1, 1, 1, 64, 128, torch.float32), (2, 5, 3, 128, 136, torch.bfloat16), (1, 13, 31, 256, 256, None),
    (2, 20, 24, 128, 128, torch.bfloat16), (2, 16, 16, 768, 256, torch.float32), (1, 9, 200, 64, 8, torch.float32),
])
def test_conv3x3_edges(gen, b, h, w, c, co, bias_dtype):
    x, wt, bb = _conv_inputs(gen, b, h, w, c, co, bias_dtype)
    out = conv3x3_nhwc(x, wt, bb)
    assert out.shape == (b, h, w, co) and out.dtype == torch.bfloat16 and out.is_contiguous()
    assert _ulps(out, conv3x3_reference(x, wt, bb), 7, floor=1 / 16) <= 1
    assert torch.equal(conv3x3_nhwc(x, wt, bb), out)  # deterministic, split or not


@pytest.mark.parametrize("hw,c,co", K7_SHAPES)
def test_conv3x3_at_every_dpt_plan(gen, hw, c, co):
    "The seven DPT shapes at batch 2, each with the tile and split the planner picks for it; two calls, one answer."
    plan = conv3x3_plan(2, hw, hw, c, co, torch.cuda.get_device_properties(0).multi_processor_count)
    x, wt, bb = _conv_inputs(gen, 2, hw, hw, c, co)
    out = conv3x3_nhwc(x, wt, bb)
    assert _ulps(out, conv3x3_reference(x, wt, bb), 7, floor=1 / 16) <= 1, plan
    assert torch.equal(conv3x3_nhwc(x, wt, bb), out), plan


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_call_launches_only_its_kernels(gen, bias_dtype):
    "A bf16 contiguous HWIO weight and a float32 or bf16 bias: one call launches K7's kernels and nothing else."
    from torch.profiler import ProfilerActivity, profile

    for hw, c, co in ((16, 256, 256), (128, 256, 256)):  # split (conv + reduction) and not
        x, wt, bb = _conv_inputs(gen, 2, hw, hw, c, co, bias_dtype)
        conv3x3_nhwc(x, wt, bb)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            conv3x3_nhwc(x, wt, bb)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        split = conv3x3_plan(2, hw, hw, c, co, torch.cuda.get_device_properties(0).multi_processor_count)[3]
        assert names and all("conv3x3" in n for n in names), names
        assert len(names) == (2 if split > 1 else 1), names


def _int8_qkv(gen, layout, b, nq, nk, h):
    "bf16 q, k, v in one of the layouts of _layout_qkv, at batch b."
    def randn(*shape):
        return torch.randn(*shape, 64, device="cuda", generator=gen).bfloat16()

    if layout == "qkv":
        xq = randn(b, nq, 3, h)
        xkv = xq if nq == nk else randn(b, nk, 3, h)
        return xq[:, :, 0], xkv[:, :, 1], xkv[:, :, 2]
    if layout == "kv":
        kv = randn(b, nk, 2, h)
        return randn(b, nq, h), kv[:, :, 0], kv[:, :, 1]
    return randn(b, nq, h), randn(b, nk, h), randn(b, nk, h)


# K6's edges: one key, a key tile and prep chunk ragged or full (63, 64, 65, 1000, 1024 keys), ragged query
# tiles, every q/k/v layout, both modes; its prep scratch is the plain prep's bit for bit, and two calls agree.
@pytest.mark.parametrize("layout", ["qkv", "kv", "contiguous"])
@pytest.mark.parametrize("mode", ["int8", "int8pv"])
@pytest.mark.parametrize("nq,nk", [(7, 1), (63, 63), (130, 64), (65, 65), (300, 1000), (1024, 1024)])
def test_flash_attention_int8_edges(gen, nq, nk, mode, layout):
    q, k, v = _int8_qkv(gen, layout, 2, nq, nk, 3)
    out = flash_attention_int8(q, k, v, mode=mode)
    assert out.shape == (2, nq, 3, 64) and out.dtype == torch.bfloat16 and out.is_contiguous()
    assert _ulps(out, flash_attention_int8_ref(q, k, v, mode=mode), 7, floor=K6_ULP_FLOOR) <= K6_ULPS
    assert torch.equal(flash_attention_int8(q, k, v, mode=mode), out)
    before = flash_attention_int8_prep.launches
    got = flash_attention_int8_prep(k, v, mode)
    assert flash_attention_int8_prep.launches == before + 1
    for name, a, r in zip(("k8", "kscale", "v8t", "vscale"), got, flash_attention_int8_prep_ref(k, v, mode)):
        assert (a is None) == (r is None) == (mode == "int8" and name in ("v8t", "vscale")), name
        if r is not None:
            assert a.dtype == r.dtype and torch.equal(a, r), name


def test_grouped_query_route_launches_k1(gen):
    "Grouped-query shapes: the key/value heads repeated to the query heads, then one K1 launch."
    q = torch.randn(2, 40, 8, 64, device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn(2, 40, 2, 64, device="cuda", generator=gen).bfloat16() for _ in range(2))
    before = flash_attention.launches
    out = scaled_dot_product_attention(q, k, v)
    assert flash_attention.launches == before + 1
    ref = flash_attention_ref(q.float(), k.float().repeat_interleave(4, dim=2), v.float().repeat_interleave(4, dim=2))
    assert (out.float() - ref).abs().max().item() <= BF16_TOL


def test_new_kernels_reject_what_they_do_not_take(gen):
    "On CUDA an input a kernel cannot take raises; nothing falls back to the plain version."
    x = torch.randn(4, 24, device="cuda", generator=gen)
    w_q = torch.zeros(24, 8, dtype=torch.int8, device="cuda")
    before = (int8_matmul_dynamic.launches, flash_attention_int8.launches, conv3x3_nhwc.launches)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_matmul_dynamic(x, w_q, torch.ones(8, device="cuda"))
    with pytest.raises(ValueError, match="dtypes"):
        int8_matmul_dynamic(torch.randn(4, 32, device="cuda").half(), torch.zeros(32, 8, dtype=torch.int8,
                            device="cuda"), torch.ones(8, device="cuda"))
    q = torch.randn(1, 8, 2, 64, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_int8(q, q, q)
    kb = torch.randn(1, 1025, 2, 64, device="cuda", generator=gen).bfloat16()
    with pytest.raises(ValueError, match="keys"):
        flash_attention_int8(q.bfloat16(), kb, kb)
    with pytest.raises(ValueError, match="head dim"):  # D = 264: above the 256 K6 takes
        flash_attention_int8(*(torch.randn(1, 8, 2, 264, device="cuda").bfloat16() for _ in range(3)))
    xc = torch.randn(1, 8, 8, 96, device="cuda", generator=gen).bfloat16()
    with pytest.raises(ValueError, match="multiple of 64"):
        conv3x3_nhwc(xc, torch.randn(3, 3, 96, 128, device="cuda").bfloat16())
    with pytest.raises(ValueError, match="bfloat16"):
        conv3x3_nhwc(xc.float()[..., :64], torch.randn(3, 3, 64, 128, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_nhwc(xc[..., :64], torch.randn(3, 3, 64, 128, device="cuda").bfloat16())
    assert (int8_matmul_dynamic.launches, flash_attention_int8.launches, conv3x3_nhwc.launches) == before


@pytest.mark.parametrize("mode", ["dynamic", "zero-point", "static"])
def test_int8_linear_on_cuda_matches_cpu(gen, mode):
    "The symmetric dynamic mode launches K4 (also at K < 4096); the zero-point and static modes take torch._int_mm."
    lin = LinearX(768, 200)
    q = Int8Linear.from_linear(lin, asym=mode == "zero-point")
    if mode == "static":
        q = Int8Linear(q.w_q.t(), q.w_scale, q.bias, a_scale=0.03)
    x = torch.randn(2, 9, 768, generator=torch.Generator().manual_seed(1)) * 2
    ref = q(x)  # the CPU: plain versions
    q = q.cuda()
    before = int8_matmul_dynamic.launches
    out = q(x.cuda())
    assert int8_matmul_dynamic.launches == before + (mode == "dynamic")
    assert out.shape == ref.shape and out.dtype == torch.float32
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-5)  # the same codes, int32 sums, fp32 epilogue


def test_dpt_conv_routing(gen):
    "Eligible bf16 3x3 convs take K7 (plain version under 'naive'); others, or the 'torch' impl, take the stock conv."
    conv = Conv2dTorch(128, 128, 3, 1, 1, dtype=torch.bfloat16, device="cuda").to(torch.bfloat16)
    narrow = Conv2dTorch(96, 128, 3, 1, 1, dtype=torch.bfloat16, device="cuda").to(torch.bfloat16)
    x = torch.randn(1, 128, 9, 11, device="cuda", generator=gen).bfloat16().contiguous(memory_format=torch.channels_last)
    x96 = torch.randn(1, 96, 9, 11, device="cuda", generator=gen).bfloat16()
    prev = config.get_conv3x3_impl()
    config.set_conv3x3_impl("kernel")
    try:
        before = conv3x3_nhwc.launches
        out = conv(x)
        narrow(x96)
        assert conv3x3_nhwc.launches == before + 1
        config.set_attention_impl("naive")
        try:
            plain = conv(x)
        finally:
            config.set_attention_impl("kernel")
        assert conv3x3_nhwc.launches == before + 1
    finally:
        config.set_conv3x3_impl(prev)
    stock = conv(x)
    assert conv3x3_nhwc.launches == before + 1
    assert out.shape == plain.shape == stock.shape == (1, 128, 9, 11)
    ref = conv3x3_reference(x.permute(0, 2, 3, 1), conv.weight.permute(2, 3, 1, 0), conv.bias).permute(0, 3, 1, 2)
    torch.testing.assert_close(plain, ref, rtol=0, atol=0)
    assert _ulps(out, plain, 7, floor=1 / 16) <= 1


# K5 against its plain version: bf16 in ulps of max(|plain|, 1/64); the tensor cores sum q.k in another order, so a p
# or a projected element may round to the other bf16 neighbour and move its row (chip_smoke.py states the
# measurement). fp32 as K1.
K5_ULPS, K5_ULP_FLOOR = 16, 1 / 64
K5_CASES = [  # (b, nq, nk (None: self), c, h, query grid, key grid)
    (2, 49, None, 128, 2, (7, 7), None), (1, 196, None, 192, 3, (14, 14), None), (2, 65, None, 64, 1, (5, 13), None),
    (2, 49, 80, 128, 2, (7, 7), (8, 10)), (1, 130, 36, 192, 3, (10, 13), (6, 6)),
]


def _k5_inputs(gen, b, nq, nk, c, h, qgrid, kgrid, dtype):
    "Seeded inputs; x a strided view (every other row of a wider tensor) and the biases fp32, as the modules pass them."
    hd = h * 64
    x = torch.randn(b, nq, 2 * c, device="cuda", generator=gen)[..., :c].to(dtype)
    w = (torch.randn(3 * hd, c, device="cuda", generator=gen) * c**-0.5).to(dtype)
    bias = torch.randn(3 * hd, device="cuda", generator=gen) * 0.1
    qpos = make_patch_positions(b, *qgrid, device="cuda")
    if nk is None:
        return (x, w, bias, qpos, h, 64**-0.5)
    xkv = torch.randn(b, nk, c, device="cuda", generator=gen).to(dtype)
    return (x, xkv, *w.chunk(3), *bias.chunk(3), qpos, make_patch_positions(b, *kgrid, device="cuda"), h, 64**-0.5)


def _k5_fns(nk):
    return ((fused.fused_qkv_rope_attention, fused.fused_qkv_rope_attention_ref) if nk is None else
            (fused.fused_cross_rope_attention, fused.fused_cross_rope_attention_ref))


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", K5_CASES)
def test_fused_attention_matches_plain(gen, case, dtype, rope):
    b, nq, nk, c, h = case[:5]
    args = list(_k5_inputs(gen, *case, dtype))
    if not rope:  # positions None
        args[3 if nk is None else 8] = None
        if nk is not None:
            args[9] = None
    kernel, plain = _k5_fns(nk)
    before = kernel.launches
    out = kernel(*args)
    assert kernel.launches == before + 1
    ref = plain(*args)
    assert out.shape == (b, nq, h * 64) and out.dtype == dtype and out.is_contiguous()
    if dtype == torch.bfloat16:
        assert _ulps(out, ref, 7, floor=K5_ULP_FLOOR) <= K5_ULPS
    else:
        assert (out - ref).abs().max().item() <= FP32_TOL
    if rope:  # the inverse rotation (-F0) is told apart from it
        wrong = kernel(*args, 100.0, -1.0)
        assert _ulps(wrong, ref, 7, floor=K5_ULP_FLOOR) > K5_ULPS


def _pair_ulps(out, ref, floor):
    "Max |out - ref| of RoPE'd (..., 64) heads in bf16 ulps of max(each (u, v) pair's norm in ref, floor)."
    r = ref.float().unflatten(-1, (2, 2, 16))  # [y / x half][u / v][quarter index]
    norm = r.square().sum(-2, keepdim=True).sqrt().expand_as(r).flatten(-3)
    ulp = (norm.clamp_min(floor).log2().floor() - 7).exp2()
    return ((out.float() - ref.float()).abs() / ulp).max().item()


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("c,h", [(768, 12), (1024, 16)])
@pytest.mark.parametrize("b,n,grid", [(4, 196, (14, 14)), (2, 300, (15, 20)), (1, 1000, (25, 40)), (1, 100, (10, 10))])
def test_fused_projection_scratch_matches_plain(gen, b, n, grid, c, h, rope, bias_dtype):
    """K5's projection launch (the shared wgmma GEMM with the bias + RoPE epilogue) against the plain projection,
    per section, at N = 196 (224 input), the cross shapes Nq 300 / Nk 1000 and 64 <= M < 128, with fp32 biases and
    with the bf16 biases of a bf16 model (read as they are): v within 1 ulp (one rounding of fp32 sums in another
    order), RoPE'd q and k within 2 ulps of the pair's norm."""
    hd = h * 64
    x = torch.randn(b, n, c, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(3 * hd, c, device="cuda", generator=gen) * c**-0.5).bfloat16()
    bias = (torch.randn(3 * hd, device="cuda", generator=gen) * 0.1).to(bias_dtype)
    pos = make_patch_positions(b, *grid, device="cuda") if rope else None
    got = fused._project(x, w.chunk(3), bias.chunk(3), pos, 2 if rope else 0, h, 100.0, 1.0)
    want = fused._project_ref(x, w.chunk(3), bias.chunk(3), pos, (rope, rope, False), h, 100.0, 1.0)
    assert got.shape == (3, b, h, n, 64)
    for name, g, w_ in zip("qkv", got, want):
        err = _pair_ulps(g.transpose(1, 2), w_, K5_ULP_FLOOR) if rope and name != "v" else _ulps(g.transpose(1, 2), w_, 7, K5_ULP_FLOOR)
        assert err <= (2 if rope and name != "v" else 1), (name, err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_attention_layers_train_through_the_kernels(gen, dtype):
    """Under "fused", loss.backward() through K5 (its backward: the unfused kernel path's recompute) gives the
    attention layers' weights and the inputs the gradients of the unfused kernel path."""
    torch.manual_seed(0)
    rope = Rope2D(100.0)
    self_attn = Attention(128, num_heads=2, qkv_bias=True, custom_positional_encoding=rope, device="cuda").to(dtype)
    cross = CrossAttention(128, num_heads=2, qkv_bias=True, custom_positional_encoding=rope, device="cuda").to(dtype)
    x = torch.randn(2, 48, 128, device="cuda", generator=gen).to(dtype)
    y = torch.randn(2, 80, 128, device="cuda", generator=gen).to(dtype)
    xpos, ypos = make_patch_positions(2, 6, 8, device="cuda"), make_patch_positions(2, 8, 10, device="cuda")

    def grads(impl):
        config.set_attention_impl(impl)
        try:
            for m in (self_attn, cross):
                m.zero_grad(set_to_none=True)
            xs, ys = x.clone().requires_grad_(), y.clone().requires_grad_()
            loss = cross(self_attn(xs, xpos), ys, ys, xpos, ypos).float().square().mean()
            loss.backward()
        finally:
            config.set_attention_impl("kernel")
        named = [("qkv", self_attn.qkv), ("projq", cross.projq), ("projk", cross.projk), ("projv", cross.projv)]
        out = {n: m.weight.grad.float().clone() for n, m in named}
        out.update(qkv_bias=self_attn.qkv.bias.grad.float().clone(), x=xs.grad.float(), y=ys.grad.float())
        return out

    k5 = (fused.fused_qkv_rope_attention.launches, fused.fused_cross_rope_attention.launches)
    bwd = flash_attention_bwd.launches
    got = grads("fused")
    assert (fused.fused_qkv_rope_attention.launches, fused.fused_cross_rope_attention.launches) == (k5[0] + 1, k5[1] + 1)
    assert flash_attention_bwd.launches == bwd + 2  # the recompute's backward through K3
    want = grads("kernel")
    for name in want:
        assert got[name].abs().max().item() > 0, name
        rel = ((got[name] - want[name]).norm() / want[name].norm()).item()
        assert rel <= (2e-2 if dtype == torch.bfloat16 else 1e-5), (name, rel)


def test_fused_attention_rejects_what_it_does_not_take(gen):
    "A CUDA call K5 cannot take raises; nothing falls back to the plain version."
    x = torch.randn(1, 16, 128, device="cuda", generator=gen)
    before = fused.fused_qkv_rope_attention.launches
    with pytest.raises(ValueError, match="head dim"):  # D = 264: above the 256 K5 takes
        fused.fused_qkv_rope_attention(x, torch.randn(792, 128, device="cuda"), None, None, 1, 0.2)
    with pytest.raises(ValueError, match="head dim"):  # D = 18: not a multiple of 4 (the RoPE quarters)
        fused.fused_qkv_rope_attention(x, torch.randn(216, 128, device="cuda"), None, None, 4, 0.2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused.fused_qkv_rope_attention(x.half(), torch.randn(384, 128, device="cuda").half(), None, None, 2, 0.2)
    with pytest.raises(ValueError, match="multiple of"):
        fused.fused_qkv_rope_attention(x[..., :126], torch.randn(384, 126, device="cuda"), None, None, 2, 0.2)
    assert fused.fused_qkv_rope_attention.launches == before


def _k8_errors(out, q, k, v):
    """K8's bar (chip_smoke.py phase 18): (ulps of max(|out|, 1) from two bf16 torch.matmul, whose tensor-core scores
    round to bf16 between them; ||out - plain|| / ||plain||, where a few IEEE fp32 scores round to the other bf16
    neighbour)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    tc = torch.matmul(torch.matmul(qt, kt.transpose(-1, -2)).float(), vt.float()).transpose(1, 2)
    ref = sv_only_ref(q, k, v).float()
    return _ulps(out, tc, 7, floor=1.0), ((out.float() - ref).norm() / ref.norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("b,nq,nk,h", [(2, 64, 64, 2), (1, 100, 1030, 3), (2, 7, 1, 1)])
def test_sv_only_matches_plain(gen, b, nq, nk, h):
    q, k, v = _strided_qkv(gen, b, nq, nk, h, torch.bfloat16)
    before = sv_only.launches
    out = sv_only(q, k, v)
    assert sv_only.launches == before + 1
    assert out.shape == (b, nq, h, 64) and out.dtype == torch.bfloat16 and out.is_contiguous()
    ulps, rel = _k8_errors(out, q, k, v)
    assert ulps <= 2 and rel <= 1e-3, (ulps, rel)
    with pytest.raises(ValueError, match="dtype"):
        sv_only(q.float(), k.float(), v.float())


# K8 (K1's kernel with the softmax compiled out) at K1's TMA and ring edges: one key, a ragged last 128-key box
# (63, 127, 129, 1000 keys), full ones (128, 1024), ragged query tiles, q/k/v as views of qkv projections or
# contiguous; 1000 and 1024 keys wrap the 3-slot ring twice.
@pytest.mark.parametrize("layout", ["qkv", "contiguous"])
@pytest.mark.parametrize("nq", [1, 130, 300])
@pytest.mark.parametrize("nk", [1, 63, 127, 128, 129, 1000, 1024])
def test_sv_only_at_tma_and_ring_edges(gen, nk, nq, layout):
    q, k, v = _layout_qkv(gen, layout, nq, nk, 12)
    out = sv_only(q, k, v)
    assert out.shape == (1, nq, 12, 64) and out.dtype == torch.bfloat16 and out.is_contiguous()
    ulps, rel = _k8_errors(out, q, k, v)
    assert ulps <= 2 and rel <= 1e-3, (ulps, rel)


@pytest.mark.parametrize("n", [1, 129, 1000])
def test_sv_only_reads_views_of_one_qkv_tensor(gen, n):
    "q, k, v as the strided views of one (B, N, 3, H, D) projection: the answer of contiguous copies, bit for bit."
    qkv = torch.randn(2, n, 3, 4, 64, device="cuda", generator=gen).bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = sv_only(q, k, v)
    assert torch.equal(out, sv_only(q.contiguous(), k.contiguous(), v.contiguous()))
    ulps, rel = _k8_errors(out, q, k, v)
    assert ulps <= 2 and rel <= 1e-3, (ulps, rel)


def test_sv_only_across_items_is_deterministic_with_one_launch(gen):
    """More work items than SMs (2 x 8 query tiles x 16 heads = 256), so each block's K/V ring phase carries from one
    item to the next; two calls give the same bits, and each call is one launch of K8's kernel and nothing else."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = _strided_qkv(gen, 2, 1024, 1000, 16, torch.bfloat16)
    before = sv_only.launches
    out = sv_only(q, k, v)
    assert sv_only.launches == before + 1
    ulps, rel = _k8_errors(out, q, k, v)
    assert ulps <= 2 and rel <= 1e-3, (ulps, rel)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = sv_only(q, k, v)
        torch.cuda.synchronize()
    assert torch.equal(again, out)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "fa_fwd_bf16_kernel<false, 64, 64>" in names[0], names


# The mixed-aspect serving shapes: the five DUSt3R-512 buckets (h, w) and their token counts per view.
BUCKETS_512 = [(384, 512), (336, 512), (288, 512), (256, 512), (160, 512)]


def _dpt_levels(h, w):
    "(H, W, C, Co) of the K7 convs of one DPT head pass on an h x w image (nn/dpt_parts.py Conv2dTorch's rule)."
    hp, wp = h // 16, w // 16
    h4, w4 = -(-hp // 2), -(-wp // 2)  # after the stride-2 conv
    return [(hp, wp, 384, 256), (h4, w4, 768, 256), (h4, w4, 256, 256), (hp, wp, 256, 256),
            (2 * hp, 2 * wp, 256, 256), (4 * hp, 4 * wp, 256, 256), (8 * hp, 8 * wp, 256, 128)]


@pytest.mark.parametrize("transposed", [False, True], ids=["canvas", "transposed"])
@pytest.mark.parametrize("bucket", BUCKETS_512, ids=lambda b: f"{b[0]}x{b[1]}")
def test_conv3x3_at_bucket_dpt_levels(gen, bucket, transposed):
    """K7 at every eligible DPT level of a bucket, and on the transposed grid of landscape_only's second head pass
    (W = 21, 42, 84, 11, 5, ... cut the planner's power-of-two tiles), batch 2, with the planner's plan."""
    h, w = bucket[::-1] if transposed else bucket
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for hh, ww, c, co in _dpt_levels(h, w):
        plan = conv3x3_plan(2, hh, ww, c, co, sms)
        x, wt, bb = _conv_inputs(gen, 2, hh, ww, c, co)
        out = conv3x3_nhwc(x, wt, bb)
        assert out.shape == (2, hh, ww, co)
        assert _ulps(out, conv3x3_reference(x, wt, bb), 7, floor=1 / 16) <= 1, (hh, ww, c, co, plan)
        assert torch.equal(conv3x3_nhwc(x, wt, bb), out), (hh, ww, c, co, plan)


@pytest.mark.parametrize("b,h", [(4, 16), (2, 12)], ids=["encoder", "decoder"])
@pytest.mark.parametrize("n", [320, 576, 672, 768])
def test_attention_kernels_at_bucket_token_counts(gen, n, b, h):
    "K1 (bf16) and K6 (both modes) at Nq = Nk of the buckets (672 = 5 * 128 + 32 and 320 = 2.5 * 128 keys)."
    q, k, v = _strided_qkv(gen, b, n, n, h, torch.bfloat16)
    out = flash_attention(q, k, v)
    assert (out.float() - flash_attention_ref(q.float(), k.float(), v.float())).abs().max().item() <= BF16_TOL
    for mode in ("int8", "int8pv"):
        out8 = flash_attention_int8(q, k, v, mode=mode)
        assert _ulps(out8, flash_attention_int8_ref(q, k, v, mode=mode), 7, floor=K6_ULP_FLOOR) <= K6_ULPS, mode


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_with_rows_of_different_positions(gen, dtype):
    "K2 with landscape_only's positions: landscape rows on the (hp, wp) grid, portrait rows on (wp, hp)."
    b, hp, wp, h = 4, 21, 32, 12
    x = torch.randn(b, hp * wp, 3, h, 64, device="cuda", generator=gen).to(dtype)[:, :, 0]
    is_land = torch.tensor([True, False, False, True], device="cuda")[:, None, None]
    pos = torch.where(is_land, make_patch_positions(b, hp, wp, device="cuda"), make_patch_positions(b, wp, hp, device="cuda"))
    assert not torch.equal(pos[0], pos[1])
    out, ref = rope_2d_kernel(x, pos), rope_2d(x, pos)
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() <= 1e-5
    else:
        assert _ulps(out, ref, 7) <= 1
    assert not torch.equal(out[1], rope_2d(x, make_patch_positions(b, hp, wp, device="cuda"))[1])


def test_prefetch_ring_delivers_every_batch_intact(gen):
    "The pinned two-slot ring and copy stream of data/pipeline.py: batches of changing shapes arrive whole, in order."
    import numpy as np

    from uniception_tpu_torch.data.pipeline import prefetch_to_device

    rng = np.random.RandomState(0)
    batches = [{"img": rng.randint(0, 256, (2, 8 + 4 * (i % 3), 16, 3), np.uint8), "rest": i} for i in range(9)]
    for got, want in zip(prefetch_to_device(iter(batches), "cuda"), batches):
        torch.cuda._sleep(200000)  # the consumer's work on the stream while the next batch is staged
        assert got["rest"] == want["rest"] and got["img"].is_cuda
        assert torch.equal(got["img"].cpu(), torch.from_numpy(want["img"]))


@pytest.mark.parametrize("landscape_only", [False, True])
def test_serving_forward_waits_for_no_queued_work(gen, landscape_only):
    """A serving forward with CPU true shapes (landscape and portrait rows) only enqueues work: behind a second of
    queued device time the host returns long before the card is done, so the host can prepare the next batch."""
    import numpy as np

    from uniception_tpu_torch import serve

    model = serve.build_model(64, 2, 128, 2, 2, 128, 2, device="cuda", seed=0, landscape_only=landscape_only)
    fn = serve.make_serving_fn(model, "cuda")
    frames = np.random.RandomState(0).randint(0, 256, (2, 32, 64, 3), np.uint8)
    ts = torch.tensor([[32, 64], [64, 32]], dtype=torch.int32)
    fn(frames, frames, ts, ts)  # warm-up: builds the kernels
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # about a second of queued work
    start = time.perf_counter()
    out = fn(frames, frames, ts, ts)
    host = time.perf_counter() - start
    torch.cuda.synchronize()
    waited = time.perf_counter() - start
    assert host < 0.3 < waited, (host, waited)
    assert all(torch.isfinite(o).all() for o in out)


# K1 over the multi-view global stream, in bf16 ulps of max(|plain|, 1/64): |o| is 0.02-0.3 over thousands of random
# keys, so the bar is relative (chip_smoke.py K1_MV_ULPS). The plain version without the keys of a lost tile, or of
# the ragged tail, must land at least K1_MV_CONTROL_ULPS away: the bar sees such a fault.
K1_MV_ULPS, K1_MV_ULP_FLOOR, K1_MV_CONTROL_ULPS = 8, 1 / 64, 32


@pytest.mark.parametrize("n,lost", [(4096, 128), (8192, 128), (3 * 1024 + 5, 5)],
                         ids=["4-views", "8-views", "3-views-5-global"])
def test_flash_attention_at_multiview_global_lengths(gen, n, lost):
    """K1 over the multi-view model's global stream (V * 1024 tokens of 512x512 views, 12 heads of the 768-wide
    info sharing), on strided views of one qkv tensor as the layers pass them; 3077 = 3 views and 5 global tokens."""
    q, k, v = _strided_qkv(gen, 1, n, n, 12, torch.bfloat16)
    ref = flash_attention_ref(q, k, v)
    assert _ulps(flash_attention(q, k, v), ref, 7, floor=K1_MV_ULP_FLOOR) <= K1_MV_ULPS
    control = flash_attention_ref(q, k[:, :n - lost], v[:, :n - lost])
    assert _ulps(control, ref, 7, floor=K1_MV_ULP_FLOOR) >= K1_MV_CONTROL_ULPS


@pytest.mark.parametrize("rung", ["bf16", "int8 attention", "fused"])
@pytest.mark.parametrize("attention_type", ["alternating", "global"])
def test_multiview_model_kernels_match_plain_with_exact_launches(gen, attention_type, rung):
    """A narrow multi-view model (3 views of 512x512: 1024 tokens per view, 3072 in the global stream; 2 encoder
    blocks, 4 info-sharing depths) against its plain path, with exact launches per forward: a global layer's 3072
    keys are past one int8 key block (1024) and past the fused contract (2048), so it stays on K1."""
    from uniception_tpu_torch import serve
    from uniception_tpu_torch.ops.fused_attention import fused_qkv_rope_attention

    model = serve.build_model(512, 2, 128, 2, 4, 192, 3, device="cuda", seed=0, model="multiview", num_views=3,
                              attention_type=attention_type)
    views = [torch.randn(1, 3, 512, 512, device="cuda", generator=gen) for _ in range(3)]
    glob = 4 if attention_type == "global" else 2
    want = {"bf16": (6, 4, 0, 0), "int8 attention": (glob, 4, 2 + 4 - glob, 0), "fused": (glob, 0, 0, 2 + 4 - glob)}
    counters = (flash_attention, rope_2d_kernel, flash_attention_int8, fused_qkv_rope_attention)

    def forward(impl):
        config.set_attention_impl(impl)
        config.set_attention_quant("int8" if rung == "int8 attention" else "none")
        try:
            before = [c.launches for c in counters]
            with torch.inference_mode():
                out = model(views)
            return out, tuple(c.launches - b for c, b in zip(counters, before))
        finally:
            config.set_attention_impl("kernel")
            config.set_attention_quant("none")

    plain, none = forward("naive")
    out, launches = forward("fused" if rung == "fused" else "kernel")
    assert none == (0, 0, 0, 0)
    assert launches == want[rung]
    for o, p in zip(out, plain):
        for key in ("pts3d", "conf"):
            assert torch.isfinite(o[key]).all()
            assert ((o[key] - p[key]).norm() / p[key].norm()).item() <= 2e-2, key


# K3, and K1 with its logsumexp, over the multi-view global stream, in bf16 ulps of max(|plain|, 1/64): set from a probe
# on an H100 (at most 3.74 ulps over dq, dk, dv; chip_smoke.py K3_MV_ULPS). The controls, the plain dq without the last
# 128 keys and the plain dk and dv without the last 128 queries, must land at least 4 bars away.
K3_MV_ULPS = 8


@pytest.mark.parametrize("n", [4096, 8192, 3 * 1024 + 5], ids=["4-views", "8-views", "3-views-5-global"])
def test_attention_backward_at_multiview_global_lengths(gen, n):
    q, k, v = _strided_qkv(gen, 1, n, n, 12, torch.bfloat16)
    dout = torch.randn(1, n, 12, 64, device="cuda", generator=gen).to(torch.bfloat16)
    out, lse = flash_attention_fwd(q, k, v, with_lse=True)
    qf, kf, vf, of, df = (t.float() for t in (q, k, v, out, dout))
    oref, lref = flash_attention_lse_ref(qf, kf, vf)
    assert _ulps(out, oref, 7, floor=K1_MV_ULP_FLOOR) <= K1_MV_ULPS
    assert (lse - lref).abs().max().item() <= LSE_TOL[torch.bfloat16]
    grads = flash_attention_bwd(q, k, v, out, lse, dout)
    refs = flash_attention_bwd_ref(qf, kf, vf, of, lse, df)
    o_c, l_c = flash_attention_lse_ref(qf, kf[:, :-128], vf[:, :-128])
    dq_c = flash_attention_bwd_ref(qf, kf[:, :-128], vf[:, :-128], o_c, l_c, df)[0]
    _, dk_c, dv_c = flash_attention_bwd_ref(qf[:, :-128], kf, vf, of[:, :-128], lse[..., :-128], df[:, :-128])
    for name, g, r, c in zip(("dq", "dk", "dv"), grads, refs, (dq_c, dk_c, dv_c)):
        assert _ulps(g, r, 7, floor=K1_MV_ULP_FLOOR) <= K3_MV_ULPS, name
        assert _ulps(c, r, 7, floor=K1_MV_ULP_FLOOR) >= 4 * K3_MV_ULPS, name


def test_narrow_dpt_lora_training_matches_plain_and_resumes(gen, tmp_path):
    """A narrow DUSt3R with bf16 DPT heads (K7 forward, cuDNN backward) and LoRA on the trunk: one step's loss and
    adapter gradients through the kernels against the plain path at chip_smoke.py's bf16 training bars; then the
    trainer's save and --resume on the card (LoRA, linear head), bit for bit the uninterrupted run."""
    from uniception_tpu_torch import train
    from uniception_tpu_torch.models.factory.dust3r import DUSt3R
    from uniception_tpu_torch.nn.lora import apply_lora, lora_trainable
    from uniception_tpu_torch.parallel import training

    model = DUSt3R(name="t", img_size=(64, 64), pred_head_type="dpt", enc_embed_dim=128, enc_depth=2, enc_num_heads=2,
                   info_sharing_dim=128, info_sharing_depth=2, info_sharing_num_heads=2, head_gradient_checkpointing=True,
                   head_dtype=torch.bfloat16, dtype=torch.bfloat16, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(0))
    for part in (model.encoder, model.info_sharing):
        apply_lora(part, 4, generator=torch.Generator(device="cuda").manual_seed(1), min_params=1)
    for m in model.modules():  # non-zero adapters: the first gradients reach lora_a too
        if hasattr(m, "lora_b"):
            with torch.no_grad():
                m.lora_b.normal_(0, 0.05, generator=gen)
    img1, img2 = (torch.randn(2, 3, 64, 64, device="cuda", generator=gen) for _ in range(2))
    t1, t2 = (torch.randn(2, 64, 64, 3, device="cuda", generator=gen) for _ in range(2))
    named = [(n, p) for n, p in model.named_parameters() if lora_trainable(n)]

    def grads(impl):
        config.set_attention_impl(impl)
        config.set_conv3x3_impl("kernel")
        try:
            before = conv3x3_nhwc.launches
            r1, r2 = model.forward_pair(img1, img2)
            loss = training.dust3r_confidence_loss(r1, r2, t1, t2)
            gs = torch.autograd.grad(loss, [p for _, p in named])
            return loss.item(), torch.cat([g.float().flatten() for g in gs]), conv3x3_nhwc.launches - before
        finally:
            config.set_attention_impl("kernel")
            config.set_conv3x3_impl("torch")

    lk, gk, k7 = grads("kernel")
    ln, gn, none = grads("naive")
    assert k7 > 0 and none == 0
    assert torch.isfinite(gk).all() and abs(lk - ln) / abs(ln) <= 2e-3
    assert ((gk - gn).norm() / gn.norm()).item() <= 2e-2

    # the linear head: the DPT head's bilinear upsampling adds its gradient with atomics on the card (see PERF.md)
    flags = ["--device", "cuda", "--img", "64", "--embed-dim", "128", "--heads", "2", "--depth", "2", "--batch", "2",
             "--dataset-size", "4", "--lora", "4", "--bf16", "--warmup-cosine", "1", "--mu-bf16"]
    whole, part = str(tmp_path / "whole"), str(tmp_path / "part")
    ref = train.main(flags + ["--steps", "4", "--ckpt-dir", whole])
    first = train.main(flags + ["--steps", "2", "--ckpt-every", "1", "--ckpt-dir", part])
    second = train.main(flags + ["--steps", "2", "--resume", "--ckpt-dir", part])
    assert first + second == ref
    a, b = (torch.load(f"{d}/{training.STATE_FILE}", weights_only=True) for d in (whole, part))
    assert a["count"] == b["count"] == 4 and all(torch.equal(v, b["tensors"][k]) for k, v in a["tensors"].items())


def test_dpt_training_resumes_bit_for_bit_under_deterministic_algorithms(gen, tmp_path):
    """The DPT heads' bilinear upsampling and cuDNN's fp32 conv gradients add with atomics by default, so DPT
    training on the card repeats only under torch.use_deterministic_algorithms: there save and --resume equal the
    uninterrupted run bit for bit."""
    from uniception_tpu_torch import train
    from uniception_tpu_torch.parallel import training

    flags = ["--device", "cuda", "--img", "64", "--embed-dim", "128", "--heads", "2", "--depth", "2", "--batch", "2",
             "--dataset-size", "4", "--head", "dpt", "--bf16", "--mu-bf16"]
    whole, part = str(tmp_path / "whole"), str(tmp_path / "part")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = train.main(flags + ["--steps", "4", "--ckpt-dir", whole])
        first = train.main(flags + ["--steps", "2", "--ckpt-dir", part])
        second = train.main(flags + ["--steps", "2", "--resume", "--ckpt-dir", part])
    finally:
        torch.use_deterministic_algorithms(False)
    assert first + second == ref
    a, b = (torch.load(f"{d}/{training.STATE_FILE}", weights_only=True) for d in (whole, part))
    assert all(torch.equal(v, b["tensors"][k]) for k, v in a["tensors"].items())


# K1 at the DINOv2 paths' key counts, none a multiple of its 128-key tile (37 x 37 patches + cls + 4 registers at
# 518; 32 x 32 + 5 for DUNE at 448; two 518 views in the surgery's global stream), in bf16 ulps as at the multi-view
# lengths. The control drops the ragged last tile's keys (the TMA's zero-filled tile): the bar must see them.
@pytest.mark.parametrize("b,n,h", [(2, 1374, 16), (1, 1374, 24), (2, 1029, 12), (1, 2738, 16)],
                         ids=["dinov2-L-518", "vit-g-518", "dune-448", "surgery-2-views"])
def test_flash_attention_at_dinov2_ragged_lengths(gen, b, n, h):
    q, k, v = _strided_qkv(gen, b, n, n, h, torch.bfloat16)
    ref = flash_attention_ref(q, k, v)
    assert _ulps(flash_attention(q, k, v), ref, 7, floor=K1_MV_ULP_FLOOR) <= K1_MV_ULPS
    control = flash_attention_ref(q, k[:, :n - n % 128], v[:, :n - n % 128])
    assert _ulps(control, ref, 7, floor=K1_MV_ULP_FLOOR) >= K1_MV_CONTROL_ULPS


@pytest.mark.parametrize("h", [16, 6])
def test_fused_attention_without_rope_with_qkv_bias_at_dinov2_length(gen, h):
    "K5 as DINOv2's attention runs it under \"fused\": no RoPE, a qkv bias, N = 1374 (ViT-L: C 1024; ViT-S: C 384)."
    n, c = 1374, 64 * h
    x = torch.randn(2, n, c, device="cuda", generator=gen).to(torch.bfloat16)
    w = (torch.randn(3 * c, c, device="cuda", generator=gen) * c**-0.5).to(torch.bfloat16)
    bias = torch.randn(3 * c, device="cuda", generator=gen) * 0.1
    before = fused.fused_qkv_rope_attention.launches
    out = fused.fused_qkv_rope_attention(x, w, bias, None, h, 64**-0.5)
    assert fused.fused_qkv_rope_attention.launches == before + 1
    ref = fused.fused_qkv_rope_attention_ref(x, w, bias, None, h, 64**-0.5)
    assert out.shape == (2, n, c) and _ulps(out, ref, 7, floor=K5_ULP_FLOOR) <= K5_ULPS
    no_bias = fused.fused_qkv_rope_attention_ref(x, w, None, None, h, 64**-0.5)  # the bias must be seen
    assert _ulps(no_bias, ref, 7, floor=K5_ULP_FLOOR) > K5_ULPS


@pytest.mark.parametrize("rung", ["kernel", "fused", "qk-norm fused"])
def test_dinov2_small_reg_518_kernels_match_plain_with_exact_launches(gen, rung):
    """DINOv2-S with registers at 518 (12 blocks, 1374 tokens), bf16, through encoder_factory, against its plain
    path with exact launches per forward: K1 on every layer; under "fused" K5 on every layer; with qk-norm on q and
    k (a LayerNorm per head) "fused" cannot take the layers, so they stay on K1 and no K5 launches."""
    from uniception_tpu_torch.models.encoders import ViTEncoderInput, encoder_factory
    from uniception_tpu_torch.nn.blocks import make_norm_layer
    from uniception_tpu_torch.ops.fused_attention import fused_qkv_rope_attention

    enc = encoder_factory("dinov2", name="dinov2_small", size="small", with_registers=True, dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16).eval()
    if rung == "qk-norm fused":
        for blk in enc.model.blocks:
            blk.attn.q_norm = make_norm_layer(64, device="cuda", dtype=torch.bfloat16).to(torch.bfloat16)
            blk.attn.k_norm = make_norm_layer(64, device="cuda", dtype=torch.bfloat16).to(torch.bfloat16)
    inp = ViTEncoderInput(image=torch.randn(2, 3, 518, 518, device="cuda", generator=gen), data_norm_type="dinov2")
    counters = (flash_attention, fused_qkv_rope_attention)

    def forward(impl):
        config.set_attention_impl(impl)
        try:
            before = [c.launches for c in counters]
            with torch.inference_mode():
                out = enc(inp)
            return out, tuple(c.launches - b for c, b in zip(counters, before))
        finally:
            config.set_attention_impl("kernel")

    plain, none = forward("naive")
    out, launches = forward("kernel" if rung == "kernel" else "fused")
    assert none == (0, 0)
    assert launches == ((0, 12) if rung == "fused" else (12, 0))
    assert out.features.shape == (2, 384, 37, 37) and out.registers.shape == (2, 384, 5)
    for o, p in ((out.features, plain.features), (out.registers, plain.registers)):
        assert torch.isfinite(o).all()
        assert ((o.float() - p.float()).norm() / p.float().norm()).item() <= 2e-2


# K1 at the head dims of the encoder zoo (32: E-RADIO; 80: RADIO-h, Pixio-H; 96: PE-G, Pixio-5B; 128: DINOv3-7b),
# in bf16 ulps of max(|plain|, 1/64) (chip_smoke.py phase 34), fp32 by ||kernel - plain|| / ||plain||.
K1_ULPS, K1_ULP_FLOOR, K1_FP32_REL = 8, 1 / 64, 2e-6
NEW_HEAD_DIMS = [32, 80, 96, 128]
# (Nq, Nk) at the edges of K1's 128-row TMA boxes and its ring (1033 keys: 9 tiles, the last of 9 keys)
K1_EDGES = [(1, 1), (127, 129), (128, 128), (129, 127), (1, 1033), (1033, 1033)]
# (B, N, H, D) of the zoo's attention: RADIO-h at 512, PE-G14 at 448, DINOv3-7b at 512, E-RADIO's windows at 512,
# Pixio-H at 256
ZOO_SHAPES = [(2, 1033, 16, 80), (2, 1025, 16, 96), (1, 1029, 32, 128), (2, 1024, 12, 32), (2, 256, 24, 32),
              (2, 264, 16, 80)]


def _k1_against_plain(q, k, v, with_lse):
    out, lse = flash_attention_fwd(q, k, v, with_lse=with_lse)
    ref, ref_lse = flash_attention_lse_ref(q, k, v)
    assert out.dtype == q.dtype and out.shape == q.shape and out.is_contiguous()
    assert torch.isfinite(out).all()
    if q.dtype == torch.bfloat16:
        assert _ulps(out, ref, 7, floor=K1_ULP_FLOOR) <= K1_ULPS
    else:
        assert ((out - ref).norm() / ref.norm()).item() <= K1_FP32_REL
    if with_lse:
        assert (lse - ref_lse).abs().max().item() <= LSE_TOL[q.dtype]
    else:
        assert lse is None


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq,nk", K1_EDGES)
@pytest.mark.parametrize("d", NEW_HEAD_DIMS)
def test_flash_attention_head_dims_at_tma_and_ring_edges(gen, d, nq, nk, dtype, with_lse):
    "q as a view of a (B, N, 3, H, D) projection, k and v of a (B, N, 2, H, D) one: K1 reads them by stride."
    q = torch.randn(2, nq, 3, 3, d, device="cuda", generator=gen).to(dtype)[:, :, 0]
    kv = torch.randn(2, nk, 2, 3, d, device="cuda", generator=gen).to(dtype)
    _k1_against_plain(q, kv[:, :, 0], kv[:, :, 1], with_lse)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,h,d", ZOO_SHAPES)
def test_flash_attention_at_the_zoo_shapes(gen, b, n, h, d, dtype, with_lse):
    qkv = torch.randn(b, n, 3, h, d, device="cuda", generator=gen).to(dtype)
    before = flash_attention.launches
    _k1_against_plain(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], with_lse)
    assert flash_attention.launches == before + 1


def test_the_other_attention_kernels_raise_at_head_dims_other_than_64(gen):
    """K3 (the backward), K5 (fused) and K6 (int8) take D = 80 now: each launches once and matches its plain version.
    Above the head dims they take (K3, K5 and K6 256, K1 512) and for K8 (S.V, 64 only) each raises, naming the ROADMAP
    item that would add the head dim, and launches nothing."""
    x = torch.randn(1, 40, 2, 80, device="cuda", generator=gen).bfloat16()
    counters = (flash_attention, flash_attention_bwd, flash_attention_int8, fused.fused_qkv_rope_attention, sv_only)
    before = [c.launches for c in counters]
    out, lse = flash_attention_fwd(x, x, x, with_lse=True)
    grads = flash_attention_bwd(x, x, x, out, lse, out)
    refs = flash_attention_bwd_ref(*(t.float() for t in (x, x, x, out, lse, out)))
    assert all(_rel(g, r) <= BWD_REL_TOL[torch.bfloat16] for g, r in zip(grads, refs))
    ref8 = flash_attention_int8_ref(x, x, x)
    assert _ulps(flash_attention_int8(x, x, x), ref8, 7, floor=K6_ULP_FLOOR) <= K6_ULPS
    xs = torch.randn(1, 40, 160, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(480, 160, device="cuda", generator=gen) * 160**-0.5).bfloat16()
    k5 = fused.fused_qkv_rope_attention(xs, w, None, None, 2, 0.1)
    assert _ulps(k5, fused.fused_qkv_rope_attention_ref(xs, w, None, None, 2, 0.1), 7, floor=1 / 64) <= 16
    assert [c.launches for c in counters] == [b + n for b, n in zip(before, (1, 1, 1, 1, 0))]
    before = [c.launches for c in counters]
    y = torch.randn(1, 40, 2, 264, device="cuda", generator=gen).bfloat16()
    out, lse = flash_attention_fwd(y, y, y, with_lse=True)  # K1 takes 264
    with pytest.raises(ValueError, match="head dim 264 .*ROADMAP queue 2 item a"):
        flash_attention_bwd(y, y, y, out, lse, out)
    leaf = y.clone().requires_grad_()
    with pytest.raises(ValueError, match="ROADMAP queue 2 item a"):
        flash_attention(leaf, leaf, leaf).sum().backward()
    with pytest.raises(ValueError, match="head dim 264 .*ROADMAP queue 2 item a"):
        flash_attention_int8(y, y, y)
    with pytest.raises(ValueError, match="head dim 80 .*ROADMAP queue 2 item a"):
        sv_only(x, x, x)
    ys = torch.randn(1, 40, 528, device="cuda", generator=gen).bfloat16()
    with pytest.raises(ValueError, match="head dim 264 .*ROADMAP queue 2 item a"):
        fused.fused_qkv_rope_attention(ys, torch.randn(1584, 528, device="cuda").bfloat16(), None, None, 2, 0.1)
    z = torch.randn(1, 40, 1, 520, device="cuda", generator=gen).bfloat16()
    with pytest.raises(ValueError, match="head dim 520 .*ROADMAP queue 2 item a"):
        flash_attention_fwd(z, z, z)
    assert [c.launches for c in counters] == [b + n for b, n in zip(before, (2, 0, 0, 0, 0))]


# Every head dim the Pallas kernels take (chip_smoke.py phase 41): each kernel against its plain version at each padded
# head dim it is built for and at D = 20 (not a multiple of 8: padded into a copy), Nq != Nk with ragged tiles.
K1_ANY_D = [8, 20, 48, 72, 136, 200, 264]  # DP 64, 64, 64, 128, 192, 256, 512
K3_ANY_D = [20, 48, 80, 136, 200]  # DP 64, 64, 128, 192, 256
K6_ANY_D = [20, 48, 136, 200]  # int8 rows of 64, 64, 256, 256 bytes
K5_ANY_D = [20, 48, 80, 136, 200]  # padded heads of 32, 64, 128, 256, 256 columns
# Hundreds of keys, where K1's bar holds: at 70 keys an exact fp32 emulation of K1's online softmax over the 64-key
# tiles of its column-split kernel is itself 10.5-10.8 bf16 ulps from the plain version (chip_smoke.py HD_SHAPES).
ANY_D_SHAPES = [(2, 200, 520, 2), (1, 130, 700, 3)]


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nk,h", ANY_D_SHAPES)
@pytest.mark.parametrize("d", K1_ANY_D)
def test_flash_attention_at_any_head_dim(gen, d, b, nq, nk, h, dtype, with_lse):
    q = torch.randn(b, nq, 3, h, d, device="cuda", generator=gen).to(dtype)[:, :, 0]
    kv = torch.randn(b, nk, 2, h, d, device="cuda", generator=gen).to(dtype)
    before = flash_attention.head_dims[d]
    _k1_against_plain(q, kv[:, :, 0], kv[:, :, 1], with_lse)
    assert flash_attention.head_dims[d] == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nk,h", ANY_D_SHAPES)
@pytest.mark.parametrize("d", K3_ANY_D)
def test_flash_attention_backward_at_any_head_dim(gen, d, b, nq, nk, h, dtype):
    q = torch.randn(b, nq, h, d, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(b, nk, h, d, device="cuda", generator=gen).to(dtype) for _ in range(2))
    dout = torch.randn(b, nq, h, d, device="cuda", generator=gen).to(dtype)
    out, lse = flash_attention_fwd(q, k, v, with_lse=True)
    grads = flash_attention_bwd(q, k, v, out, lse, dout)
    refs = flash_attention_bwd_ref(*(t.float() for t in (q, k, v, out, lse, dout)))
    for g, r in zip(grads, refs):
        assert g.shape == r.shape and g.dtype == dtype and g.is_contiguous()
        assert _rel(g, r) <= BWD_REL_TOL[dtype]


@pytest.mark.parametrize("mode", ["int8", "int8pv"])
@pytest.mark.parametrize("b,nq,nk,h", ANY_D_SHAPES)
@pytest.mark.parametrize("d", K6_ANY_D)
def test_int8_attention_at_any_head_dim(gen, d, b, nq, nk, h, mode):
    q = torch.randn(b, nq, h, d, device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn(b, nk, h, d, device="cuda", generator=gen).bfloat16() for _ in range(2))
    for got, want in zip(flash_attention_int8_prep(k, v, mode), flash_attention_int8_prep_ref(k, v, mode)):
        assert (got is None and want is None) or torch.equal(got, want)
    out = flash_attention_int8(q, k, v, mode=mode)
    assert out.shape == q.shape and _ulps(out, flash_attention_int8_ref(q, k, v, mode=mode), 7,
                                          floor=K6_ULP_FLOOR) <= K6_ULPS


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("d", K5_ANY_D)
def test_fused_attention_at_any_head_dim(gen, d, rope, dtype):
    H, C, grid = max(1, 400 // d), 256, (20, 20)  # 400 tokens: hundreds of keys, as ANY_D_SHAPES
    x = torch.randn(2, 400, C, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(3 * H * d, C, device="cuda", generator=gen) * C**-0.5).to(dtype)
    b = torch.randn(3 * H * d, device="cuda", generator=gen) * 0.1
    pos = make_patch_positions(2, *grid, device="cuda") if rope else None
    out = fused.fused_qkv_rope_attention(x, w, b, pos, H, d**-0.5)
    ref = fused.fused_qkv_rope_attention_ref(x, w, b, pos, H, d**-0.5)
    assert out.shape == ref.shape == (2, 400, H * d)
    if dtype == torch.bfloat16:
        assert _ulps(out, ref, 7, floor=1 / 64) <= 16
    else:
        assert (out - ref).abs().max().item() <= FP32_TOL
    xkv = torch.randn(2, 64, C, device="cuda", generator=gen).to(dtype)
    kpos = make_patch_positions(2, 8, 8, device="cuda") if rope else None
    args = (x, xkv, *w.chunk(3), *b.chunk(3), pos, kpos, H, d**-0.5)
    out, ref = fused.fused_cross_rope_attention(*args), fused.fused_cross_rope_attention_ref(*args)
    if dtype == torch.bfloat16:
        assert _ulps(out, ref, 7, floor=1 / 64) <= 16
    else:
        assert (out - ref).abs().max().item() <= FP32_TOL


# The new paths' exact shapes (chip_smoke.py phases 42-46): K3 under training at the JAX example's defaults (16 images of
# 4 tokens, 4 heads of 16) and at ViT-L 512 with 8 and 32 heads; K5 in RADIO-h at 512 and Pixio-H at 256 (16 heads of
# 80, C = 1280); K6 in Pixio-H, E-RADIO's windows and the differential info sharing's self-attention; K1 in PE-G14's
# attention pool (one query, 8 heads of 192).
@pytest.mark.parametrize("b,n,h,d", [(16, 4, 4, 16), (4, 1024, 8, 128), (4, 1024, 32, 32)])
def test_flash_attention_backward_at_the_training_paths(gen, b, n, h, d):
    q, k, v, dout = (torch.randn(b, n, h, d, device="cuda", generator=gen).bfloat16() for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v, with_lse=True)
    for g, r in zip(flash_attention_bwd(q, k, v, out, lse, dout),
                    flash_attention_bwd_ref(*(t.float() for t in (q, k, v, out, lse, dout)))):
        assert _rel(g, r) <= BWD_REL_TOL[torch.bfloat16]


@pytest.mark.parametrize("n", [1033, 264])
def test_fused_attention_at_the_zoo_paths(gen, n):
    x = torch.randn(2, n, 1280, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(3 * 1280, 1280, device="cuda", generator=gen) * 1280**-0.5).bfloat16()
    b = torch.randn(3 * 1280, device="cuda", generator=gen) * 0.1
    out = fused.fused_qkv_rope_attention(x, w, b, None, 16, 80**-0.5)
    assert _ulps(out, fused.fused_qkv_rope_attention_ref(x, w, b, None, 16, 80**-0.5), 7, floor=1 / 64) <= 16


@pytest.mark.parametrize("b,n,h,d", [(2, 264, 16, 80), (2, 1024, 12, 32), (2, 256, 24, 32), (2, 1024, 6, 128)])
def test_int8_attention_at_the_zoo_paths(gen, b, n, h, d):
    qkv = torch.randn(b, n, 3, h, d, device="cuda", generator=gen).bfloat16()
    q, k, v = qkv.unbind(2)
    for mode in ("int8", "int8pv"):
        out = flash_attention_int8(q, k, v, mode=mode)
        assert _ulps(out, flash_attention_int8_ref(q, k, v, mode=mode), 7, floor=K6_ULP_FLOOR) <= K6_ULPS


def test_flash_attention_at_the_pe_attention_pool(gen):
    q = torch.randn(2, 1, 8, 192, device="cuda", generator=gen).bfloat16()
    kv = torch.randn(2, 1025, 2, 8, 192, device="cuda", generator=gen).bfloat16()
    _k1_against_plain(q, kv[:, :, 0], kv[:, :, 1], False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
def test_rope_on_the_patch_tokens_of_a_projection(gen, d, dtype):
    """DINOv3's RoPE: K2 on q[:, 5:], a strided view of a (B, N, 3, H, D) projection past the cls and storage
    tokens, as the plain version on a contiguous copy (test_rope_matches_plain's bars); the prefix unchanged."""
    from uniception_tpu_torch.models.encoders.dinov3 import PrefixedRope2D

    qkv = torch.randn(2, 5 + 64 * 16, 3, 4, d, device="cuda", generator=gen).to(dtype)
    q = qkv[:, :, 0]
    pos = make_patch_positions(2, 64, 16, device="cuda")
    before = rope_2d_kernel.launches
    out = PrefixedRope2D(5)(q, pos)
    assert rope_2d_kernel.launches == before + 1
    assert torch.equal(out[:, :5], q[:, :5])
    ref = rope_2d(q[:, 5:].contiguous(), pos, 100.0)
    if dtype == torch.float32:
        assert (out[:, 5:] - ref).abs().max().item() <= 1e-5
    else:
        assert _ulps(out[:, 5:], ref, 7) <= 1


# K7 at the DPT-Large head's eligible convs over DINOv2-L/14 at 518 (a 37 x 37 token grid), batch 2: (H = W, C, Co)
# of the four layer*_rn projections and the refinenets' residual convs (chip_smoke.py phase 36)
K7_DPT_LARGE_518 = [(148, 256, 256), (74, 512, 256), (37, 1024, 256), (19, 1024, 256), (19, 256, 256),
                    (37, 256, 256), (74, 256, 256), (148, 256, 256)]


@pytest.mark.parametrize("hw,c,co", K7_DPT_LARGE_518, ids=lambda v: str(v))
def test_conv3x3_at_dpt_large_518_shapes(gen, hw, c, co):
    "K7 at the DPT-Large shapes, odd grids included: within 1 ulp of its plain version, two calls one answer."
    x, wt, bb = _conv_inputs(gen, 2, hw, hw, c, co)
    before = conv3x3_nhwc.launches
    out = conv3x3_nhwc(x, wt, bb)
    assert conv3x3_nhwc.launches == before + 1
    assert _ulps(out, conv3x3_reference(x, wt, bb), 7, floor=1 / 16) <= 1
    assert torch.equal(conv3x3_nhwc(x, wt, bb), out)


def test_dpt_large_head_at_518_takes_k7_eighteen_times(gen):
    """DPTFeature at the DPT-Large widths on a 37 x 37 grid in bf16 under the conv kernel: 18 K7 launches (4
    layer*_rn, 2 in refinenet4, 4 in each of refinenets 3-1) and none in the regression or segmentation processor,
    whose 296^2 input is above the kernel's 256^2; the features within the DPT head bar of the plain path."""
    from uniception_tpu_torch.models.prediction_heads.base import PredictionHeadLayeredInput
    from uniception_tpu_torch.models.prediction_heads.dpt import (
        DPTFeature, DPTRegressionProcessor, DPTSegmentationProcessor)

    kw = dict(dtype=torch.bfloat16, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    feature = DPTFeature(patch_size=14, hooks=[0, 1, 2, 3], input_feature_dims=1024, layer_dims=[256, 512, 1024, 1024],
                         feature_dim=256, **kw).eval()
    regressor, seg = DPTRegressionProcessor(256, 6, **kw).eval(), DPTSegmentationProcessor(256, 1, **kw).eval()
    feats = [torch.randn(1, 1024, 37, 37, device="cuda", generator=gen).bfloat16() for _ in range(4)]
    inp = PredictionHeadLayeredInput(list_features=feats, target_output_shape=(518, 518))
    prev = config.get_conv3x3_impl()
    config.set_conv3x3_impl("kernel")
    try:
        with torch.no_grad():
            config.set_attention_impl("naive")
            try:
                plain = feature(inp).features_upsampled_8x
            finally:
                config.set_attention_impl("kernel")
            before = conv3x3_nhwc.launches
            out = feature(inp)
            assert conv3x3_nhwc.launches == before + 18
            regressor(out), seg(out)
            assert conv3x3_nhwc.launches == before + 18
    finally:
        config.set_conv3x3_impl(prev)
    got = out.features_upsampled_8x
    assert tuple(got.shape) == (1, 256, 296, 296) and torch.isfinite(got).all()
    assert ((got.float() - plain.float()).norm() / plain.float().norm()).item() <= 5e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,h,d", [(2, 1024, 24, 32), (2, 1024, 12, 64), (2, 1024, 6, 128)],
                         ids=["24x32", "12x64", "6x128"])
def test_rope_on_differential_sub_heads(gen, b, n, h, d, dtype):
    """K2 on the differential attention's sub-heads: q of a (B, N, 3, H / 2, 2 D) projection viewed as (B, N, H, D),
    as DiffAttention makes it. (2, 1024, 12, 64) and (2, 1024, 6, 128) are the 768-wide, 12-head differential info
    sharing's cross and self-attention; (2, 1024, 24, 32) the same width at twice the heads."""
    q = torch.randn(b, n, 3, h // 2, 2 * d, device="cuda", generator=gen).to(dtype)[:, :, 0].reshape(b, n, h, d)
    pos = make_patch_positions(b, 32, n // 32, device="cuda")
    before = rope_2d_kernel.launches
    out = rope_2d_kernel(q, pos)
    assert rope_2d_kernel.launches == before + 1
    ref = rope_2d(q.contiguous(), pos)
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() <= 1e-5
    else:
        assert _ulps(out, ref, 7) <= 1


def test_diff_cross_attention_block_kernels_match_plain_with_exact_launches(gen):
    """A DiffCrossAttentionBlock of the 768-wide, 12-head differential info sharing (6 heads per block) in bf16 with
    RoPE100: one K1 (its self-attention, D = 128) and four K2 (self q, k at D = 128; cross q, k over 12 sub-heads of
    64), the two softmaxes on the einsum path (Dv = 2 Dq); within 2e-2 of the plain path by norm."""
    from uniception_tpu_torch.nn.blocks import DiffCrossAttentionBlock, layer_norm_factory

    blk = DiffCrossAttentionBlock(768, 3, 6, qkv_bias=True, norm_layer=layer_norm_factory(1e-6),
                                  custom_positional_encoding=Rope2D(100.0), device="cuda", dtype=torch.bfloat16,
                                  generator=torch.Generator(device="cuda").manual_seed(0)).eval()
    x, y = (torch.randn(2, 1024, 768, device="cuda", generator=gen).bfloat16() for _ in range(2))
    pos = make_patch_positions(2, 32, 32, device="cuda")
    with torch.no_grad():
        config.set_attention_impl("naive")
        try:
            plain = blk(x, y, pos, pos)
        finally:
            config.set_attention_impl("kernel")
        before = (flash_attention.launches, rope_2d_kernel.launches)
        out = blk(x, y, pos, pos)
    assert (flash_attention.launches - before[0], rope_2d_kernel.launches - before[1]) == (1, 4)
    assert torch.isfinite(out).all() and _rel_norm(out, plain) <= 2e-2


def _rel_norm(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


# K1 at D = 512, the Cosmos tokenizer's single-head mid-block attention (its column-split kernel: 64-row tiles), at the
# edges of its boxes (1033 keys: 17 tiles, the last of 9) and with q, k and v strided views of one projection
K1_WIDE_EDGES = [(1, 1), (63, 65), (64, 64), (65, 63), (1, 4100), (200, 1033)]


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq,nk", K1_WIDE_EDGES)
def test_flash_attention_d512_at_tma_edges(gen, nq, nk, dtype, with_lse):
    q = torch.randn(2, nq, 3, 2, 512, device="cuda", generator=gen).to(dtype)[:, :, 0]
    kv = torch.randn(2, nk, 2, 2, 512, device="cuda", generator=gen).to(dtype)
    out, lse = flash_attention_fwd(q, kv[:, :, 0], kv[:, :, 1], with_lse=with_lse)
    ref, ref_lse = flash_attention_lse_ref(q, kv[:, :, 0], kv[:, :, 1])
    assert out.dtype == dtype and out.shape == q.shape and out.is_contiguous() and torch.isfinite(out).all()
    if dtype == torch.bfloat16:
        assert (out.float() - ref.float()).abs().max().item() <= BF16_TOL
    else:
        assert ((out - ref).norm() / ref.norm()).item() <= K1_FP32_REL
    if with_lse:
        assert (lse - ref_lse).abs().max().item() <= LSE_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n", [(2, 1024), (2, 4096)], ids=["CI16x16-512", "CI8x8-512"])
def test_flash_attention_d512_at_the_tokenizer_shapes(gen, b, n, dtype):
    "One launch each; bf16 in ulps of max(|plain|, 1/64) (chip_smoke.py phase 38), fp32 norm-relative."
    q, k, v = torch.randn(b, n, 3, 1, 512, device="cuda", generator=gen).to(dtype).unbind(2)
    before = flash_attention.launches
    out, ref = flash_attention(q, k, v), flash_attention_ref(q, k, v)
    assert flash_attention.launches == before + 1
    if dtype == torch.bfloat16:
        assert _ulps(out, ref, 7, floor=K1_ULP_FLOOR) <= K1_ULPS
    else:
        assert ((out - ref).norm() / ref.norm()).item() <= K1_FP32_REL


def test_cosmos_encoder_runs_on_k1_and_k7_with_exact_launches(gen):
    """A bf16 Cosmos encoder at the published channels (128, multipliers 2 and 4: its residual convs take K7, its mid
    block attends at D = 512), two levels, on 64 x 64 images: one K1 launch, one K7 launch per eligible 3x3 conv,
    against the plain path within 2e-2."""
    from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules.layers2d import AttnBlock, Encoder

    enc = Encoder(in_channels=3, channels=128, channels_mult=[2, 4], num_res_blocks=1, attn_resolutions=[32],
                  dropout=0.0, resolution=64, z_channels=16, spatial_compression=8, patch_size=4, patch_method="haar",
                  dtype=torch.bfloat16, device="cuda", generator=gen).eval()
    k7 = sum(1 for m in enc.modules() if isinstance(m, Conv2dTorch) and m.kernel_size == (3, 3) and m.stride == (1, 1)
             and m.in_channels % 128 == 0 and m.out_channels % 128 == 0)
    attn = sum(1 for m in enc.modules() if isinstance(m, AttnBlock))
    assert (k7, attn) == (8, 1)  # two per ResnetBlock (levels 0 and 1, mid 1 and 2); the mid block's AttnBlock
    x = torch.rand(2, 3, 64, 64, device="cuda", generator=gen) * 2 - 1
    config.set_conv3x3_impl("kernel")
    try:
        config.set_attention_impl("naive")
        try:
            plain = enc(x)
        finally:
            config.set_attention_impl("kernel")
        before = (flash_attention.launches, conv3x3_nhwc.launches)
        out = enc(x)
        torch.cuda.synchronize()
        assert (flash_attention.launches - before[0], conv3x3_nhwc.launches - before[1]) == (attn, k7)
    finally:
        config.set_conv3x3_impl("torch")
    assert out.shape == (2, 16, 8, 8) and torch.isfinite(out).all()
    assert ((out.float() - plain.float()).norm() / plain.float().norm()).item() <= 2e-2


# K1's fp32 kernel (3xTF32 on wgmma) and K3's whole-width kernels above D = 64, at every padded head dim each is built
# for (K1 fp32: DP 32, 64, 128 with the row split, 256 and 512 with the column split; K3: DP 128, 192, 256) and D = 20
# (padded into a copy), on strided views, with ragged key tiles: hundreds of keys and 1033 (17 tiles of 64, the last
# of 9 keys).
K1_F32_D = [8, 16, 20, 32, 40, 64, 72, 80, 96, 128, 136, 192, 200, 256, 264, 384, 504, 512]
K3_WIDE_D = [72, 80, 96, 128, 136, 192, 200, 256]
REDESIGN_SHAPES = [(2, 200, 520, 2), (1, 130, 1033, 3)]


def _strided(gen, b, nq, nk, h, d, dtype):
    q = torch.randn(b, nq, 3, h, d, device="cuda", generator=gen).to(dtype)[:, :, 0]
    kv = torch.randn(b, nk, 2, h, d, device="cuda", generator=gen).to(dtype)
    return q, kv[:, :, 0], kv[:, :, 1]


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("b,nq,nk,h", REDESIGN_SHAPES)
@pytest.mark.parametrize("d", K1_F32_D)
def test_flash_attention_fp32_at_every_padded_head_dim(gen, d, b, nq, nk, h, with_lse):
    "K1 fp32 within 2e-5 max abs and 2e-6 norm-relative of its plain version, its logsumexp within 1e-5."
    q, k, v = _strided(gen, b, nq, nk, h, d, torch.float32)
    out, lse = flash_attention_fwd(q, k, v, with_lse=with_lse)
    ref, ref_lse = flash_attention_lse_ref(q, k, v)
    assert out.shape == q.shape and out.dtype == torch.float32 and out.is_contiguous()
    assert (out - ref).abs().max().item() <= FP32_TOL
    assert ((out - ref).norm() / ref.norm()).item() <= K1_FP32_REL
    if with_lse:
        assert (lse - ref_lse).abs().max().item() <= LSE_TOL[torch.float32]
        torch.testing.assert_close(out, flash_attention_fwd(q, k, v)[0], rtol=0, atol=0)
    else:
        assert lse is None


@pytest.mark.parametrize("d", [64, 512])
def test_flash_attention_fp32_bar_sees_a_dropped_tile(gen, d):
    "The control: the plain version without the last 64-key tile misses the bar the kernel meets."
    q, k, v = _strided(gen, 2, 200, 520, 2, d, torch.float32)
    ref = flash_attention_ref(q, k, v)
    assert (flash_attention(q, k, v) - ref).abs().max().item() <= FP32_TOL
    assert (flash_attention_ref(q, k[:, :-64], v[:, :-64]) - ref).abs().max().item() > 10 * FP32_TOL


def test_flash_attention_fp32_at_the_cosmos_shape(gen):
    "(2, 4096, 1, 512): the fp32 Cosmos autoencode's mid-block attention, with its logsumexp."
    q, k, v = (torch.randn(2, 4096, 1, 512, device="cuda", generator=gen) for _ in range(3))
    out, lse = flash_attention_fwd(q, k, v, with_lse=True)
    ref, ref_lse = flash_attention_lse_ref(q, k, v)
    assert (out - ref).abs().max().item() <= FP32_TOL and (lse - ref_lse).abs().max().item() <= LSE_TOL[torch.float32]


@pytest.mark.parametrize("b,nq,nk,h", REDESIGN_SHAPES + [(1, 1033, 1033, 2)])
@pytest.mark.parametrize("d", K3_WIDE_D)
def test_flash_attention_bwd_wide_head_dims_are_right_and_deterministic(gen, d, b, nq, nk, h):
    "K3 above D = 64 within the bf16 bar of its plain version on strided views, and bit-equal across two calls."
    q, k, v = _strided(gen, b, nq, nk, h, d, torch.bfloat16)
    dout = torch.randn(b, nq, h, d, device="cuda", generator=gen).bfloat16()
    out, lse = flash_attention_fwd(q, k, v, with_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, dout)
    second = flash_attention_bwd(q, k, v, out, lse, dout)
    refs = flash_attention_bwd_ref(*(t.float() for t in (q, k, v, out, lse, dout)))
    for g, g2, r in zip(first, second, refs):
        assert g.shape == r.shape and g.dtype == torch.bfloat16 and g.is_contiguous()
        assert _rel(g, r) <= BWD_REL_TOL[torch.bfloat16]
        assert torch.equal(g, g2)


@pytest.mark.parametrize("d", [8, 16, 24, 64, 512])
def test_flash_attention_fp32_routes_each_head_dim_to_its_kernel(gen, d):
    """D <= 16 takes the CUDA-core kernel, which allocates nothing beside o (the 3xTF32 kernel's entry point refuses to
    run without its workspace); every other D the 3xTF32 kernel with its split operands' workspace."""
    q, k, v = _strided(gen, 2, 4, 4, 4, d, torch.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, _ = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - out.numel() * out.element_size()
    ws = 4 * tf32_workspace_floats(2, 4, 4, 4, d)
    assert (extra < ws) if d <= F32_SMALL_HEAD_DIM else (extra >= ws), (extra, ws)
    assert (out - flash_attention_ref(q, k, v)).abs().max().item() <= FP32_TOL


# --- the int8 weight-transform path (nn/gptq.py) on the card --------------------------------------------------------


@pytest.mark.parametrize("d_in,d_out,dtype", [(768, 256, torch.float32), (1024, 384, torch.float32),
                                              (300, 96, torch.float64)])
def test_gptq_int8_on_cuda_matches_the_cpu_float64_version(gen, d_in, d_out, dtype):
    from uniception_tpu_torch.calibrate_gptq import h_error
    from uniception_tpu_torch.nn.gptq import gptq_int8

    w = (torch.randn(d_in, d_out, device="cuda", generator=gen) * 0.05).bfloat16().float()  # a bf16 model's weight
    mix = torch.randn(d_in, d_in, device="cuda", generator=gen) / d_in**0.5 + 0.5 * torch.eye(d_in, device="cuda")
    x = torch.randn(4 * d_in, d_in, device="cuda", generator=gen) @ mix
    H = (x.t().double() @ x.double()) / x.shape[0]
    q, s = gptq_int8(w, H, dtype=dtype)
    assert q.is_cuda and q.dtype == torch.int8 and s.dtype == torch.float32 and tuple(q.shape) == (d_in, d_out)
    q64, s64 = gptq_int8(w.cpu().double(), H.cpu())
    assert torch.equal(s.cpu(), s64)  # the scale of a bf16 weight is one rounding of the same quotient
    share = (q.cpu() == q64).double().mean().item()
    assert share >= (0.999 if dtype == torch.float64 else 0.98), share
    e_card, e_cpu = h_error(w.cpu().double(), q.cpu(), s.cpu(), H.cpu()), h_error(w.cpu().double(), q64, s64, H.cpu())
    assert abs(e_card - e_cpu) <= 1e-2 * e_cpu, (e_card, e_cpu)


def test_apply_gptq_then_a_k4_forward(gen):
    from uniception_tpu_torch.nn.gptq import apply_gptq, gptq_int8
    from uniception_tpu_torch.nn.quant import quantize_linears

    lin = LinearX(256, 320, generator=gen, device="cuda").bfloat16()
    holder = torch.nn.Sequential(lin)
    mix = torch.randn(256, 256, device="cuda", generator=gen) / 16 + 0.5 * torch.eye(256, device="cuda")
    x = (torch.randn(3 * 70, 256, device="cuda", generator=gen) @ mix).reshape(3, 70, 256).bfloat16()  # channels covary
    xf = x.reshape(-1, 256).double()
    q, s = gptq_int8(lin.weight.detach().t(), xf.t() @ xf / xf.shape[0], dtype=torch.float32)
    with torch.no_grad():
        ref_full = lin(x).float()
    assert quantize_linears(holder, min_params=0) == 1
    layer = holder[0]
    rtn_out = layer(x).float()
    assert apply_gptq(holder, {"0": (q.cpu().numpy(), s.cpu().numpy())}) == 1
    assert torch.equal(layer.w_q, q.t().contiguous()) and torch.equal(layer.w_scale, s)
    before = int8_matmul_dynamic.launches
    out = layer(x)
    assert int8_matmul_dynamic.launches == before + 1
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (3, 70, 320)
    plain = int8_matmul_dynamic_ref(x, layer.w_q.t(), layer.w_scale, layer.bias)
    assert _ulps(out, plain, 7) <= 1
    # the calibrated codes serve closer to the float layer than RTN's on the inputs they were calibrated on
    assert (out.float() - ref_full).norm() < (rtn_out - ref_full).norm()


# The Cosmos video tokenizer's mid-block attention (one head of D = 512 over each latent frame's grid, B * T frames):
# CV8x8x8 over 17-frame 512^2 clips at batch 2 (6 frames of 64^2 tokens) and DV8x16x16 (6 frames of 32^2), held as
# chip_smoke.py phase 49 holds them: bf16 in ulps of max(|plain|, 1/64) with the last 64-key tile dropped as the
# control, fp32 at the fp32 bars.
VIDEO_K1_CONTROL_ULPS = 32


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n", [(6, 4096), (6, 1024)], ids=["CV8x8x8-512", "DV8x16x16-512"])
def test_flash_attention_d512_at_the_video_tokenizer_shapes(gen, b, n, dtype):
    q, k, v = torch.randn(b, n, 3, 1, 512, device="cuda", generator=gen).to(dtype).unbind(2)
    before = flash_attention.launches
    out, ref = flash_attention(q, k, v), flash_attention_ref(q, k, v)
    assert flash_attention.launches == before + 1
    if dtype == torch.bfloat16:
        assert _ulps(out, ref, 7, floor=K1_ULP_FLOOR) <= K1_ULPS
        control = flash_attention_ref(q, k[:, :-64], v[:, :-64])
        assert _ulps(control, ref, 7, floor=K1_ULP_FLOOR) >= VIDEO_K1_CONTROL_ULPS
    else:
        assert (out - ref).abs().max().item() <= FP32_TOL and ((out - ref).norm() / ref.norm()).item() <= K1_FP32_REL


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_video_spatial_attention_block_launches_one_k1(gen, dtype, b):
    """A layers3d CausalAttnBlock at the mid blocks' width (C = 512) over 3 frames of 16 x 16: one K1 launch for the
    B * T frames (at B = 1 the fold's reshape is a view, made contiguous for K1), against the plain path; the causal
    temporal block beside it launches none."""
    from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules.layers3d import (CausalAttnBlock,
                                                                                      CausalTemporalAttnBlock)

    kw = dict(dtype=dtype if dtype == torch.bfloat16 else None, device="cuda", generator=gen)
    spatial, temporal = CausalAttnBlock(512, **kw).eval(), CausalTemporalAttnBlock(512, **kw).eval()
    x = torch.randn(b, 512, 3, 16, 16, device="cuda", generator=gen).to(dtype)
    with torch.no_grad():
        config.set_attention_impl("naive")
        try:
            plain = spatial(x)
        finally:
            config.set_attention_impl("kernel")
        before = flash_attention.launches
        out = spatial(x)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        temporal(x)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert _rel_norm(out, plain) <= (2e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_masked_attentions_launch_no_kernel(gen, dtype):
    """PE's masked SelfAttention (the text tower's) and the Llama Attention with mask="causal" run the explicit fp32
    einsum and launch no kernel; the Llama Attention without a mask launches K1 once (GQA: the kv heads repeated)."""
    from uniception_tpu_torch.models.libs.perception_encoder.pe import SelfAttention
    from uniception_tpu_torch.models.libs.perception_encoder.transformer import Attention, RotaryEmbedding, causal_mask

    kw = dict(dtype=dtype, device="cuda", generator=gen)
    pe_attn = SelfAttention(1024, 16, **kw).eval()
    llama = Attention(1024, 64, 16, 4, 10000.0, **kw).eval()
    cos, sin = RotaryEmbedding(10000.0, 64, 64, device="cuda")(seqlen=64)
    x = torch.randn(2, 32, 1024, device="cuda", generator=gen).to(dtype)
    y = torch.randn(2, 64, 1024, device="cuda", generator=gen).to(dtype)
    counters = (flash_attention, fused.fused_qkv_rope_attention, flash_attention_int8, rope_2d_kernel)
    with torch.no_grad():
        before = [f.launches for f in counters]
        a = pe_attn(x, attn_mask=causal_mask(32, "cuda"))
        b = llama(y, cos, sin, mask="causal")
        torch.cuda.synchronize()
        assert [f.launches for f in counters] == before
        c = llama(y, cos, sin)
        torch.cuda.synchronize()
        assert flash_attention.launches == before[0] + 1
        config.set_attention_impl("naive")
        try:
            plain = llama(y, cos, sin)
        finally:
            config.set_attention_impl("kernel")
    assert all(torch.isfinite(t).all() for t in (a, b, c))
    assert _rel_norm(c, plain) <= (2e-2 if dtype == torch.bfloat16 else 1e-5)
