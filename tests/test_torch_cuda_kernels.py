"""
The port's CUDA kernels against their plain PyTorch versions on a GPU, at
small and ragged shapes (the main-path shapes run in chip_smoke.py): the
flash-attention forward (K1, with and without the logsumexp), its backward
(K3), RoPE2D (K2) forward and backward, and gradients through attention
layers on the kernel path. Every test here needs a CUDA device and skips
without one.

On a machine with a GPU and without jax, run them without the repo's
conftest (which configures jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from uniception_tpu_torch.models.utils import config
from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions
from uniception_tpu_torch.nn.blocks import Attention, CrossAttention
from uniception_tpu_torch.ops.attention import scaled_dot_product_attention
from uniception_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_lse_ref,
    flash_attention_ref,
)
from uniception_tpu_torch.ops.rope import Rope2D, rope_2d, rope_2d_kernel

pytestmark = pytest.mark.cuda

BF16_TOL = 2e-2  # max abs vs the plain version in fp32 from the same bf16 inputs
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
    x = torch.randn(1, 8, 2, 32, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="head dim"):
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
    x = torch.randn(1, 8, 2, 32, device="cuda", generator=gen, requires_grad=True)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(x, x, x).sum().backward()
    y = torch.randn(1, 8, 2, 64, device="cuda", generator=gen)
    out, lse = flash_attention_fwd(y, y, y, with_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(y, y, y, out, lse[:, :, :4], out)


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
