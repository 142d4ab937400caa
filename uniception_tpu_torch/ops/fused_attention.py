"""
Fused qkv projection + RoPE2D + attention (counterpart of uniception_tpu/ops/fused_attention.py).

Per call: the projection x . W^T + b with fp32 accumulation and the fp32
bias, rounded once to the compute dtype (bf16 for bf16 x, else fp32); RoPE2D
on q and k on the ``[u_Y v_Y u_X v_X]`` quarter layout with the port's RoPE
arithmetic (ops/rope.py, so q and k equal K2's output on the same projection);
then single-pass softmax attention with flash_attention_ref's numerics. The
output is (B, Nq, H*D) in x's dtype, before the output projection.

Weights are in torch's (out, in) layout. The cross variant takes the k and v
projections' weights and biases apart (the JAX package concatenates them
into one (C, 2*H*D) kernel per call); the product is the same.

    * :func:`fused_qkv_rope_attention_ref` and :func:`fused_cross_rope_attention_ref`
      — plain PyTorch, the references for the kernel;
    * :func:`fused_qkv_rope_attention` and :func:`fused_cross_rope_attention`
      — K5 for CUDA tensors (csrc/fused_attention.cu: a projection launch,
      the shared Hopper GEMM tiled by ops/gemm.py gemm_plan with the bias and
      RoPE epilogue, into a q/k/v scratch; then K1's kernel, launched here,
      reads the scratch in place); a CPU tensor takes the plain version. When a gradient is needed they go
      through :class:`FusedSelfAttentionFunction` / :class:`FusedCrossAttentionFunction`,
      whose backward recomputes the forward through the unfused kernel path
      (the projection as a matmul, K2 through ``Rope2DFunction``, K1 with its
      logsumexp and K3 through ``FlashAttentionFunction``) and differentiates
      it: the JAX package's ``_fused_self_bwd`` / ``_fused_cross_bwd``.
"""

from typing import Optional, Sequence

import torch

from uniception_tpu_torch.ops import kernel_lib
from uniception_tpu_torch.ops.flash_attention import (
    _DTYPE_CODES,
    HEAD_DIM,
    HEAD_DIM_ITEM,
    FlashAttentionFunction,
    _on_cuda,
    flash_attention_ref,
    forward_launch,
)
from uniception_tpu_torch.ops.gemm import gemm_plan, maps_array, sm_count
from uniception_tpu_torch.ops.rope import rope_2d, rope_2d_kernel

__all__ = [
    "fused_qkv_rope_attention",
    "fused_cross_rope_attention",
    "fused_qkv_rope_attention_ref",
    "fused_cross_rope_attention_ref",
    "FusedSelfAttentionFunction",
    "FusedCrossAttentionFunction",
]

def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def _project_ref(x, weights: Sequence, biases: Sequence, positions, rope: Sequence[bool], num_heads, base, f0):
    """The plain projection: per section, (B, N, H, D) in the compute dtype,
    RoPE'd where ``rope`` says so. The fp32 bias is added to the fp32
    product before the one rounding."""
    B, N, _ = x.shape
    cd = _compute_dtype(x)
    out = []
    for w, b, r in zip(weights, biases, rope):
        y = x.float() @ w.float().t()
        if b is not None:
            y = y + b.float()
        y = y.to(cd).reshape(B, N, num_heads, -1)
        out.append(rope_2d(y, positions, base, f0) if r else y)
    return out


def _attend_ref(x, q, k, v, scale):
    out = flash_attention_ref(q, k, v, scale)
    return out.reshape(out.shape[0], out.shape[1], -1).to(x.dtype)


def fused_qkv_rope_attention_ref(x, wqkv, bqkv, positions, num_heads: int, scale: float, base: float = 100.0,
                                 f0: float = 1.0) -> torch.Tensor:
    """Plain PyTorch fused self-attention with the Pallas kernel's numerics.

    x: (B, N, C); wqkv: (3*H*D, C); bqkv: (3*H*D,) or None; positions:
    (B, N, 2) integer (y, x) or None for no RoPE. Returns (B, N, H*D) in x's dtype.
    """
    ws, bs = wqkv.chunk(3), (None,) * 3 if bqkv is None else bqkv.chunk(3)
    use_rope = positions is not None
    q, k, v = _project_ref(x, ws, bs, positions, (use_rope, use_rope, False), num_heads, base, f0)
    return _attend_ref(x, q, k, v, scale)


def fused_cross_rope_attention_ref(xq, xkv, wq, wk, wv, bq, bk, bv, qpos, kpos, num_heads: int, scale: float,
                                   base: float = 100.0, f0: float = 1.0) -> torch.Tensor:
    """Plain PyTorch fused cross-attention: q from xq (B, Nq, C), k and v from
    xkv (B, Nk, Ckv); weights (H*D, C) / (H*D, Ckv), biases (H*D,) or None;
    qpos / kpos (B, Nq, 2) / (B, Nk, 2) or None. Returns (B, Nq, H*D) in xq's dtype."""
    (q,) = _project_ref(xq, (wq,), (bq,), qpos, (qpos is not None,), num_heads, base, f0)
    k, v = _project_ref(xkv, (wk, wv), (bk, bv), kpos, (kpos is not None, False), num_heads, base, f0)
    return _attend_ref(xq, q, k, v, scale)


def _project(x, weights: Sequence, biases: Sequence, positions, n_rope: int, num_heads: int, base: float,
             f0: float) -> torch.Tensor:
    """The projection launch alone (CUDA tensors): returns the (S, B, H, N, D)
    scratch of the S = len(weights) sections in the compute dtype, the first
    ``n_rope`` sections RoPE'd. Raises on what the kernel does not take."""
    op = "fused_attention"
    if x.dim() != 3 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{op}: x must be (B, N, C) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    B, N, C = x.shape
    hd = num_heads * HEAD_DIM
    if C % (8 if x.dtype == torch.bfloat16 else 4):
        raise ValueError(f"{op}: C = {C} must be a multiple of 8 (bfloat16) or 4 (float32)")
    x = x.contiguous()
    ws = [w.contiguous() for w in weights]
    for w in ws:
        if w.shape[1] != C or w.dtype != x.dtype or w.device != x.device:
            raise ValueError(f"{op}: weight {tuple(w.shape)} {w.dtype} on {w.device} does not fit x {tuple(x.shape)}")
        if w.shape[0] != hd:
            raise ValueError(
                f"{op}: head dim {w.shape[0] / num_heads:g} not supported (the kernel is built for {HEAD_DIM}; "
                f"other head dims: {HEAD_DIM_ITEM})"
            )
    # bf16 biases of a bf16 call are read as they are (the kernel widens them to fp32, exactly): no cast per call
    bias_bf16 = x.dtype == torch.bfloat16 and all(b is None or b.dtype == torch.bfloat16 for b in biases)
    bs = [None if b is None else (b if bias_bf16 else b.to(torch.float32)).contiguous() for b in biases]
    for b in bs:
        if b is not None and (b.shape != (hd,) or b.device != x.device):
            raise ValueError(f"{op}: bias {tuple(b.shape)} on {b.device} must be ({hd},) on {x.device}")
    if any(t.data_ptr() % 16 for t in (x, *ws)):
        raise ValueError(f"{op}: x and the weights need 16-byte aligned bases")
    rope = n_rope > 0
    if rope:
        positions = positions.to(torch.int32)
        if positions.shape != (B, N, 2) or positions.device != x.device:
            raise ValueError(f"{op}: positions must be ({B}, {N}, 2) on {x.device}, got {tuple(positions.shape)}")
    S = len(ws)
    out = torch.empty((S, B, num_heads, N, HEAD_DIM), dtype=x.dtype, device=x.device)
    pad = [None] * (3 - S)
    maps, bn = None, 0
    if x.dtype == torch.bfloat16:
        bn = gemm_plan(B * N, hd, C, 2, sm_count(x.device.index or 0), sections=S, split_k=False)[0]
        maps = maps_array(B * N, C, hd, 2, bn)
    status = kernel_lib.library().uc_fused_project(
        x.data_ptr(), *[w.data_ptr() for w in ws], *pad, *[None if b is None else b.data_ptr() for b in bs], *pad,
        positions.data_ptr() if rope else None, *(positions.stride() if rope else (0, 0, 0)), (1 << n_rope) - 1,
        out.data_ptr(), _DTYPE_CODES[x.dtype], B, N, C, num_heads, S, float(base), float(f0), maps, bn,
        int(bias_bf16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernel_lib.check(status, "fused_attention (projection)")
    return out


def _attend(q, k, v, scale: float) -> torch.Tensor:
    """The attention launch: K1's kernel on the projection's scratch, read in place as (B, N, H, D) views of
    q (B, H, Nq, D) and k/v (B, H, Nk, D). Returns (B, Nq, H*D)."""
    out, _ = forward_launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale)
    return out.reshape(out.shape[0], out.shape[1], -1)


def _self_forward(x, wqkv, bqkv, positions, num_heads, scale, base, f0):
    if not _on_cuda("fused_qkv_rope_attention", x):
        return fused_qkv_rope_attention_ref(x, wqkv, bqkv, positions, num_heads, scale, base, f0)
    if wqkv.dim() != 2 or wqkv.shape[0] % 3:
        raise ValueError(f"fused_qkv_rope_attention: wqkv must be (3*H*D, C), got {tuple(wqkv.shape)}")
    bs = (None,) * 3 if bqkv is None else bqkv.chunk(3)
    q, k, v = _project(x, wqkv.chunk(3), bs, positions, 0 if positions is None else 2, num_heads, base, f0)
    out = _attend(q, k, v, scale)
    fused_qkv_rope_attention.launches += 1
    return out


def _cross_forward(xq, xkv, wq, wk, wv, bq, bk, bv, qpos, kpos, num_heads, scale, base, f0):
    if not _on_cuda("fused_cross_rope_attention", xq):
        return fused_cross_rope_attention_ref(xq, xkv, wq, wk, wv, bq, bk, bv, qpos, kpos, num_heads, scale, base, f0)
    if xkv.dtype != xq.dtype or xkv.device != xq.device or xkv.dim() != 3 or xkv.shape[0] != xq.shape[0]:
        raise ValueError(f"fused_cross_rope_attention: xkv {tuple(xkv.shape)} {xkv.dtype} does not fit xq")
    (q,) = _project(xq, (wq,), (bq,), qpos, int(qpos is not None), num_heads, base, f0)
    k, v = _project(xkv, (wk, wv), (bk, bv), kpos, int(kpos is not None), num_heads, base, f0)
    out = _attend(q, k, v, scale)
    fused_cross_rope_attention.launches += 1
    return out


def _unfused_projection(x, w, b):
    "x . W^T + b with the fp32 bias added before the one rounding, differentiable."
    y = (x @ w.t()).float()
    return (y if b is None else y + b.float()).to(x.dtype)


def _unfused_attention(q, k, v, qpos, kpos, scale, base, f0):
    "RoPE through K2 (Rope2DFunction) and attention through K1 + K3 (FlashAttentionFunction); CPU: plain versions."
    if qpos is not None:
        q = rope_2d_kernel(q, qpos.to(torch.int32), base, f0)
    if kpos is not None:
        k = rope_2d_kernel(k, kpos.to(torch.int32), base, f0)
    out = FlashAttentionFunction.apply(q, k, v, scale)
    return out.reshape(out.shape[0], out.shape[1], -1)


def _recompute_grads(fn, inputs, grad):
    "The gradients of fn(*inputs) for ``grad``, recomputed under autograd (None for a None input)."
    leaves = [None if t is None else t.detach().requires_grad_() for t in inputs]
    with torch.enable_grad():
        out = fn(*leaves)
        want = [t for t in leaves if t is not None]
        got = iter(torch.autograd.grad(out, want, grad.to(out.dtype)))
    return [None if t is None else next(got) for t in leaves]


class FusedSelfAttentionFunction(torch.autograd.Function):
    """K5 self-attention forward; the backward recomputes through the unfused
    kernel path and differentiates it (gradients for x, wqkv and bqkv)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, positions, num_heads, scale, base, f0):
        ctx.save_for_backward(x, wqkv, bqkv, positions)
        ctx.args = (num_heads, scale, base, f0)
        return _self_forward(x, wqkv, bqkv, positions, num_heads, scale, base, f0)

    @staticmethod
    def backward(ctx, grad):
        x, wqkv, bqkv, positions = ctx.saved_tensors
        num_heads, scale, base, f0 = ctx.args

        def unfused(x_, w_, b_):
            B, N, _ = x_.shape
            q, k, v = _unfused_projection(x_, w_, b_).reshape(B, N, 3, num_heads, -1).unbind(2)
            return _unfused_attention(q, k, v, positions, positions, scale, base, f0)

        dx, dw, db = _recompute_grads(unfused, (x, wqkv, bqkv), grad)
        return dx, dw, db, None, None, None, None, None


class FusedCrossAttentionFunction(torch.autograd.Function):
    """K5 cross-attention forward; the backward recomputes through the unfused
    kernel path and differentiates it (gradients for xq, xkv, the weights and biases)."""

    @staticmethod
    def forward(ctx, xq, xkv, wq, wk, wv, bq, bk, bv, qpos, kpos, num_heads, scale, base, f0):
        ctx.save_for_backward(xq, xkv, wq, wk, wv, bq, bk, bv, qpos, kpos)
        ctx.args = (num_heads, scale, base, f0)
        return _cross_forward(xq, xkv, wq, wk, wv, bq, bk, bv, qpos, kpos, num_heads, scale, base, f0)

    @staticmethod
    def backward(ctx, grad):
        xq, xkv, wq, wk, wv, bq, bk, bv, qpos, kpos = ctx.saved_tensors
        num_heads, scale, base, f0 = ctx.args

        def unfused(xq_, xkv_, wq_, wk_, wv_, bq_, bk_, bv_):
            heads = lambda t: t.reshape(t.shape[0], t.shape[1], num_heads, -1)  # noqa: E731
            q = heads(_unfused_projection(xq_, wq_, bq_))
            k = heads(_unfused_projection(xkv_, wk_, bk_))
            v = heads(_unfused_projection(xkv_, wv_, bv_))
            return _unfused_attention(q, k, v, qpos, kpos, scale, base, f0)

        grads = _recompute_grads(unfused, (xq, xkv, wq, wk, wv, bq, bk, bv), grad)
        return (*grads, None, None, None, None, None, None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def fused_qkv_rope_attention(x: torch.Tensor, wqkv: torch.Tensor, bqkv: Optional[torch.Tensor],
                             positions: Optional[torch.Tensor], num_heads: int, scale: float, base: float = 100.0,
                             f0: float = 1.0) -> torch.Tensor:
    """Fused self-attention: (x W^T + b) -> RoPE2D -> attention (K5).

    Args:
        x: (B, N, C) block input (post-norm), float32 or bfloat16.
        wqkv: (3*H*D, C) fused qkv weight (torch layout), in x's dtype.
        bqkv: (3*H*D,) bias (any float dtype; added in fp32), or None.
        positions: (B, N, 2) integer (y, x) RoPE positions, or None for no RoPE.
        num_heads: H. scale: the softmax scale (SSMax / entropy scaling folded in).
        base, f0: RoPE frequency parameters.

    Returns:
        (B, N, H*D) attention output (before the output projection), in x's dtype.

    CUDA tensors launch the kernel (D = 64, C a multiple of 8 in bf16 or 4 in
    fp32) or raise; a CPU tensor takes :func:`fused_qkv_rope_attention_ref`.
    ``fused_qkv_rope_attention.launches`` counts the calls that launched it.
    """
    if _needs_grad(x, wqkv, bqkv):
        return FusedSelfAttentionFunction.apply(x, wqkv, bqkv, positions, num_heads, float(scale), float(base),
                                                float(f0))
    return _self_forward(x, wqkv, bqkv, positions, num_heads, float(scale), float(base), float(f0))


def fused_cross_rope_attention(xq: torch.Tensor, xkv: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                               wv: torch.Tensor, bq: Optional[torch.Tensor], bk: Optional[torch.Tensor],
                               bv: Optional[torch.Tensor], qpos: Optional[torch.Tensor], kpos: Optional[torch.Tensor],
                               num_heads: int, scale: float, base: float = 100.0, f0: float = 1.0) -> torch.Tensor:
    """Fused cross-attention: q = RoPE(xq Wq^T + bq), k = RoPE(xkv Wk^T + bk),
    v = xkv Wv^T + bv, then attention (K5).

    xq: (B, Nq, C), xkv: (B, Nk, Ckv) in one dtype; wq (H*D, C), wk and wv
    (H*D, Ckv) in that dtype; biases (H*D,) or None; qpos (B, Nq, 2) and kpos
    (B, Nk, 2) or None (each independently). Returns (B, Nq, H*D) in xq's
    dtype. Devices as for :func:`fused_qkv_rope_attention`;
    ``fused_cross_rope_attention.launches`` counts the calls that launched it.
    """
    if _needs_grad(xq, xkv, wq, wk, wv, bq, bk, bv):
        return FusedCrossAttentionFunction.apply(xq, xkv, wq, wk, wv, bq, bk, bv, qpos, kpos, num_heads,
                                                 float(scale), float(base), float(f0))
    return _cross_forward(xq, xkv, wq, wk, wv, bq, bk, bv, qpos, kpos, num_heads, float(scale), float(base),
                          float(f0))


fused_qkv_rope_attention.launches = 0
fused_cross_rope_attention.launches = 0
