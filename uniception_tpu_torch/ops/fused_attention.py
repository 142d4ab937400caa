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
      it: the JAX package's ``_fused_self_bwd`` / ``_fused_cross_bwd``. Each K5
      call is one custom op (``uniception::fused_self_attention``,
      ``uniception::fused_cross_attention``) that an exported program replays;
      the padded heads of a bf16 call at D != 64 are made before it, through
      ops/serving_operands.py, so an exported program takes them from its
      ``prepare`` program instead of remaking them per call.
"""

import collections
import functools
from typing import Optional, Sequence

import torch

from uniception_tpu_torch.ops import kernel_lib
from uniception_tpu_torch.ops.flash_attention import (
    _DTYPE_CODES,
    HEAD_DIM_ALIGN,
    FlashAttentionFunction,
    _on_cuda,
    flash_attention_ref,
    forward_launch,
    head_dim_rule,
)
from uniception_tpu_torch.ops.gemm import TILE_N, gemm_plan, maps_array, sm_count
from uniception_tpu_torch.ops.rope import _inv_freq, rope_2d, rope_2d_kernel
from uniception_tpu_torch.ops.serving_operands import exporting, kernel_op, weight_layout

__all__ = [
    "fused_qkv_rope_attention",
    "fused_cross_rope_attention",
    "fused_qkv_rope_attention_ref",
    "fused_cross_rope_attention_ref",
    "FusedSelfAttentionFunction",
    "FusedCrossAttentionFunction",
    "rope_pair_layout",
]

PAD_WIDTHS = (32, 64, 128, 256)  # the padded heads of rope_pair_layout: each divides the GEMM's tile widths it takes

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


def rope_pair_layout(head_dim: int):
    """The padded head K5's bf16 projection computes at a head dim other than 64 (csrc/fused_attention.cu
    PadRopeEpilogue): (dpad, src) with src[c] the head column at padded column c, or -1 for a zero row. Rotation pair
    P < D / 2 (u_Y / v_Y of quarter index P, or u_X / v_X of quarter index P - D / 4) has its u column at
    32 (P // 16) + P % 16 and its v 16 columns on, so a thread of the GEMM's epilogue holds both; dpad is the
    narrowest of :data:`PAD_WIDTHS` that holds the pairs' 32-column groups."""
    q = head_dim // 4
    groups = -(-2 * q // 16)
    dpad = next(w for w in PAD_WIDTHS if w >= 32 * groups)
    src = [-1] * dpad
    for p in range(2 * q):
        half, qi = divmod(p, q)
        col = 32 * (p // 16) + p % 16
        src[col], src[col + 16] = 2 * half * q + qi, 2 * half * q + qi + q
    return dpad, src


def _pad_rows(head_dim: int, device) -> torch.Tensor:
    "rope_pair_layout's source rows on the device, D for a zero row."
    return torch.tensor([head_dim if c < 0 else c for c in rope_pair_layout(head_dim)[1]], device=device)


_pad_index = functools.lru_cache(maxsize=64)(_pad_rows)  # one tensor per head dim and device, reused


def _pad_heads(t: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    "A (H * D, ...) weight or bias with each head's rows in rope_pair_layout's order, zero rows where it has -1."
    heads = t.reshape(num_heads, head_dim, *t.shape[1:])
    heads = torch.cat([heads, heads.new_zeros((num_heads, 1, *t.shape[1:]))], dim=1)  # row D: the zero row
    # under export the index is a constant of the traced program, never a tensor of the cache
    index = _pad_rows(head_dim, t.device) if exporting() else _pad_index(head_dim, t.device)
    return heads.index_select(1, index).reshape(num_heads * index.numel(), *t.shape[1:]).contiguous()


def _padded_section(t: Optional[torch.Tensor], num_heads: int, head_dim: int, bias: bool):
    """A weight (or an fp32-cast bias) of ``num_heads`` heads in rope_pair_layout's padded heads: a layout that an
    exported program takes from its ``prepare`` program (ops/serving_operands.py)."""
    if t is None:
        return None
    fn = (lambda b: _pad_heads(b.float().contiguous(), num_heads, head_dim)) if bias else (  # noqa: E731
        lambda w: _pad_heads(w.contiguous(), num_heads, head_dim))
    return weight_layout(f"k5_padded_{'bias' if bias else 'weight'}:{num_heads}:{head_dim}", fn, t)


def _pads(x, head_dim: int) -> bool:
    "Whether K5 computes ``x``'s projection on rope_pair_layout's padded heads: a bf16 CUDA call at D != 64."
    return x.device.type == "cuda" and x.dtype == torch.bfloat16 and head_dim != 64


def _project(x, weights: Sequence, biases: Sequence, positions, n_rope: int, num_heads: int, base: float,
             f0: float, head_dim: int, padded: bool) -> torch.Tensor:
    """The projection launch alone (CUDA tensors): returns the (S, B, H, N, DS) scratch of the S = len(weights)
    sections in the compute dtype, the first ``n_rope`` sections RoPE'd, DS = D rounded up to 8 (zeros past D, so
    K1's tensor maps read it in place), D = ``head_dim``. Raises on what the kernel does not take. A bf16 call at
    D != 64 takes the weights and biases in rope_pair_layout's padded heads (fp32 biases, from
    :func:`_padded_section`), and ``padded`` must say they come so."""
    op = "fused_attention"
    if x.dim() != 3 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{op}: x must be (B, N, C) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    B, N, C = x.shape
    D = head_dim
    head_dim_rule(op, "K5", D)
    if padded != _pads(x, D):
        raise ValueError(f"{op}: a bf16 projection at D != 64 takes padded heads, and only it (D = {D}, {x.dtype}, "
                         f"padded {padded})")
    dpad = rope_pair_layout(D)[0] if padded else 0
    hd = num_heads * (dpad or D)
    if C % (8 if x.dtype == torch.bfloat16 else 4):
        raise ValueError(f"{op}: C = {C} must be a multiple of 8 (bfloat16) or 4 (float32)")
    x = x.contiguous()
    ws = [w.contiguous() for w in weights]
    for w in ws:
        if w.shape != (hd, C) or w.dtype != x.dtype or w.device != x.device:
            raise ValueError(f"{op}: weight {tuple(w.shape)} {w.dtype} on {w.device} does not fit x {tuple(x.shape)} "
                             f"and {num_heads} heads of {D}")
    # bf16 biases of a bf16 call at D = 64 are read as they are (the kernel widens them to fp32, exactly): no cast
    bias_bf16 = x.dtype == torch.bfloat16 and not padded and all(b is None or b.dtype == torch.bfloat16 for b in biases)
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
    ds = -(-D // HEAD_DIM_ALIGN) * HEAD_DIM_ALIGN
    out = (torch.empty if ds == D else torch.zeros)((S, B, num_heads, N, ds), dtype=x.dtype, device=x.device)
    pad = [None] * (3 - S)
    maps, bn, freq = None, 0, None
    if padded and rope:
        freq = _inv_freq(D // 4, base, f0, x.device)
    if x.dtype == torch.bfloat16:
        n = num_heads * (dpad or D)
        widths = tuple(w for w in TILE_N if w % (dpad or 1) == 0)
        bn = gemm_plan(B * N, n, C, 2, sm_count(x.device.index or 0), sections=S, split_k=False, widths=widths)[0]
        maps = maps_array(B * N, C, n, 2, bn)
    status = kernel_lib.library().uc_fused_project(
        x.data_ptr(), *[w.data_ptr() for w in ws], *pad, *[None if b is None else b.data_ptr() for b in bs], *pad,
        positions.data_ptr() if rope else None, *(positions.stride() if rope else (0, 0, 0)), (1 << n_rope) - 1,
        out.data_ptr(), _DTYPE_CODES[x.dtype], B, N, C, num_heads, D, S, float(base), float(f0), maps, bn,
        int(bias_bf16), dpad, None if freq is None else freq.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernel_lib.check(status, "fused_attention (projection)")
    return out


def _attend(q, k, v, scale: float, head_dim: Optional[int] = None) -> torch.Tensor:
    """The attention launch: K1's kernel on the projection's scratch, read in place as (B, N, H, DS) views of
    q (B, H, Nq, DS) and k/v (B, H, Nk, DS). Returns (B, Nq, H * D), D = ``head_dim`` (default DS)."""
    out, _ = forward_launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale)
    if head_dim is not None and head_dim != out.shape[-1]:
        out = out[..., :head_dim]
    return out.reshape(out.shape[0], out.shape[1], -1)


def _self_forward(x, wqkv, bqkv, positions, num_heads, scale, base, f0):
    "K5-self through its op: the weights in padded heads first where the kernel takes them so (:func:`_pads`)."
    _on_cuda("fused_qkv_rope_attention", x)
    if wqkv.dim() != 2 or wqkv.shape[0] % (3 * num_heads):
        raise ValueError(f"fused_qkv_rope_attention: wqkv must be (3*H*D, C), got {tuple(wqkv.shape)}")
    D = wqkv.shape[0] // (3 * num_heads)
    padded = _pads(x, D)
    if x.device.type == "cuda":
        head_dim_rule("fused_attention", "K5", D)
    if padded:  # the three sections are 3H heads of D rows: padding each head pads each section
        fused_qkv_rope_attention.weight_copies += 1
        wqkv, bqkv = _padded_section(wqkv, 3 * num_heads, D, False), _padded_section(bqkv, 3 * num_heads, D, True)
    return fused_self_op(x, wqkv, bqkv, positions, num_heads, D, scale, base, f0, padded)


@kernel_op("fused_self_attention")
def fused_self_op(x: torch.Tensor, wqkv: torch.Tensor, bqkv: Optional[torch.Tensor], positions: Optional[torch.Tensor],
                  num_heads: int, head_dim: int, scale: float, base: float, f0: float, padded: bool) -> torch.Tensor:
    """K5-self as one op (the projection launch, then K1's kernel on its scratch): the plain version on a CPU
    tensor, else the checked and counted launches. With ``padded`` the weights come in padded heads."""
    if not _on_cuda("fused_qkv_rope_attention", x):
        return fused_qkv_rope_attention_ref(x, wqkv, bqkv, positions, num_heads, scale, base, f0).contiguous()
    bs = (None,) * 3 if bqkv is None else bqkv.chunk(3)
    q, k, v = _project(x, wqkv.chunk(3), bs, positions, 0 if positions is None else 2, num_heads, base, f0,
                       head_dim, padded)
    out = _attend(q, k, v, scale, head_dim)
    fused_qkv_rope_attention.launches += 1
    fused_qkv_rope_attention.head_dims[head_dim] += 1
    return out


@fused_self_op.register_fake
def _(x, wqkv, bqkv, positions, num_heads, head_dim, scale, base, f0, padded):
    return x.new_empty((*x.shape[:2], num_heads * head_dim))


def _cross_forward(xq, xkv, wq, wk, wv, bq, bk, bv, qpos, kpos, num_heads, scale, base, f0):
    "K5-cross through its op: the weights in padded heads first where the kernel takes them so (:func:`_pads`)."
    _on_cuda("fused_cross_rope_attention", xq)
    D = wq.shape[0] // num_heads
    padded = _pads(xq, D)
    if xq.device.type == "cuda":
        head_dim_rule("fused_attention", "K5", D)
    if padded:  # one copy for each projection launch, q's and k/v's
        fused_qkv_rope_attention.weight_copies += 2
        wq, wk, wv = (_padded_section(w, num_heads, D, False) for w in (wq, wk, wv))
        bq, bk, bv = (_padded_section(b, num_heads, D, True) for b in (bq, bk, bv))
    return fused_cross_op(xq, xkv, wq, wk, wv, bq, bk, bv, qpos, kpos, num_heads, D, scale, base, f0, padded)


@kernel_op("fused_cross_attention")
def fused_cross_op(xq: torch.Tensor, xkv: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                   bq: Optional[torch.Tensor], bk: Optional[torch.Tensor], bv: Optional[torch.Tensor],
                   qpos: Optional[torch.Tensor], kpos: Optional[torch.Tensor], num_heads: int, head_dim: int,
                   scale: float, base: float, f0: float, padded: bool) -> torch.Tensor:
    """K5-cross as one op (the q and the k/v projection launches, then K1's kernel): the plain version on a CPU
    tensor, else the checked and counted launches. With ``padded`` the weights come in padded heads."""
    if not _on_cuda("fused_cross_rope_attention", xq):
        return fused_cross_rope_attention_ref(xq, xkv, wq, wk, wv, bq, bk, bv, qpos, kpos, num_heads, scale, base,
                                              f0).contiguous()
    if xkv.dtype != xq.dtype or xkv.device != xq.device or xkv.dim() != 3 or xkv.shape[0] != xq.shape[0]:
        raise ValueError(f"fused_cross_rope_attention: xkv {tuple(xkv.shape)} {xkv.dtype} does not fit xq")
    (q,) = _project(xq, (wq,), (bq,), qpos, int(qpos is not None), num_heads, base, f0, head_dim, padded)
    k, v = _project(xkv, (wk, wv), (bk, bv), kpos, int(kpos is not None), num_heads, base, f0, head_dim, padded)
    out = _attend(q, k, v, scale, head_dim)
    fused_cross_rope_attention.launches += 1
    fused_cross_rope_attention.head_dims[head_dim] += 1
    return out


@fused_cross_op.register_fake
def _(xq, xkv, wq, wk, wv, bq, bk, bv, qpos, kpos, num_heads, head_dim, scale, base, f0, padded):
    return xq.new_empty((*xq.shape[:2], num_heads * head_dim))


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

    CUDA tensors launch the kernel (D a multiple of 4 up to 256, C a multiple
    of 8 in bf16 or 4 in fp32) or raise; a CPU tensor takes
    :func:`fused_qkv_rope_attention_ref`.
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
fused_qkv_rope_attention.weight_copies = 0  # projections whose weights were copied into padded heads (bf16, D != 64)
fused_cross_rope_attention.launches = 0
fused_qkv_rope_attention.head_dims = collections.Counter()  # launches by head dim
fused_cross_rope_attention.head_dims = collections.Counter()
