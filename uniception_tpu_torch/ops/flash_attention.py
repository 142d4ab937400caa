"""
Flash attention, forward and backward (counterpart of uniception_tpu/ops/flash_attention.py).

Non-causal softmax(q k^T * scale) v over (B, N, H, D) tensors, with fp32
scores and accumulators and p cast to v's dtype before the P.V product, as
the Pallas kernel computes it. Training saves the (B, H, Nq) fp32 logsumexp
of the scaled scores, and the backward recomputes p from it (the standard
FlashAttention-2 recurrence of the Pallas backward kernels).

    * :func:`flash_attention_ref`, :func:`flash_attention_lse_ref` and
      :func:`flash_attention_bwd_ref` — plain PyTorch, the references for the
      kernels; ``flash_attention_ref`` is also the "naive" implementation;
    * :func:`flash_attention_fwd` and :func:`flash_attention_bwd` — the
      hand-written CUDA kernels (K1: csrc/flash_attention.cu, K3:
      csrc/flash_attention_bwd.cu) for CUDA tensors; a CPU tensor takes the
      plain versions;
    * :class:`FlashAttentionFunction` — the autograd Function over the two;
    * :func:`flash_attention` — the entry point: through the Function when a
      gradient is needed, else the forward without the logsumexp.
"""

from typing import Optional

import torch

from uniception_tpu_torch.ops import kernel_lib

__all__ = [
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_bwd",
    "flash_attention_ref",
    "flash_attention_lse_ref",
    "flash_attention_bwd_ref",
    "FlashAttentionFunction",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64  # the one head dim the kernels are built for


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None):
    """Plain PyTorch attention with the kernel's numerics, and its logsumexp.

    q: (B, Nq, H, D); k, v: (B, Nk, H, D). Scores, max and sum in fp32; the
    unnormalized p is rounded to v's dtype before P.V (the Pallas kernel's
    ``p.astype(v.dtype)``), the fp32 result is divided by the fp32 sum and
    returned in q's dtype. Returns (out (B, Nq, H, D), lse (B, H, Nq) fp32),
    lse = max + log(sum) of the scaled scores.
    """
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * _scale(q, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)  # (B, H, Nq)
    out = torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype).float(), v.float()) / l.transpose(1, 2)[..., None]
    return out.to(q.dtype), m[..., 0] + torch.log(l)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    "Plain PyTorch attention with the kernel's numerics (:func:`flash_attention_lse_ref` without the logsumexp)."
    return flash_attention_lse_ref(q, k, v, scale)[0]


def flash_attention_bwd_ref(q, k, v, out, lse, dout, scale: Optional[float] = None):
    """Plain PyTorch backward from the saved logsumexp, with the Pallas kernels' numerics.

    delta = rowsum(dO * O) and p = exp(s * scale - lse) in fp32; dv = p^T dO
    with p rounded to dO's dtype; ds = p * (dO v^T - delta) * scale in fp32;
    dq = ds k and dk = ds^T q with ds rounded to k's and q's dtype. Returns
    contiguous (dq, dk, dv) in the dtypes of q, k and v.
    """
    scale = _scale(q, scale)
    f = lambda t: t.float()  # noqa: E731
    delta = (f(dout) * f(out)).sum(-1).transpose(1, 2)  # (B, H, Nq)
    s = torch.einsum("bnhd,bmhd->bhnm", f(q), f(k)) * scale
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhnm,bnhd->bmhd", f(p.to(dout.dtype)), f(dout))
    dp = torch.einsum("bnhd,bmhd->bhnm", f(dout), f(v))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhnm,bmhd->bnhd", f(ds.to(k.dtype)), f(k))
    dk = torch.einsum("bhnm,bnhd->bmhd", f(ds.to(q.dtype)), f(q))
    return dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


def _check(op, *tensors):
    "Raise on what the kernels do not take: q, k, v (and o, dO) of one device and dtype, D = 64, 16-byte vectors."
    q = tensors[0]
    for i, t in enumerate(tensors):
        name = ("q", "k", "v", "o", "dO")[i]
        if t.dim() != 4:
            raise ValueError(f"{op}: {name} must be (B, N, H, D), got {tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{op}: q/k/v must share device and dtype, {name} is {t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{op}: {name} needs a unit stride on the head dim")
        # 16-byte vector loads: aligned base and (b, n, h) strides
        if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in t.stride()[:3]):
            raise ValueError(f"{op}: {name} needs a 16-byte aligned base and (b, n, h) strides")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{op}: dtype {q.dtype} not supported (float32, bfloat16)")
    k, v = tensors[1], tensors[2]
    B, _, H, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"{op}: head dim {D} not supported (the kernel is built for {HEAD_DIM})")
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"{op}: k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if B > 65535 or H > 65535:
        raise ValueError(f"{op}: B and H must be at most 65535 (grid limits)")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError(f"{op}: empty query or key set")


def _on_cuda(op, t):
    "True for a CUDA tensor, False for a CPU tensor; raises on any other device."
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {t.device}")
    return t.device.type == "cuda"


def flash_attention_fwd(q, k, v, scale: Optional[float] = None, with_lse: bool = False):
    """K1: the flash-attention forward kernel; a CPU tensor takes :func:`flash_attention_lse_ref`.

    CUDA tensors (float32 or bfloat16, D = 64, unit stride on D, 16-byte
    aligned strides) launch the kernel; anything else on a CUDA device
    raises. Returns (out, lse): a contiguous (B, Nq, H, D) tensor in q's
    dtype, and with ``with_lse`` the (B, H, Nq) fp32 logsumexp, else None.
    ``flash_attention.launches`` counts the kernel launches,
    ``flash_attention.lse_launches`` those that wrote the logsumexp.
    """
    scale = _scale(q, scale)
    if not _on_cuda("flash_attention", q):
        out, lse = flash_attention_lse_ref(q, k, v, scale)
        return out, (lse if with_lse else None)
    _check("flash_attention", q, k, v)
    B, Nq, H, D = q.shape
    out = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Nq), dtype=torch.float32, device=q.device) if with_lse else None
    status = kernel_lib.library().uc_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        _DTYPE_CODES[q.dtype], B, H, Nq, k.shape[1], D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernel_lib.check(status, "flash_attention_fwd")
    flash_attention.launches += 1
    flash_attention.lse_launches += with_lse
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, scale: Optional[float] = None):
    """K3: the flash-attention backward kernels; a CPU tensor takes :func:`flash_attention_bwd_ref`.

    q/k/v as for :func:`flash_attention_fwd` (read by stride), ``out`` and
    ``lse`` the forward's outputs, ``dout`` the output gradient (made
    contiguous when its layout does not fit the kernel). Returns contiguous
    (dq, dk, dv) in the input dtype. Anything the kernel does not take on a
    CUDA device raises. ``flash_attention_bwd.launches`` counts the calls
    (each launches the delta, dq and dk/dv kernels).
    """
    scale = _scale(q, scale)
    if not _on_cuda("flash_attention_bwd", q):
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, scale)
    if dout.stride(-1) != 1 or dout.data_ptr() % 16 or any(s * dout.element_size() % 16 for s in dout.stride()[:3]):
        dout = dout.contiguous()
    _check("flash_attention_bwd", q, k, v, out, dout)
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    if out.shape != q.shape or not out.is_contiguous() or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o must be contiguous and o, dO shaped like q {tuple(q.shape)}")
    if lse.shape != (B, H, Nq) or lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous float32 ({B}, {H}, {Nq}) tensor on {q.device}")
    delta = torch.empty((B, H, Nq), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Nk, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Nk, H, D), dtype=q.dtype, device=q.device)
    status = kernel_lib.library().uc_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPE_CODES[q.dtype], B, H, Nq, Nk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernel_lib.check(status, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the kernels in both directions: the forward writes the
    logsumexp (K1) and saves (q, k, v, out, lse); the backward is K3. CPU
    tensors take the plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over (B, N, H, D) tensors (non-causal, no mask).

    When a gradient is needed (grad mode on and q, k or v requires it) this
    is :class:`FlashAttentionFunction`; otherwise the forward alone, without
    the logsumexp. CUDA tensors launch the kernels (or raise), CPU tensors
    take the plain versions. Returns a (B, Nq, H, D) tensor in q's dtype.
    """
    scale = _scale(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, scale)
    return flash_attention_fwd(q, k, v, scale)[0]


flash_attention.launches = 0
flash_attention.lse_launches = 0
