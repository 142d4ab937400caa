"""
2D rotary position embedding (counterpart of uniception_tpu/ops/rope.py).

Layout (identical to the JAX package and the reference's cuRoPE2D): each
head's D splits into a y half and an x half, each into [u | v] quarters of
Q = D/4, rotated by ``angle = pos * F0 / base**(q/Q)``:

    out_u = u * cos - v * sin
    out_v = v * cos + u * sin

The inverse rotation is the same operation with -F0, and so is the
gradient: the transpose of a rotation is the rotation by the opposite angle
(the custom VJP of the JAX package's ``rope_2d_pallas``).

Two implementations over (B, N, H, D) tokens and (B, N, 2) integer (y, x)
positions:
    * :func:`rope_2d` — plain PyTorch, the reference for the kernel (and
      :func:`rope_precompute_cos_sin` / :func:`rope_2d_from_cos_sin`, the JAX
      package's plain pair with tables computed once and the rotation in the
      token dtype);
    * :func:`rope_2d_kernel` — the hand-written CUDA kernel (csrc/rope.cu) for
      CUDA tensors, through :class:`Rope2DFunction` when a gradient is
      needed; on a CPU tensor it takes :func:`rope_2d`. Each launch is the
      custom op ``uniception::rope2d`` (a fake kernel gives its output's
      shape to ``torch.export``), so an exported program replays it.
"""

import torch

from uniception_tpu_torch.models.utils.config import get_attention_impl
from uniception_tpu_torch.ops import kernel_lib
from uniception_tpu_torch.ops.serving_operands import kernel_op

__all__ = ["rope_2d", "rope_precompute_cos_sin", "rope_2d_from_cos_sin", "rope_2d_kernel", "Rope2DFunction",
           "Rope2D"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _inv_freq(quarter: int, base: float, f0: float, device) -> torch.Tensor:
    # computed in float64 and rounded once, exactly as the kernel computes its table
    q = torch.arange(quarter, dtype=torch.float64, device=device)
    return (f0 / base ** (q / quarter)).to(torch.float32)


def rope_precompute_cos_sin(positions: torch.Tensor, head_dim: int, base: float = 100.0, f0: float = 1.0):
    """(cos, sin) tables of shape (B, N, 2, D/4) in fp32 for (B, N, 2) integer
    (y, x) positions: axis 2 indexes (y, x), the last axis the quarter's
    frequencies (JAX ``rope_precompute_cos_sin``)."""
    if head_dim % 4 != 0:
        raise ValueError(f"head dim {head_dim} must be a multiple of 4 for RoPE2D")
    quarter = head_dim // 4
    ang = positions.to(torch.float32)[..., None] * _inv_freq(quarter, base, f0, positions.device)
    return ang.cos(), ang.sin()


def rope_2d_from_cos_sin(tokens: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE2D of (B, N, H, D) tokens from precomputed (B, N, 2, D/4) tables,
    computed in the tokens' dtype (JAX ``rope_2d_from_cos_sin``)."""
    B, N, H, D = tokens.shape
    Q = D // 4
    dt = tokens.dtype
    t = tokens.reshape(B, N, H, 2, 2, Q)
    u, v = t[..., 0, :], t[..., 1, :]
    c = cos[:, :, None].to(dt)  # (B, N, 1, 2, Q)
    s = sin[:, :, None].to(dt)
    return torch.stack([u * c - v * s, v * c + u * s], dim=-2).reshape(B, N, H, D)


def rope_2d(tokens: torch.Tensor, positions: torch.Tensor, base: float = 100.0, f0: float = 1.0) -> torch.Tensor:
    """Plain PyTorch RoPE2D.

    tokens: (B, N, H, D), D % 4 == 0; positions: (B, N, 2) int (y, x).
    cos/sin are rounded to the token dtype (as rope.py:78-79 of the JAX
    package does), the rotation runs in fp32 and the result is rounded once.
    """
    B, N, H, D = tokens.shape
    if D % 4 != 0:
        raise ValueError(f"head dim {D} must be a multiple of 4 for RoPE2D")
    Q = D // 4
    ang = positions.to(torch.float32)[..., None] * _inv_freq(Q, base, f0, tokens.device)  # (B, N, 2, Q)
    cos = ang.cos().to(tokens.dtype).float()[:, :, None]  # (B, N, 1, 2, Q)
    sin = ang.sin().to(tokens.dtype).float()[:, :, None]
    t = tokens.float().reshape(B, N, H, 2, 2, Q)
    u, v = t[..., 0, :], t[..., 1, :]
    out = torch.stack([u * cos - v * sin, v * cos + u * sin], dim=-2)
    return out.reshape(B, N, H, D).to(tokens.dtype)


def _rope_launch(tokens: torch.Tensor, positions: torch.Tensor, base: float, f0: float, backward: bool) -> torch.Tensor:
    "One counted launch of the kernel on a CUDA tensor; a CPU tensor takes :func:`rope_2d`."
    if tokens.device.type == "cpu":
        return rope_2d(tokens, positions, base, f0)
    if tokens.device.type != "cuda":
        raise ValueError(f"rope_2d_kernel: unsupported device {tokens.device}")
    if tokens.dim() != 4 or tokens.dtype not in _DTYPE_CODES:
        raise ValueError(f"rope_2d_kernel: want (B, N, H, D) float32/bfloat16, got {tuple(tokens.shape)} {tokens.dtype}")
    B, N, H, D = tokens.shape
    if D % 4 != 0 or D > 1024:
        raise ValueError(f"rope_2d_kernel: head dim {D} must be a multiple of 4 and at most 1024")
    if tokens.stride(-1) != 1:
        raise ValueError("rope_2d_kernel: tokens need a unit stride on the head dim")
    if positions.shape != (B, N, 2) or positions.dtype != torch.int32 or positions.device != tokens.device:
        raise ValueError(
            f"rope_2d_kernel: positions must be int32 ({B}, {N}, 2) on {tokens.device}, "
            f"got {positions.dtype} {tuple(positions.shape)} on {positions.device}"
        )
    out = torch.empty((B, N, H, D), dtype=tokens.dtype, device=tokens.device)
    if out.numel() == 0:
        return out
    sb, sn, sh, _ = tokens.stride()
    pb, pn, p2 = positions.stride()
    lib = kernel_lib.library()
    status = lib.uc_rope2d(
        tokens.data_ptr(), positions.data_ptr(), out.data_ptr(), _DTYPE_CODES[tokens.dtype],
        B, N, H, D, sb, sn, sh, pb, pn, p2, float(base), float(f0),
        torch.cuda.current_stream(tokens.device).cuda_stream,
    )
    kernel_lib.check(status, "rope2d")
    if backward:
        rope_2d_kernel.backward_launches += 1
    else:
        rope_2d_kernel.launches += 1
    return out


@kernel_op("rope2d")
def rope2d_op(tokens: torch.Tensor, positions: torch.Tensor, base: float, f0: float, backward: bool) -> torch.Tensor:
    "K2 as one op: :func:`_rope_launch` (counted as a forward or a ``backward`` launch)."
    return _rope_launch(tokens, positions, base, f0, backward)


@rope2d_op.register_fake
def _(tokens, positions, base, f0, backward):
    return tokens.new_empty(tokens.shape)


class Rope2DFunction(torch.autograd.Function):
    """RoPE2D whose backward is the same kernel with -F0; positions get no gradient."""

    @staticmethod
    def forward(ctx, tokens, positions, base, f0):
        ctx.save_for_backward(positions)
        ctx.base, ctx.f0 = base, f0
        return rope2d_op(tokens, positions, base, f0, False)

    @staticmethod
    def backward(ctx, grad):
        (positions,) = ctx.saved_tensors
        return rope2d_op(grad, positions, ctx.base, -ctx.f0, True), None, None, None


def rope_2d_kernel(tokens: torch.Tensor, positions: torch.Tensor, base: float = 100.0, f0: float = 1.0) -> torch.Tensor:
    """RoPE2D through the CUDA kernel; a CPU tensor takes :func:`rope_2d`.

    tokens: (B, N, H, D) float32 or bfloat16 with unit stride on D (any
    (b, n, h) strides); positions: (B, N, 2) int32 on the same device.
    Returns a new contiguous (B, N, H, D) tensor. When a gradient is needed
    this is :class:`Rope2DFunction`. ``rope_2d_kernel.launches`` counts the
    forward launches, ``rope_2d_kernel.backward_launches`` the backward ones.
    """
    if torch.is_grad_enabled() and tokens.requires_grad:
        return Rope2DFunction.apply(tokens, positions, float(base), float(f0))
    return rope2d_op(tokens, positions, float(base), float(f0), False)


rope_2d_kernel.launches = 0
rope_2d_kernel.backward_launches = 0


class Rope2D:
    """RoPE2D callable matching the reference module API (pos_embed.py:103-155).

    Stateless; one instance is shared by every attention layer of a model.
    Call: tokens (B, N, H, D), positions (B, N, 2) -> rotated tokens. CUDA
    tensors go through the kernel unless the "naive" implementation is set.
    """

    def __init__(self, freq: float = 100.0, F0: float = 1.0):
        self.base = float(freq)
        self.F0 = float(F0)

    def __call__(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        if get_attention_impl() == "naive":
            return rope_2d(tokens, positions, self.base, self.F0)
        return rope_2d_kernel(tokens, positions, self.base, self.F0)
