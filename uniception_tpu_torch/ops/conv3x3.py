"""
3x3 / stride-1 / pad-1 convolution over NHWC activations (counterpart of
uniception_tpu/ops/conv3x3.py), for the DPT head's eligible convs.

    * :func:`conv3x3_reference` — plain PyTorch: the conv in fp32 from the
      inputs' values, + fp32 bias, cast to x's dtype (the JAX reference's
      ``preferred_element_type=float32``);
    * :func:`conv3x3_nhwc` — the hand-written CUDA kernel (K7:
      csrc/conv3x3.cu) for CUDA tensors, through :class:`Conv3x3Function`,
      whose backward is the exact gradient of the plain conv (the JAX custom
      VJP, :98-131); a CPU tensor takes the plain version.

Layouts are the JAX package's: x (B, H, W, C), w (3, 3, C, Co) (HWIO), b (Co,).
"""

from typing import Optional

import torch
import torch.nn.functional as F

from uniception_tpu_torch.ops import kernel_lib

__all__ = ["conv3x3_nhwc", "conv3x3_reference", "Conv3x3Function"]


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    "Plain PyTorch 3x3 conv over NHWC / HWIO: fp32 sums and bias, result in x's dtype, NHWC."
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), None, padding=1)
    if b is not None:
        y = y + b.float().reshape(1, -1, 1, 1)
    return y.to(x.dtype).permute(0, 2, 3, 1)


def _conv3x3_kernel(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    "Launch K7 on CUDA tensors; raises on what it does not take. Returns a contiguous NHWC tensor."
    if x.dim() != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"conv3x3_nhwc: x {tuple(x.shape)} and w {tuple(w.shape)} are not NHWC / (3, 3, C, Co)")
    B, H, W, C = x.shape
    Co = w.shape[3]
    if x.dtype != torch.bfloat16 or w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError(f"conv3x3_nhwc: needs bfloat16 x and w, b on {x.device}; got {x.dtype}")
    if C % 64 or Co % 8:
        raise ValueError(f"conv3x3_nhwc: C = {C} must be a multiple of 64 and Co = {Co} of 8")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("conv3x3_nhwc: x must be a contiguous NHWC tensor (a channels_last NCHW one, permuted)")
    wk = w.to(torch.bfloat16).permute(3, 0, 1, 2).contiguous()  # (Co, 3, 3, C): K-contiguous B fragments
    bias = None if b is None else b.float().contiguous()
    out = torch.empty((B, H, W, Co), dtype=x.dtype, device=x.device)
    status = kernel_lib.library().uc_conv3x3(
        x.data_ptr(), wk.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(), B, H, W, C, Co,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernel_lib.check(status, "conv3x3_nhwc")
    conv3x3_nhwc.launches += 1
    return out


class Conv3x3Function(torch.autograd.Function):
    """K7 forward; the backward is the gradient of :func:`conv3x3_reference`
    (``torch.nn.grad`` on the fp32 conv), so training through it is exact."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return _conv3x3_kernel(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        g32 = g.float().permute(0, 3, 1, 2)
        x32, w32 = x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1)  # NCHW, OIHW
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x32.shape, w32, g32, padding=1).permute(0, 2, 3, 1).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x32, w32.shape, g32, padding=1).permute(2, 3, 1, 0).to(w.dtype)
        if b is not None and ctx.needs_input_grad[2]:
            db = g32.sum(dim=(0, 2, 3)).to(b.dtype)
        return dx, dw, db


def conv3x3_nhwc(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7: 3x3 / stride-1 / pad-1 conv of NHWC ``x`` with HWIO ``w`` (+ ``b``).

    CUDA tensors (bfloat16 x, contiguous NHWC, C % 64 == 0, Co % 8 == 0)
    launch the kernel; anything else on a CUDA device raises. The weight is
    cast to bfloat16 and laid out as (Co, 3, 3, C) at each call, the bias
    used in fp32. A CPU tensor takes :func:`conv3x3_reference`. Returns
    (B, H, W, Co) in x's dtype. ``conv3x3_nhwc.launches`` counts the launches.
    """
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_nhwc: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        return Conv3x3Function.apply(x, w, b)
    return _conv3x3_kernel(x, w, b)


conv3x3_nhwc.launches = 0
