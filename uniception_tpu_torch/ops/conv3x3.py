"""
3x3 / stride-1 / pad-1 convolution over NHWC activations (counterpart of
uniception_tpu/ops/conv3x3.py), for the DPT head's eligible convs.

    * :func:`conv3x3_reference` — plain PyTorch: the conv in fp32 from the
      inputs' values, + fp32 bias, cast to x's dtype (the JAX reference's
      ``preferred_element_type=float32``);
    * :func:`conv3x3_nhwc` — the hand-written CUDA kernel (K7:
      csrc/conv3x3.cu, tiled by :func:`conv3x3_plan`) for CUDA tensors,
      through :class:`Conv3x3Function`,
      whose backward is the exact gradient of the plain conv (the JAX custom
      VJP, :98-131); a CPU tensor takes the plain version. The launch is the
      custom op ``uniception::conv3x3``, which an exported program replays.

Layouts are the JAX package's: x (B, H, W, C), w (3, 3, C, Co) (HWIO), b (Co,).
"""

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from uniception_tpu_torch.ops import kernel_lib
from uniception_tpu_torch.ops.gemm import SMS, sm_count
from uniception_tpu_torch.ops.serving_operands import kernel_op

__all__ = ["conv3x3_nhwc", "conv3x3_reference", "conv3x3_plan", "conv3x3_maps", "Conv3x3Function"]


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    "Plain PyTorch 3x3 conv over NHWC / HWIO: fp32 sums and bias, result in x's dtype, NHWC."
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), None, padding=1)
    if b is not None:
        y = y + b.float().reshape(1, -1, 1, 1)
    return y.to(x.dtype).permute(0, 2, 3, 1)


TILE_PIXELS = 128  # output pixels per tile (csrc/conv3x3.cu BM)
ITEM_STEPS = 2  # the planner's cost of a work item beyond its k-steps (ring fill, epilogue), in k-steps
_BIAS_TYPES = {None: 0, torch.float32: 1, torch.bfloat16: 2}


def conv3x3_plan(B: int, H: int, W: int, C: int, Co: int, sms: int = SMS):
    """K7's tiling of one conv: (tw, th, bn, split).

    An output tile is tw x th = 128 pixels of one image (tw the smallest power
    of two from 8 to 128 that covers W) by bn output channels: 256 where Co is
    a multiple of 256 and the tiles still fill ``sms`` SMs, else 128. The K
    loop (9 taps x C / 64 channel chunks) is cut into ranges of ``per``
    steps, split = ceil(steps / per) of them, none empty. The persistent
    grid gives each SM ceil(items / sms) items of ``per`` steps plus
    ITEM_STEPS for the item's ring fill and epilogue, so ``per`` is the one
    with the least such makespan, the fewest ranges among equals: a second
    wave that is mostly idle costs as much as the first, so 128 items on
    132 SMs beat 160.
    """
    tw = 8
    while tw < min(W, TILE_PIXELS):
        tw *= 2
    th = TILE_PIXELS // tw
    px_tiles = B * -(-H // th) * -(-W // tw)
    bn = 256 if Co % 256 == 0 and px_tiles * (Co // 256) >= sms else 128
    tiles = px_tiles * -(-Co // bn)
    steps = 9 * (C // 64)
    splits = {-(-steps // per): per for per in range(steps, 0, -1)}  # each split with its smallest per
    split = min(splits, key=lambda n: (-(-tiles * n // sms) * (splits[n] + ITEM_STEPS), n))
    return tw, th, bn, split


def conv3x3_maps(B: int, H: int, W: int, C: int, Co: int, tw: int, th: int):
    """K7's two tensor maps as its C entry point takes them (19 ints), for contiguous bf16 x and w.

    x (B, H, W, C): the dims innermost first (C, W, H, B), the byte strides of
    W, H and B, and the box (64, tw, th, 1): 64 channels of a tw x th pixel
    rectangle, which a tap (dy, dx) loads at (c0, x0 + dx - 1, y0 + dy - 1, b).
    TMA fills the box's coordinates outside the image with zeros: the padding.
    w (3, 3, C, Co), HWIO, as a (tap, C, Co) tensor: the dims (Co, C, 9), the
    byte strides of C and tap, and the box (64, 64, 1): 64 input channels of 64
    output channels of one tap.
    """
    return (C, W, H, B, 2 * C, 2 * W * C, 2 * H * W * C, 64, tw, th, 1,
            Co, C, 9, 2 * Co, 2 * C * Co, 64, 64, 1)


@functools.lru_cache(maxsize=64)
def _maps_array(*args):
    return (ctypes.c_longlong * 19)(*conv3x3_maps(*args))


def _conv3x3_kernel(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch K7 on CUDA tensors; raises on what it does not take. Returns a contiguous NHWC tensor.

    A bfloat16 contiguous HWIO weight and a float32 or bfloat16 bias are read as they are: the call then
    launches only K7 (its conv kernel, and its reduction when the plan splits the K loop). Any other weight
    is made so first (a cast or copy)."""
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
    if w.dtype != torch.bfloat16 or not w.is_contiguous() or w.data_ptr() % 16:
        w = w.to(torch.bfloat16).contiguous()
    if b is not None and (b.dtype not in _BIAS_TYPES or not b.is_contiguous()):
        b = b.float().contiguous()
    tw, th, bn, split = conv3x3_plan(B, H, W, C, Co, sm_count(x.device.index or 0))
    out = torch.empty((B, H, W, Co), dtype=x.dtype, device=x.device)
    ws = torch.empty((split, B, H, W, Co), dtype=torch.float32, device=x.device) if split > 1 else None
    status = kernel_lib.library().uc_conv3x3(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), _BIAS_TYPES[None if b is None else b.dtype],
        out.data_ptr(), None if ws is None else ws.data_ptr(), _maps_array(B, H, W, C, Co, tw, th), bn, split,
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
        return conv3x3_op(x, w, b)

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
    read as HWIO and the bias in its own dtype (float32 or bfloat16), so a
    bfloat16 contiguous weight costs no copy. A CPU tensor takes
    :func:`conv3x3_reference`. Returns
    (B, H, W, Co) in x's dtype. The launch is the custom op
    ``uniception::conv3x3``. ``conv3x3_nhwc.launches`` counts the launches.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3_nhwc: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        # a CPU tensor differentiates the plain version itself
        return conv3x3_reference(x, w, b) if x.device.type == "cpu" else Conv3x3Function.apply(x, w, b)
    return conv3x3_op(x, w, b)


@kernel_op("conv3x3")
def conv3x3_op(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    "K7 as one op: :func:`conv3x3_reference` on a CPU tensor, else the checked and counted launch."
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, b).contiguous()
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_nhwc: unsupported device {x.device}")
    return _conv3x3_kernel(x, w, b)


@conv3x3_op.register_fake
def _(x, w, b):
    return x.new_empty((*x.shape[:3], w.shape[3]))


conv3x3_nhwc.launches = 0
