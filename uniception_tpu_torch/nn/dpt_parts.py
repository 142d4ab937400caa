"""
DPT internals (counterpart of uniception_tpu/nn/dpt_parts.py): the scratch
projection convs, residual conv units, feature fusion blocks and the
nonlinearity factory (reference uniception/models/libs/croco/dpt_block.py:
make_scratch :21-81, ResidualConvUnit_custom :114-178,
FeatureFusionBlock_custom :180-256, make_nonlinearity :258-274).

Activations are NCHW tensors kept in ``channels_last`` memory (the JAX DPT runs
NHWC), so the 3x3 conv kernel (K7, ops/conv3x3.py) reads them as NHWC without
a copy; weights keep torch's layouts, the reference's state-dict keys. Every
conv takes a compute ``dtype`` (None: the parameters' dtype), as
``nnx.Conv(dtype=...)``. The 2x bilinear upsample is
``F.interpolate(..., align_corners=True)``.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.models.utils.config import get_attention_impl, get_conv3x3_impl
from uniception_tpu_torch.ops.conv3x3 import conv3x3_nhwc, conv3x3_reference

__all__ = [
    "make_scratch_convs",
    "make_fusion_block",
    "ResidualConvUnit",
    "FeatureFusionBlock",
    "make_nonlinearity",
    "Conv2dTorch",
    "ConvTranspose2dTorch",
    "Seq",
    "Interpolate2x",
]

# Sequential whose children sit at "0", "1", ...: the reference's nn.Sequential keys.
Seq = nn.Sequential


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]):
    "The JAX convs' default init scale (lecun normal, untruncated), from ``generator``."
    with torch.no_grad():
        nn.init.normal_(weight, std=1.0 / math.sqrt(fan_in), generator=generator)


class Conv2dTorch(nn.Conv2d):
    """nn.Conv2d with a compute dtype and the 3x3 conv kernel's routing
    (the JAX ``_Conv2dDPT``, nn/dpt_parts.py:57-80).

    A conv takes K7 when the conv3x3 implementation is "kernel", the input is
    a CUDA tensor, the attention implementation is "kernel" (the "naive"
    switch sends every kernel to its plain version, here
    :func:`conv3x3_reference`), and the JAX package's gates hold: a bf16
    input to a module computing in bf16, 3x3 / stride 1 / padding 1 / one
    group, H * W <= 256^2, and C and Co multiples of 128. Everything else is
    the stock conv.
    """

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0, bias=True, *, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding, bias=bias, device=device)
        self.compute_dtype = dtype
        _lecun_normal_(self.weight, cin * self.kernel_size[0] * self.kernel_size[1], generator)
        if bias:
            with torch.no_grad():
                self.bias.zero_()

    def takes_conv3x3(self, x: torch.Tensor) -> bool:
        "Whether this call goes to the 3x3 conv kernel or, under the 'naive' switch, its plain version."
        return (
            get_conv3x3_impl() == "kernel"
            and x.is_cuda
            and x.dtype == torch.bfloat16
            and self.compute_dtype == torch.bfloat16  # only modules built for bf16 (the head_dtype region)
            and self.kernel_size == (3, 3)
            and self.stride == (1, 1)
            and self.padding == (1, 1)
            and self.dilation == (1, 1)
            and self.groups == 1
            and x.dim() == 4
            and x.shape[2] * x.shape[3] <= 256 * 256
            and x.shape[1] % 128 == 0
            and self.out_channels % 128 == 0
        )

    def _hwio_weight(self) -> torch.Tensor:
        """The weight as the conv kernel reads it: bf16 (3, 3, C, Co). Inference keeps one contiguous copy,
        remade only when the weight changes (its storage or version), so a call launches no relayout; with a
        gradient it is a view of the weight, which autograd follows."""
        w = self.weight
        if torch.is_grad_enabled() and w.requires_grad:
            return w.to(torch.bfloat16).permute(2, 3, 1, 0)
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if getattr(self, "_hwio_key", None) != key:
            self._hwio = w.detach().to(torch.bfloat16).permute(2, 3, 1, 0).contiguous()
            self._hwio_key = key
        return self._hwio

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.takes_conv3x3(x):
            fn = conv3x3_reference if get_attention_impl() == "naive" else conv3x3_nhwc
            x_nhwc = x.permute(0, 2, 3, 1)
            if not x_nhwc.is_contiguous():
                x_nhwc = x_nhwc.contiguous()
            return fn(x_nhwc, self._hwio_weight(), self.bias).permute(0, 3, 1, 2)
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2dTorch(nn.ConvTranspose2d):
    "nn.ConvTranspose2d (padding 0) with a compute dtype; the weight is torch's (in, out, kh, kw)."

    def __init__(self, cin, cout, kernel_size, stride, *, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cin, cout, kernel_size, stride=stride, device=device)
        self.compute_dtype = dtype
        _lecun_normal_(self.weight, cin * self.kernel_size[0] * self.kernel_size[1], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride)


class _Elementwise(nn.Module):
    "A parameter-free activation as a module, so that it can sit in a Sequential."

    def __init__(self, fn, name: str):
        super().__init__()
        self.fn, self.name = fn, name

    def forward(self, x):
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.name


def make_nonlinearity(nonlinearity: str) -> nn.Module:
    "Activation factory (dpt_block.py:258-274)."
    fns = {
        "relu": F.relu,
        "sine": torch.sin,
        "gaussian": lambda x: torch.exp(-(x**2)),
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "xcosx": lambda x: x * torch.cos(x),
    }
    if nonlinearity not in fns:
        raise ValueError(f"Unknown nonlinearity: {nonlinearity}")
    return _Elementwise(fns[nonlinearity], nonlinearity)


class ResidualConvUnit(nn.Module):
    "act-conv-act-conv + skip (dpt_block.py:114-178)."

    def __init__(self, features: int, activation: nn.Module, bn: bool, *, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if bn:
            raise NotImplementedError("batch norm in the DPT residual units is not ported (unused by DUSt3R)")
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.conv1 = Conv2dTorch(features, features, 3, 1, 1, bias=True, **kw)
        self.conv2 = Conv2dTorch(features, features, 3, 1, 1, bias=True, **kw)
        self.activation = activation

    def forward(self, x):
        return self.conv2(self.activation(self.conv1(self.activation(x)))) + x


class FeatureFusionBlock(nn.Module):
    """Fusion + 2x upsample (dpt_block.py:180-256), width_ratio 1. ``has_res1=False``
    mirrors the reference deleting refinenet4's unused resConfUnit1 (dpt.py:82-83)."""

    def __init__(self, features: int, activation: nn.Module, bn: bool = False, align_corners: bool = True,
                 has_res1: bool = True, *, dtype=None, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.align_corners = align_corners
        self.out_conv = Conv2dTorch(features, features, 1, 1, 0, bias=True, **kw)
        if has_res1:
            self.resConfUnit1 = ResidualConvUnit(features, activation, bn, **kw)
        self.resConfUnit2 = ResidualConvUnit(features, activation, bn, **kw)

    def forward(self, x, res: Optional[torch.Tensor] = None):
        "x, res: NCHW. Returns NCHW at twice the spatial size."
        output = x if res is None else x + self.resConfUnit1(res)
        output = self.resConfUnit2(output)
        output = F.interpolate(output, scale_factor=2, mode="bilinear", align_corners=self.align_corners)
        return self.out_conv(output)


def make_fusion_block(features, use_bn, width_ratio=1, nonlinearity="relu", has_res1=True, *, dtype=None,
                      device=None, generator: Optional[torch.Generator] = None) -> FeatureFusionBlock:
    if width_ratio != 1:
        raise ValueError("width_ratio != 1 is not supported (unused by the reference models)")
    return FeatureFusionBlock(features, make_nonlinearity(nonlinearity), bn=use_bn, align_corners=True,
                              has_res1=has_res1, dtype=dtype, device=device, generator=generator)


def make_scratch_convs(in_shape, out_shape, *, dtype=None, device=None,
                       generator: Optional[torch.Generator] = None) -> nn.ModuleList:
    "Per-level 3x3 projection convs (dpt_block.py:21-81, expand=False)."
    return nn.ModuleList(
        [Conv2dTorch(cin, out_shape, 3, 1, 1, bias=False, dtype=dtype, device=device, generator=generator)
         for cin in in_shape]
    )


class Interpolate2x(nn.Module):
    "Parameter-free bilinear upsample layer over NCHW (dpt_block.py Interpolate)."

    def __init__(self, scale_factor=2, mode="bilinear", align_corners=True):
        super().__init__()
        self.scale_factor, self.mode, self.align_corners = scale_factor, mode, align_corners

    def forward(self, x):
        return F.interpolate(x, scale_factor=self.scale_factor, mode=self.mode, align_corners=self.align_corners)
