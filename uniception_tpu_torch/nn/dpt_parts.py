"""
DPT internals (counterpart of uniception_tpu/nn/dpt_parts.py): the scratch
projection convs, residual conv units (with or without batch norm), feature
fusion blocks, the nonlinearity factory and the MultiMAE-style DPT output
adapter (reference uniception/models/libs/croco/dpt_block.py: make_scratch
:21-81, ResidualConvUnit_custom :114-178, FeatureFusionBlock_custom :180-256,
make_nonlinearity :258-274, DPTOutputAdapter :326-530).

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
from uniception_tpu_torch.ops.serving_operands import exporting, weight_layout

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
    "BatchNorm",
    "Elementwise",
    "DPTOutputAdapter",
    "DPT_ADAPTER_CHECKPOINT_ALIASES",
]

# DPTOutputAdapter's canonical keys are scratch.layer{i}_rn and act_{i}_postprocess; the reference torch module also
# aliases them as scratch.layer_rn.{i-1} and act_postprocess.{i-1} (dpt_block.py:71,488), which these patterns name.
DPT_ADAPTER_CHECKPOINT_ALIASES = (r"scratch\.layer_rn\.", r"(^|\.)act_postprocess\.")

# Sequential whose children sit at "0", "1", ...: the reference's nn.Sequential keys.
Seq = nn.Sequential


def _hwio(w: torch.Tensor) -> torch.Tensor:
    "An OIHW conv weight as K7 reads it: a contiguous bf16 (3, 3, C, Co) copy."
    return w.to(torch.bfloat16).permute(2, 3, 1, 0).contiguous()


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
        if exporting():  # an exported program takes the copy from its prepare program (ops/serving_operands.py)
            return weight_layout("k7_hwio", _hwio, w)
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if getattr(self, "_hwio_key", None) != key:
            self._hwio = _hwio(w.detach())
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


class Elementwise(nn.Module):
    "A parameter-free activation as a module, so that it can sit in a Sequential."

    def __init__(self, fn, name: str):
        super().__init__()
        self.fn, self.name = fn, name

    def forward(self, x):
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.name


def make_nonlinearity(nonlinearity: str, dim=None, on_channels: bool = False) -> nn.Module:
    "Activation factory (dpt_block.py:258-274); ``dim`` and ``on_channels`` are accepted and unused, as in JAX."
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
    return Elementwise(fns[nonlinearity], nonlinearity)


class BatchNorm(nn.BatchNorm2d):
    """``nnx.BatchNorm(use_running_average=True)``: always the running statistics, in training too; epsilon 1e-5;
    computed in fp32, the output in the compute ``dtype`` (None: the input's). Keys are torch's (weight, bias,
    running_mean, running_var, num_batches_tracked)."""

    def __init__(self, features: int, *, dtype=None, device=None):
        super().__init__(features, eps=1e-5, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        out = F.batch_norm(x.float(), self.running_mean.float(), self.running_var.float(), self.weight.float(),
                           self.bias.float(), False, 0.0, self.eps)
        return out.to(dt)


class ResidualConvUnit(nn.Module):
    "act-conv(-bn)-act-conv(-bn) + skip (dpt_block.py:114-178); with ``bn`` the convs have no bias."

    def __init__(self, features: int, activation: nn.Module, bn: bool, *, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.bn = bn
        self.conv1 = Conv2dTorch(features, features, 3, 1, 1, bias=not bn, **kw)
        self.conv2 = Conv2dTorch(features, features, 3, 1, 1, bias=not bn, **kw)
        if bn:
            self.bn1 = BatchNorm(features, dtype=dtype, device=device)
            self.bn2 = BatchNorm(features, dtype=dtype, device=device)
        self.activation = activation

    def forward(self, x):
        out = self.conv1(self.activation(x))
        if self.bn:
            out = self.bn1(out)
        out = self.conv2(self.activation(out))
        if self.bn:
            out = self.bn2(out)
        return out + x


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


class DPTOutputAdapter(nn.Module):
    """MultiMAE-style DPT output adapter (dpt_block.py:326-530; JAX nn/dpt_parts.py:237).

    Hooks four of a list of per-depth encoder token tensors (B, N, C), reshapes each to its token grid, resizes it
    through its ``act_{i}_postprocess`` (4x deconv / 2x deconv / identity / stride-2 conv), projects it with
    ``scratch.layer{i}_rn``, fuses coarse to fine through four refinenets and applies the "regression" or "semseg"
    output head. Returns NCHW. The resizers depend on the encoder's width and are built by :meth:`init` (or at
    construction with ``dim_tokens_enc``). Keys are the reference's canonical ones; its aliases are
    :data:`DPT_ADAPTER_CHECKPOINT_ALIASES`.
    """

    def __init__(
        self,
        num_channels: int = 1,
        stride_level: int = 1,
        patch_size=16,
        main_tasks=("rgb",),
        hooks=(2, 5, 8, 11),
        layer_dims=(96, 192, 384, 768),
        feature_dim: int = 256,
        last_dim: int = 32,
        use_bn: bool = False,
        dim_tokens_enc: Optional[int] = None,
        head_type: str = "regression",
        output_width_ratio=1,
        nonlinearity: str = "relu",
        *,
        dtype=None,
        device=None,
        generator: Optional[torch.Generator] = None,
        **_ignore,
    ):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.num_channels = num_channels
        self.stride_level = stride_level
        self.patch_size = (patch_size, patch_size) if isinstance(patch_size, int) else tuple(patch_size)
        self.main_tasks = tuple(main_tasks)
        self.hooks = list(hooks)
        self.layer_dims = list(layer_dims)
        self.feature_dim = feature_dim
        self.head_type = head_type
        self.dim_tokens_enc = None
        self.P_H = max(1, self.patch_size[0] // stride_level)
        self.P_W = max(1, self.patch_size[1] // stride_level)

        self.scratch = nn.Module()
        convs = make_scratch_convs(self.layer_dims, feature_dim, **kw)
        self.scratch.layer1_rn, self.scratch.layer2_rn, self.scratch.layer3_rn, self.scratch.layer4_rn = convs
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}",
                    make_fusion_block(feature_dim, use_bn, output_width_ratio, nonlinearity, **kw))
        if head_type == "regression":
            self.head = Seq(
                Conv2dTorch(feature_dim, feature_dim // 2, 3, 1, 1, **kw),
                Interpolate2x(2, "bilinear", True),
                Conv2dTorch(feature_dim // 2, last_dim, 3, 1, 1, **kw),
                make_nonlinearity(nonlinearity, dim=last_dim),
                Conv2dTorch(last_dim, num_channels, 1, 1, 0, **kw),
            )
        elif head_type == "semseg":
            self.head = Seq(
                Conv2dTorch(feature_dim, feature_dim, 3, 1, 1, bias=False, **kw),
                BatchNorm(feature_dim, dtype=dtype, device=device) if use_bn else nn.Identity(),
                make_nonlinearity(nonlinearity, dim=feature_dim),
                nn.Identity(),  # the reference's Dropout(0.1), a no-op at inference
                Conv2dTorch(feature_dim, num_channels, 1, 1, 0, **kw),
                Interpolate2x(2, "bilinear", True),
            )
        else:
            raise ValueError('DPT head_type must be "regression" or "semseg".')
        if dim_tokens_enc is not None:
            self.init(dim_tokens_enc=dim_tokens_enc, dtype=dtype, device=device, generator=generator)

    def init(self, dim_tokens_enc=768, *, dtype=None, device=None, generator: Optional[torch.Generator] = None):
        "Build the encoder-width-dependent resizers act_{1..4}_postprocess (dpt_block.py:408-490)."
        kw = dict(dtype=dtype, device=device, generator=generator)
        if isinstance(dim_tokens_enc, int):
            dim_tokens_enc = 4 * [dim_tokens_enc]
        self.dim_tokens_enc = [dt * len(self.main_tasks) for dt in dim_tokens_enc]
        d, ld = self.dim_tokens_enc, self.layer_dims
        self.act_1_postprocess = Seq(Conv2dTorch(d[0], ld[0], 1, 1, 0, **kw),
                                     ConvTranspose2dTorch(ld[0], ld[0], 4, 4, **kw))
        self.act_2_postprocess = Seq(Conv2dTorch(d[1], ld[1], 1, 1, 0, **kw),
                                     ConvTranspose2dTorch(ld[1], ld[1], 2, 2, **kw))
        self.act_3_postprocess = Seq(Conv2dTorch(d[2], ld[2], 1, 1, 0, **kw))
        self.act_4_postprocess = Seq(Conv2dTorch(d[3], ld[3], 1, 1, 0, **kw), Conv2dTorch(ld[3], ld[3], 3, 2, 1, **kw))

    def forward(self, encoder_tokens, image_size) -> torch.Tensor:
        "encoder_tokens: a list of (B, N, C); image_size: (H, W). Returns NCHW."
        if self.dim_tokens_enc is None:
            raise RuntimeError("Need to call init(dim_tokens_enc) first")
        H, W = image_size
        n_h, n_w = H // (self.stride_level * self.P_H), W // (self.stride_level * self.P_W)
        posts = [self.act_1_postprocess, self.act_2_postprocess, self.act_3_postprocess, self.act_4_postprocess]
        rn = [self.scratch.layer1_rn, self.scratch.layer2_rn, self.scratch.layer3_rn, self.scratch.layer4_rn]
        layers = []
        for hook, post, conv in zip(self.hooks, posts, rn):
            t = encoder_tokens[hook]
            t = t.reshape(t.shape[0], n_h, n_w, t.shape[-1]).permute(0, 3, 1, 2)
            layers.append(conv(post(t.contiguous(memory_format=torch.channels_last))))
        s = self.scratch
        path_3 = s.refinenet3(s.refinenet4(layers[3]), layers[2])
        path_1 = s.refinenet1(s.refinenet2(path_3, layers[1]), layers[0])
        return self.head(path_1)
