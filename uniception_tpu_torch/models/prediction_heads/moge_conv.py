"""
MoGe-v1 multi-level conv decoder head (counterpart of uniception_tpu/models/prediction_heads/moge_conv.py; reference
prediction_heads/moge_conv.py:17-248): per-level 1x1 projections summed, three 2x deconv + residual-block upsampling
stages with the view plane's UV coordinates concatenated before each (aspect-ratio awareness), a bilinear resize to
the target size (align_corners=False), and one conv block per output.

Its 3x3 convs are flax ``nnx.Conv`` after edge padding in the JAX package, outside any Pallas kernel, so here they
are ``F.pad(mode="replicate")`` and the stock conv (:class:`ReplicatePadConv`), never the 3x3 conv kernel. The
GroupNorms take flax's epsilon, 1e-6 (torch's default is 1e-5), with fp32 statistics; ``leaky_relu`` has slope 0.2.
"""

from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.models.prediction_heads.base import PixelTaskOutput, PredictionHeadLayeredInput
from uniception_tpu_torch.nn.common import GroupNorm, Identity, lecun_normal
from uniception_tpu_torch.nn.dpt_parts import Conv2dTorch, ConvTranspose2dTorch, Elementwise, Seq
from uniception_tpu_torch.utils.weights import load_encoder_checkpoint

__all__ = ["MoGeConvFeature", "ResidualConvBlock", "ReplicatePadConv", "GroupNorm", "normalized_view_plane_uv"]


class ReplicatePadConv(nn.Conv2d):
    """k x k conv after ``padding`` pixels of edge padding (torch's padding_mode="replicate"), with a compute
    ``dtype``; flax's init (lecun normal, zero bias)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, padding: int, *, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cin, cout, kernel_size, device=device)
        self.compute_dtype = dtype
        self.replicate_padding = padding
        lecun_normal(self.weight, cin * kernel_size * kernel_size, generator=generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        x = x.to(dt)
        p = self.replicate_padding
        if p:
            x = F.pad(x, (p, p, p, p), mode="replicate")
        return self._conv_forward(x, self.weight.to(dt), self.bias.to(dt))


def _activation(name: str) -> nn.Module:
    fns = {"relu": F.relu, "leaky_relu": lambda x: F.leaky_relu(x, 0.2), "silu": F.silu, "elu": F.elu}
    if name not in fns:
        raise ValueError(f"Unsupported activation function: {name}")
    return Elementwise(fns[name], name)


class ResidualConvBlock(nn.Module):
    "GroupNorm-act-conv twice, plus the input through a 1x1 conv where the widths differ (moge_conv.py:17-64)."

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        hidden_channels: Optional[int] = None,
        padding_mode: str = "replicate",
        activation: str = "relu",
        norm: str = "group_norm",
        *,
        dtype=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        out_channels = out_channels or in_channels
        hidden_channels = hidden_channels or in_channels
        kw = dict(dtype=dtype, device=device, generator=generator)
        groups2 = hidden_channels // 32 if norm == "group_norm" else 1
        self.layers = Seq(
            GroupNorm(in_channels, 1, dtype=dtype, device=device),
            _activation(activation),
            ReplicatePadConv(in_channels, hidden_channels, 3, 1, **kw),
            GroupNorm(hidden_channels, groups2, dtype=dtype, device=device),
            _activation(activation),
            ReplicatePadConv(hidden_channels, out_channels, 3, 1, **kw),
        )
        self.skip_connection = (Conv2dTorch(in_channels, out_channels, 1, 1, 0, **kw) if in_channels != out_channels
                                else Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x) + self.skip_connection(x)


def normalized_view_plane_uv(width: int, height: int, aspect_ratio: Optional[float] = None, dtype=torch.float32,
                             device=None) -> torch.Tensor:
    """The UV plane spanning the unit-diagonal view plane (moge_conv.py:67-87): (H, W, 2), u along the width. Built
    in float64 on ``device`` and rounded once to ``dtype``."""
    if aspect_ratio is None:
        aspect_ratio = width / height
    span_x = aspect_ratio / (1 + aspect_ratio**2) ** 0.5
    span_y = 1 / (1 + aspect_ratio**2) ** 0.5
    u = torch.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width, width, dtype=torch.float64,
                       device=device)
    v = torch.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height, height,
                       dtype=torch.float64, device=device)
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    return torch.stack([uu, vv], dim=-1).to(dtype)


class MoGeConvFeature(nn.Module):
    """MoGe conv decoder (moge_conv.py:90-248) over ``num_features`` BCHW levels of one token grid; (B, sum(dim_out),
    H, W) out at the target size. ``dtype`` is the compute dtype."""

    def __init__(
        self,
        patch_size: int,
        num_features: int,
        input_feature_dims: Union[int, List[int]],
        dim_out: List[int],
        dim_proj: int = 512,
        dim_upsample: List[int] = (256, 128, 64),
        dim_times_res_block_hidden: int = 2,
        num_res_blocks: int = 2,
        res_block_norm: str = "group_norm",
        last_res_blocks: int = 0,
        last_conv_channels: int = 32,
        last_conv_size: int = 1,
        pretrained_checkpoint_path: Optional[str] = None,
        *,
        dtype=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.patch_size = patch_size
        if isinstance(input_feature_dims, int):
            input_feature_dims = [input_feature_dims] * num_features
        self.input_feature_dims = list(input_feature_dims)
        dim_upsample = list(dim_upsample)
        kw = dict(dtype=dtype, device=device, generator=generator)

        self.projects = nn.ModuleList([Conv2dTorch(input_feature_dims[i], dim_proj, 1, 1, 0, **kw)
                                       for i in range(num_features)])

        def res_blocks(width, n):
            return [ResidualConvBlock(width, width, dim_times_res_block_hidden * width, activation="relu",
                                      norm=res_block_norm, **kw) for _ in range(n)]

        def upsampler(cin, cout):
            deconv = ConvTranspose2dTorch(cin, cout, 2, 2, **kw)
            with torch.no_grad():  # the reference repeats each kernel's [0, 0] tap over the 2 x 2 window at init
                deconv.weight.copy_(deconv.weight[:, :, :1, :1].expand_as(deconv.weight))
            return Seq(deconv, ReplicatePadConv(cout, cout, 3, 1, **kw))

        self.upsample_blocks = nn.ModuleList([
            Seq(upsampler(cin + 2, cout), *res_blocks(cout, num_res_blocks))
            for cin, cout in zip([dim_proj] + dim_upsample[:-1], dim_upsample)
        ])
        self.output_block = nn.ModuleList([
            Seq(ReplicatePadConv(dim_upsample[-1] + 2, last_conv_channels, 3, 1, **kw),
                *res_blocks(last_conv_channels, last_res_blocks), Elementwise(F.relu, "relu"),
                ReplicatePadConv(last_conv_channels, d, last_conv_size, last_conv_size // 2, **kw))
            for d in dim_out
        ])
        if pretrained_checkpoint_path is not None:
            print(f"Loading pretrained MoGe conv feature head from {pretrained_checkpoint_path}")
            load_encoder_checkpoint(self, pretrained_checkpoint_path)

    @staticmethod
    def _cat_uv(x: torch.Tensor, aspect: float) -> torch.Tensor:
        B, _, H, W = x.shape
        uv = normalized_view_plane_uv(W, H, aspect_ratio=aspect, dtype=x.dtype, device=x.device)
        return torch.cat([x, uv.permute(2, 0, 1)[None].expand(B, 2, H, W)], dim=1)

    def forward(self, head_input: PredictionHeadLayeredInput) -> PixelTaskOutput:
        img_h, img_w = head_input.target_output_shape
        aspect = img_w / img_h
        x = None
        for proj, feat in zip(self.projects, head_input.list_features):
            y = proj(feat)
            x = y if x is None else x + y
        for block in self.upsample_blocks:
            x = block(self._cat_uv(x, aspect))
        x = F.interpolate(x, size=(img_h, img_w), mode="bilinear", align_corners=False)
        x = self._cat_uv(x, aspect)
        return PixelTaskOutput(decoded_channels=torch.cat([block(x) for block in self.output_block], dim=1))
