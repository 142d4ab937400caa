"""
Dense Representation Encoder (counterpart of uniception_tpu/models/encoders/dense_rep_encoder.py; reference
uniception/models/encoders/dense_rep_encoder.py:31-344): pixel-unshuffle patchify -> 3x3 conv -> residual conv
blocks -> 1x1 projection -> LayerNorm, then an optional sinusoid PE (base 70007, interpolated bicubically off its
grid) and a second LayerNorm.

Activations are NCHW; the 3x3 convs are :class:`~uniception_tpu_torch.nn.dpt_parts.Conv2dTorch`, so under
``config.set_conv3x3_impl("kernel")`` a bf16 encoder's eligible ones (C and Co multiples of 128) run on K7, the JAX
conv gate (nn/dpt_parts.py:58-79): at the default widths (588, 768, 1024) the residual blocks' convs 768 -> 768,
768 -> 1024 and 1024 -> 1024. The sinusoid PE is a non-persistent buffer, recomputed and never loaded.
"""

from typing import Callable, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.models.encoders.base import (
    UniCeptionViTEncoderBase,
    ViTEncoderInput,
    ViTEncoderNonImageInput,
    ViTEncoderOutput,
)
from uniception_tpu_torch.models.encoders.pe_utils import interpolate_patch_pos_embed, sinusoid_encoding_table
from uniception_tpu_torch.nn.blocks import layer_norm_factory
from uniception_tpu_torch.nn.common import gelu_exact
from uniception_tpu_torch.nn.dpt_parts import Conv2dTorch, Seq
from uniception_tpu_torch.utils.weights import load_encoder_checkpoint

__all__ = ["DenseRepresentationEncoder", "ResidualBlock"]


def _make_2tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


class ResidualBlock(nn.Module):
    "Residual conv block (dense_rep_encoder.py:31-52): act(conv2(act(conv1(x))) + shortcut(x)), NCHW."

    def __init__(self, in_channels: int, out_channels: int, act_layer: Callable = gelu_exact, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.conv1 = Conv2dTorch(in_channels, out_channels, 3, 1, 1, **kw)
        self.act = act_layer
        self.conv2 = Conv2dTorch(out_channels, out_channels, 3, 1, 1, **kw)
        self.shortcut = (Conv2dTorch(in_channels, out_channels, 1, 1, 0, **kw) if in_channels != out_channels
                         else nn.Identity())

    def forward(self, x):
        return self.act(self.conv2(self.act(self.conv1(x))) + self.shortcut(x))


class DenseRepresentationEncoder(UniCeptionViTEncoderBase):
    "UniCeption Dense Representation Encoder: BCHW features on the patch grid."

    def __init__(
        self,
        name: str,
        in_chans: int = 3,
        enc_embed_dim: int = 1024,
        apply_pe: bool = True,
        input_size_for_pe: Union[int, Tuple[int, int]] = 518,
        patch_size: int = 14,
        intermediate_dims: List[int] = (588, 768, 1024),
        data_norm_type: str = "dense_rep_encoder",
        act_layer: Callable = gelu_exact,
        norm_layer: Optional[Callable] = layer_norm_factory(eps=1e-6),
        post_pe_norm_layer: Optional[Callable] = layer_norm_factory(eps=1e-6),
        interpolate_antialias: bool = False,
        interpolate_offset: float = 0.1,
        pretrained_checkpoint_path: Optional[str] = None,
        *,
        device=None,
        dtype=None,
        param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(name=name, data_norm_type=data_norm_type, patch_size=patch_size)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.in_chans = in_chans
        self.enc_embed_dim = enc_embed_dim
        self.intermediate_dims = list(intermediate_dims)
        self.apply_pe = apply_pe

        self.conv_in = Conv2dTorch(in_chans * patch_size**2, intermediate_dims[0], 3, 1, 1, **kw)
        layers = [ResidualBlock(intermediate_dims[i], intermediate_dims[i + 1], act_layer, **kw)
                  for i in range(len(intermediate_dims) - 1)]
        layers.append(Conv2dTorch(intermediate_dims[-1], enc_embed_dim, 1, 1, 0, **kw))
        self.encoder = Seq(*layers)
        self.norm_layer = norm_layer(enc_embed_dim, device=device, dtype=dtype) if norm_layer else nn.Identity()

        if apply_pe:
            patch_hw = _make_2tuple(patch_size)
            self.input_size_for_pe = _make_2tuple(input_size_for_pe)
            self.patches_resolution = (self.input_size_for_pe[0] // patch_hw[0],
                                       self.input_size_for_pe[1] // patch_hw[1])
            self.num_patches = self.patches_resolution[0] * self.patches_resolution[1]
            table = sinusoid_encoding_table(self.num_patches, enc_embed_dim, 70007.0)
            self.register_buffer("pos_embed", torch.tensor(table, device=device), persistent=False)
            self.interpolate_antialias = interpolate_antialias
            self.interpolate_offset = interpolate_offset
            self.post_pe_norm = (post_pe_norm_layer(enc_embed_dim, device=device, dtype=dtype) if post_pe_norm_layer
                                 else nn.Identity())
        self.to(param_dtype)

        if pretrained_checkpoint_path:
            print(f"Loading custom pretrained Dense Representation Encoder checkpoint from {pretrained_checkpoint_path} ...")
            load_encoder_checkpoint(self, pretrained_checkpoint_path, ignore=(r"^pos_embed$",))

    def forward(self, encoder_input: Union[ViTEncoderInput, ViTEncoderNonImageInput]) -> ViTEncoderOutput:
        if isinstance(encoder_input, ViTEncoderInput):
            self._check_data_normalization_type(encoder_input.data_norm_type)
            data = encoder_input.image
        elif isinstance(encoder_input, ViTEncoderNonImageInput):
            data = encoder_input.data
        else:
            raise ValueError("Unsupported input type for Dense Representation Encoder.")
        if data.dim() != 4 or data.shape[1] != self.in_chans:
            raise ValueError(f"Input must be of shape (B, {self.in_chans}, H, W), got {tuple(data.shape)}")
        B, _, height, width = data.shape
        if height % self.patch_size or width % self.patch_size:
            raise ValueError(f"Input shape must be divisible by patch size: {self.patch_size}")
        hp, wp = height // self.patch_size, width // self.patch_size

        # (B, C * P^2, hp, wp) in channels-last memory, the layout the 3x3 conv kernel reads without a copy
        x = F.pixel_unshuffle(data, self.patch_size).contiguous(memory_format=torch.channels_last)
        x = self.encoder(self.conv_in(x))
        x = self.norm_layer(x.permute(0, 2, 3, 1).reshape(B, hp * wp, self.enc_embed_dim))
        if self.apply_pe:
            pe = interpolate_patch_pos_embed(self.pos_embed[None], hp, wp, self.interpolate_offset,
                                             self.interpolate_antialias)
            x = self.post_pe_norm(x + pe.to(x.dtype))
        return ViTEncoderOutput(features=x.reshape(B, hp, wp, self.enc_embed_dim).permute(0, 3, 1, 2))
