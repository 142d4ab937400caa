"""
Patch Embedder encoder: a bare conv patchifier, an optional norm, a learned PE table interpolated to the input's
grid, and a post-PE norm (counterpart of uniception_tpu/models/encoders/patch_embedder.py; reference
uniception/models/encoders/patch_embedder.py:30-181). It takes an image or any dense 2D grid
(:class:`ViTEncoderNonImageInput`).
"""

from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.models.encoders.base import (
    UniCeptionViTEncoderBase,
    ViTEncoderInput,
    ViTEncoderNonImageInput,
    ViTEncoderOutput,
)
from uniception_tpu_torch.models.encoders.pe_utils import interpolate_patch_pos_embed
from uniception_tpu_torch.nn.blocks import layer_norm_factory
from uniception_tpu_torch.nn.common import Identity, trunc_normal
from uniception_tpu_torch.utils.checkpoint import load_checkpoint
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

__all__ = ["PatchEmbedder"]


def _make_2tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


class PatchEmbedder(UniCeptionViTEncoderBase):
    "UniCeption Patch Embedder: BCHW features of the patch grid."

    def __init__(
        self,
        name: str,
        data_norm_type: str = "patch_embedder",
        input_size: Union[int, Tuple[int, int]] = 518,
        patch_size: int = 14,
        in_chans: int = 3,
        enc_embed_dim: int = 1024,
        norm_layer: Optional[Callable] = None,
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
        patch_hw = _make_2tuple(patch_size)
        self.input_size = _make_2tuple(input_size)
        self.patches_resolution = (self.input_size[0] // patch_hw[0], self.input_size[1] // patch_hw[1])
        self.num_patches = self.patches_resolution[0] * self.patches_resolution[1]
        self.in_chans = in_chans
        self.enc_embed_dim = enc_embed_dim
        self.interpolate_antialias = interpolate_antialias
        self.interpolate_offset = interpolate_offset
        self.compute_dtype = dtype

        self.proj = nn.Conv2d(in_chans, enc_embed_dim, patch_hw, stride=patch_hw, device=device)
        # flax nnx.Conv's default init: lecun normal (truncated, std 1/sqrt(fan_in)), zero bias
        trunc_normal(self.proj.weight, (in_chans * patch_hw[0] * patch_hw[1]) ** -0.5, generator=generator)
        with torch.no_grad():
            self.proj.bias.zero_()
        self.norm = norm_layer(enc_embed_dim, device=device, dtype=dtype) if norm_layer else Identity()
        self.pos_embed = nn.Parameter(
            trunc_normal(torch.empty(1, self.num_patches, enc_embed_dim, device=device), 0.02, generator=generator))
        self.post_pe_norm = post_pe_norm_layer(enc_embed_dim, device=device, dtype=dtype) if post_pe_norm_layer \
            else Identity()
        self.to(param_dtype)

        if pretrained_checkpoint_path:
            print(f"Loading custom pretrained Patch Embedder checkpoint from {pretrained_checkpoint_path} ...")
            load_state_dict_numpy(self, load_checkpoint(pretrained_checkpoint_path)["model"])

    def forward(self, encoder_input: Union[ViTEncoderInput, ViTEncoderNonImageInput]) -> ViTEncoderOutput:
        if isinstance(encoder_input, ViTEncoderInput):
            self._check_data_normalization_type(encoder_input.data_norm_type)
            data = encoder_input.image
        elif isinstance(encoder_input, ViTEncoderNonImageInput):
            data = encoder_input.data
        else:
            raise ValueError("Unsupported input type for Patch Embedder.")
        if data.dim() != 4:
            raise ValueError(f"Input must be of shape (B, C, H, W), got {tuple(data.shape)}")
        B, _, height, width = data.shape
        if height % self.patch_size or width % self.patch_size:
            raise ValueError(f"Input shape must be divisible by patch size: {self.patch_size}")
        hp, wp = height // self.patch_size, width // self.patch_size

        dt = self.compute_dtype or self.proj.weight.dtype
        x = F.conv2d(data.to(dt), self.proj.weight.to(dt), self.proj.bias.to(dt), stride=self.proj.stride)
        x = self.norm(x.flatten(2).transpose(1, 2))
        pe = interpolate_patch_pos_embed(self.pos_embed, hp, wp, self.interpolate_offset, self.interpolate_antialias)
        x = self.post_pe_norm(x + pe.to(x.dtype))
        return ViTEncoderOutput(features=x.reshape(B, hp, wp, self.enc_embed_dim).permute(0, 3, 1, 2))
