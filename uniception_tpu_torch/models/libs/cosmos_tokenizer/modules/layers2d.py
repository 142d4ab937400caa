"""
The Cosmos tokenizer's 2D layers, a stable-diffusion style autoencoder (counterpart of
uniception_tpu/models/libs/cosmos_tokenizer/modules/layers2d.py; reference
uniception/models/libs/cosmos_tokenizer/modules/layers2d.py:38-331): Upsample (nearest 2x, then a 3x3 conv),
Downsample (zero padding on the bottom and right only, then a stride-2 3x3 conv), ResnetBlock (GroupNorm, silu and a
3x3 conv twice, plus a 1x1 shortcut where the widths differ), the single-head AttnBlock over the flattened grid, and
the Encoder and Decoder pyramids with haar or rearrange patching.

Activations are NCHW (torch's idiom; the JAX modules run NHWC inside) and the state-dict keys are the reference's
(``down.{i}.block.{j}.*``, ``mid.attn_1.*``, ...). The 3x3 / stride-1 convs are
:class:`~uniception_tpu_torch.nn.dpt_parts.Conv2dTorch`: in a module built with ``dtype=torch.bfloat16`` and under
``config.set_conv3x3_impl("kernel")`` those with C and Co multiples of 128 run on K7 (the JAX gate), ``conv_in`` (C =
48, or the latent's 16) and ``conv_out`` (Co = 16, or 48) stay on cuDNN. AttnBlock's attention goes through
:func:`~uniception_tpu_torch.ops.attention.scaled_dot_product_attention` at (B, H * W, 1, C): K1 at D = 512 on the
card. Its ``attn_resolutions`` ([32] in every published config) never match the pyramid's levels at the Cosmos
configs, so only the two mid blocks attend.
"""

import math
from typing import List, Optional

import torch
from torch import nn

from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules.patching import Patcher, UnPatcher
from uniception_tpu_torch.nn.common import GroupNorm, Identity
from uniception_tpu_torch.nn.dpt_parts import Conv2dTorch
from uniception_tpu_torch.ops.attention import scaled_dot_product_attention

__all__ = ["Normalize", "Upsample", "Downsample", "ResnetBlock", "AttnBlock", "Encoder", "Decoder"]


def nonlinearity(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)  # silu (utils.py:57-58)


def Normalize(in_channels: int, num_groups: int = 32, *, dtype=None, device=None) -> GroupNorm:
    "32 groups, epsilon 1e-6, flax's fast variance: ``nnx.GroupNorm`` as the JAX package builds it."
    return GroupNorm(in_channels, num_groups, dtype=dtype, device=device)


class Upsample(nn.Module):
    "Nearest 2x, then a 3x3 conv (layers2d.py:38-46)."

    def __init__(self, in_channels: int, *, dtype=None, device=None, generator=None):
        super().__init__()
        self.conv = Conv2dTorch(in_channels, in_channels, 3, 1, 1, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


class Downsample(nn.Module):
    "Zero padding of one row and one column on the bottom and right, then a stride-2 3x3 conv (layers2d.py:49-57)."

    def __init__(self, in_channels: int, *, dtype=None, device=None, generator=None):
        super().__init__()
        self.conv = Conv2dTorch(in_channels, in_channels, 3, 2, 0, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nn.functional.pad(x, (0, 1, 0, 1)))


class ResnetBlock(nn.Module):
    "GroupNorm-silu-conv twice, plus a 1x1 shortcut where the widths differ (layers2d.py:60-97)."

    def __init__(self, *, in_channels: int, out_channels: Optional[int] = None, dropout: float = 0.0, dtype=None,
                 device=None, generator=None):
        super().__init__()
        out_channels = in_channels if out_channels is None else out_channels
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.norm1 = Normalize(in_channels, dtype=dtype, device=device)
        self.conv1 = Conv2dTorch(in_channels, out_channels, 3, 1, 1, **kw)
        self.norm2 = Normalize(out_channels, dtype=dtype, device=device)
        self.conv2 = Conv2dTorch(out_channels, out_channels, 3, 1, 1, **kw)
        self.nin_shortcut = (Conv2dTorch(in_channels, out_channels, 1, 1, 0, **kw) if in_channels != out_channels
                             else Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(nonlinearity(self.norm1(x)))
        h = self.conv2(nonlinearity(self.norm2(h)))
        return self.nin_shortcut(x) + h


class AttnBlock(nn.Module):
    "Single-head self-attention over the H * W grid with D = C (layers2d.py:100-137)."

    def __init__(self, in_channels: int, *, dtype=None, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.norm = Normalize(in_channels, dtype=dtype, device=device)
        self.q = Conv2dTorch(in_channels, in_channels, 1, 1, 0, **kw)
        self.k = Conv2dTorch(in_channels, in_channels, 1, 1, 0, **kw)
        self.v = Conv2dTorch(in_channels, in_channels, 1, 1, 0, **kw)
        self.proj_out = Conv2dTorch(in_channels, in_channels, 1, 1, 0, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h_ = self.norm(x)

        def tokens(t):  # (B, C, H, W) -> (B, H * W, 1, C), C contiguous (an NCHW input's reshape is a view)
            return t.permute(0, 2, 3, 1).reshape(B, H * W, 1, C).contiguous()

        h_ = scaled_dot_product_attention(tokens(self.q(h_)), tokens(self.k(h_)), tokens(self.v(h_)), scale=C**-0.5)
        return x + self.proj_out(h_.reshape(B, H, W, C).permute(0, 3, 1, 2))


class Encoder(nn.Module):
    "The Cosmos 2D encoder pyramid (layers2d.py:139-233): (B, C, H, W) -> (B, z_channels, H / sc, W / sc)."

    def __init__(self, in_channels: int, channels: int, channels_mult: List[int], num_res_blocks: int,
                 attn_resolutions: List[int], dropout: float, resolution: int, z_channels: int,
                 spatial_compression: int, *, dtype=None, device=None, generator: Optional[torch.Generator] = None,
                 **ignore_kwargs):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.num_resolutions = len(channels_mult)
        self.num_res_blocks = num_res_blocks

        patch_size = ignore_kwargs.get("patch_size", 1)
        self.patcher = Patcher(patch_size, ignore_kwargs.get("patch_method", "rearrange"))
        in_channels = in_channels * patch_size * patch_size

        self.num_downsamples = int(math.log2(spatial_compression)) - int(math.log2(patch_size))
        assert self.num_downsamples <= self.num_resolutions

        self.conv_in = Conv2dTorch(in_channels, channels, 3, 1, 1, **kw)

        curr_res = resolution // patch_size
        in_ch_mult = (1,) + tuple(channels_mult)
        self.down = nn.ModuleList()
        block_in = channels
        for i_level in range(self.num_resolutions):
            block, attn = nn.ModuleList(), nn.ModuleList()
            block_in = channels * in_ch_mult[i_level]
            block_out = channels * channels_mult[i_level]
            for _ in range(self.num_res_blocks):
                block.append(ResnetBlock(in_channels=block_in, out_channels=block_out, dropout=dropout, **kw))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attn.append(AttnBlock(block_in, **kw))
            down = nn.Module()
            down.block, down.attn = block, attn
            if i_level < self.num_downsamples:
                down.downsample = Downsample(block_in, **kw)
                curr_res = curr_res // 2
            self.down.append(down)

        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(in_channels=block_in, out_channels=block_in, dropout=dropout, **kw)
        self.mid.attn_1 = AttnBlock(block_in, **kw)
        self.mid.block_2 = ResnetBlock(in_channels=block_in, out_channels=block_in, dropout=dropout, **kw)

        self.norm_out = Normalize(block_in, dtype=dtype, device=device)
        self.conv_out = Conv2dTorch(block_in, z_channels, 3, 1, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(self.patcher(x))
        for i_level in range(self.num_resolutions):
            down = self.down[i_level]
            for i_block in range(self.num_res_blocks):
                h = down.block[i_block](h)
                if len(down.attn) > 0:
                    h = down.attn[i_block](h)
            if i_level < self.num_downsamples:
                h = down.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(nonlinearity(self.norm_out(h)))


class Decoder(nn.Module):
    "The Cosmos 2D decoder pyramid (layers2d.py:236-331): (B, z_channels, h, w) -> (B, out_channels, H, W)."

    def __init__(self, out_channels: int, channels: int, channels_mult: List[int], num_res_blocks: int,
                 attn_resolutions: List[int], dropout: float, resolution: int, z_channels: int,
                 spatial_compression: int, *, dtype=None, device=None, generator: Optional[torch.Generator] = None,
                 **ignore_kwargs):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.num_resolutions = len(channels_mult)
        self.num_res_blocks = num_res_blocks

        patch_size = ignore_kwargs.get("patch_size", 1)
        self.unpatcher = UnPatcher(patch_size, ignore_kwargs.get("patch_method", "rearrange"))
        out_ch = out_channels * patch_size * patch_size

        self.num_upsamples = int(math.log2(spatial_compression)) - int(math.log2(patch_size))
        assert self.num_upsamples <= self.num_resolutions

        block_in = channels * channels_mult[self.num_resolutions - 1]
        curr_res = (resolution // patch_size) // 2 ** (self.num_resolutions - 1)

        self.conv_in = Conv2dTorch(z_channels, block_in, 3, 1, 1, **kw)

        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(in_channels=block_in, out_channels=block_in, dropout=dropout, **kw)
        self.mid.attn_1 = AttnBlock(block_in, **kw)
        self.mid.block_2 = ResnetBlock(in_channels=block_in, out_channels=block_in, dropout=dropout, **kw)

        ups = []
        for i_level in reversed(range(self.num_resolutions)):
            block, attn = nn.ModuleList(), nn.ModuleList()
            block_out = channels * channels_mult[i_level]
            for _ in range(self.num_res_blocks + 1):
                block.append(ResnetBlock(in_channels=block_in, out_channels=block_out, dropout=dropout, **kw))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attn.append(AttnBlock(block_in, **kw))
            up = nn.Module()
            up.block, up.attn = block, attn
            if i_level >= self.num_resolutions - self.num_upsamples:
                up.upsample = Upsample(block_in, **kw)
                curr_res = curr_res * 2
            ups.insert(0, up)
        self.up = nn.ModuleList(ups)

        self.norm_out = Normalize(block_in, dtype=dtype, device=device)
        self.conv_out = Conv2dTorch(block_in, out_ch, 3, 1, 1, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i_level in reversed(range(self.num_resolutions)):
            up = self.up[i_level]
            for i_block in range(self.num_res_blocks + 1):
                h = up.block[i_block](h)
                if len(up.attn) > 0:
                    h = up.attn[i_block](h)
            if i_level >= self.num_resolutions - self.num_upsamples:
                h = up.upsample(h)
        return self.unpatcher(self.conv_out(nonlinearity(self.norm_out(h))))
