"""
Pixio encoder (counterpart of uniception_tpu/models/encoders/pixio.py; reference
uniception/models/encoders/pixio.py:335-581): a ViT (H/16 by default) with 8 cls tokens, a learned PE table for a
16 x 16 patch grid resized bicubically to other grids, pre-LN blocks without LayerScale, LayerNorm eps 1e-6.

The reference downloads its weights from the HF hub; here they load from a local checkpoint
(``pretrained_checkpoint_path``). Head dims at the five published sizes: 64 (B, L, 1B), 80 (H: 1280 / 16) and 96
(5B: 3072 / 32); K1 takes all three.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.models.encoders.base import UniCeptionViTEncoderBase, ViTEncoderInput, ViTEncoderOutput
from uniception_tpu_torch.nn.blocks import SelfAttentionBlock, layer_norm_factory
from uniception_tpu_torch.nn.common import ChannelsLastConv, remat_call, trunc_normal
from uniception_tpu_torch.utils.weights import load_encoder_checkpoint

__all__ = ["PixioEncoder", "pixio_vitb16", "pixio_vitl16", "pixio_vith16", "pixio_vit1b16", "pixio_vit5b16"]


class _PixioPatchEmbed(nn.Module):
    "Conv patchifier, keys ``patch_embed.proj.*``: BCHW image -> (B, hp * wp, C) tokens."

    def __init__(self, img_size, patch_size, in_chans, embed_dim, *, device=None, dtype=None, generator=None):
        super().__init__()
        self.patch_size = (patch_size, patch_size)
        self.num_patches = (img_size // patch_size) ** 2
        self.embed_dim = embed_dim
        self.proj = ChannelsLastConv(in_chans, embed_dim, patch_size, stride=patch_size, device=device, dtype=dtype,
                                     generator=generator)

    def forward(self, image_bchw: torch.Tensor) -> torch.Tensor:
        x = self.proj(image_bchw.permute(0, 2, 3, 1))
        B, hp, wp, C = x.shape
        return x.reshape(B, hp * wp, C)


class PixioEncoder(UniCeptionViTEncoderBase):
    "UniCeption Pixio encoder: BCHW patch features."

    def __init__(
        self,
        name: str = "pixio",
        data_norm_type: str = "pixio",
        img_size: int = 256,
        patch_size: int = 16,
        embed_dim: int = 1280,
        depth: int = 32,
        in_chans: int = 3,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        n_cls_tokens: int = 8,
        pretrained_checkpoint_path: Optional[str] = None,
        gradient_checkpointing: bool = False,
        *,
        device=None,
        dtype=None,
        param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        **_compat_kwargs,  # hf_model_name accepted and ignored (no network)
    ):
        super().__init__(name=name, data_norm_type=data_norm_type, patch_size=patch_size,
                         gradient_checkpointing=gradient_checkpointing)
        norm_layer = layer_norm_factory(eps=1e-6)
        self.n_cls_tokens = n_cls_tokens
        self.enc_embed_dim = embed_dim
        self.patch_embed = _PixioPatchEmbed(img_size, patch_size, in_chans, embed_dim, device=device, dtype=dtype,
                                            generator=generator)
        self.cls_token = nn.Parameter(torch.zeros(1, n_cls_tokens, embed_dim, device=device))
        self.pos_embed = nn.Parameter(trunc_normal(
            torch.empty(1, self.patch_embed.num_patches + n_cls_tokens, embed_dim, device=device), 0.02,
            generator=generator))
        self.blocks = nn.ModuleList([
            SelfAttentionBlock(embed_dim, num_heads, mlp_ratio=mlp_ratio, qkv_bias=True, norm_layer=norm_layer,
                               device=device, dtype=dtype, generator=generator)
            for _ in range(depth)
        ])
        self.norm = norm_layer(embed_dim, device=device, dtype=dtype)
        self.to(param_dtype)
        if pretrained_checkpoint_path is not None:
            print(f"Loading pretrained Pixio Encoder from {pretrained_checkpoint_path} ...")
            load_encoder_checkpoint(self, pretrained_checkpoint_path)

    def _interpolate_pos_emb(self, hp: int, wp: int) -> torch.Tensor:
        """The (1, n_cls + hp * wp, C) PE: the table on its own grid, else its patch part resized to hp x wp by size
        (bicubic, align_corners False, in fp32; pixio.py:425-456), the cls rows kept."""
        pe = self.pos_embed
        patch_pe = pe[:, self.n_cls_tokens :]
        pt = int(patch_pe.shape[1] ** 0.5)
        if pt == hp == wp:
            return pe
        grid = patch_pe.reshape(1, pt, pt, -1).permute(0, 3, 1, 2).float()
        grid = F.interpolate(grid, size=(hp, wp), mode="bicubic", align_corners=False)
        patch_pe = grid.permute(0, 2, 3, 1).reshape(1, hp * wp, -1).to(pe.dtype)
        return torch.cat([pe[:, : self.n_cls_tokens], patch_pe], dim=1)

    def forward(self, encoder_input: ViTEncoderInput) -> ViTEncoderOutput:
        self._check_data_normalization_type(encoder_input.data_norm_type)
        image = encoder_input.image
        if image.dim() != 4 or image.shape[1] != 3:
            raise ValueError(f"Input must be of shape (B, 3, H, W), got {tuple(image.shape)}")
        B, _, height, width = image.shape
        if height % self.patch_size or width % self.patch_size:
            raise ValueError(f"Input shape must be divisible by patch size: {self.patch_size}")
        hp, wp = height // self.patch_size, width // self.patch_size

        pos_embed = self._interpolate_pos_emb(hp, wp)
        x = self.patch_embed(image)
        x = x + pos_embed[:, self.n_cls_tokens :].to(x.dtype)
        cls_tokens = (self.cls_token + pos_embed[:, : self.n_cls_tokens]).to(x.dtype)
        x = torch.cat([cls_tokens.expand(B, -1, -1), x], dim=1)
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        for blk in self.blocks:
            x = remat_call(blk, x) if remat else blk(x)
        x = self.norm(x)
        features = x[:, self.n_cls_tokens :].reshape(B, hp, wp, self.enc_embed_dim).permute(0, 3, 1, 2)
        return ViTEncoderOutput(features=features)


def _pixio_variant(embed_dim, depth, num_heads):
    def ctor(pretrained=None, **kwargs):
        return PixioEncoder(img_size=256, patch_size=16, embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                            mlp_ratio=4, n_cls_tokens=8, pretrained_checkpoint_path=pretrained, **kwargs)

    return ctor


pixio_vitb16 = _pixio_variant(768, 12, 12)
pixio_vitl16 = _pixio_variant(1024, 24, 16)
pixio_vith16 = _pixio_variant(1280, 32, 16)
pixio_vit1b16 = _pixio_variant(1536, 48, 24)
pixio_vit5b16 = _pixio_variant(3072, 48, 32)
