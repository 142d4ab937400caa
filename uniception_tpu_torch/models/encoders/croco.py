"""
CroCo / DUSt3R / MASt3R ViT encoder (counterpart of uniception_tpu/models/encoders/croco.py).

patch-embed -> depth x pre-norm attention blocks with shared 2D RoPE ->
final LayerNorm -> BCHW feature grid. Loop layout only. ``dtype`` is the
compute dtype; ``gradient_checkpointing`` recomputes each block's
activations in the backward (croco.py:142-143 of the JAX package).
"""

from typing import Optional, Tuple, Union

import torch
from torch import nn

from uniception_tpu_torch.models.encoders.base import UniCeptionViTEncoderBase, ViTEncoderInput, ViTEncoderOutput
from uniception_tpu_torch.models.encoders.patch_embed import get_patch_embed
from uniception_tpu_torch.nn.blocks import SelfAttentionBlock, layer_norm_factory
from uniception_tpu_torch.nn.common import remat_call
from uniception_tpu_torch.ops.rope import Rope2D

__all__ = ["CroCoEncoder"]


class CroCoEncoder(UniCeptionViTEncoderBase):
    "UniCeption CroCov2 encoder."

    def __init__(
        self,
        name: str,
        data_norm_type: str,
        patch_embed_cls: str = "PatchEmbedDust3R",
        img_size: Union[int, Tuple[int, int]] = (224, 224),
        patch_size: int = 16,
        enc_embed_dim: int = 1024,
        enc_depth: int = 24,
        enc_num_heads: int = 16,
        mlp_ratio: int = 4,
        pos_embed: str = "RoPE100",
        scan_blocks: bool = False,
        gradient_checkpointing: bool = False,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(name=name, data_norm_type=data_norm_type, patch_size=patch_size)
        if scan_blocks:
            raise NotImplementedError("scan_blocks is XLA-only (nn/scan.py); the port runs the loop layout")
        if not pos_embed.startswith("RoPE"):
            raise NotImplementedError(f"Unknown pos_embed {pos_embed}")
        norm_layer = layer_norm_factory(eps=1e-6)

        self.patch_embed_cls = patch_embed_cls
        self.img_size = img_size
        self.enc_embed_dim = enc_embed_dim
        self.enc_depth = enc_depth
        self.enc_num_heads = enc_num_heads
        self.mlp_ratio = mlp_ratio
        self.pos_embed = pos_embed
        self.gradient_checkpointing = gradient_checkpointing
        self.rope = Rope2D(freq=float(pos_embed[len("RoPE"):]))

        self.patch_embed = get_patch_embed(
            patch_embed_cls, img_size, patch_size, enc_embed_dim, device=device, dtype=dtype, generator=generator
        )
        self.enc_blocks = nn.ModuleList(
            [
                SelfAttentionBlock(
                    dim=enc_embed_dim,
                    num_heads=enc_num_heads,
                    mlp_ratio=mlp_ratio,
                    qkv_bias=True,
                    norm_layer=norm_layer,
                    custom_positional_encoding=self.rope,
                    device=device,
                    dtype=dtype,
                    generator=generator,
                )
                for _ in range(enc_depth)
            ]
        )
        self.enc_norm = norm_layer(enc_embed_dim, device=device, dtype=dtype)

    def forward(self, encoder_input: ViTEncoderInput) -> ViTEncoderOutput:
        self._check_data_normalization_type(encoder_input.data_norm_type)
        image = encoder_input.image
        B, _, H, W = image.shape
        true_shape = encoder_input.true_shape
        if true_shape is None:
            true_shape = torch.tensor([H, W], dtype=torch.int32, device=image.device).expand(B, 2)
        features, pos = self.patch_embed(image, true_shape=true_shape)
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        for blk in self.enc_blocks:
            features = remat_call(blk, features, pos) if remat else blk(features, pos)
        features = self.enc_norm(features)
        # (B, N, C) -> (B, C, H/P, W/P), matching croco.py:176-180
        features = features.reshape(B, H // self.patch_size, W // self.patch_size, self.enc_embed_dim)
        return ViTEncoderOutput(features=features.permute(0, 3, 1, 2))
