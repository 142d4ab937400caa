"""
The DINOv2 Vision Transformer trunk (counterpart of uniception_tpu/models/encoders/vit.py; the architecture of
facebookresearch/dinov2, which the reference loads from torch.hub): ViT-S/B/L/g, patch 14, a cls token, optional
register tokens, a learned PE table interpolated bicubically with the 0.1 offset, LayerScale, exact GELU or the
SwiGLU-fused FFN, LayerNorm eps 1e-6.

State-dict keys are the hub model's (patch_embed.proj, cls_token, pos_embed, register_tokens,
blocks.N.{norm1,attn.qkv,ls1.gamma,mlp.fc1 | mlp.w12,...}, norm). Loop layout only. ``dtype`` is the compute
dtype; ``gradient_checkpointing`` recomputes each block's activations in the backward.

Every size has heads of 64 (384/6, 768/12, 1024/16, 1536/24), so the attention runs on the flash-attention kernel
(K1), the fused qkv + attention kernel (K5, under "fused", no RoPE) or the int8 attention (K6) as it is.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.models.encoders.pe_utils import interpolate_patch_pos_embed
from uniception_tpu_torch.nn.blocks import Mlp, SelfAttentionBlock, SwiGLUFFNFused, layer_norm_factory
from uniception_tpu_torch.nn.common import remat_call, trunc_normal

__all__ = ["DinoVisionTransformer", "DINO_VIT_CONFIGS"]

DINO_VIT_CONFIGS = {
    "small": dict(embed_dim=384, depth=12, num_heads=6, ffn_layer="mlp"),
    "base": dict(embed_dim=768, depth=12, num_heads=12, ffn_layer="mlp"),
    "large": dict(embed_dim=1024, depth=24, num_heads=16, ffn_layer="mlp"),
    "giant": dict(embed_dim=1536, depth=40, num_heads=24, ffn_layer="swiglufused"),
}


class _PatchEmbed(nn.Module):
    "Conv patchifier, keys ``patch_embed.proj.*``: BCHW image -> ((B, hp * wp, C) tokens, (hp, wp))."

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.compute_dtype = dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size, device=device)
        # flax nnx.Conv's default init: lecun normal (truncated, std 1/sqrt(fan_in)), zero bias
        trunc_normal(self.proj.weight, (in_chans * patch_size * patch_size) ** -0.5, generator=generator)
        with torch.no_grad():
            self.proj.bias.zero_()

    def forward(self, image: torch.Tensor):
        dt = self.compute_dtype or self.proj.weight.dtype
        x = F.conv2d(image.to(dt), self.proj.weight.to(dt), self.proj.bias.to(dt), stride=self.patch_size)
        hp, wp = x.shape[-2:]
        return x.flatten(2).transpose(1, 2), (hp, wp)


class DinoVisionTransformer(nn.Module):
    "DINOv2 ViT trunk with cls + register tokens and PE interpolation (JAX vit.py:64-197)."

    def __init__(
        self,
        img_size: int = 518,
        patch_size: int = 14,
        in_chans: int = 3,
        embed_dim: int = 1024,
        depth: int = 24,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        init_values: Optional[float] = 1.0,
        num_register_tokens: int = 0,
        interpolate_offset: float = 0.1,
        interpolate_antialias: bool = False,
        ffn_layer: str = "mlp",
        scan_blocks: bool = False,
        gradient_checkpointing: bool = False,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if scan_blocks:
            raise NotImplementedError("scan_blocks is XLA-only (nn/scan.py); the port runs the loop layout")
        if ffn_layer not in ("mlp", "swiglufused"):
            raise ValueError(f"Unknown ffn_layer {ffn_layer!r}: 'mlp' or 'swiglufused'")
        norm_layer = layer_norm_factory(eps=1e-6)
        self.embed_dim = embed_dim
        self.depth = depth
        self.patch_size = patch_size
        self.num_register_tokens = num_register_tokens
        self.interpolate_offset = interpolate_offset
        self.interpolate_antialias = interpolate_antialias
        self.gradient_checkpointing = gradient_checkpointing

        self.patch_embed = _PatchEmbed(patch_size, in_chans, embed_dim, device=device, dtype=dtype,
                                       generator=generator)
        num_patches = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device))
        self.pos_embed = nn.Parameter(
            trunc_normal(torch.empty(1, num_patches + 1, embed_dim, device=device), 0.02, generator=generator))
        if num_register_tokens > 0:
            self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim, device=device))
        else:
            self.register_tokens = None

        mlp_layer = Mlp if ffn_layer == "mlp" else SwiGLUFFNFused
        self.blocks = nn.ModuleList([
            SelfAttentionBlock(embed_dim, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, init_values=init_values,
                               norm_layer=norm_layer, mlp_layer=mlp_layer, device=device, dtype=dtype,
                               generator=generator)
            for _ in range(depth)
        ])
        self.norm = norm_layer(embed_dim, device=device, dtype=dtype)

    def _interpolated_pos_embed(self, hp: int, wp: int, dtype):
        "(cls PE, patch PE) for an hp x wp grid: interpolated in fp32, then cast to ``dtype`` (JAX vit.py:136-146)."
        pe = self.pos_embed.float()
        patch_pe = interpolate_patch_pos_embed(pe[:, 1:], hp, wp, self.interpolate_offset, self.interpolate_antialias)
        return pe[:, :1].to(dtype), patch_pe.to(dtype)

    def prepare_tokens(self, image_bchw: torch.Tensor):
        "(B, 1 + R + hp * wp, C) tokens: cls + its PE, the registers (no PE), the patches + theirs; and (hp, wp)."
        x, (hp, wp) = self.patch_embed(image_bchw)
        B, _, C = x.shape
        cls_pe, patch_pe = self._interpolated_pos_embed(hp, wp, x.dtype)
        tokens = [self.cls_token.to(x.dtype).expand(B, 1, C) + cls_pe]
        if self.register_tokens is not None:
            tokens.append(self.register_tokens.to(x.dtype).expand(B, self.num_register_tokens, C))
        tokens.append(x + patch_pe)
        return torch.cat(tokens, dim=1), (hp, wp)

    def forward_tokens(self, image_bchw: torch.Tensor, n_blocks: Optional[int] = None, collect_indices=()):
        "Run the first ``n_blocks`` blocks (all: None); returns (tokens, {i: pre-norm tokens after block i}, (hp, wp))."
        x, grid = self.prepare_tokens(image_bchw)
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        collected = {}
        for i, blk in enumerate(self.blocks[: self.depth if n_blocks is None else n_blocks]):
            x = remat_call(blk, x) if remat else blk(x)
            if i in collect_indices:
                collected[i] = x
        return x, collected, grid

    def split_tokens(self, x: torch.Tensor):
        "tokens -> (cls, registers, patches)."
        r = self.num_register_tokens
        return x[:, 0], x[:, 1 : 1 + r], x[:, 1 + r :]

    def forward_features(self, image_bchw: torch.Tensor) -> dict:
        "DINOv2's forward_features dict: x_norm_clstoken, x_norm_regtokens, x_norm_patchtokens, and grid_hw."
        x, _, grid = self.forward_tokens(image_bchw)
        cls_tok, reg_tok, patch_tok = self.split_tokens(self.norm(x))
        return {"x_norm_clstoken": cls_tok, "x_norm_regtokens": reg_tok, "x_norm_patchtokens": patch_tok,
                "grid_hw": grid}
