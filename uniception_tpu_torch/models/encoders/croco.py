"""
CroCo / DUSt3R / MASt3R ViT encoder and its intermediate-feature returner (counterpart of
uniception_tpu/models/encoders/croco.py).

patch-embed -> depth x pre-norm attention blocks with shared 2D RoPE ->
final LayerNorm -> BCHW feature grid. Loop layout only. ``dtype`` is the
compute dtype; ``gradient_checkpointing`` recomputes each block's
activations in the backward (croco.py:142-143 of the JAX package). A
reference checkpoint (``ckpt["model"]`` with ``data_norm_type`` and
``patch_embed_cls``, croco.py:99-111) loads through
``pretrained_checkpoint_path``.
"""

from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from uniception_tpu_torch.models.encoders.base import UniCeptionViTEncoderBase, ViTEncoderInput, ViTEncoderOutput
from uniception_tpu_torch.models.encoders.patch_embed import get_patch_embed
from uniception_tpu_torch.models.utils.intermediate_feature_return import (
    IntermediateFeatureReturner,
    feature_take_indices,
)
from uniception_tpu_torch.nn.blocks import SelfAttentionBlock, layer_norm_factory
from uniception_tpu_torch.nn.common import remat_call
from uniception_tpu_torch.ops.rope import Rope2D
from uniception_tpu_torch.utils.checkpoint import load_checkpoint
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

__all__ = ["CroCoEncoder", "CroCoIntermediateFeatureReturner"]


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
        pretrained_checkpoint_path: Optional[str] = None,
        override_checkpoint_attributes: bool = False,
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

        if pretrained_checkpoint_path:
            print(f"Loading pretrained CroCo checkpoint from {pretrained_checkpoint_path}")
            ckpt = load_checkpoint(pretrained_checkpoint_path)
            load_state_dict_numpy(self, ckpt["model"])
            if not override_checkpoint_attributes:
                for attr, mine in (("data_norm_type", data_norm_type), ("patch_embed_cls", patch_embed_cls)):
                    if ckpt.get(attr) != mine:
                        raise ValueError(f"{attr} {mine} does not match the checkpoint's {ckpt.get(attr)}.")

    def _embed(self, encoder_input: ViTEncoderInput):
        "(tokens (B, N, C), positions (B, N, 2), (H, W)) after the patch embedding."
        self._check_data_normalization_type(encoder_input.data_norm_type)
        image = encoder_input.image
        B, _, H, W = image.shape
        true_shape = encoder_input.true_shape
        if true_shape is None:
            true_shape = torch.tensor([H, W], dtype=torch.int32, device=image.device).expand(B, 2)
        features, pos = self.patch_embed(image, true_shape=true_shape)
        return features, pos, (H, W)

    def _blocks(self, features, pos, collect=(), n_blocks=None):
        """The first ``n_blocks`` blocks (all: None) in order; returns (tokens, [tokens after each block in
        ``collect``, in block order])."""
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        collected = []
        for i, blk in enumerate(self.enc_blocks[:n_blocks]):
            features = remat_call(blk, features, pos) if remat else blk(features, pos)
            if i in collect:
                collected.append(features)
        return features, collected

    def _to_bchw(self, features: torch.Tensor, height: int, width: int) -> ViTEncoderOutput:
        "(B, N, C) -> (B, C, H/P, W/P), matching croco.py:176-180."
        B = features.shape[0]
        features = features.reshape(B, height // self.patch_size, width // self.patch_size, self.enc_embed_dim)
        return ViTEncoderOutput(features=features.permute(0, 3, 1, 2))

    def forward(self, encoder_input: ViTEncoderInput) -> ViTEncoderOutput:
        features, pos, (H, W) = self._embed(encoder_input)
        features, _ = self._blocks(features, pos)
        return self._to_bchw(self.enc_norm(features), H, W)


class CroCoIntermediateFeatureReturner(CroCoEncoder, IntermediateFeatureReturner):
    """CroCo encoder returning the features after the blocks in ``indices`` (JAX croco.py:165-234): through the
    final norm when ``norm_intermediate``; with ``intermediates_only`` False, (final output, intermediates)."""

    def __init__(
        self,
        *args,
        indices: Optional[Union[int, List[int]]] = None,
        norm_intermediate: bool = True,
        stop_early: bool = False,
        intermediates_only: bool = True,
        **kwargs,
    ):
        CroCoEncoder.__init__(self, *args, **kwargs)
        IntermediateFeatureReturner.__init__(self, indices=indices, norm_intermediate=norm_intermediate,
                                             stop_early=stop_early, intermediates_only=intermediates_only)

    def forward(self, encoder_input: ViTEncoderInput):
        features, pos, (H, W) = self._embed(encoder_input)
        take_indices, max_index = feature_take_indices(self.enc_depth, self.indices)
        # with stop_early the blocks after the deepest index do not run (the final output is then the deepest's)
        features, collected = self._blocks(features, pos, set(take_indices), max_index + 1 if self.stop_early else None)
        intermediates = [self._to_bchw(self.enc_norm(f) if self.norm_intermediate else f, H, W) for f in collected]
        if self.intermediates_only:
            return intermediates
        return self._to_bchw(self.enc_norm(features), H, W), intermediates
