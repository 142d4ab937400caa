"""
Multi-view cross-attention transformer, DUSt3R-decoder style (counterpart of
uniception_tpu/models/info_sharing/cross_attention_transformer.py).

Per-view branches of CrossAttentionBlocks; at each depth every view
cross-attends to the concatenation of all other views' tokens. Loop layout.
``dtype`` is the compute dtype; ``gradient_checkpointing`` recomputes each
block's activations in the backward. :class:`MultiViewCrossAttentionTransformerIFR`
also returns the features after chosen depths (the DPT heads' inputs).
"""

from typing import Callable, List, Optional, Union

import torch
from torch import nn

from uniception_tpu_torch.models.info_sharing.base import (
    MultiViewTransformerInput,
    MultiViewTransformerOutput,
    UniCeptionInfoSharingBase,
)
from uniception_tpu_torch.models.utils.intermediate_feature_return import (
    IntermediateFeatureReturner,
    feature_take_indices,
)
from uniception_tpu_torch.models.utils.positional_encoding import make_patch_positions
from uniception_tpu_torch.nn.blocks import CrossAttentionBlock, layer_norm_factory
from uniception_tpu_torch.nn.common import Identity, LinearX, remat_call

__all__ = ["MultiViewCrossAttentionTransformer", "MultiViewCrossAttentionTransformerIFR"]


def _concat_tokens(parts):
    "Concatenate along the token axis; a single part is passed through without a copy."
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


class MultiViewCrossAttentionTransformer(UniCeptionInfoSharingBase):
    "Multi-view cross-attention transformer for information sharing."

    def __init__(
        self,
        name: str,
        input_embed_dim: int,
        num_views: int,
        depth: int = 12,
        dim: int = 768,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        custom_positional_encoding: Optional[Callable] = None,
        scan_blocks: bool = False,
        gradient_checkpointing: bool = False,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(name=name)
        if scan_blocks:
            raise NotImplementedError("scan_blocks is XLA-only (nn/scan.py); the port runs the loop layout")
        norm_layer = layer_norm_factory(eps=1e-6)

        self.input_embed_dim = input_embed_dim
        self.num_views = num_views
        self.depth = depth
        self.dim = dim
        self.num_heads = num_heads
        self.custom_positional_encoding = custom_positional_encoding
        self.gradient_checkpointing = gradient_checkpointing

        if input_embed_dim != dim:
            self.proj_embed = LinearX(input_embed_dim, dim, device=device, dtype=dtype, generator=generator)
        else:
            self.proj_embed = Identity()

        def make_block():
            return CrossAttentionBlock(
                dim=dim,
                num_heads=num_heads,
                mlp_ratio=mlp_ratio,
                norm_layer=norm_layer,
                qkv_bias=qkv_bias,
                custom_positional_encoding=custom_positional_encoding,
                device=device,
                dtype=dtype,
                generator=generator,
            )

        self.multi_view_branches = nn.ModuleList(
            [nn.ModuleList([make_block() for _ in range(depth)]) for _ in range(num_views)]
        )
        self.norm = norm_layer(dim, device=device, dtype=dtype)

    def _check_input(self, model_input: MultiViewTransformerInput):
        feats = model_input.features
        if len(feats) != self.num_views:
            raise ValueError(f"Expected {self.num_views} views, got {len(feats)}")
        if not all(f.dim() == 4 and f.shape[1] == self.input_embed_dim for f in feats):
            raise ValueError(f"All views must be (N, {self.input_embed_dim}, H, W)")

    def _tokens_and_positions(self, model_input: MultiViewTransformerInput):
        "Per-view BCHW -> (B, N, dim) tokens and their positions."
        feats = model_input.features
        B, _, H, W = feats[0].shape
        tokens = [self.proj_embed(f.permute(0, 2, 3, 1).reshape(B, H * W, self.input_embed_dim)) for f in feats]
        if self.custom_positional_encoding is None:
            positions = [None] * self.num_views
        elif model_input.positions is not None:  # the caller's true positions (ManyAR mixed orientations)
            positions = list(model_input.positions)
        else:
            positions = [make_patch_positions(B, H, W, device=feats[0].device)] * self.num_views
        return tokens, positions, (B, H, W)

    def _depth_step(self, depth_idx, tokens, positions):
        "One depth: every view attends to the others' tokens of the previous depth (:241-264)."
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        updated = []
        for view_idx in range(self.num_views):
            others = [i for i in range(self.num_views) if i != view_idx]
            y = _concat_tokens([tokens[i] for i in others])
            xpos = positions[view_idx]
            ypos = None if xpos is None else _concat_tokens([positions[i] for i in others])
            blk = self.multi_view_branches[view_idx][depth_idx]
            args = (tokens[view_idx], y, xpos, ypos)
            updated.append(remat_call(blk, *args) if remat else blk(*args))
        return updated

    def _to_bchw(self, t, B, H, W):
        return t.reshape(B, H, W, self.dim).permute(0, 3, 1, 2)

    def forward(self, model_input: MultiViewTransformerInput) -> MultiViewTransformerOutput:
        self._check_input(model_input)
        tokens, positions, (B, H, W) = self._tokens_and_positions(model_input)
        for depth_idx in range(self.depth):
            tokens = self._depth_step(depth_idx, tokens, positions)
        return MultiViewTransformerOutput(features=[self._to_bchw(self.norm(t), B, H, W) for t in tokens])


class MultiViewCrossAttentionTransformerIFR(MultiViewCrossAttentionTransformer, IntermediateFeatureReturner):
    """Multi-view cross-attention transformer that also returns the features
    after the depths in ``indices`` (JAX :243-297; reference :278-505)."""

    def __init__(
        self,
        *args,
        indices: Optional[Union[int, List[int]]] = None,
        norm_intermediate: bool = True,
        intermediates_only: bool = False,
        **kwargs,
    ):
        MultiViewCrossAttentionTransformer.__init__(self, *args, **kwargs)
        IntermediateFeatureReturner.__init__(
            self, indices=indices, norm_intermediate=norm_intermediate, intermediates_only=intermediates_only
        )

    def forward(self, model_input: MultiViewTransformerInput):
        """Returns (final output, [output after each index]), or only the list
        with ``intermediates_only``; every output holds per-view BCHW features."""
        self._check_input(model_input)
        take_indices, _ = feature_take_indices(self.depth, self.indices)
        tokens, positions, (B, H, W) = self._tokens_and_positions(model_input)
        intermediates = []
        for depth_idx in range(self.depth):
            tokens = self._depth_step(depth_idx, tokens, positions)
            if depth_idx in take_indices:
                views = [self.norm(t) if self.norm_intermediate else t for t in tokens]
                intermediates.append(MultiViewTransformerOutput(features=[self._to_bchw(t, B, H, W) for t in views]))
        if self.intermediates_only:
            return intermediates
        out = MultiViewTransformerOutput(features=[self._to_bchw(self.norm(t), B, H, W) for t in tokens])
        return out, intermediates
