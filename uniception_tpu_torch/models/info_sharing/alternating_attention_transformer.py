"""
Multi-view alternating-attention transformer, VGGT style (counterpart of
uniception_tpu/models/info_sharing/alternating_attention_transformer.py;
reference alternating_attention_transformer.py:22-997).

Even depths run global attention over every view's tokens; odd depths fold
the views into the batch, (B, V*T, C) -> (B*V, T, C), for frame-local
attention. Global extra tokens join the global depths only; per-view extra
tokens join both. The token preparation and the split are the global
transformer's; only its default differs: no index encoding for the
non-reference views.

The port keeps the loop layout. The JAX scan layout stores the blocks as one
depth-stacked list, sliced even/odd at run time, so its checkpoints map onto
``self_attention_blocks.{i}`` like any other stacked block list
(utils/coldstart.py).
"""

from typing import List, Optional, Union

import torch

from uniception_tpu_torch.models.info_sharing.global_attention_transformer import (
    MultiViewGlobalAttentionTransformer,
    MultiViewGlobalAttentionTransformerIFR,
)
from uniception_tpu_torch.models.utils.intermediate_feature_return import IntermediateFeatureReturner

__all__ = [
    "MultiViewAlternatingAttentionTransformer",
    "MultiViewAlternatingAttentionTransformerIFR",
    "reshape_for_frame_attention",
    "reshape_from_frame_attention",
]


def reshape_for_frame_attention(tokens: torch.Tensor, num_views: int, tokens_per_view: int, dim: int) -> torch.Tensor:
    "(B, V*T, C) -> (B*V, T, C): row b*V + v is view v of batch b (reference :404-417)."
    return tokens.reshape(tokens.shape[0] * num_views, tokens_per_view, dim)


def reshape_from_frame_attention(tokens: torch.Tensor, batch_size: int, num_views: int, tokens_per_view: int,
                                 dim: int) -> torch.Tensor:
    "(B*V, T, C) -> (B, V*T, C)."
    return tokens.reshape(batch_size, num_views * tokens_per_view, dim)


class MultiViewAlternatingAttentionTransformer(MultiViewGlobalAttentionTransformer):
    "Alternating global / frame attention over multi-view tokens."

    def __init__(
        self,
        name: str,
        input_embed_dim: int,
        distinguish_ref_and_non_ref_views: bool = True,
        use_pe_for_non_reference_views: bool = False,  # the global transformer's default is True (reference :31)
        max_num_views_for_pe: int = 1000,
        use_rand_idx_pe_for_non_reference_views: bool = True,
        **kwargs,
    ):
        super().__init__(
            name=name,
            input_embed_dim=input_embed_dim,
            distinguish_ref_and_non_ref_views=distinguish_ref_and_non_ref_views,
            use_pe_for_non_reference_views=use_pe_for_non_reference_views,
            max_num_views_for_pe=max_num_views_for_pe,
            use_rand_idx_pe_for_non_reference_views=use_rand_idx_pe_for_non_reference_views,
            **kwargs,
        )

    def _depth(self, depth_idx, blk, tokens, pos, meta):
        """Global attention at even depths; at odd ones frame-local attention (JAX :89-94): the global extra tokens
        set aside, the views folded into the batch."""
        if depth_idx % 2 == 0:
            return self._block_apply(blk, tokens, pos)
        B, H, W, num_views, n_tok_per_view, n_extra_per_view, n_global = meta
        n_view_tokens = num_views * n_tok_per_view
        # with global extra tokens the view part is a strided slice: the reshape copies it
        frame = reshape_for_frame_attention(tokens[:, :n_view_tokens], num_views, n_tok_per_view, self.dim)
        frame_pos = None if pos is None else pos[:, :n_view_tokens].reshape(B * num_views, n_tok_per_view, 2)
        frame = self._block_apply(blk, frame, frame_pos)
        view_part = reshape_from_frame_attention(frame, B, num_views, n_tok_per_view, self.dim)
        return torch.cat([view_part, tokens[:, n_view_tokens:]], dim=1) if n_global else view_part


class MultiViewAlternatingAttentionTransformerIFR(MultiViewAlternatingAttentionTransformer,
                                                  IntermediateFeatureReturner):
    "Alternating-attention transformer that also returns the features after the depths in ``indices`` (JAX :149-185)."

    def __init__(
        self,
        *args,
        indices: Optional[Union[int, List[int]]] = None,
        norm_intermediate: bool = True,
        intermediates_only: bool = False,
        **kwargs,
    ):
        MultiViewAlternatingAttentionTransformer.__init__(self, *args, **kwargs)
        IntermediateFeatureReturner.__init__(
            self, indices=indices, norm_intermediate=norm_intermediate, intermediates_only=intermediates_only
        )

    forward = MultiViewGlobalAttentionTransformerIFR.forward
