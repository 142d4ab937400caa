"""
Differential multi-view cross-attention transformer (counterpart of
uniception_tpu/models/info_sharing/diff_cross_attention_transformer.py; reference
info_sharing/diff_cross_attention_transformer.py:22-493): the cross-attention transformer's per-view branches with
DiffTransformer cross-attention (the lambda-weighted difference of two softmaxes, arXiv:2410.05258). Each block gets
its depth index for the lambda schedule, and, as in the reference, the blocks run ``num_heads // 2`` heads: each
differential head holds two sub-heads, so the sub-heads keep ``dim / num_heads`` channels, while the blocks'
self-attention runs ``num_heads // 2`` heads of ``2 dim / num_heads``.
"""

from typing import Callable, List, Optional, Union

import torch
from torch import nn

from uniception_tpu_torch.models.info_sharing.base import UniCeptionInfoSharingBase
from uniception_tpu_torch.models.info_sharing.cross_attention_transformer import (
    MultiViewCrossAttentionTransformer,
    MultiViewCrossAttentionTransformerIFR,
)
from uniception_tpu_torch.models.utils.intermediate_feature_return import IntermediateFeatureReturner
from uniception_tpu_torch.nn.blocks import DiffCrossAttentionBlock, Mlp, layer_norm_factory
from uniception_tpu_torch.nn.common import Identity, LinearX
from uniception_tpu_torch.utils.weights import load_encoder_checkpoint

__all__ = ["DifferentialMultiViewCrossAttentionTransformer", "DifferentialMultiViewCrossAttentionTransformerIFR"]


class DifferentialMultiViewCrossAttentionTransformer(MultiViewCrossAttentionTransformer):
    """Per-view branches of :class:`DiffCrossAttentionBlock` (depth-indexed lambdas); the forward, the view loop and
    the outputs are the cross-attention transformer's. ``dtype`` is the compute dtype."""

    def __init__(
        self,
        name: str,
        input_embed_dim: int,
        num_views: int,
        size: Optional[str] = None,
        depth: int = 12,
        dim: int = 768,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        qk_norm: bool = False,
        proj_drop: float = 0.0,
        attn_drop: float = 0.0,
        init_values: Optional[float] = None,
        drop_path: float = 0.0,
        act_layer: Optional[Callable] = None,
        norm_layer: Optional[Callable] = None,
        mlp_layer=Mlp,
        custom_positional_encoding: Optional[Callable] = None,
        norm_cross_tokens: bool = True,
        pretrained_checkpoint_path: Optional[str] = None,
        gradient_checkpointing: bool = False,
        *,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        UniCeptionInfoSharingBase.__init__(self, name=name)
        if num_heads % 2:
            raise ValueError("Number of heads must be divisible by 2 for differential cross-attention.")
        norm_layer = norm_layer or layer_norm_factory(eps=1e-6)
        self.size = size
        self.input_embed_dim = input_embed_dim
        self.num_views = num_views
        self.depth = depth
        self.dim = dim
        self.num_heads = num_heads
        self.custom_positional_encoding = custom_positional_encoding
        self.gradient_checkpointing = gradient_checkpointing
        self.pretrained_checkpoint_path = pretrained_checkpoint_path
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.proj_embed = LinearX(input_embed_dim, dim, **kw) if input_embed_dim != dim else Identity()

        def branch():
            return nn.ModuleList([
                DiffCrossAttentionBlock(
                    dim=dim, depth=i, num_heads=num_heads // 2, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                    qk_norm=qk_norm, proj_drop=proj_drop, attn_drop=attn_drop, init_values=init_values,
                    drop_path=drop_path, norm_layer=norm_layer, mlp_layer=mlp_layer,
                    custom_positional_encoding=custom_positional_encoding, norm_cross_tokens=norm_cross_tokens, **kw,
                )
                for i in range(depth)
            ])

        self.multi_view_branches = nn.ModuleList([branch() for _ in range(num_views)])
        self.norm = norm_layer(dim, device=device, dtype=dtype)
        if pretrained_checkpoint_path is not None:
            print(f"Loading pretrained differential multi-view cross-attention transformer weights from "
                  f"{pretrained_checkpoint_path} ...")
            load_encoder_checkpoint(self, pretrained_checkpoint_path)


class DifferentialMultiViewCrossAttentionTransformerIFR(DifferentialMultiViewCrossAttentionTransformer,
                                                       IntermediateFeatureReturner):
    """The differential transformer also returning the features after the depths in ``indices``; the forward is the
    cross-attention transformer IFR's."""

    def __init__(
        self,
        *args,
        indices: Optional[Union[int, List[int]]] = None,
        norm_intermediate: bool = True,
        intermediates_only: bool = False,
        **kwargs,
    ):
        DifferentialMultiViewCrossAttentionTransformer.__init__(self, *args, **kwargs)
        IntermediateFeatureReturner.__init__(
            self, indices=indices, norm_intermediate=norm_intermediate, intermediates_only=intermediates_only
        )

    forward = MultiViewCrossAttentionTransformerIFR.forward
