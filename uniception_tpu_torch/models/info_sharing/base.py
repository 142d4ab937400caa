"""
Info-sharing typed I/O and base class (counterpart of uniception_tpu/models/info_sharing/base.py).
Feature lists keep the reference's per-view BCHW layout.
"""

from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn

__all__ = [
    "InfoSharingInput",
    "InfoSharingOutput",
    "MultiViewTransformerInput",
    "MultiViewTransformerOutput",
    "MultiSetTransformerInput",
    "MultiSetTransformerOutput",
    "UniCeptionInfoSharingBase",
]


class InfoSharingInput:
    "Base of the info-sharing inputs (JAX ``InfoSharingInput``)."


class InfoSharingOutput:
    "Base of the info-sharing outputs (JAX ``InfoSharingOutput``)."


@dataclass
class MultiViewTransformerInput(InfoSharingInput):
    """Multi-view transformer input.

    features: per-view (batch, input_embed_dim, feat_h, feat_w).
    additional_input_tokens: (batch, input_embed_dim, num_additional), global extra tokens.
    additional_input_tokens_per_view: per-view (batch, input_embed_dim, n) extra tokens.
    positions: optional per-view true token positions (batch, N, 2) int32 for
        the custom positional encoding; None builds the canvas grid. A ManyAR
        portrait row's tokens are in transposed-grid order, so its positions
        are the (feat_w, feat_h) grid (DUSt3R ``landscape_only``).
    """

    features: List[torch.Tensor]
    additional_input_tokens: Optional[torch.Tensor] = None
    additional_input_tokens_per_view: Optional[List[torch.Tensor]] = None
    positions: Optional[List[torch.Tensor]] = None


@dataclass
class MultiViewTransformerOutput(InfoSharingOutput):
    "Multi-view transformer output: per-view BCHW features and the extra tokens' features (batch, dim, n)."

    features: List[torch.Tensor]
    additional_token_features: Optional[torch.Tensor] = None
    additional_token_features_per_view: Optional[List[torch.Tensor]] = None


@dataclass
class MultiSetTransformerInput(InfoSharingInput):
    "Multi-set transformer input: per-set (batch, input_embed_dim, num_tokens), and global extra tokens."

    features: List[torch.Tensor]
    additional_input_tokens: Optional[torch.Tensor] = None


@dataclass
class MultiSetTransformerOutput(InfoSharingOutput):
    "Multi-set transformer output: per-set (batch, dim, num_tokens), and the extra tokens' features."

    features: List[torch.Tensor]
    additional_token_features: Optional[torch.Tensor] = None


class UniCeptionInfoSharingBase(nn.Module):
    "Info-sharing base class (reference info_sharing/base.py:24-71)."

    def __init__(self, name: str):
        super().__init__()
        self.name = name
