"""
Info-sharing typed I/O and base class (counterpart of uniception_tpu/models/info_sharing/base.py).
Feature lists keep the reference's per-view BCHW layout.
"""

from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn

__all__ = ["MultiViewTransformerInput", "MultiViewTransformerOutput", "UniCeptionInfoSharingBase"]


@dataclass
class MultiViewTransformerInput:
    """Multi-view transformer input.

    features: per-view (batch, input_embed_dim, feat_h, feat_w).
    positions: optional per-view true token positions (batch, N, 2) int32 for
        the custom positional encoding; None builds the canvas grid. A ManyAR
        portrait row's tokens are in transposed-grid order, so its positions
        are the (feat_w, feat_h) grid (DUSt3R ``landscape_only``).
    """

    features: List[torch.Tensor]
    positions: Optional[List[torch.Tensor]] = None


@dataclass
class MultiViewTransformerOutput:
    "Multi-view transformer output: per-view BCHW features."

    features: List[torch.Tensor]


class UniCeptionInfoSharingBase(nn.Module):
    "Info-sharing base class (reference info_sharing/base.py:24-71)."

    def __init__(self, name: str):
        super().__init__()
        self.name = name
