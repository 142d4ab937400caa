"""
Prediction-head typed I/O (counterpart of uniception_tpu/models/prediction_heads/base.py).
"""

from dataclasses import dataclass
from typing import List, Tuple

import torch
from torch import nn

__all__ = [
    "PredictionHeadInput",
    "PredictionHeadLayeredInput",
    "PixelTaskOutput",
    "AdaptorInput",
    "RegressionAdaptorOutput",
    "RegressionWithConfidenceAdaptorOutput",
    "UniCeptionAdaptorBase",
]


@dataclass
class PredictionHeadInput:
    "Dense head input: (batch, feat_dim, feat_h, feat_w)."

    last_feature: torch.Tensor


@dataclass
class PredictionHeadLayeredInput:
    "Layered head input (DPT): a list of BCHW features and the target (H, W)."

    list_features: List[torch.Tensor]
    target_output_shape: Tuple[int, int]


@dataclass
class PixelTaskOutput:
    "Dense pixel-wise output (BCHW at input resolution)."

    decoded_channels: torch.Tensor


@dataclass
class AdaptorInput:
    adaptor_feature: torch.Tensor
    output_shape_hw: Tuple[int, int]


@dataclass
class RegressionAdaptorOutput:
    value: torch.Tensor


@dataclass
class RegressionWithConfidenceAdaptorOutput:
    value: torch.Tensor
    confidence: torch.Tensor


class UniCeptionAdaptorBase(nn.Module):
    "Adaptor base (reference base.py:139-170)."

    def __init__(self, name: str, required_channels: int):
        super().__init__()
        self.name = name
        self.required_channels = required_channels
