"""
Prediction-head base classes, typed I/O dataclasses and AdaptorMap (counterpart of
uniception_tpu/models/prediction_heads/base.py; reference
uniception/models/prediction_heads/base.py:14-211).
"""

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
from torch import nn

__all__ = [
    "PredictionHeadInput",
    "PredictionHeadLayeredInput",
    "PredictionHeadTokenInput",
    "PixelTaskOutput",
    "SummaryTaskOutput",
    "AdaptorInput",
    "AdaptorOutput",
    "PredictionHeadOutput",
    "MaskAdaptorOutput",
    "Covariance2DAdaptorOutput",
    "RegressionAdaptorOutput",
    "RegressionWithConfidenceAdaptorOutput",
    "RegressionWithMaskAdaptorOutput",
    "RegressionWithConfidenceAndMaskAdaptorOutput",
    "UniCeptionPredictionHeadBase",
    "UniCeptionAdaptorBase",
    "AdaptorMap",
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
class PredictionHeadTokenInput:
    "Token head input: (batch, feat_dim, num_tokens)."

    last_feature: torch.Tensor


@dataclass
class PixelTaskOutput:
    "Dense pixel-wise output (BCHW at input resolution)."

    decoded_channels: torch.Tensor


@dataclass
class SummaryTaskOutput:
    "Per-image latent output (BC)."

    decoded_channels: torch.Tensor


@dataclass
class AdaptorInput:
    adaptor_feature: torch.Tensor
    output_shape_hw: Tuple[int, ...]


@dataclass
class AdaptorOutput:
    value: torch.Tensor


@dataclass
class PredictionHeadOutput:
    adaptor_output: Dict[str, object]


@dataclass
class MaskAdaptorOutput:
    logits: torch.Tensor
    mask: torch.Tensor


@dataclass
class Covariance2DAdaptorOutput:
    covariance: torch.Tensor  # (B, 3, H, W): s_x^2, s_y^2, rho_xy
    log_det: torch.Tensor  # (B, 1, H, W)
    inv_covariance: torch.Tensor  # (B, 3, H, W): [0, 0], [1, 1], [0, 1]
    log_representation: torch.Tensor  # (B, 3, H, W): c1, c2, s


@dataclass
class RegressionAdaptorOutput:
    value: torch.Tensor


@dataclass
class RegressionWithConfidenceAdaptorOutput:
    value: torch.Tensor
    confidence: torch.Tensor


@dataclass
class RegressionWithMaskAdaptorOutput:
    value: torch.Tensor
    logits: torch.Tensor
    mask: torch.Tensor


@dataclass
class RegressionWithConfidenceAndMaskAdaptorOutput:
    value: torch.Tensor
    confidence: torch.Tensor
    logits: torch.Tensor
    mask: torch.Tensor


class UniCeptionPredictionHeadBase(nn.Module):
    "Prediction-head base (reference base.py:107-136)."

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def forward(self, head_input: PredictionHeadInput) -> PredictionHeadOutput:
        raise NotImplementedError


class UniCeptionAdaptorBase(nn.Module):
    "Adaptor base (reference base.py:139-170)."

    def __init__(self, name: str, required_channels: int):
        super().__init__()
        self.name = name
        self.required_channels = required_channels

    def forward(self, adaptor_input: AdaptorInput):
        raise NotImplementedError


class AdaptorMap(nn.Module):
    """Slices the decoded channels in the adaptors' order and hands each slice to its adaptor (reference
    base.py:173-211). Takes an :class:`AdaptorInput` or a head output with ``decoded_channels``; each adaptor gets
    ``output_shape_hw`` = the slice's shape past the channel axis, ``()`` for a (B, C) summary output."""

    def __init__(self, *adaptors: UniCeptionAdaptorBase):
        super().__init__()
        self.adaptors = nn.ModuleDict({adaptor.name: adaptor for adaptor in adaptors})
        self.adaptor_order = [adaptor.name for adaptor in adaptors]
        self.required_channels = sum(adaptor.required_channels for adaptor in adaptors)

    def forward(self, adaptor_input) -> Dict[str, object]:
        feats = getattr(adaptor_input, "adaptor_feature", None)
        if feats is None:
            feats = adaptor_input.decoded_channels
        result, offset = {}, 0
        for name in self.adaptor_order:
            adaptor = self.adaptors[name]
            chunk = feats[:, offset:offset + adaptor.required_channels]
            offset += adaptor.required_channels
            result[name] = adaptor(AdaptorInput(adaptor_feature=chunk, output_shape_hw=tuple(chunk.shape[2:])))
        return result
