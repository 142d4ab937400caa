"""
MLP head over (B, C, T) tokens: a projection, ``num_mlp_layers`` x (Linear + ReLU) and an output projection (counterpart
of uniception_tpu/models/prediction_heads/mlp_head.py; reference prediction_heads/mlp_head.py:13-94).
"""

from typing import Optional

import torch
from torch import nn

from uniception_tpu_torch.models.prediction_heads.base import PredictionHeadTokenInput, SummaryTaskOutput
from uniception_tpu_torch.nn.common import LinearX
from uniception_tpu_torch.utils.weights import load_encoder_checkpoint

__all__ = ["MLPHead"]


class MLPHead(nn.Module):
    "proj -> n x (Linear + ReLU) -> output proj over (B, C, T) tokens; (B, output_dim, T) out."

    def __init__(
        self,
        input_feature_dim: int,
        output_dim: int,
        num_mlp_layers: int = 2,
        hidden_dim: int = 196,
        pretrained_checkpoint_path: Optional[str] = None,
        *,
        dtype=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.input_feature_dim = input_feature_dim
        self.num_mlp_layers = num_mlp_layers
        self.hidden_dim = hidden_dim
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.proj = LinearX(input_feature_dim, hidden_dim, **kw)
        self.mlp = nn.ModuleList([nn.Sequential(LinearX(hidden_dim, hidden_dim, **kw), nn.ReLU())
                                  for _ in range(num_mlp_layers)])
        self.output_proj = LinearX(hidden_dim, output_dim, **kw)
        if pretrained_checkpoint_path:
            print(f"Loading pretrained mlp head from {pretrained_checkpoint_path}")
            load_encoder_checkpoint(self, pretrained_checkpoint_path)

    def forward(self, feature_input: PredictionHeadTokenInput) -> SummaryTaskOutput:
        feat = feature_input.last_feature
        if feat.dim() != 3:
            raise ValueError(f"Input feature tensor must have 3 dimensions (B, C, T), got {feat.dim()}")
        if feat.shape[1] != self.input_feature_dim:
            raise ValueError(f"Input feature dimension mismatch: {feat.shape[1]} != {self.input_feature_dim}")
        feat = self.proj(feat.transpose(1, 2))  # (B, T, hidden)
        for layer in self.mlp:
            feat = layer(feat)
        return SummaryTaskOutput(decoded_channels=self.output_proj(feat).transpose(1, 2))
