"""
Linear prediction head: 1x1 conv to out_dim * P^2 channels + pixel shuffle
(counterpart of uniception_tpu/models/prediction_heads/linear.py; reference
prediction_heads/linear.py:15-84).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.models.prediction_heads.base import PixelTaskOutput, PredictionHeadInput

__all__ = ["LinearFeature"]


class LinearFeature(nn.Module):
    "Linear mapping from patch features to pixel-wise features; ``dtype`` is the compute dtype (None: the parameters')."

    def __init__(
        self,
        input_feature_dim: int,
        output_dim: int,
        patch_size: int,
        *,
        dtype=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.compute_dtype = dtype
        self.input_feature_dim = input_feature_dim
        self.output_dim = output_dim
        self.patch_size = patch_size
        self.linear = nn.Conv2d(input_feature_dim, output_dim * patch_size**2, kernel_size=1, device=device)
        with torch.no_grad():
            # lecun-normal weight, zero bias: the JAX head's nnx.Conv defaults
            nn.init.normal_(self.linear.weight, std=input_feature_dim**-0.5, generator=generator)
            self.linear.bias.zero_()

    def forward(self, feature_input: PredictionHeadInput) -> PixelTaskOutput:
        x = feature_input.last_feature  # (B, C, H, W)
        if x.shape[1] != self.input_feature_dim:
            raise ValueError(f"Input feature dimension mismatch: {x.shape[1]} != {self.input_feature_dim}")
        dt = self.compute_dtype
        if dt is None:
            y = self.linear(x)
        else:
            y = F.conv2d(x.to(dt), self.linear.weight.to(dt), self.linear.bias.to(dt))
        return PixelTaskOutput(decoded_channels=F.pixel_shuffle(y, self.patch_size))
