"""
MLP feature head: a token-wise MLP, a 1x1 conv to ``output_dim * P^2`` channels and a pixel shuffle (counterpart of
uniception_tpu/models/prediction_heads/mlp_feature.py; reference prediction_heads/mlp_feature.py:16-104).

``F.pixel_shuffle``'s channel order is the one the JAX package's ``ops/pixel_shuffle.py`` copies from torch.
"""

import math
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from uniception_tpu_torch.models.prediction_heads.base import PixelTaskOutput, PredictionHeadInput
from uniception_tpu_torch.nn.blocks import Mlp
from uniception_tpu_torch.nn.common import ChannelsLastConv, gelu_exact
from uniception_tpu_torch.utils.weights import load_encoder_checkpoint

__all__ = ["MLPFeature", "feature_dim"]

def feature_dim(dim: Union[int, str]) -> int:
    "A feature width, or the reference's product spelling of one (\"768*2\")."
    return dim if isinstance(dim, int) else math.prod(int(f) for f in dim.split("*"))


class MLPFeature(nn.Module):
    "Linear pixel-wise mapping with an intermediate MLP; ``dtype`` is the compute dtype (None: the parameters')."

    def __init__(
        self,
        input_feature_dim: Union[int, str],
        patch_size: int,
        output_dim: int,
        mlp_ratio: int = 4,
        act_layer: Callable = gelu_exact,
        bias: bool = True,
        drop: float = 0.0,
        pretrained_checkpoint_path: Optional[str] = None,
        *,
        dtype=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        input_feature_dim = feature_dim(input_feature_dim)
        self.input_feature_dim = input_feature_dim
        self.output_dim = output_dim
        self.patch_size = patch_size
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.mlp = Mlp(input_feature_dim, int(mlp_ratio * input_feature_dim), act_layer=act_layer, drop=drop, bias=bias,
                       **kw)
        self.linear = ChannelsLastConv(input_feature_dim, output_dim * patch_size**2, 1, **kw)
        if pretrained_checkpoint_path is not None:
            print(f"Loading pretrained MLP dense feature head from {pretrained_checkpoint_path}")
            load_encoder_checkpoint(self, pretrained_checkpoint_path)

    def forward(self, feature_input: PredictionHeadInput) -> PixelTaskOutput:
        x = feature_input.last_feature  # (B, C, H, W)
        if x.shape[1] != self.input_feature_dim:
            raise ValueError(f"Input feature dimension mismatch: {x.shape[1]} != {self.input_feature_dim}")
        x = self.linear(self.mlp(x.permute(0, 2, 3, 1)))  # channels last
        return PixelTaskOutput(decoded_channels=F.pixel_shuffle(x.permute(0, 3, 1, 2), self.patch_size))
