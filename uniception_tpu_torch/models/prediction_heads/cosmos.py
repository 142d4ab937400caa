"""
The Cosmos tokenizer's decoder as a dense prediction head (counterpart of
uniception_tpu/models/prediction_heads/cosmos.py; reference uniception/models/prediction_heads/cosmos.py:29-191).
:class:`CosmosSingleChannel` is post_quant_conv -> the CI decoder; :class:`CosmosFeature` projects a feature map
linearly to one 16-channel latent per output channel, decodes each with its own Cosmos decoder, averages each
decoder's RGB to one channel, then applies a learned per-channel scale and bias.

Under ``config.set_conv3x3_impl("kernel")`` a head built with ``dtype=torch.bfloat16`` runs each decoder's eligible
3x3 convs on K7 (24 per CI16x16 decoder, 23 per CI8x8 one) and its mid block's attention on K1 at D = 512.
Checkpoints load strictly (the JAX package loads with ``strict=False``; ROADMAP queue 3).
"""

from typing import Optional

import torch
from torch import nn

from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules import DecoderType
from uniception_tpu_torch.models.libs.cosmos_tokenizer.networks import TokenizerConfigs
from uniception_tpu_torch.models.prediction_heads.adaptors import (
    Covariance2DAdaptor,
    FlowAdaptor,
    FlowWithConfidenceAdaptor,
    MaskAdaptor,
)
from uniception_tpu_torch.models.prediction_heads.base import PixelTaskOutput, PredictionHeadInput
from uniception_tpu_torch.nn.dpt_parts import Conv2dTorch
from uniception_tpu_torch.utils.weights import load_encoder_checkpoint

__all__ = ["CosmosSingleChannel", "CosmosFeature", "CLASSNAME_TO_ADAPTOR_CLASS", "COSMOS_LATENT_CHANNELS"]

COSMOS_LATENT_CHANNELS = 16

CLASSNAME_TO_ADAPTOR_CLASS = {
    "FlowAdaptor": FlowAdaptor,
    "FlowWithConfidenceAdaptor": FlowWithConfidenceAdaptor,
    "Covariance2DAdaptor": Covariance2DAdaptor,
    "MaskAdaptor": MaskAdaptor,
}


class CosmosSingleChannel(nn.Module):
    "One Cosmos decoder: a latent (B, 16, h, w) -> (B, 3, h * P, w * P) in about [-1, 1]."

    def __init__(self, patch_size: int, pretrained_checkpoint_path: Optional[str] = None, *, device=None, dtype=None,
                 param_dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        self.patch_size = patch_size
        assert patch_size in [8, 16], f"Invalid patch size: {patch_size}"

        tokenizer_config = dict(TokenizerConfigs["CI"].value)
        tokenizer_config.update(dict(spatial_compression=patch_size))
        z_channels = tokenizer_config.pop("z_channels")
        latent_channels = tokenizer_config.pop("latent_channels")
        tokenizer_config.pop("z_factor")

        kw = dict(dtype=dtype, device=device, generator=generator)
        decoder_name = tokenizer_config.get("decoder", DecoderType.Default.name)
        self.decoder = DecoderType[decoder_name].value(z_channels=z_channels, **kw, **tokenizer_config)
        self.post_quant_conv = Conv2dTorch(latent_channels, z_channels, 1, 1, 0, **kw)
        self.to(param_dtype)

        if pretrained_checkpoint_path is not None:
            print(f"Loading pretrained cosmos decoder from {pretrained_checkpoint_path}")
            load_encoder_checkpoint(self, pretrained_checkpoint_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(x))


class CosmosFeature(nn.Module):
    """The multi-channel Cosmos decoder head: ``output_dim`` decoders over 16-channel slices of a 1x1 projection of
    the input feature map (or of the input itself with ``skip_linear``). Returns (PixelTaskOutput, the slices)."""

    def __init__(self, input_feature_dim: int, output_dim: int, patch_size: int, skip_linear: bool = False,
                 single_channel_ckpt: Optional[str] = None, pretrained_checkpoint_path: Optional[str] = None, *,
                 device=None, dtype=None, param_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        self.input_feature_dim = input_feature_dim
        self.output_dim = output_dim
        self.patch_size = patch_size
        self.skip_linear = skip_linear
        assert patch_size in [8, 16], f"Invalid patch size: {patch_size}"

        kw = dict(dtype=dtype, device=device, generator=generator)
        if not skip_linear:
            self.linear = Conv2dTorch(input_feature_dim, output_dim * COSMOS_LATENT_CHANNELS, 1, 1, 0, **kw)
        self.cosmos_decoders = nn.ModuleList([
            CosmosSingleChannel(patch_size=patch_size, pretrained_checkpoint_path=single_channel_ckpt, **kw)
            for _ in range(output_dim)
        ])
        self.output_scaling = nn.Parameter(torch.ones((1, output_dim, 1, 1), device=device))
        self.output_bias = nn.Parameter(torch.zeros((1, output_dim, 1, 1), device=device))
        self.to(param_dtype)

        if pretrained_checkpoint_path is not None:
            print(f"Loading pretrained cosmos feature head from {pretrained_checkpoint_path}")
            load_encoder_checkpoint(self, pretrained_checkpoint_path)

    def forward(self, feature_input: PredictionHeadInput):
        x = feature_input.last_feature
        assert x.shape[1] == self.input_feature_dim
        if not self.skip_linear:
            x = self.linear(x)
        c = COSMOS_LATENT_CHANNELS
        x_split = [x[:, i * c:(i + 1) * c] for i in range(self.output_dim)]
        outputs = [dec(xs).mean(dim=1, keepdim=True) for dec, xs in zip(self.cosmos_decoders, x_split)]
        x = torch.cat(outputs, dim=1)
        x = x * self.output_scaling.to(x.dtype) + self.output_bias.to(x.dtype)
        return PixelTaskOutput(decoded_channels=x), x_split
