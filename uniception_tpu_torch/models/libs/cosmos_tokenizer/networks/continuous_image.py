"""
The continuous image tokenizer (counterpart of uniception_tpu/models/libs/cosmos_tokenizer/networks/continuous_image.py;
reference uniception/models/libs/cosmos_tokenizer/networks/continuous_image.py:27-110).
"""

from collections import namedtuple
from typing import Optional

import torch
from torch import nn

from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules import ContinuousFormulation, DecoderType, EncoderType
from uniception_tpu_torch.nn.dpt_parts import Conv2dTorch

__all__ = ["ContinuousImageTokenizer", "NetworkEval"]

NetworkEval = namedtuple("NetworkEval", ["reconstructions", "posteriors", "latent"])


class ContinuousImageTokenizer(nn.Module):
    """Encoder -> quant_conv -> distribution; post_quant_conv -> decoder. ``dtype`` is the compute dtype (None: the
    parameters'), ``generator`` draws the weights; the remaining keyword arguments are the config's."""

    def __init__(self, z_channels: int, z_factor: int, latent_channels: int, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        self.name = kwargs.get("name", "ContinuousImageTokenizer")
        self.latent_channels = latent_channels
        kw = dict(dtype=dtype, device=device, generator=generator)
        encoder_name = kwargs.get("encoder", EncoderType.Default.name)
        self.encoder = EncoderType[encoder_name].value(z_channels=z_factor * z_channels, **kw, **kwargs)
        decoder_name = kwargs.get("decoder", DecoderType.Default.name)
        self.decoder = DecoderType[decoder_name].value(z_channels=z_channels, **kw, **kwargs)
        self.quant_conv = Conv2dTorch(z_factor * z_channels, z_factor * latent_channels, 1, 1, 0, **kw)
        self.post_quant_conv = Conv2dTorch(latent_channels, z_channels, 1, 1, 0, **kw)
        formulation_name = kwargs.get("formulation", ContinuousFormulation.AE.name)
        self.distribution = ContinuousFormulation[formulation_name].value()

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        "(B, 3, H, W) in [-1, 1] -> (latent, posteriors); ``generator`` samples a VAE's latent (None: its mean)."
        return self.distribution(self.quant_conv(self.encoder(x)), generator=generator)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> NetworkEval:
        latent, posteriors = self.encode(x, generator=generator)
        return NetworkEval(reconstructions=self.decode(latent), posteriors=posteriors, latent=latent)
