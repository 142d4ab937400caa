"""
The causal continuous video tokenizer (counterpart of
uniception_tpu/models/libs/cosmos_tokenizer/networks/continuous_video.py; reference
uniception/models/libs/cosmos_tokenizer/networks/continuous_video.py:27-110).
"""

from collections import namedtuple
from typing import Optional

import torch
from torch import nn

from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules import (ContinuousFormulation, Decoder3DType,
                                                                      Encoder3DType)
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules.layers3d import CausalConv3d

__all__ = ["CausalContinuousVideoTokenizer", "NetworkEval"]

NetworkEval = namedtuple("NetworkEval", ["reconstructions", "posteriors", "latent"])


class CausalContinuousVideoTokenizer(nn.Module):
    """A causal video AE or VAE (BASE or FACTORIZED): encoder -> quant_conv -> distribution; post_quant_conv ->
    decoder. ``dtype`` is the compute dtype (None: the parameters'), ``generator`` draws the weights; the remaining
    keyword arguments are the config's."""

    def __init__(self, z_channels: int, z_factor: int, latent_channels: int, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        self.name = kwargs.get("name", "CausalContinuousVideoTokenizer")
        self.latent_channels = latent_channels
        kw = dict(dtype=dtype, device=device, generator=generator)
        encoder_name = kwargs.get("encoder", Encoder3DType.BASE.name)
        self.encoder = Encoder3DType[encoder_name].value(z_channels=z_factor * z_channels, **kw, **kwargs)
        # the reference's kludge (continuous_video.py:32-33): at temporal compression 4 (the default when the config
        # does not say) the decoder alone is built with channels_mult [2, 4]
        if kwargs.get("temporal_compression", 4) == 4:
            kwargs["channels_mult"] = [2, 4]
        decoder_name = kwargs.get("decoder", Decoder3DType.BASE.name)
        self.decoder = Decoder3DType[decoder_name].value(z_channels=z_channels, **kw, **kwargs)
        self.quant_conv = CausalConv3d(z_factor * z_channels, z_factor * latent_channels, kernel_size=1, padding=0,
                                       **kw)
        self.post_quant_conv = CausalConv3d(latent_channels, z_channels, kernel_size=1, padding=0, **kw)
        formulation_name = kwargs.get("formulation", ContinuousFormulation.AE.name)
        self.distribution = ContinuousFormulation[formulation_name].value()

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        "(B, 3, T, H, W) in [-1, 1] -> (latent, posteriors); ``generator`` samples a VAE's latent (None: its mean)."
        return self.distribution(self.quant_conv(self.encoder(x)), generator=generator)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> NetworkEval:
        latent, posteriors = self.encode(x, generator=generator)
        return NetworkEval(reconstructions=self.decode(latent), posteriors=posteriors, latent=latent)
