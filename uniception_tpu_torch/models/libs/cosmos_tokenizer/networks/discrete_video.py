"""
The causal discrete video tokenizer (counterpart of
uniception_tpu/models/libs/cosmos_tokenizer/networks/discrete_video.py; reference
uniception/models/libs/cosmos_tokenizer/networks/discrete_video.py:27-130).

FSQ and residual FSQ quantize the 5-D latent (indices (B, T, H, W), or (B, num_quantizers, T, H, W)). As in the JAX
package, VQ cannot be built here (the quantizer is not given ``embedding_dim``) and LFQ's forward takes no 5-D latent
(ROADMAP queue 3, faults of the JAX package).
"""

from collections import namedtuple
from typing import Optional

import torch
from torch import nn

from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules import Decoder3DType, DiscreteQuantizer, Encoder3DType
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules.layers3d import CausalConv3d

__all__ = ["CausalDiscreteVideoTokenizer", "NetworkEval"]

NetworkEval = namedtuple("NetworkEval", ["reconstructions", "quant_loss", "quant_info"])


class CausalDiscreteVideoTokenizer(nn.Module):
    """A causal video tokenizer (BASE or FACTORIZED): encoder -> quant_conv -> quantizer; indices -> codes ->
    post_quant_conv -> decoder. ``dtype`` is the compute dtype (None: the parameters'), ``generator`` draws the
    weights; the remaining keyword arguments are the config's."""

    def __init__(self, z_channels: int, embedding_dim: int, z_factor: int = 1, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        self.name = kwargs.get("name", "CausalDiscreteVideoTokenizer")
        self.embedding_dim = embedding_dim
        kw = dict(dtype=dtype, device=device, generator=generator)
        encoder_name = kwargs.get("encoder", Encoder3DType.BASE.name)
        self.encoder = Encoder3DType[encoder_name].value(z_channels=z_factor * z_channels, **kw, **kwargs)
        decoder_name = kwargs.get("decoder", Decoder3DType.BASE.name)
        self.decoder = Decoder3DType[decoder_name].value(z_channels=z_channels, **kw, **kwargs)
        self.quant_conv = CausalConv3d(z_factor * z_channels, embedding_dim, kernel_size=1, padding=0, **kw)
        self.post_quant_conv = CausalConv3d(embedding_dim, z_channels, kernel_size=1, padding=0, **kw)
        quantizer_name = kwargs.get("quantizer", DiscreteQuantizer.RESFSQ.name)
        self.quantizer = DiscreteQuantizer[quantizer_name].value(device=device, generator=generator, **kwargs)

    def encode(self, x: torch.Tensor):
        "(B, 3, T, H, W) in [-1, 1] -> the quantizer's (indices (B, T, H, W), codes, loss)."
        return self.quantizer(self.quant_conv(self.encoder(x)))

    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(self.quantizer.indices_to_codes(indices)))

    def forward(self, x: torch.Tensor) -> NetworkEval:
        indices, codes, loss = self.encode(x)
        return NetworkEval(reconstructions=self.decoder(self.post_quant_conv(codes)), quant_loss=loss,
                           quant_info=indices)
