"""
The discrete image tokenizer (counterpart of uniception_tpu/models/libs/cosmos_tokenizer/networks/discrete_image.py;
reference uniception/models/libs/cosmos_tokenizer/networks/discrete_image.py:27-130).
"""

from collections import namedtuple
from typing import Optional

import torch
from torch import nn

from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules import DecoderType, DiscreteQuantizer, EncoderType
from uniception_tpu_torch.nn.dpt_parts import Conv2dTorch

__all__ = ["DiscreteImageTokenizer", "NetworkEval"]

NetworkEval = namedtuple("NetworkEval", ["reconstructions", "quant_loss", "quant_info"])


class DiscreteImageTokenizer(nn.Module):
    """Encoder -> quant_conv -> quantizer; indices -> codes -> post_quant_conv -> decoder. ``dtype`` is the compute
    dtype (None: the parameters'), ``generator`` draws the weights; the remaining keyword arguments are the config's."""

    def __init__(self, z_channels: int, embedding_dim: int, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        self.name = kwargs.get("name", "DiscreteImageTokenizer")
        self.embedding_dim = embedding_dim
        kw = dict(dtype=dtype, device=device, generator=generator)
        encoder_name = kwargs.get("encoder", EncoderType.Default.name)
        self.encoder = EncoderType[encoder_name].value(z_channels=z_channels, **kw, **kwargs)
        decoder_name = kwargs.get("decoder", DecoderType.Default.name)
        self.decoder = DecoderType[decoder_name].value(z_channels=z_channels, **kw, **kwargs)
        self.quant_conv = Conv2dTorch(z_channels, embedding_dim, 1, 1, 0, **kw)
        self.post_quant_conv = Conv2dTorch(embedding_dim, z_channels, 1, 1, 0, **kw)

        quantizer_name = kwargs.get("quantizer", DiscreteQuantizer.RESFSQ.name)
        if quantizer_name == DiscreteQuantizer.VQ.name:
            assert "num_embeddings" in kwargs
            kwargs.update(dict(embedding_dim=embedding_dim))
        elif quantizer_name == DiscreteQuantizer.LFQ.name:
            assert "codebook_size" in kwargs and "codebook_dim" in kwargs
        elif quantizer_name in (DiscreteQuantizer.FSQ.name, DiscreteQuantizer.RESFSQ.name):
            assert "levels" in kwargs
        self.quantizer = DiscreteQuantizer[quantizer_name].value(device=device, generator=generator, **kwargs)

    def encode(self, x: torch.Tensor):
        "(B, 3, H, W) in [-1, 1] -> the quantizer's (indices, codes, loss)."
        return self.quantizer(self.quant_conv(self.encoder(x)))

    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(self.quantizer.indices_to_codes(indices)))

    def forward(self, x: torch.Tensor) -> NetworkEval:
        indices, codes, loss = self.encode(x)
        return NetworkEval(reconstructions=self.decoder(self.post_quant_conv(codes)), quant_loss=loss,
                           quant_info=indices)
