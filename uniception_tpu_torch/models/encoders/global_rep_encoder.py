"""
Global Representation Encoder (counterpart of uniception_tpu/models/encoders/global_rep_encoder.py; reference
uniception/models/encoders/global_rep_encoder.py:14-108): an MLP stack projecting a (B, C) vector to the encoder
embedding dim, then a LayerNorm. The nested Sequentials reproduce the reference's state-dict keys
(``encoder.0.0.0.0.weight``, ...).
"""

from typing import Callable, List, Optional

import torch
from torch import nn

from uniception_tpu_torch.models.encoders.base import EncoderGlobalRepInput, EncoderGlobalRepOutput
from uniception_tpu_torch.nn.blocks import layer_norm_factory
from uniception_tpu_torch.nn.common import LinearX, gelu_exact
from uniception_tpu_torch.nn.dpt_parts import Seq
from uniception_tpu_torch.utils.weights import load_encoder_checkpoint

__all__ = ["GlobalRepresentationEncoder"]


class _Act(nn.Module):
    "An activation function as a module, so it holds its place in the Sequential (and its key index)."

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class GlobalRepresentationEncoder(nn.Module):
    "UniCeption Global Representation Encoder: (B, in_chans) -> (B, enc_embed_dim)."

    def __init__(
        self,
        name: str,
        in_chans: int = 3,
        enc_embed_dim: int = 1024,
        intermediate_dims: List[int] = (128, 256, 512),
        act_layer: Callable = gelu_exact,
        norm_layer: Optional[Callable] = layer_norm_factory(eps=1e-6),
        pretrained_checkpoint_path: Optional[str] = None,
        *,
        device=None,
        dtype=None,
        param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.name = name
        self.in_chans = in_chans
        self.enc_embed_dim = enc_embed_dim
        self.intermediate_dims = list(intermediate_dims)
        encoder = Seq(LinearX(in_chans, intermediate_dims[0], **kw), _Act(act_layer))
        for i in range(1, len(intermediate_dims)):
            encoder = Seq(encoder, LinearX(intermediate_dims[i - 1], intermediate_dims[i], **kw), _Act(act_layer))
        self.encoder = Seq(encoder, LinearX(intermediate_dims[-1], enc_embed_dim, **kw))
        self.norm_layer = norm_layer(enc_embed_dim, device=device, dtype=dtype) if norm_layer else nn.Identity()
        self.to(param_dtype)
        if pretrained_checkpoint_path is not None:
            print(f"Loading pretrained Global Representation Encoder checkpoint from {pretrained_checkpoint_path} ...")
            load_encoder_checkpoint(self, pretrained_checkpoint_path)

    def forward(self, encoder_input: EncoderGlobalRepInput) -> EncoderGlobalRepOutput:
        data = encoder_input.data
        if data.dim() != 2 or data.shape[1] != self.in_chans:
            raise ValueError(f"Input data must have shape (B, {self.in_chans}), got {tuple(data.shape)}")
        return EncoderGlobalRepOutput(features=self.norm_layer(self.encoder(data)))
