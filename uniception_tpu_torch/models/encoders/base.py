"""
Encoder typed I/O and base classes (counterpart of uniception_tpu/models/encoders/base.py).

``features`` keeps the reference's BCHW layout at the API boundary; encoders
work on (B, N, C) tokens inside.
"""

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

__all__ = [
    "EncoderInput",
    "EncoderOutput",
    "EncoderGlobalRepInput",
    "EncoderGlobalRepOutput",
    "ViTEncoderInput",
    "ViTEncoderNonImageInput",
    "ViTEncoderOutput",
    "UniCeptionEncoderBase",
    "UniCeptionViTEncoderBase",
]


@dataclass
class EncoderInput:
    "Base encoder input: carries the normalization-type handshake."

    data_norm_type: str


@dataclass
class EncoderOutput:
    "Base encoder output."


@dataclass
class EncoderGlobalRepInput:
    "Global-representation input: (batch, channel)."

    data: torch.Tensor
    data_norm_type: str = ""


@dataclass
class EncoderGlobalRepOutput:
    "Global-representation output: (batch, enc_embed_dim)."

    features: torch.Tensor


@dataclass
class ViTEncoderInput:
    """ViT encoder input.

    image: (batch, channel, height, width), normalized per data_norm_type.
    true_shape: optional (batch, 2) [height, width] actual shapes for mixed
        landscape/portrait batches (ManyAR patch embedding).
    """

    image: torch.Tensor
    data_norm_type: str
    true_shape: Optional[torch.Tensor] = None


@dataclass
class ViTEncoderNonImageInput:
    "Dense 2D-grid non-image input: (batch, channel, height, width)."

    data: torch.Tensor
    data_norm_type: str = ""


@dataclass
class ViTEncoderOutput:
    """ViT encoder output: features (batch, enc_embed_dim, h/P, w/P) BCHW; registers (batch, enc_embed_dim, R), the
    cls token first, from the encoders that return them (DINOv2), else None."""

    features: torch.Tensor
    registers: Optional[torch.Tensor] = None


class UniCeptionEncoderBase(nn.Module):
    "Encoder base class (reference encoders/base.py:43-96)."

    def __init__(self, name: str, data_norm_type: str):
        super().__init__()
        self.name = name
        self.data_norm_type = data_norm_type

    def _check_data_normalization_type(self, data_norm_type: str):
        "Raise if the input's normalization is not this encoder's."
        if data_norm_type != self.data_norm_type:
            raise ValueError(
                f"Input normalization type {data_norm_type} does not match the encoder's "
                f"normalization type {self.data_norm_type}."
            )


class UniCeptionViTEncoderBase(UniCeptionEncoderBase):
    """ViT encoder base class (reference encoders/base.py:121-152). ``gradient_checkpointing`` recomputes each
    block's activations in the backward (``nn.common.remat_call``)."""

    def __init__(self, patch_size: int, gradient_checkpointing: bool = False, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.patch_size = patch_size
        self.gradient_checkpointing = gradient_checkpointing
