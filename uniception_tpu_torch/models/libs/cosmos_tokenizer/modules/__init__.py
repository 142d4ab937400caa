"""
The Cosmos tokenizer's module registry (counterpart of uniception_tpu/models/libs/cosmos_tokenizer/modules/__init__.py;
reference uniception/models/libs/cosmos_tokenizer/modules/__init__.py:33-60).
"""

from enum import Enum

from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules.distributions import (
    GaussianDistribution,
    IdentityDistribution,
)
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules.layers2d import Decoder, Encoder
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules.layers3d import (
    DecoderBase,
    DecoderFactorized,
    EncoderBase,
    EncoderFactorized,
)
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules.quantizers import (
    FSQuantizer,
    LFQuantizer,
    ResidualFSQuantizer,
    VectorQuantizer,
)


class EncoderType(Enum):
    Default = Encoder


class DecoderType(Enum):
    Default = Decoder


class Encoder3DType(Enum):
    BASE = EncoderBase
    FACTORIZED = EncoderFactorized


class Decoder3DType(Enum):
    BASE = DecoderBase
    FACTORIZED = DecoderFactorized


class ContinuousFormulation(Enum):
    VAE = GaussianDistribution
    AE = IdentityDistribution


class DiscreteQuantizer(Enum):
    VQ = VectorQuantizer
    LFQ = LFQuantizer
    FSQ = FSQuantizer
    RESFSQ = ResidualFSQuantizer
