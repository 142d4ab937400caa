"""
The Cosmos tokenizer's module registry (counterpart of uniception_tpu/models/libs/cosmos_tokenizer/modules/__init__.py;
reference uniception/models/libs/cosmos_tokenizer/modules/__init__.py:33-60).

The 3D encoder and decoder types name the JAX package's classes, which the port does not build yet: their members
are stand-ins that raise NotImplementedError naming the ROADMAP item, so no 3D config silently builds a 2D class.
"""

from enum import Enum

from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules.distributions import (
    GaussianDistribution,
    IdentityDistribution,
)
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules.layers2d import Decoder, Encoder
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules.quantizers import (
    FSQuantizer,
    LFQuantizer,
    ResidualFSQuantizer,
    VectorQuantizer,
)
from uniception_tpu_torch.models.utils.unported import not_ported

COSMOS_3D = "queue 1 item 17"  # the causal-3D (video) path


class EncoderType(Enum):
    Default = Encoder


class DecoderType(Enum):
    Default = Decoder


class Encoder3DType(Enum):
    BASE = not_ported("EncoderBase (Cosmos causal-3D)", COSMOS_3D)
    FACTORIZED = not_ported("EncoderFactorized (Cosmos causal-3D)", COSMOS_3D)


class Decoder3DType(Enum):
    BASE = not_ported("DecoderBase (Cosmos causal-3D)", COSMOS_3D)
    FACTORIZED = not_ported("DecoderFactorized (Cosmos causal-3D)", COSMOS_3D)


class ContinuousFormulation(Enum):
    VAE = GaussianDistribution
    AE = IdentityDistribution


class DiscreteQuantizer(Enum):
    VQ = VectorQuantizer
    LFQ = LFQuantizer
    FSQ = FSQuantizer
    RESFSQ = ResidualFSQuantizer
