"""
The Cosmos tokenizer network registry (counterpart of uniception_tpu/models/libs/cosmos_tokenizer/networks/__init__.py;
reference uniception/models/libs/cosmos_tokenizer/networks/__init__.py:28-39). All four configs are listed; the
image networks (CI, DI) build, the causal-video ones (CV, DV) are stand-ins that raise NotImplementedError naming
their ROADMAP item.
"""

from enum import Enum

# the config dicts under other names: the submodules continuous_image / discrete_image would shadow them
from uniception_tpu_torch.models.libs.cosmos_tokenizer.networks.configs import (
    continuous_image as continuous_image_dict,
    continuous_video as continuous_video_dict,
    discrete_image as discrete_image_dict,
    discrete_video as discrete_video_dict,
)
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules import COSMOS_3D
from uniception_tpu_torch.models.libs.cosmos_tokenizer.networks.continuous_image import ContinuousImageTokenizer
from uniception_tpu_torch.models.libs.cosmos_tokenizer.networks.discrete_image import DiscreteImageTokenizer
from uniception_tpu_torch.models.utils.unported import not_ported


class TokenizerConfigs(Enum):
    CI = continuous_image_dict
    DI = discrete_image_dict
    CV = continuous_video_dict
    DV = discrete_video_dict


class TokenizerModels(Enum):
    CI = ContinuousImageTokenizer
    DI = DiscreteImageTokenizer
    CV = not_ported("CausalContinuousVideoTokenizer (Cosmos CV)", COSMOS_3D)
    DV = not_ported("CausalDiscreteVideoTokenizer (Cosmos DV)", COSMOS_3D)
