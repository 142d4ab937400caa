"""
The Cosmos tokenizer network registry (counterpart of uniception_tpu/models/libs/cosmos_tokenizer/networks/__init__.py;
reference uniception/models/libs/cosmos_tokenizer/networks/__init__.py:28-39): the image networks (CI, DI) and the
causal-video ones (CV, DV), whose published configs use the FACTORIZED encoder and decoder.
"""

from enum import Enum

# the config dicts under other names: the submodules continuous_image / discrete_image would shadow them
from uniception_tpu_torch.models.libs.cosmos_tokenizer.networks.configs import (
    continuous_image as continuous_image_dict,
    continuous_video as continuous_video_dict,
    discrete_image as discrete_image_dict,
    discrete_video as discrete_video_dict,
)
from uniception_tpu_torch.models.libs.cosmos_tokenizer.networks.continuous_image import ContinuousImageTokenizer
from uniception_tpu_torch.models.libs.cosmos_tokenizer.networks.continuous_video import CausalContinuousVideoTokenizer
from uniception_tpu_torch.models.libs.cosmos_tokenizer.networks.discrete_image import DiscreteImageTokenizer
from uniception_tpu_torch.models.libs.cosmos_tokenizer.networks.discrete_video import CausalDiscreteVideoTokenizer


class TokenizerConfigs(Enum):
    CI = continuous_image_dict
    DI = discrete_image_dict
    CV = continuous_video_dict
    DV = discrete_video_dict


class TokenizerModels(Enum):
    CI = ContinuousImageTokenizer
    DI = DiscreteImageTokenizer
    CV = CausalContinuousVideoTokenizer
    DV = CausalDiscreteVideoTokenizer
