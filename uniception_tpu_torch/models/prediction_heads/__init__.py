"""
Prediction heads and adaptors namespace (counterpart of uniception_tpu/models/prediction_heads/__init__.py): the I/O
dataclasses, the bases, the heads and every adaptor are importable from the package root, as in the reference.
MoGe's head is imported from its module (``moge_conv``), as in the JAX package.
"""

from uniception_tpu_torch.models.prediction_heads import adaptors as _adaptors
from uniception_tpu_torch.models.prediction_heads.adaptors import *  # noqa: F401,F403
from uniception_tpu_torch.models.prediction_heads.base import (
    AdaptorInput,
    AdaptorMap,
    AdaptorOutput,
    Covariance2DAdaptorOutput,
    MaskAdaptorOutput,
    PixelTaskOutput,
    PredictionHeadInput,
    PredictionHeadLayeredInput,
    PredictionHeadOutput,
    PredictionHeadTokenInput,
    RegressionAdaptorOutput,
    RegressionWithConfidenceAdaptorOutput,
    RegressionWithConfidenceAndMaskAdaptorOutput,
    RegressionWithMaskAdaptorOutput,
    SummaryTaskOutput,
    UniCeptionAdaptorBase,
    UniCeptionPredictionHeadBase,
)
from uniception_tpu_torch.models.prediction_heads.dpt import (
    DPTFeature,
    DPTFeatureDoubleUpsampling,
    DPTRegressionProcessor,
    DPTSegmentationProcessor,
)
from uniception_tpu_torch.models.prediction_heads.global_head import GlobalHead
from uniception_tpu_torch.models.prediction_heads.linear import LinearFeature
from uniception_tpu_torch.models.prediction_heads.mlp_feature import MLPFeature
from uniception_tpu_torch.models.prediction_heads.mlp_head import MLPHead
from uniception_tpu_torch.models.prediction_heads.pose_head import PoseHead

__all__ = list(_adaptors.__all__) + [
    "AdaptorInput", "AdaptorMap", "AdaptorOutput", "Covariance2DAdaptorOutput", "MaskAdaptorOutput",
    "PixelTaskOutput", "PredictionHeadInput", "PredictionHeadLayeredInput", "PredictionHeadOutput",
    "PredictionHeadTokenInput", "RegressionAdaptorOutput", "RegressionWithConfidenceAdaptorOutput",
    "RegressionWithConfidenceAndMaskAdaptorOutput", "RegressionWithMaskAdaptorOutput", "SummaryTaskOutput",
    "UniCeptionAdaptorBase", "UniCeptionPredictionHeadBase", "DPTFeature", "DPTFeatureDoubleUpsampling",
    "DPTRegressionProcessor", "DPTSegmentationProcessor", "GlobalHead", "LinearFeature", "MLPFeature", "MLPHead",
    "PoseHead",
]
