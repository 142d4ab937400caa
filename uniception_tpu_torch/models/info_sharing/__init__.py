"""
Info-sharing registry (counterpart of uniception_tpu/models/info_sharing/__init__.py; reference
uniception/models/info_sharing/__init__.py:23-37): ``INFO_SHARING_CLASSES`` maps a name to (class, IFR class).
"""

from uniception_tpu_torch.models.info_sharing.alternating_attention_transformer import (
    MultiViewAlternatingAttentionTransformer,
    MultiViewAlternatingAttentionTransformerIFR,
)
from uniception_tpu_torch.models.info_sharing.base import (
    MultiSetTransformerInput,
    MultiSetTransformerOutput,
    MultiViewTransformerInput,
    MultiViewTransformerOutput,
    UniCeptionInfoSharingBase,
)
from uniception_tpu_torch.models.info_sharing.cross_attention_transformer import (
    MultiViewCrossAttentionTransformer,
    MultiViewCrossAttentionTransformerIFR,
)
from uniception_tpu_torch.models.info_sharing.diff_cross_attention_transformer import (
    DifferentialMultiViewCrossAttentionTransformer,
    DifferentialMultiViewCrossAttentionTransformerIFR,
)
from uniception_tpu_torch.models.info_sharing.global_attention_transformer import (
    GlobalAttentionTransformer,
    MultiViewGlobalAttentionTransformer,
    MultiViewGlobalAttentionTransformerIFR,
)

__all__ = [
    "INFO_SHARING_CLASSES",
    "MultiSetTransformerInput",
    "MultiSetTransformerOutput",
    "MultiViewTransformerInput",
    "MultiViewTransformerOutput",
    "UniCeptionInfoSharingBase",
    "MultiViewAlternatingAttentionTransformer",
    "MultiViewAlternatingAttentionTransformerIFR",
    "MultiViewCrossAttentionTransformer",
    "MultiViewCrossAttentionTransformerIFR",
    "DifferentialMultiViewCrossAttentionTransformer",
    "DifferentialMultiViewCrossAttentionTransformerIFR",
    "GlobalAttentionTransformer",
    "MultiViewGlobalAttentionTransformer",
    "MultiViewGlobalAttentionTransformerIFR",
]

INFO_SHARING_CLASSES = {
    "cross_attention": (MultiViewCrossAttentionTransformer, MultiViewCrossAttentionTransformerIFR),
    "diff_cross_attention": (
        DifferentialMultiViewCrossAttentionTransformer,
        DifferentialMultiViewCrossAttentionTransformerIFR,
    ),
    "alternating_attention": (
        MultiViewAlternatingAttentionTransformer,
        MultiViewAlternatingAttentionTransformerIFR,
    ),
    "global_attention": (MultiViewGlobalAttentionTransformer, MultiViewGlobalAttentionTransformerIFR),
}
