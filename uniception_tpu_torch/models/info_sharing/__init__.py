"""
Info-sharing registry (counterpart of uniception_tpu/models/info_sharing/__init__.py; reference
uniception/models/info_sharing/__init__.py:23-37): ``INFO_SHARING_CLASSES`` maps a name to (class, IFR class).
The differential cross-attention transformer is not ported yet: its entries raise NotImplementedError naming
its ROADMAP item.
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
from uniception_tpu_torch.models.info_sharing.global_attention_transformer import (
    GlobalAttentionTransformer,
    MultiViewGlobalAttentionTransformer,
    MultiViewGlobalAttentionTransformerIFR,
)
from uniception_tpu_torch.models.utils.unported import not_ported

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
    "GlobalAttentionTransformer",
    "MultiViewGlobalAttentionTransformer",
    "MultiViewGlobalAttentionTransformerIFR",
]

INFO_SHARING_CLASSES = {
    "cross_attention": (MultiViewCrossAttentionTransformer, MultiViewCrossAttentionTransformerIFR),
    "diff_cross_attention": (
        not_ported("DifferentialMultiViewCrossAttentionTransformer", "queue 1 item 7"),
        not_ported("DifferentialMultiViewCrossAttentionTransformerIFR", "queue 1 item 7"),
    ),
    "alternating_attention": (
        MultiViewAlternatingAttentionTransformer,
        MultiViewAlternatingAttentionTransformerIFR,
    ),
    "global_attention": (MultiViewGlobalAttentionTransformer, MultiViewGlobalAttentionTransformerIFR),
}
