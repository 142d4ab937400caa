from uniception_tpu_torch.models.utils.config import (
    get_attention_impl,
    set_attention_impl,
    set_fused_attn,
    use_fused_attn,
)
from uniception_tpu_torch.models.utils.intermediate_feature_return import (
    IntermediateFeatureReturner,
    feature_take_indices,
)
from uniception_tpu_torch.models.utils.positional_encoding import PositionGetter, make_patch_positions
