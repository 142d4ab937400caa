"""
Multi-view N-frame pointmap model (counterpart of
uniception_tpu/models/factory/multiview.py): a shared CroCo encoder -> the
multi-view alternating- or global-attention info sharing -> one linear head
shared by every view -> the pointmap + confidence adaptor.

The encoder runs once over the views folded into the batch. The trunk
(encoder + info sharing) keeps its parameters in ``param_dtype`` and computes
in ``dtype`` (None: in ``param_dtype``), as in the DUSt3R factory; the head
has fp32 parameters and runs on the info sharing's features cast to fp32, and
the adaptor runs in fp32.
"""

from typing import List, Optional, Tuple

import torch
from torch import nn

from uniception_tpu_torch.models.encoders.base import ViTEncoderInput
from uniception_tpu_torch.models.encoders.croco import CroCoEncoder
from uniception_tpu_torch.models.info_sharing.alternating_attention_transformer import (
    MultiViewAlternatingAttentionTransformer,
)
from uniception_tpu_torch.models.info_sharing.base import MultiViewTransformerInput
from uniception_tpu_torch.models.info_sharing.global_attention_transformer import MultiViewGlobalAttentionTransformer
from uniception_tpu_torch.models.prediction_heads.adaptors import PointMapWithConfidenceAdaptor
from uniception_tpu_torch.models.prediction_heads.base import AdaptorInput, PredictionHeadInput
from uniception_tpu_torch.models.prediction_heads.linear import LinearFeature
from uniception_tpu_torch.ops.attention import sequence_parallel as sequence_parallel_ctx

__all__ = ["MultiViewPointmapModel"]

INFO_SHARING = {"alternating": MultiViewAlternatingAttentionTransformer, "global": MultiViewGlobalAttentionTransformer}


class MultiViewPointmapModel(nn.Module):
    "N-frame pointmap regression with a single head shared across views."

    def __init__(
        self,
        name: str,
        num_views: int,
        data_norm_type: str = "dust3r",
        img_size: tuple = (224, 224),
        attention_type: str = "alternating",
        pred_head_output_dim: int = 4,
        depth_mode: Tuple[str, float, float] = ("exp", -float("inf"), float("inf")),
        conf_mode: Tuple[str, float, float] = ("exp", 1, float("inf")),
        enc_embed_dim: int = 1024,
        enc_depth: int = 24,
        enc_num_heads: int = 16,
        info_sharing_dim: int = 768,
        info_sharing_depth: int = 12,
        info_sharing_num_heads: int = 12,
        use_rand_idx_pe_for_non_reference_views: bool = False,
        sequence_parallel: Optional[tuple] = None,
        scan_blocks: bool = False,
        gradient_checkpointing: bool = False,
        *,
        dtype: Optional[torch.dtype] = None,
        param_dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if attention_type not in INFO_SHARING:
            raise ValueError(f"Invalid attention type: {attention_type}. Must be one of {sorted(INFO_SHARING)}.")
        self.name = name
        # (mesh, axis): the info-sharing pass runs under ring attention over the V*T tokens split on that mesh axis
        # (ops/attention.py sequence_parallel); every rank of the axis passes the same views and gets every output
        self.sequence_parallel = sequence_parallel
        self.num_views = num_views
        self.data_norm_type = data_norm_type
        self.img_size = img_size
        self.attention_type = attention_type

        self.encoder = CroCoEncoder(
            name=name,
            data_norm_type=data_norm_type,
            patch_embed_cls="PatchEmbedDust3R",
            img_size=img_size,
            enc_embed_dim=enc_embed_dim,
            enc_depth=enc_depth,
            enc_num_heads=enc_num_heads,
            scan_blocks=scan_blocks,
            gradient_checkpointing=gradient_checkpointing,
            device=device,
            dtype=dtype,
            generator=generator,
        ).to(param_dtype)
        self.info_sharing = INFO_SHARING[attention_type](
            name="multi_view_info_sharing",
            input_embed_dim=enc_embed_dim,
            dim=info_sharing_dim,
            depth=info_sharing_depth,
            num_heads=info_sharing_num_heads,
            use_rand_idx_pe_for_non_reference_views=use_rand_idx_pe_for_non_reference_views,
            scan_blocks=scan_blocks,
            gradient_checkpointing=gradient_checkpointing,
            device=device,
            dtype=dtype,
            generator=generator,
        ).to(param_dtype)
        self.head = LinearFeature(
            input_feature_dim=info_sharing_dim,
            output_dim=pred_head_output_dim,
            patch_size=self.encoder.patch_size,
            device=device,
            generator=generator,
        )
        self.adaptor = PointMapWithConfidenceAdaptor(
            name="pointmap",
            pointmap_mode=depth_mode[0],
            pointmap_vmin=depth_mode[1],
            pointmap_vmax=depth_mode[2],
            confidence_type=conf_mode[0],
            confidence_vmin=conf_mode[1],
            confidence_vmax=conf_mode[2],
        )

    def checkpoint_alias_patterns(self) -> tuple:
        "None: the sinusoid tables are non-persistent buffers, which every load skips (utils/weights.py)."
        return ()

    def forward(self, views: List[torch.Tensor], generator: Optional[torch.Generator] = None) -> List[dict]:
        """N-frame forward.

        Args:
            views: ``num_views`` normalized (B, 3, H, W) frames; view 0 is the reference view.
            generator: draws the non-reference views' index encodings when the info sharing uses random
                indices (the JAX package's ``rng_key``); None: sequential indices.

        Returns:
            one dict per view with "pts3d" (B, H, W, 3) and "conf" (B, H, W, 1), fp32.
        """
        if len(views) != self.num_views:
            raise ValueError(f"Expected {self.num_views} views, got {len(views)}")
        H, W = views[0].shape[-2:]
        images = ViTEncoderInput(image=torch.cat(views, dim=0), data_norm_type=self.data_norm_type)
        feats = self.encoder(images).features
        info_in = MultiViewTransformerInput(features=list(feats.chunk(self.num_views, dim=0)))
        if self.sequence_parallel is not None:
            with sequence_parallel_ctx(*self.sequence_parallel):
                out = self.info_sharing(info_in, generator=generator)
        else:
            out = self.info_sharing(info_in, generator=generator)
        results = []
        for feat in out.features:
            head_out = self.head(PredictionHeadInput(last_feature=feat.float()))
            adapted = self.adaptor(AdaptorInput(adaptor_feature=head_out.decoded_channels, output_shape_hw=(H, W)))
            results.append({"pts3d": adapted.value.permute(0, 2, 3, 1), "conf": adapted.confidence.permute(0, 2, 3, 1)})
        return results
