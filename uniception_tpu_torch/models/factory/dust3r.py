"""
DUSt3R: two-view pointmap model (counterpart of uniception_tpu/models/factory/dust3r.py;
reference factory/dust3r.py:40-332).

Shared CroCo ViT-L encoder -> two-view cross-attention transformer (+2D RoPE)
-> per-view linear heads -> PointMapWithConfidence adaptor. The trunk
(encoder + info sharing) keeps its parameters in ``param_dtype`` and computes
in ``dtype`` (None: in ``param_dtype``): fp32 parameters with a bf16 trunk for
training, bf16 parameters for serving. The heads and adaptor run in fp32, the
reference's autocast-off region (dust3r.py:309).
"""

from typing import Optional, Tuple

import torch
from torch import nn

from uniception_tpu_torch.models.encoders.base import ViTEncoderInput
from uniception_tpu_torch.models.encoders.croco import CroCoEncoder
from uniception_tpu_torch.models.info_sharing.base import MultiViewTransformerInput
from uniception_tpu_torch.models.info_sharing.cross_attention_transformer import MultiViewCrossAttentionTransformer
from uniception_tpu_torch.models.prediction_heads.adaptors import PointMapWithConfidenceAdaptor
from uniception_tpu_torch.models.prediction_heads.base import AdaptorInput, PredictionHeadInput
from uniception_tpu_torch.models.prediction_heads.linear import LinearFeature
from uniception_tpu_torch.ops.rope import Rope2D

__all__ = ["DUSt3R"]


class DUSt3R(nn.Module):
    "DUSt3R defined with UniCeption modules."

    def __init__(
        self,
        name: str,
        data_norm_type: str = "dust3r",
        img_size: tuple = (224, 224),
        patch_embed_cls: str = "PatchEmbedDust3R",
        pred_head_type: str = "linear",
        pred_head_output_dim: int = 4,
        depth_mode: Tuple[str, float, float] = ("exp", -float("inf"), float("inf")),
        conf_mode: Tuple[str, float, float] = ("exp", 1, float("inf")),
        pos_embed: str = "RoPE100",
        enc_embed_dim: int = 1024,
        enc_depth: int = 24,
        enc_num_heads: int = 16,
        info_sharing_dim: int = 768,
        info_sharing_depth: int = 12,
        info_sharing_num_heads: int = 12,
        scan_blocks: bool = False,
        landscape_only: bool = False,
        gradient_checkpointing: bool = False,
        *,
        dtype: Optional[torch.dtype] = None,
        param_dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if pred_head_type == "dpt":
            raise NotImplementedError("the DPT head is not ported yet (ROADMAP.md queue 1 item 9)")
        if pred_head_type != "linear":
            raise ValueError(f"Invalid prediction head type: {pred_head_type}. Must be 'linear' or 'dpt'.")
        if landscape_only:
            raise NotImplementedError("landscape_only is not ported yet (ROADMAP.md queue 1 item 7)")

        self.name = name
        self.data_norm_type = data_norm_type
        self.img_size = img_size
        self.patch_embed_cls = patch_embed_cls
        self.pred_head_type = pred_head_type
        self.pred_head_output_dim = pred_head_output_dim
        self.depth_mode = depth_mode
        self.conf_mode = conf_mode
        self.pos_embed = pos_embed

        # one RoPE shared by encoder and info sharing (dust3r.py:110-112)
        self.rope = Rope2D(freq=float(pos_embed[len("RoPE"):]))
        self.encoder = CroCoEncoder(
            name=name,
            data_norm_type=data_norm_type,
            patch_embed_cls=patch_embed_cls,
            img_size=img_size,
            enc_embed_dim=enc_embed_dim,
            enc_depth=enc_depth,
            enc_num_heads=enc_num_heads,
            pos_embed=pos_embed,
            scan_blocks=scan_blocks,
            gradient_checkpointing=gradient_checkpointing,
            device=device,
            dtype=dtype,
            generator=generator,
        ).to(param_dtype)
        self.info_sharing = MultiViewCrossAttentionTransformer(
            name="base_info_sharing",
            input_embed_dim=enc_embed_dim,
            num_views=2,
            dim=info_sharing_dim,
            depth=info_sharing_depth,
            num_heads=info_sharing_num_heads,
            custom_positional_encoding=self.rope,
            scan_blocks=scan_blocks,
            gradient_checkpointing=gradient_checkpointing,
            device=device,
            dtype=dtype,
            generator=generator,
        ).to(param_dtype)
        head_kwargs = dict(
            input_feature_dim=info_sharing_dim,
            output_dim=pred_head_output_dim,
            patch_size=self.encoder.patch_size,
            device=device,
            generator=generator,
        )
        self.head1 = LinearFeature(**head_kwargs)
        self.head2 = LinearFeature(**head_kwargs)
        self.adaptor = PointMapWithConfidenceAdaptor(
            name="pointmap",
            pointmap_mode=depth_mode[0],
            pointmap_vmin=depth_mode[1],
            pointmap_vmax=depth_mode[2],
            confidence_type=conf_mode[0],
            confidence_vmin=conf_mode[1],
            confidence_vmax=conf_mode[2],
        )

    def _encode_image_pairs(self, img1, img2, data_norm_type, true_shape1=None, true_shape2=None):
        "Encode both views; same-shape pairs go through the encoder as one batch (dust3r.py:211-225)."
        if img1.shape[-2:] == img2.shape[-2:]:
            true_shape = None
            if true_shape1 is not None and true_shape2 is not None:
                true_shape = torch.cat([true_shape1, true_shape2], dim=0)
            out = self.encoder(
                ViTEncoderInput(image=torch.cat([img1, img2], dim=0), data_norm_type=data_norm_type, true_shape=true_shape)
            )
            feat1, feat2 = out.features.chunk(2, dim=0)
        else:
            feat1 = self.encoder(ViTEncoderInput(image=img1, data_norm_type=data_norm_type, true_shape=true_shape1)).features
            feat2 = self.encoder(ViTEncoderInput(image=img2, data_norm_type=data_norm_type, true_shape=true_shape2)).features
        return feat1, feat2

    def forward_pair(self, img1, img2, true_shape1=None, true_shape2=None):
        """Two-view forward.

        Args:
            img1/img2: (B, 3, H, W) normalized images.
            true_shape1/2: optional (B, 2) actual (h, w) for ManyAR batches.

        Returns:
            (res1, res2) dicts with pts3d / pts3d_in_other_view and conf, BHWC fp32.
        """
        shape1 = (int(img1.shape[-2]), int(img1.shape[-1]))
        shape2 = (int(img2.shape[-2]), int(img2.shape[-1]))
        feat1, feat2 = self._encode_image_pairs(img1, img2, self.data_norm_type, true_shape1, true_shape2)
        return self._decode_and_predict(feat1, feat2, shape1, shape2)

    def _head_and_adapt(self, head, feature, shape):
        # heads and the adaptor's exp/clip run in fp32 (dust3r.py:422-431)
        head_out = head(PredictionHeadInput(last_feature=feature.float()))
        return self.adaptor(AdaptorInput(adaptor_feature=head_out.decoded_channels, output_shape_hw=shape))

    def _decode_and_predict(self, feat1, feat2, shape1, shape2):
        final = self.info_sharing(MultiViewTransformerInput(features=[feat1, feat2]))
        out1 = self._head_and_adapt(self.head1, final.features[0], shape1)
        out2 = self._head_and_adapt(self.head2, final.features[1], shape2)
        res1 = {"pts3d": out1.value.permute(0, 2, 3, 1), "conf": out1.confidence.permute(0, 2, 3, 1)}
        res2 = {"pts3d_in_other_view": out2.value.permute(0, 2, 3, 1), "conf": out2.confidence.permute(0, 2, 3, 1)}
        return res1, res2
