"""
UFM-style dense-correspondence (optical flow) model (counterpart of
uniception_tpu/models/factory/flow.py).

The reference's named downstream consumer is UFM ("A Simple Path towards
Unified Dense Correspondence with Flow"): CroCo encoder -> two-view
cross-attention info sharing -> one linear or DPT head on the SOURCE branch
-> FlowWithConfidenceAdaptor (2 flow channels + confidence). Parameters and
compute dtypes follow the DUSt3R factory: the trunk in ``param_dtype`` /
``dtype``, the head in fp32 unless ``head_dtype`` is set, the adaptor in fp32.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from uniception_tpu_torch.models.encoders.base import ViTEncoderInput
from uniception_tpu_torch.models.encoders.croco import CroCoEncoder
from uniception_tpu_torch.models.info_sharing.base import MultiViewTransformerInput
from uniception_tpu_torch.models.info_sharing.cross_attention_transformer import (
    MultiViewCrossAttentionTransformer,
    MultiViewCrossAttentionTransformerIFR,
)
from uniception_tpu_torch.models.prediction_heads.adaptors import FlowWithConfidenceAdaptor
from uniception_tpu_torch.models.prediction_heads.base import (
    AdaptorInput,
    PredictionHeadInput,
    PredictionHeadLayeredInput,
)
from uniception_tpu_torch.models.prediction_heads.dpt import (
    DPT_CHECKPOINT_ALIASES,
    DPTFeature,
    DPTRegressionProcessor,
)
from uniception_tpu_torch.models.prediction_heads.linear import LinearFeature
from uniception_tpu_torch.ops.rope import Rope2D
from uniception_tpu_torch.utils.checkpoint import load_checkpoint
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

__all__ = ["UFMFlow"]


class UFMFlow(nn.Module):
    """Two-view flow-with-confidence model.

    ``forward_pair(img1, img2)`` returns ``{"flow": (B, H, W, 2), "flow_conf":
    (B, H, W, 1)}``: the dense correspondence from view 1 (source) into view 2
    (target) and its per-pixel confidence.
    """

    def __init__(
        self,
        name: str,
        data_norm_type: str = "dust3r",
        img_size: tuple = (224, 224),
        patch_embed_cls: str = "PatchEmbedDust3R",
        pred_head_type: str = "dpt",
        pred_head_feature_dim: int = 256,
        flow_mean: Tuple[float, float] = (0.0, 0.0),
        flow_std: Tuple[float, float] = (1.0, 1.0),
        flow_base_shape: Optional[Tuple[int, int]] = None,
        scale_strategy: str = "scale_both",
        output_normalized_coordinate: bool = False,
        conf_mode: Tuple[str, float, float] = ("exp", 1, float("inf")),
        pos_embed: str = "RoPE100",
        pretrained_checkpoint_path: Optional[str] = None,
        enc_embed_dim: int = 1024,
        enc_depth: int = 24,
        enc_num_heads: int = 16,
        info_sharing_dim: int = 768,
        info_sharing_depth: int = 12,
        info_sharing_num_heads: int = 12,
        gradient_checkpointing: bool = False,
        head_gradient_checkpointing: Optional[bool] = None,
        scan_blocks: bool = False,
        head_dtype: Optional[torch.dtype] = None,
        *,
        dtype: Optional[torch.dtype] = None,
        param_dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if pred_head_type not in ("linear", "dpt"):
            raise ValueError(f"Invalid prediction head type: {pred_head_type}. Must be 'linear' or 'dpt'.")
        if pred_head_type == "dpt" and info_sharing_depth < 2:
            raise ValueError("dpt heads need info_sharing_depth >= 2 for distinct hook indices")
        self.name = name
        self.data_norm_type = data_norm_type
        self.img_size = img_size
        self.pred_head_type = pred_head_type
        self.head_dtype = head_dtype
        head_remat = gradient_checkpointing if head_gradient_checkpointing is None else head_gradient_checkpointing

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
        info_kwargs = dict(
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
        )
        if pred_head_type == "linear":
            self.info_sharing = MultiViewCrossAttentionTransformer(**info_kwargs).to(param_dtype)
            self.head = LinearFeature(input_feature_dim=info_sharing_dim, output_dim=3,
                                      patch_size=self.encoder.patch_size, dtype=head_dtype, device=device,
                                      generator=generator)
        else:
            indices = [5, 8] if info_sharing_depth >= 9 else [0, info_sharing_depth // 2]
            self.info_sharing = MultiViewCrossAttentionTransformerIFR(
                indices=indices, norm_intermediate=False, **info_kwargs
            ).to(param_dtype)
            kw = dict(checkpoint_gradient=head_remat, dtype=head_dtype, device=device, generator=generator)
            self.dpt_feature_head = DPTFeature(
                patch_size=self.encoder.patch_size,
                hooks=[0, 1, 2, 3],
                input_feature_dims=[enc_embed_dim] + [info_sharing_dim] * 3,
                feature_dim=pred_head_feature_dim,
                **kw,
            )
            self.dpt_regressor_head = DPTRegressionProcessor(input_feature_dim=pred_head_feature_dim, output_dim=3,
                                                             **kw)
        base_shape = tuple(flow_base_shape) if flow_base_shape is not None else tuple(img_size)
        self.adaptor = FlowWithConfidenceAdaptor(
            name="flow",
            flow_mean=flow_mean,
            flow_std=flow_std,
            base_shape=base_shape,
            scale_strategy=scale_strategy,
            output_normalized_coordinate=output_normalized_coordinate,
            confidence_type=conf_mode[0],
            vmin=conf_mode[1],
            vmax=conf_mode[2],
        )
        if pretrained_checkpoint_path is not None:
            print(f"Loading pretrained UFMFlow weights from {pretrained_checkpoint_path} ...")
            ckpt = load_checkpoint(pretrained_checkpoint_path)
            load_state_dict_numpy(self, ckpt["model"], ignore=self.checkpoint_alias_patterns())

    def heads(self):
        "The prediction-head modules (the head_dtype region)."
        if self.pred_head_type == "linear":
            return [self.head]
        return [self.dpt_feature_head, self.dpt_regressor_head]

    def checkpoint_alias_patterns(self) -> tuple:
        "Regex patterns of duplicate keys in reference state dicts (the DPT's scratch.layer*_rn spellings)."
        return DPT_CHECKPOINT_ALIASES if self.pred_head_type == "dpt" else ()

    def _encode_pair(self, img1, img2):
        "Same-shape views go through the encoder as one batch."
        if img1.shape[-2:] == img2.shape[-2:]:
            out = self.encoder(ViTEncoderInput(image=torch.cat([img1, img2], dim=0), data_norm_type=self.data_norm_type))
            return out.features.chunk(2, dim=0)
        feat1 = self.encoder(ViTEncoderInput(image=img1, data_norm_type=self.data_norm_type)).features
        feat2 = self.encoder(ViTEncoderInput(image=img2, data_norm_type=self.data_norm_type)).features
        return feat1, feat2

    def forward_pair(self, img1, img2):
        """Dense flow view 1 -> view 2.

        Args:
            img1/img2: (B, 3, H, W) normalized images (source, target).

        Returns:
            dict with "flow" (B, H, W, 2) and "flow_conf" (B, H, W, 1), fp32.
        """
        shape = (int(img1.shape[-2]), int(img1.shape[-1]))
        feat1, feat2 = self._encode_pair(img1, img2)
        hd = self.head_dtype or torch.float32
        info_in = MultiViewTransformerInput(features=[feat1, feat2])
        if self.pred_head_type == "linear":
            final = self.info_sharing(info_in)
            head_out = self.head(PredictionHeadInput(last_feature=final.features[0].to(hd)))
        else:
            final, inter = self.info_sharing(info_in)
            layered = [f.to(hd) for f in (feat1, inter[0].features[0], inter[1].features[0], final.features[0])]
            feats = self.dpt_feature_head(PredictionHeadLayeredInput(list_features=layered, target_output_shape=shape))
            head_out = self.dpt_regressor_head(feats)
        out = self.adaptor(AdaptorInput(adaptor_feature=head_out.decoded_channels.float(), output_shape_hw=shape))
        return {"flow": out.value.permute(0, 2, 3, 1), "flow_conf": out.confidence.permute(0, 2, 3, 1)}
