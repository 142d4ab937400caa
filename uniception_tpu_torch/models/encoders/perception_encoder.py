"""
Meta Perception Encoder (counterpart of uniception_tpu/models/encoders/perception_encoder.py; reference
uniception/models/encoders/perception_encoder.py:14-237).

The trunk is the port's PE vision transformer (models/libs/perception_encoder/pe.py) under ``model``; every
``_MODEL_CKPT_DICT`` entry of the JAX package builds. Weights load from local files: ``pe_checkpoint_path`` (the PE
model's own state dict) or ``pretrained_checkpoint_path`` (a UniCeption checkpoint, keys under ``model.``); the
reference downloads the former from the HF hub.

``keep_first_n_layers`` is PE's ``truncate(layer_idx)``, as in JAX: it keeps blocks 0..n, n + 1 of them (built
directly, without the later ones; a full-depth checkpoint's later blocks are dropped on load).
"""

from typing import List, Optional, Union

import torch

from uniception_tpu_torch.models.encoders.base import UniCeptionViTEncoderBase, ViTEncoderInput, ViTEncoderOutput
from uniception_tpu_torch.models.libs.perception_encoder.pe import PE_VISION_CONFIG, VisionTransformer
from uniception_tpu_torch.models.utils.intermediate_feature_return import IntermediateFeatureReturner
from uniception_tpu_torch.utils.weights import load_encoder_checkpoint

__all__ = ["PerceptionEncoder", "PerceptionEncoderIntermediateFeatureReturner", "MODEL_CKPT_DICT"]

MODEL_CKPT_DICT = {
    ("core", "base"): "PE-Core-B16-224",
    ("core", "large"): "PE-Core-L14-336",
    ("core", "giant"): "PE-Core-G14-448",
    ("lang", "base"): "PE-Lang-B16-224",
    ("lang", "large"): "PE-Lang-L14-448",
    ("lang", "giant"): "PE-Lang-G14-448",
    ("spatial", "giant"): "PE-Spatial-G14-448",
}


class PerceptionEncoder(UniCeptionViTEncoderBase):
    "UniCeption Perception Encoder: BCHW patch features (the cls token stripped)."

    def __init__(
        self,
        name: str,
        data_norm_type: str = "perception_encoder",
        patch_size: int = 14,
        size: str = "large",
        checkpoint_type: str = "core",
        pretrained_checkpoint_path: Optional[str] = None,
        pe_checkpoint_path: Optional[str] = None,
        gradient_checkpointing: bool = False,
        keep_first_n_layers: Optional[int] = None,
        *,
        device=None,
        dtype=None,
        param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        **_compat_kwargs,
    ):
        super().__init__(name=name, data_norm_type=data_norm_type, patch_size=patch_size,
                         gradient_checkpointing=gradient_checkpointing)
        self.enc_embed_dim = {"small": 384, "base": 768, "large": 1024, "giant": 1536}[size]
        model_str = MODEL_CKPT_DICT.get((checkpoint_type, size))
        if model_str is None:
            raise ValueError(f"Unsupported combination of checkpoint_type '{checkpoint_type}' and size '{size}'.")
        cut = {}
        if keep_first_n_layers is not None:  # truncate(n)'s depth, built directly
            layers = PE_VISION_CONFIG[model_str].layers
            cut = dict(layers=((layers + keep_first_n_layers) % layers) + 1)
        self.model = VisionTransformer.from_config(model_str, pretrained=pe_checkpoint_path is not None,
                                                   checkpoint_path=pe_checkpoint_path, device=device, dtype=dtype,
                                                   generator=generator, **cut)
        self.to(param_dtype)
        if pretrained_checkpoint_path:
            print(f"Loading custom pretrained Perception Encoder checkpoint from {pretrained_checkpoint_path}")
            load_encoder_checkpoint(self, pretrained_checkpoint_path,
                                    kept_blocks={"model.transformer.resblocks.": self.model.layers})

    def _check_image(self, image: torch.Tensor):
        if image.dim() != 4 or image.shape[1] != 3:
            raise ValueError(f"Input must be of shape (B, 3, H, W), got {tuple(image.shape)}")
        height, width = image.shape[-2:]
        if height % self.patch_size or width % self.patch_size:
            raise ValueError(f"Input shape must be divisible by patch size: {self.patch_size}")
        return height, width

    def _to_bchw(self, tokens: torch.Tensor, height: int, width: int) -> torch.Tensor:
        B = tokens.shape[0]
        hp, wp = height // self.patch_size, width // self.patch_size
        return tokens.reshape(B, hp, wp, -1).permute(0, 3, 1, 2)

    def forward(self, encoder_input: ViTEncoderInput) -> ViTEncoderOutput:
        self._check_data_normalization_type(encoder_input.data_norm_type)
        height, width = self._check_image(encoder_input.image)
        feats = self.model.forward_features(encoder_input.image, norm=True, strip_cls_token=True)
        return ViTEncoderOutput(features=self._to_bchw(feats, height, width))


class PerceptionEncoderIntermediateFeatureReturner(PerceptionEncoder, IntermediateFeatureReturner):
    """PE encoder returning intermediate layers (reference perception_encoder.py:126-...): ``indices`` goes to PE's
    ``get_intermediate_layers`` (an int n: the one block n from the end; a list: those blocks; None: n = the
    number of blocks, as in JAX)."""

    def __init__(self, *args, indices: Optional[Union[int, List[int]]] = 1, norm_intermediate: bool = True,
                 **kwargs):
        PerceptionEncoder.__init__(self, *args, **kwargs)
        IntermediateFeatureReturner.__init__(self, indices=indices, norm_intermediate=norm_intermediate)

    def forward(self, encoder_input: ViTEncoderInput) -> List[ViTEncoderOutput]:
        self._check_data_normalization_type(encoder_input.data_norm_type)
        height, width = self._check_image(encoder_input.image)
        n = self.indices if self.indices is not None else self.model.layers
        outs = self.model.get_intermediate_layers(encoder_input.image, n=n, norm=self.norm_intermediate,
                                                  strip_cls_token=True)
        return [ViTEncoderOutput(features=self._to_bchw(o, height, width)) for o in outs]
