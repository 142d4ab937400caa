"""
NVIDIA RADIO encoder (counterpart of uniception_tpu/models/encoders/radio.py; reference
uniception/models/encoders/radio.py:13-367).

The ViT variants (v2.5-b/l/h/g) run the port's DINOv2 trunk
(:class:`~uniception_tpu_torch.models.encoders.vit.DinoVisionTransformer`) as the JAX package builds it: patch 16
(14 for -g), a cls token and ``num_register_tokens`` registers, a PE table for a 37 x 37 patch grid, no LayerScale,
exact GELU. E-RADIO runs :class:`~uniception_tpu_torch.models.encoders.eradio.ERadio` with its window fixed from
``eradio_input_shape`` before the forward, as in JAX.

Head dims: 64 for -b/-l/-g, 80 for v2.5-h (1280 / 16), 32 for E-RADIO's windows. K1 takes all three.
"""

from typing import List, Optional, Union

import torch

from uniception_tpu_torch.models.encoders.base import UniCeptionViTEncoderBase, ViTEncoderInput, ViTEncoderOutput
from uniception_tpu_torch.models.encoders.eradio import ERadio
from uniception_tpu_torch.models.encoders.vit import DinoVisionTransformer
from uniception_tpu_torch.models.utils.intermediate_feature_return import (
    IntermediateFeatureReturner,
    feature_take_indices,
)
from uniception_tpu_torch.utils.weights import load_encoder_checkpoint

__all__ = ["RADIOEncoder", "RADIOIntermediateFeatureReturner", "RADIO_CONFIGS"]

RADIO_CONFIGS = {
    "radio_v2.5-b": dict(embed_dim=768, depth=12, num_heads=12),
    "radio_v2.5-l": dict(embed_dim=1024, depth=24, num_heads=16),
    "radio_v2.5-h": dict(embed_dim=1280, depth=32, num_heads=16),
    "radio_v2.5-g": dict(embed_dim=1536, depth=40, num_heads=24),
    "e-radio_v2": dict(embed_dim=1536, depth=0, num_heads=0),
}


class RADIOEncoder(UniCeptionViTEncoderBase):
    "UniCeption RADIO encoder: BCHW patch features at stride 16 (14 for v2.5-g)."

    def __init__(
        self,
        name: str,
        data_norm_type: str = "radio",
        patch_size: int = 16,
        model_version: str = "radio_v2.5-l",
        pretrained_checkpoint_path: Optional[str] = None,
        eradio_input_shape: Optional[tuple] = None,
        keep_first_n_layers: Optional[int] = None,
        num_register_tokens: int = 8,
        gradient_checkpointing: bool = False,
        *,
        device=None,
        dtype=None,
        param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        **_compat_kwargs,  # the reference's torch-hub options, accepted and ignored as in the JAX package
    ):
        super().__init__(name=name, data_norm_type=data_norm_type, patch_size=patch_size,
                         gradient_checkpointing=gradient_checkpointing)
        if model_version not in RADIO_CONFIGS:
            raise ValueError(f"Unknown RADIO version {model_version!r}: one of {sorted(RADIO_CONFIGS)}")
        self.model_version = model_version
        self.enc_embed_dim = RADIO_CONFIGS[model_version]["embed_dim"]
        self.is_eradio = "e-radio" in model_version
        if model_version == "radio_v2.5-g" and patch_size != 14:
            raise ValueError("Patch size must be 14 for RADIO v2.5-g")
        if not self.is_eradio and model_version != "radio_v2.5-g" and patch_size != 16:
            raise ValueError("Patch size must be 16 for all other versions of RADIO")

        if self.is_eradio:
            # the window is a constant of the forward, fixed from the input shape up front (reference radio.py:95-98)
            if eradio_input_shape is None:
                raise ValueError("Input shape (height, width) must be provided for E-RADIO models")
            self.model = ERadio(model_version=model_version, device=device, dtype=dtype, generator=generator)
            self.model.set_optimal_window_size(eradio_input_shape)
        else:
            cfg = RADIO_CONFIGS[model_version]
            # keep_first_n_layers builds only those blocks: the first blocks of the full trunk, as JAX's slice
            depth = cfg["depth"] if keep_first_n_layers is None else min(keep_first_n_layers, cfg["depth"])
            self.model = DinoVisionTransformer(
                img_size=patch_size * 37, patch_size=patch_size, embed_dim=cfg["embed_dim"], depth=depth,
                num_heads=cfg["num_heads"], init_values=None, num_register_tokens=num_register_tokens,
                ffn_layer="mlp", gradient_checkpointing=gradient_checkpointing, device=device, dtype=dtype,
                generator=generator,
            )
        self.to(param_dtype)

        if pretrained_checkpoint_path is not None:
            print(f"Loading custom pretrained RADIO checkpoint from {pretrained_checkpoint_path}")
            kept = None if self.is_eradio else {"model.blocks.": self.model.depth}
            load_encoder_checkpoint(self, pretrained_checkpoint_path, kept_blocks=kept)

    def _check_image(self, image: torch.Tensor):
        "(height, width) of a (B, 3, H, W) image whose sides are multiples of the patch; raises otherwise."
        if image.dim() != 4 or image.shape[1] != 3:
            raise ValueError(f"Input must be of shape (B, 3, H, W), got {tuple(image.shape)}")
        height, width = image.shape[-2:]
        if height % self.patch_size or width % self.patch_size:
            raise ValueError(f"Input shape must be divisible by patch size: {self.patch_size}")
        return height, width

    def _patch_to_bchw(self, patch_tokens: torch.Tensor, height: int, width: int) -> torch.Tensor:
        B = patch_tokens.shape[0]
        hp, wp = height // self.patch_size, width // self.patch_size
        return patch_tokens.reshape(B, hp, wp, self.enc_embed_dim).permute(0, 3, 1, 2)

    def forward(self, encoder_input: ViTEncoderInput) -> ViTEncoderOutput:
        self._check_data_normalization_type(encoder_input.data_norm_type)
        height, width = self._check_image(encoder_input.image)
        if self.is_eradio:
            _, tokens = self.model(encoder_input.image)
        else:
            tokens = self.model.forward_features(encoder_input.image)["x_norm_patchtokens"]
        return ViTEncoderOutput(features=self._patch_to_bchw(tokens, height, width))


class RADIOIntermediateFeatureReturner(RADIOEncoder, IntermediateFeatureReturner):
    """RADIO encoder returning the patch features after the blocks in ``indices`` (reference radio.py:140-367), through
    the final norm when ``norm_intermediate``. The ViT variants only: E-RADIO has no block list to index, as in JAX."""

    def __init__(self, *args, indices: Optional[Union[int, List[int]]] = 1, norm_intermediate: bool = True,
                 **kwargs):
        RADIOEncoder.__init__(self, *args, **kwargs)
        IntermediateFeatureReturner.__init__(self, indices=indices, norm_intermediate=norm_intermediate)

    def forward(self, encoder_input: ViTEncoderInput) -> List[ViTEncoderOutput]:
        self._check_data_normalization_type(encoder_input.data_norm_type)
        height, width = self._check_image(encoder_input.image)
        if self.is_eradio:
            raise ValueError("E-RADIO has no intermediate layers to return; use RADIOEncoder")
        take_indices, max_index = feature_take_indices(self.model.depth, self.indices)
        _, collected, _ = self.model.forward_tokens(encoder_input.image, n_blocks=max_index + 1,
                                                    collect_indices=set(take_indices))
        outputs = []
        for i in take_indices:
            tokens = self.model.norm(collected[i]) if self.norm_intermediate else collected[i]
            outputs.append(ViTEncoderOutput(features=self._patch_to_bchw(self.model.split_tokens(tokens)[2],
                                                                        height, width)))
        return outputs
