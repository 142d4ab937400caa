"""
DUNE encoder: the DINOv2-with-registers trunk with DUNE's weights (counterpart of
uniception_tpu/models/encoders/dune.py; reference uniception/models/encoders/dune.py:17-408).

Registers are always on and the PE table is sized for ``pe_image_size`` (448: a 32 x 32 grid + cls,
dune.py:108-113). A DUNE checkpoint keeps the trunk under ``encoder.`` with its blocks chunked as
``blocks.M.N``; :func:`_extract_and_remap_encoder_weights` maps it onto the encoder's ``model.*`` keys.
"""

from typing import List, Optional, Union

import torch
from torch import nn

from uniception_tpu_torch.models.encoders.base import ViTEncoderInput, ViTEncoderOutput
from uniception_tpu_torch.models.encoders.dinov2 import DINOv2Encoder, DINOv2IntermediateFeatureReturner
from uniception_tpu_torch.models.utils.intermediate_feature_return import IntermediateFeatureReturner
from uniception_tpu_torch.utils.checkpoint import load_checkpoint
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

__all__ = ["DUNEEncoder", "DUNEIntermediateFeatureReturner"]


def _extract_and_remap_encoder_weights(checkpoint: dict) -> dict:
    """DUNE checkpoint -> encoder keys (dune.py:172-223): only ``encoder.*`` entries, as ``model.*``, with a chunked
    ``blocks.M.N.rest`` flattened to ``blocks.N.rest``; ``mask_token`` dropped."""
    out = {}
    for key, value in checkpoint.items():
        if not key.startswith("encoder."):
            continue
        parts = key[len("encoder."):].split(".")
        if len(parts) >= 3 and parts[0] == "blocks" and parts[1].isdigit() and parts[2].isdigit():
            del parts[1]
        out["model." + ".".join(parts)] = value
    out.pop("model.mask_token", None)
    return out


class DUNEEncoder(DINOv2Encoder):
    "UniCeption DUNE encoder (DINOv2-reg trunk, DUNE weights, PE table for ``pe_image_size``): BCHW features."

    def __init__(
        self,
        name: str,
        pretrained_checkpoint_path: Optional[str] = None,
        data_norm_type: str = "dune",
        patch_size: int = 14,
        vit_size: str = "base",
        pe_image_size: int = 448,
        gradient_checkpointing: bool = False,
        keep_first_n_layers: Optional[int] = None,
        *,
        device=None,
        dtype=None,
        param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        **_compat_kwargs,
    ):
        super().__init__(
            name=name, data_norm_type=data_norm_type, patch_size=patch_size, size=vit_size, with_registers=True,
            gradient_checkpointing=gradient_checkpointing, keep_first_n_layers=keep_first_n_layers, device=device,
            dtype=dtype, param_dtype=param_dtype, generator=generator,
        )
        num_patches = (pe_image_size // patch_size) ** 2
        self.model.pos_embed = nn.Parameter(
            torch.zeros(1, num_patches + 1, self.enc_embed_dim, device=device, dtype=param_dtype))
        if pretrained_checkpoint_path:
            print(f"Loading DUNE pretrained checkpoint from {pretrained_checkpoint_path}")
            state = _extract_and_remap_encoder_weights(load_checkpoint(pretrained_checkpoint_path)["model"])
            load_state_dict_numpy(self, state, strict=False)

    def forward(self, encoder_input: ViTEncoderInput) -> ViTEncoderOutput:
        self._check_data_normalization_type(encoder_input.data_norm_type)
        height, width = self._check_image(encoder_input.image)
        result = self.model.forward_features(encoder_input.image)
        return ViTEncoderOutput(features=self._patch_to_bchw(result["x_norm_patchtokens"], height, width))


class DUNEIntermediateFeatureReturner(DUNEEncoder, IntermediateFeatureReturner):
    "DUNE encoder returning intermediate layers (reference dune.py:258-...), as the DINOv2 IFR does."

    def __init__(self, *args, indices: Optional[Union[int, List[int]]] = 1, norm_intermediate: bool = True,
                 **kwargs):
        DUNEEncoder.__init__(self, *args, **kwargs)
        IntermediateFeatureReturner.__init__(self, indices=indices, norm_intermediate=norm_intermediate)

    forward = DINOv2IntermediateFeatureReturner.forward
