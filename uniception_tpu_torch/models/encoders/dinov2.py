"""
DINOv2 encoder, ViT-S/B/L/g with or without registers (counterpart of uniception_tpu/models/encoders/dinov2.py;
reference uniception/models/encoders/dinov2.py:15-386).

The trunk is :class:`~uniception_tpu_torch.models.encoders.vit.DinoVisionTransformer` under the ``model``
attribute, so the reference's checkpoint keys (``model.patch_embed.proj.weight``, ...) load as they are; a state
dict in torch.hub's layout (no ``model.`` prefix) loads too, and the unused ``mask_token`` is dropped. ``dtype``
is the compute dtype and ``param_dtype`` the parameters' (their cast happens before any checkpoint is read).
"""

from typing import List, Optional, Union

import torch

from uniception_tpu_torch.models.encoders.base import UniCeptionViTEncoderBase, ViTEncoderInput, ViTEncoderOutput
from uniception_tpu_torch.models.encoders.vit import DINO_VIT_CONFIGS, DinoVisionTransformer
from uniception_tpu_torch.models.utils.intermediate_feature_return import (
    IntermediateFeatureReturner,
    feature_take_indices,
)
from uniception_tpu_torch.nn.common import Identity
from uniception_tpu_torch.utils.checkpoint import load_checkpoint
from uniception_tpu_torch.utils.weights import load_state_dict_numpy

__all__ = ["DINOv2Encoder", "DINOv2IntermediateFeatureReturner"]


def _encoder_state(state: dict) -> dict:
    """A DINOv2 checkpoint's state dict in the encoder's keys: ``model.`` prefixed when it is in torch.hub's layout
    (no key starts with ``model.``), without ``mask_token`` (the reference deletes it, dinov2.py:104)."""
    hub = not any(k.startswith("model.") for k in state)
    return {("model." + k if hub else k): v for k, v in state.items() if "mask_token" not in k}


class DINOv2Encoder(UniCeptionViTEncoderBase):
    "UniCeption DINOv2 encoder: BCHW patch features and (B, D, 1 + R) cls + register tokens."

    def __init__(
        self,
        name: str,
        data_norm_type: str = "dinov2",
        patch_size: int = 14,
        size: str = "large",
        with_registers: bool = False,
        norm_returned_features: bool = True,
        pretrained_checkpoint_path: Optional[str] = None,
        gradient_checkpointing: bool = False,
        keep_first_n_layers: Optional[int] = None,
        scan_blocks: bool = False,
        *,
        device=None,
        dtype=None,
        param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        **_compat_kwargs,  # the reference's torch_hub_* / use_pytorch_sdpa, accepted and ignored as in the JAX package
    ):
        super().__init__(name=name if not with_registers else f"{name}_reg", data_norm_type=data_norm_type,
                         patch_size=patch_size, gradient_checkpointing=gradient_checkpointing)
        if size not in DINO_VIT_CONFIGS:
            raise ValueError(f"Unknown DINOv2 size {size!r}: one of {sorted(DINO_VIT_CONFIGS)}")
        self.version = size
        self.with_registers = with_registers
        self.norm_returned_features = norm_returned_features
        cfg = DINO_VIT_CONFIGS[size]
        self.enc_embed_dim = cfg["embed_dim"]

        self.model = DinoVisionTransformer(
            img_size=518, patch_size=patch_size, num_register_tokens=4 if with_registers else 0,
            scan_blocks=scan_blocks, gradient_checkpointing=gradient_checkpointing, device=device, dtype=dtype,
            generator=generator, **cfg,
        )
        if keep_first_n_layers is not None:
            self.model.blocks = self.model.blocks[:keep_first_n_layers]
            self.model.depth = keep_first_n_layers
        if not norm_returned_features:
            self.model.norm = Identity()
        self.to(param_dtype)

        if pretrained_checkpoint_path:
            print(f"Loading custom pretrained DINOv2 checkpoint from {pretrained_checkpoint_path}")
            load_state_dict_numpy(self, _encoder_state(load_checkpoint(pretrained_checkpoint_path)["model"]))

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
        result = self.model.forward_features(encoder_input.image)
        features = self._patch_to_bchw(result["x_norm_patchtokens"], height, width)
        regs = [result["x_norm_clstoken"][:, None]]
        if self.with_registers:
            regs.append(result["x_norm_regtokens"])
        return ViTEncoderOutput(features=features, registers=torch.cat(regs, dim=1).transpose(1, 2))


class DINOv2IntermediateFeatureReturner(DINOv2Encoder, IntermediateFeatureReturner):
    """DINOv2 encoder returning the patch features after the blocks in ``indices`` (reference dinov2.py:219-333):
    the pre-norm tokens, through the final norm when ``norm_intermediate``. Runs only as many blocks as the deepest
    index needs."""

    def __init__(self, *args, indices: Optional[Union[int, List[int]]] = 1, norm_intermediate: bool = True,
                 **kwargs):
        DINOv2Encoder.__init__(self, *args, **kwargs)
        IntermediateFeatureReturner.__init__(self, indices=indices, norm_intermediate=norm_intermediate)

    def forward(self, encoder_input: ViTEncoderInput) -> List[ViTEncoderOutput]:
        self._check_data_normalization_type(encoder_input.data_norm_type)
        height, width = self._check_image(encoder_input.image)
        take_indices, max_index = feature_take_indices(self.model.depth, self.indices)
        _, collected, _ = self.model.forward_tokens(encoder_input.image, n_blocks=max_index + 1,
                                                    collect_indices=set(take_indices))
        outputs = []
        for i in take_indices:
            tokens = self.model.norm(collected[i]) if self.norm_intermediate else collected[i]
            outputs.append(ViTEncoderOutput(features=self._patch_to_bchw(self.model.split_tokens(tokens)[2],
                                                                        height, width)))
        return outputs
