"""
The Cosmos continuous image tokenizer's encoder as a dense feature encoder (counterpart of
uniception_tpu/models/encoders/cosmos.py; reference uniception/models/encoders/cosmos.py:12-110): the CI config with
``spatial_compression = patch_size`` (8 or 16); encode = encoder -> quant_conv -> distribution, a 16-channel latent.

Under ``config.set_conv3x3_impl("kernel")`` an encoder built with ``dtype=torch.bfloat16`` runs its eligible 3x3
convs on K7 (16 per forward), and the mid block's attention (one head, D = 512) on K1 in either dtype. A
``pretrained_checkpoint_path`` loads strictly (the JAX package loads with ``strict=False``; ROADMAP queue 3).
"""

from typing import Optional

import torch

from uniception_tpu_torch.models.encoders.base import UniCeptionViTEncoderBase, ViTEncoderInput, ViTEncoderOutput
from uniception_tpu_torch.models.libs.cosmos_tokenizer.modules import ContinuousFormulation, EncoderType
from uniception_tpu_torch.models.libs.cosmos_tokenizer.networks import TokenizerConfigs
from uniception_tpu_torch.nn.dpt_parts import Conv2dTorch
from uniception_tpu_torch.utils.weights import load_encoder_checkpoint

__all__ = ["CosmosEncoder"]


class CosmosEncoder(UniCeptionViTEncoderBase):
    "UniCeption Cosmos encoder: (B, 3, H, W) in [-1, 1] -> (B, 16, H / P, W / P)."

    def __init__(
        self,
        name: str,
        data_norm_type: str = "cosmos",
        patch_size: int = 8,
        pretrained_checkpoint_path: Optional[str] = None,
        *,
        device=None,
        dtype=None,
        param_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ):
        super().__init__(name=name, data_norm_type=data_norm_type, patch_size=patch_size)
        tokenizer_config = dict(TokenizerConfigs["CI"].value)
        tokenizer_config.update(dict(spatial_compression=self.patch_size))

        z_factor = tokenizer_config.pop("z_factor")
        z_channels = tokenizer_config.pop("z_channels")
        latent_channels = tokenizer_config.pop("latent_channels")
        self.enc_embed_dim = latent_channels
        kw = dict(dtype=dtype, device=device, generator=generator)
        encoder_name = kwargs.get("encoder", EncoderType.Default.name)
        self.encoder = EncoderType[encoder_name].value(z_channels=z_factor * z_channels, **kw, **tokenizer_config)
        self.quant_conv = Conv2dTorch(z_factor * z_channels, z_factor * latent_channels, 1, 1, 0, **kw)
        formulation_name = kwargs.get("formulation", ContinuousFormulation.AE.name)
        self.distribution = ContinuousFormulation[formulation_name].value()
        self.to(param_dtype)

        if pretrained_checkpoint_path is not None:
            print(f"Loading custom pretrained Cosmos checkpoint from {pretrained_checkpoint_path}")
            load_encoder_checkpoint(self, pretrained_checkpoint_path)

    def encode(self, input_tensor: torch.Tensor):
        "(B, 3, H, W) in [-1, 1] -> (latent (B, 16, H / P, W / P),)."
        latent, _stats = self.distribution(self.quant_conv(self.encoder(input_tensor)))
        return (latent,)

    def forward(self, encoder_input: ViTEncoderInput) -> ViTEncoderOutput:
        self._check_data_normalization_type(encoder_input.data_norm_type)
        image = encoder_input.image
        assert image.dim() == 4 and image.shape[1] == 3
        height, width = image.shape[-2:]
        assert height % self.patch_size == 0 and width % self.patch_size == 0
        return ViTEncoderOutput(features=self.encode(image)[0])
