"""
The Cosmos image tokenizer for inference (counterpart of uniception_tpu/models/libs/cosmos_tokenizer/image_lib.py;
reference uniception/models/libs/cosmos_tokenizer/image_lib.py:33-...).

:class:`ImageTokenizer` wraps a CI or DI tokenizer with encode / decode / autoencode over images in [-1, 1]
(B, 3, H, W), numpy arrays or tensors. It builds on the card unless the caller passes ``device="cpu"``; ``dtype`` is
the compute dtype (None: fp32; ``torch.bfloat16`` runs the convs of C and Co multiples of 128 on K7 under
``config.set_conv3x3_impl("kernel")``, and the mid blocks' attention on K1 at D = 512 in either). The weights are
drawn from ``seed``, or loaded strictly from ``checkpoint_path``.

    tok = ImageTokenizer("CI", spatial_compression=8, dtype=torch.bfloat16)
    latent = tok.encode(images)          # (B, 16, H / 8, W / 8)
    recon = tok.autoencode(images)       # numpy (B, 3, H, W)
"""

from typing import Optional

import numpy as np
import torch

from uniception_tpu_torch.models.libs.cosmos_tokenizer.utils import load_model

__all__ = ["ImageTokenizer"]


class ImageTokenizer:
    "A continuous (CI) or discrete (DI) image tokenizer."

    def __init__(self, tokenizer_type: str = "CI", spatial_compression: int = 8, checkpoint_path: Optional[str] = None,
                 *, device="cuda", dtype: Optional[torch.dtype] = None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        assert tokenizer_type in ("CI", "DI")
        self.tokenizer_type, self.device = tokenizer_type, torch.device(device)
        self.model = load_model(tokenizer_type, checkpoint_path, device=device, dtype=dtype, seed=seed,
                                generator=generator, spatial_compression=spatial_compression).eval()

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(images, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def encode(self, images):
        "(B, 3, H, W) in [-1, 1] -> the latent (CI), or (indices, codes) (DI)."
        if self.tokenizer_type == "CI":
            return self.model.encode(self._images(images))[0]
        indices, codes, _ = self.model.encode(self._images(images))
        return indices, codes

    @torch.no_grad()
    def decode(self, latent_or_indices) -> torch.Tensor:
        "A CI latent or DI indices -> (B, 3, H, W) images in about [-1, 1]."
        return self.model.decode(torch.as_tensor(latent_or_indices, device=self.device))

    @torch.no_grad()
    def autoencode(self, images) -> np.ndarray:
        "Encode and decode: (B, 3, H, W) in [-1, 1] -> the fp32 reconstruction as a numpy array."
        return self.model(self._images(images)).reconstructions.float().cpu().numpy()
