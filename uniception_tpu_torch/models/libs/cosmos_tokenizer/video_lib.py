"""
The Cosmos causal video tokenizer for inference (counterpart of
uniception_tpu/models/libs/cosmos_tokenizer/video_lib.py; reference
uniception/models/libs/cosmos_tokenizer/video_lib.py:34-...).

:class:`CausalVideoTokenizer` wraps a CV or DV tokenizer with encode / decode / autoencode over clips in [-1, 1]
(B, 3, T, H, W) with T = 1 + temporal_compression * n, numpy arrays or tensors. It builds on the card unless the caller
passes ``device="cpu"``; ``dtype`` is the compute dtype (None: fp32). The mid blocks' spatial attention is K1 at D =
512 on the card, in either dtype; the 3D convs, norms and the causal temporal attention stay torch built-ins. The
weights are drawn from ``seed``, or loaded strictly from ``checkpoint_path``.

    tok = CausalVideoTokenizer("CV", 8, 8, dtype=torch.bfloat16)
    latent = tok.encode(video)           # (B, 16, 1 + (T - 1) / 8, H / 8, W / 8)
    recon = tok.autoencode(video)        # numpy (B, 3, T, H, W)
"""

from typing import Optional

import numpy as np
import torch

from uniception_tpu_torch.models.libs.cosmos_tokenizer.utils import load_model

__all__ = ["CausalVideoTokenizer"]


class CausalVideoTokenizer:
    "A continuous (CV) or discrete (DV) causal video tokenizer."

    def __init__(self, tokenizer_type: str = "CV", spatial_compression: int = 8, temporal_compression: int = 8,
                 checkpoint_path: Optional[str] = None, *, device="cuda", dtype: Optional[torch.dtype] = None,
                 seed: int = 0, generator: Optional[torch.Generator] = None):
        assert tokenizer_type in ("CV", "DV")
        self.tokenizer_type, self.device = tokenizer_type, torch.device(device)
        self.model = load_model(tokenizer_type, checkpoint_path, device=device, dtype=dtype, seed=seed,
                                generator=generator, spatial_compression=spatial_compression,
                                temporal_compression=temporal_compression).eval()

    def _video(self, video) -> torch.Tensor:
        return torch.as_tensor(video, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def encode(self, video):
        "(B, 3, T, H, W) in [-1, 1] -> the latent (CV), or (indices, codes) (DV)."
        if self.tokenizer_type == "CV":
            return self.model.encode(self._video(video))[0]
        indices, codes, _ = self.model.encode(self._video(video))
        return indices, codes

    @torch.no_grad()
    def decode(self, latent_or_indices) -> torch.Tensor:
        "A CV latent or DV indices -> (B, 3, T, H, W) clips in about [-1, 1]."
        return self.model.decode(torch.as_tensor(latent_or_indices, device=self.device))

    @torch.no_grad()
    def autoencode(self, video) -> np.ndarray:
        "Encode and decode: (B, 3, T, H, W) in [-1, 1] -> the fp32 reconstruction as a numpy array."
        return self.model(self._video(video)).reconstructions.float().cpu().numpy()
