"""
Cosmos tokenizer utilities (counterpart of uniception_tpu/models/libs/cosmos_tokenizer/utils.py; reference
uniception/models/libs/cosmos_tokenizer/utils.py:34-126): :func:`load_model` builds an image (CI, DI) or causal
video (CV, DV) tokenizer from its config and loads a checkpoint strictly (the JAX package loads with ``strict=False``;
ROADMAP queue 3 records the difference); the array helpers keep the [-1, 1] convention, and the padding helpers bring
a (B, C, T, H, W) clip to 1 + k * temporal_multiple frames.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from uniception_tpu_torch.models.libs.cosmos_tokenizer.networks import TokenizerConfigs, TokenizerModels
from uniception_tpu_torch.utils.weights import load_encoder_checkpoint

__all__ = ["load_model", "numpy2tensor", "tensor2numpy", "pad_video_batch", "unpad_video_batch"]


def load_model(tokenizer_type: str, checkpoint_path: Optional[str] = None, *, device="cuda", dtype=None, seed: int = 0,
               generator: Optional[torch.Generator] = None, **overrides):
    """Build a tokenizer of the config ``tokenizer_type`` ("CI", "DI", "CV" or "DV") with ``overrides``, on
    ``device`` (default: the card; raises without one), computing in ``dtype`` (None: fp32), weights drawn from
    ``generator`` (default: seeded with ``seed``); then load ``checkpoint_path`` strictly."""
    cfg = dict(TokenizerConfigs[tokenizer_type].value)
    cfg.update(overrides)
    cfg.pop("name", None)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the tokenizer builds on the card unless the caller passes device='cpu'")
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(seed)
    model = TokenizerModels[tokenizer_type].value(device=device, dtype=dtype, generator=generator, **cfg)
    if checkpoint_path:
        load_encoder_checkpoint(model, checkpoint_path)
    return model


def numpy2tensor(arr: np.ndarray, range_min: float = -1.0, range_max: float = 1.0, device=None) -> torch.Tensor:
    "uint8 HWC / THWC image(s) -> an fp32 tensor in [range_min, range_max], channel-first with a batch of 1."
    x = np.asarray(arr).astype(np.float32) / 255.0 * (range_max - range_min) + range_min
    if x.ndim == 3:  # HWC -> 1CHW
        return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None])).to(device)
    if x.ndim == 4:  # THWC -> 1CTHW
        return torch.from_numpy(np.ascontiguousarray(x.transpose(3, 0, 1, 2)[None])).to(device)
    raise ValueError(f"Unsupported input shape {np.asarray(arr).shape}")


def tensor2numpy(x, range_min: float = -1.0, range_max: float = 1.0) -> np.ndarray:
    "A channel-first tensor (or array) in [range_min, range_max] -> uint8 channel-last."
    x = x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    x = (x - range_min) / (range_max - range_min)
    x = (x.clip(0, 1) * 255).astype(np.uint8)
    if x.ndim == 4:  # BCHW -> BHWC
        return x.transpose(0, 2, 3, 1)
    if x.ndim == 5:  # BCTHW -> BTHWC
        return x.transpose(0, 2, 3, 4, 1)
    return x


def pad_video_batch(video: torch.Tensor, temporal_multiple: int = 8, spatial_multiple: int = 16):
    """Edge-pad (B, C, T, H, W) to 1 + k * temporal_multiple frames and spatial multiples; returns (video,
    crop_region)."""
    B, C, T, H, W = video.shape
    t_pad, h_pad, w_pad = (-(T - 1)) % temporal_multiple, (-H) % spatial_multiple, (-W) % spatial_multiple
    return F.pad(video, (0, w_pad, 0, h_pad, 0, t_pad), mode="replicate"), (T, H, W)


def unpad_video_batch(video: torch.Tensor, crop_region):
    T, H, W = crop_region
    return video[:, :, :T, :H, :W]
