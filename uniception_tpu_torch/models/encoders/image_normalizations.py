"""
Per-encoder image normalizations (counterpart of
uniception_tpu/models/encoders/image_normalizations.py): every entry of the
JAX table, the adaptors of non-encoder consumers (sea_raft, unimatch, roma:
0-255 inputs in fp32 for the first two) included. Means and stds are float32
tensors of 3, as the JAX package holds float32 arrays.
"""

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["ImageNormalization", "IMAGE_NORMALIZATION_DICT", "normalize_image"]


@dataclass(frozen=True)
class ImageNormalization:
    mean: torch.Tensor
    std: torch.Tensor


def _norm(mean, std) -> ImageNormalization:
    return ImageNormalization(mean=torch.tensor(mean, dtype=torch.float32), std=torch.tensor(std, dtype=torch.float32))


_IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))

IMAGE_NORMALIZATION_DICT = {
    "dummy": _norm((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    "croco": _norm(*_IMAGENET),
    "dust3r": _norm((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    "dune": _norm(*_IMAGENET),
    "dinov2": _norm(*_IMAGENET),
    "dinov3": _norm(*_IMAGENET),
    "perception_encoder": _norm((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    "identity": _norm((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    "patch_embedder": _norm(*_IMAGENET),
    "radio": _norm((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    "sea_raft": _norm((0.0, 0.0, 0.0), np.ones(3, np.float32) / 255),  # 0-255 in fp32
    "unimatch": _norm((0.0, 0.0, 0.0), np.ones(3, np.float32) / 255),  # 0-255 in fp32
    "roma": _norm(*_IMAGENET),
    "cosmos": _norm((0.0, 0.0, 0.0), (0.5, 0.5, 0.5)),
    "pixio": _norm(*_IMAGENET),
}


def normalize_image(image_01, data_norm_type: str):
    """Normalize a (..., 3, H, W) image in [0, 1] for the given encoder type:
    ``(image - mean) / std`` per channel. A tensor stays a tensor (on its own
    device), anything else is computed in numpy as the JAX package does."""
    norm = IMAGE_NORMALIZATION_DICT[data_norm_type]
    if isinstance(image_01, torch.Tensor):
        mean = norm.mean.to(image_01.device).reshape(3, 1, 1)
        std = norm.std.to(image_01.device).reshape(3, 1, 1)
        return (image_01 - mean) / std
    return (image_01 - norm.mean.numpy().reshape(3, 1, 1)) / norm.std.numpy().reshape(3, 1, 1)
