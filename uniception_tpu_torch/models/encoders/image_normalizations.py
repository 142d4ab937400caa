"""
Per-encoder image normalizations (counterpart of
uniception_tpu/models/encoders/image_normalizations.py): every entry of the
JAX table, the adaptors of non-encoder consumers (sea_raft, unimatch, roma:
0-255 inputs in fp32 for the first two) included.
"""

from dataclasses import dataclass
from typing import Tuple

__all__ = ["ImageNormalization", "IMAGE_NORMALIZATION_DICT"]


@dataclass(frozen=True)
class ImageNormalization:
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]


_IMAGENET = ImageNormalization(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))

IMAGE_NORMALIZATION_DICT = {
    "dummy": ImageNormalization(mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)),
    "croco": _IMAGENET,
    "dust3r": ImageNormalization(mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
    "dune": _IMAGENET,
    "dinov2": _IMAGENET,
    "dinov3": _IMAGENET,
    "perception_encoder": ImageNormalization(mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
    "identity": ImageNormalization(mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)),
    "patch_embedder": _IMAGENET,
    "radio": ImageNormalization(mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)),
    "sea_raft": ImageNormalization(mean=(0.0, 0.0, 0.0), std=(1 / 255, 1 / 255, 1 / 255)),
    "unimatch": ImageNormalization(mean=(0.0, 0.0, 0.0), std=(1 / 255, 1 / 255, 1 / 255)),
    "roma": _IMAGENET,
    "cosmos": ImageNormalization(mean=(0.0, 0.0, 0.0), std=(0.5, 0.5, 0.5)),
    "pixio": _IMAGENET,
}
