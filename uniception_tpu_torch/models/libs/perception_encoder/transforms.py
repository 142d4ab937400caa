"""
CLIP-style image preprocessing for the Perception Encoder.

Mirrors reference
uniception/models/libs/perception_encoder/vision_encoder/transforms.py:4-22
(the one reference file that previously had no repo analogue): a
``get_image_transform(image_size, center_crop, interpolation)`` factory with
the same two crop modes —

* ``center_crop=False`` ("squash", the reference default): resize to
  (image_size, image_size), aspect ratio ignored;
* ``center_crop=True``: resize the *shorter* edge to ``image_size``
  (torchvision ``T.Resize(int)`` semantics), then center-crop a square.

followed by RGB conversion, [0, 1] scaling (``T.ToTensor``) and
mean/std = 0.5 normalization — landing in [-1, 1], exactly the
``IMAGE_NORMALIZATION_DICT["perception_encoder"]`` convention.

Differences from the reference: no torch/torchvision dependency — resizing goes
through PIL (same resampling filters torchvision uses on PIL inputs) and
the output is a numpy ``float32`` array. Returns CHW by default to match
the reference transform's output layout; pass ``channels_last=True`` for
an (H, W, C) array.

A copy of uniception_tpu/models/libs/perception_encoder/transforms.py: it
imports only numpy and PIL, and the port imports nothing of the JAX package.
"""

from typing import Callable, Union

import numpy as np

try:  # PIL ships with the baked-in environment; gate anyway
    from PIL import Image

    _PIL_FILTERS = {
        "bilinear": Image.Resampling.BILINEAR,
        "bicubic": Image.Resampling.BICUBIC,
        "nearest": Image.Resampling.NEAREST,
        "lanczos": Image.Resampling.LANCZOS,
    }
except ImportError:  # pragma: no cover
    Image = None
    _PIL_FILTERS = {}

__all__ = ["get_image_transform"]


def _to_pil(image) -> "Image.Image":
    if Image is None:  # pragma: no cover
        raise ImportError("PIL is required for perception_encoder.transforms")
    if isinstance(image, Image.Image):
        return image
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        # float arrays are assumed to be in [0, 1]
        arr = np.clip(arr * 255.0 if arr.max() <= 1.0 + 1e-6 else arr, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        return Image.fromarray(arr, mode="L")
    return Image.fromarray(arr)


def _resize_shorter_edge(img: "Image.Image", size: int, resample) -> "Image.Image":
    "torchvision T.Resize(int): scale so the shorter edge == size, keep aspect."
    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, round(h * size / w))
    else:
        new_w, new_h = max(1, round(w * size / h)), size
    return img.resize((new_w, new_h), resample=resample)


def _center_crop(img: "Image.Image", size: int) -> "Image.Image":
    "torchvision T.CenterCrop: crop a size x size square about the center."
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def get_image_transform(
    image_size: int,
    center_crop: bool = False,
    interpolation: str = "bilinear",  # reference used bilinear during training
    channels_last: bool = False,
) -> Callable[[Union["Image.Image", np.ndarray]], np.ndarray]:
    """Build the PE preprocessing callable (reference transforms.py:4-22).

    The returned function maps a PIL image or (H, W[, C]) uint8/float array
    to a float32 array in [-1, 1], shape (3, image_size, image_size)
    (or (image_size, image_size, 3) with ``channels_last=True``).
    """
    if interpolation not in _PIL_FILTERS:
        raise ValueError(f"interpolation must be one of {sorted(_PIL_FILTERS)}, got {interpolation!r}")
    resample = _PIL_FILTERS[interpolation]

    def transform(image) -> np.ndarray:
        img = _to_pil(image)
        if center_crop:
            img = _center_crop(_resize_shorter_edge(img, image_size, resample), image_size)
        else:
            img = img.resize((image_size, image_size), resample=resample)  # "squash"
        img = img.convert("RGB")
        arr = np.asarray(img, dtype=np.float32) / 255.0  # ToTensor scaling
        arr = (arr - 0.5) / 0.5  # Normalize(mean=0.5, std=0.5)
        if not channels_last:
            arr = np.transpose(arr, (2, 0, 1))
        return arr

    return transform
