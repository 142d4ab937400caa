"""
ManyAR canvas packing and aspect bucketing for mixed-size serving
(counterpart of uniception_tpu/data/bucketing.py).

The ManyAR convention: every image of a batch sits in one landscape canvas
(h <= w); portrait images are spatially transposed into it, and
``true_shape`` (B, 2) = (true_h, true_w) records each row's native
orientation. ``DUSt3R(landscape_only=True)`` returns its outputs in the same
canvas layout, and :func:`extract_view` undoes the transpose.

Bucketing: a small fixed family of landscape canvases (the DUSt3R-512
training resolutions); each image is aspect-matched to the nearest one,
resized and centre-cropped into it, and batched with others of its bucket,
so the set of served shapes stays fixed (one CUDA graph per bucket, later).

:func:`resize_to_bucket` resizes without PIL: :func:`resize_bicubic_u8` is
PIL's ``Image.resize(..., BICUBIC)`` (Resample.c: the a = -0.5 cubic,
antialiased by the scale, coefficients in 22-bit fixed point, horizontal pass
then vertical, each rounded and clipped to uint8) in integer torch arithmetic,
so it gives PIL's pixels.
"""

import math
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "pack_views",
    "extract_view",
    "extract_views",
    "DUST3R_512_BUCKETS",
    "DUST3R_224_BUCKETS",
    "assign_bucket",
    "resize_bicubic_u8",
    "resize_to_bucket",
    "with_portrait_buckets",
    "BucketedBatcher",
    "PairBucketedBatcher",
]


def pack_views(images: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Stack mixed landscape/portrait (C, H, W) images into one ManyAR canvas
    batch; portrait images (H > W) are transposed into the landscape canvas.

    Returns (canvas (B, C, h, w), true_shape (B, 2) int32).
    """
    if not images:
        raise ValueError("pack_views needs at least one image")
    rows, shapes = [], []
    for im in images:
        if im.ndim != 3:
            raise ValueError(f"expected (C, H, W), got shape {im.shape}")
        _, H, W = im.shape
        shapes.append((H, W))
        rows.append(np.swapaxes(im, -1, -2) if H > W else im)
    hw = {r.shape[-2:] for r in rows}
    if len(hw) != 1:
        raise ValueError(
            f"mixed canvas sizes {sorted(hw)}: bucket images so every batch "
            "shares one (h, w) canvas (transposes of each other are fine)"
        )
    return np.stack(rows), np.asarray(shapes, np.int32)


def extract_view(x, true_shape) -> np.ndarray:
    """One row's native-orientation array from a canvas-layout output (a
    ``pts3d`` row (h, w, C) or a ``conf`` row (h, w)); the channel axis, if
    any, is last. true_shape: (2,) = (true_h, true_w)."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    th, tw = int(true_shape[0]), int(true_shape[1])
    if th > tw:  # portrait: the canvas holds the spatial transpose
        x = np.swapaxes(x, 0, 1)
    if x.shape[:2] != (th, tw):
        raise ValueError(f"canvas {x.shape[:2]} does not match true_shape {(th, tw)}")
    return x


def extract_views(batch, true_shapes) -> List[np.ndarray]:
    "Vector form: one native-orientation array per batch row."
    return [extract_view(batch[i], true_shapes[i]) for i in range(len(batch))]


# (h, w) landscape canvases, all multiples of 16: the DUSt3R-512 training resolutions
DUST3R_512_BUCKETS: Tuple[Tuple[int, int], ...] = ((384, 512), (336, 512), (288, 512), (256, 512), (160, 512))
DUST3R_224_BUCKETS: Tuple[Tuple[int, int], ...] = ((224, 224),)


def assign_bucket(
    h: int,
    w: int,
    buckets: Sequence[Tuple[int, int]] = DUST3R_512_BUCKETS,
    manyar: bool = True,
) -> Tuple[int, bool]:
    """The bucket whose aspect ratio best matches an (h, w) image, minimizing
    |log(bucket_ar) - log(image_ar)|.

    manyar=True: a portrait image is matched against the landscape buckets
    transposed and flagged for the ManyAR canvas (the family must be all
    landscape). manyar=False: the image's own aspect is matched against each
    canvas's own, nothing is transposed (:func:`with_portrait_buckets` gives
    portraits their canvases; ``UFMFlow`` has no ManyAR path).

    Returns (bucket_index, is_portrait — always False when manyar=False).
    """
    if h <= 0 or w <= 0:
        raise ValueError(f"bad image size ({h}, {w})")
    portrait = manyar and h > w
    ar = (h / w) if portrait else (w / h)
    best, best_err = 0, float("inf")
    for i, (bh, bw) in enumerate(buckets):
        if manyar and bh > bw:
            raise ValueError(f"bucket {i} {(bh, bw)} is not a landscape canvas (h <= w)")
        err = abs(np.log(bw / bh) - np.log(ar))
        if err < best_err:
            best, best_err = i, err
    return best, portrait


def with_portrait_buckets(buckets: Sequence[Tuple[int, int]]) -> Tuple[Tuple[int, int], ...]:
    "Extend a landscape bucket family with each canvas's transpose (manyar=False mode)."
    out = [tuple(b) for b in buckets]
    for bh, bw in list(out):
        if bh != bw and (bw, bh) not in out:
            out.append((bw, bh))
    return tuple(out)


_PRECISION_BITS = 22  # PIL's fixed point for 8-bit images: 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    "PIL's bicubic_filter (a = -0.5), with its operations in its order, in float64."
    x = np.abs(x)
    near = ((-0.5 + 2.0) * x - (-0.5 + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc for the whole input:
    (first tap (out,), fixed-point weights (out, ksize) int32, ksize)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C's (int) truncates toward zero
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = np.where(live, _bicubic(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale)), 0.0)
    ww = np.cumsum(w, axis=1)[:, -1:]  # summed in tap order, as the C loop does
    k = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = np.where(k < 0, -0.5 + k * (1 << _PRECISION_BITS), 0.5 + k * (1 << _PRECISION_BITS))
    return xmin, fixed.astype(np.int64).astype(np.int32), ksize


def _resample_last(x: torch.Tensor, out_size: int) -> torch.Tensor:
    "One PIL pass along the last axis of an int32 tensor of uint8 values."
    xmin, k, ksize = _coeffs(x.shape[-1], out_size)
    acc = torch.full((*x.shape[:-1], out_size), 1 << (_PRECISION_BITS - 1), dtype=torch.int32)
    last = x.shape[-1] - 1
    for j in range(ksize):
        idx = torch.from_numpy(np.minimum(xmin + j, last))
        acc += x[..., idx] * torch.from_numpy(k[:, j])
    return (acc >> _PRECISION_BITS).clamp_(0, 255)


def resize_bicubic_u8(image: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    "PIL's ``Image.fromarray(image).resize((w, h), Image.BICUBIC)`` of an HWC uint8 image, without PIL."
    rh, rw = size_hw
    x = torch.from_numpy(np.ascontiguousarray(image, dtype=np.uint8)).permute(2, 0, 1).to(torch.int32)
    if rw != x.shape[2]:
        x = _resample_last(x, rw)
    if rh != x.shape[1]:
        x = _resample_last(x.transpose(1, 2), rh).transpose(1, 2)
    return x.to(torch.uint8).permute(1, 2, 0).contiguous().numpy()


def resize_to_bucket(
    image: np.ndarray, bucket_hw: Tuple[int, int], portrait: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Aspect-preserving resize + centre crop of one HWC uint8 image into a
    canvas (the DUSt3R preprocessing: scale so the canvas fits inside the
    scaled image, crop the centre). A portrait image is resized in its native
    orientation, then transposed into the canvas; a square canvas carries no
    orientation, so ``portrait`` is ignored there.

    Returns (canvas (bh, bw, C) uint8, true_shape (2,) int32): (bh, bw) for
    landscape, (bw, bh) for portrait.
    """
    if image.ndim != 3:
        raise ValueError(f"expected HWC image, got shape {image.shape}")
    bh, bw = bucket_hw
    if bh == bw:
        portrait = False
    th, tw = (bw, bh) if portrait else (bh, bw)  # target in native orientation
    H, W = image.shape[:2]
    scale = max(th / H, tw / W)
    rh, rw = max(th, int(round(H * scale))), max(tw, int(round(W * scale)))
    arr = resize_bicubic_u8(image.astype(np.uint8), (rh, rw))
    y0, x0 = (rh - th) // 2, (rw - tw) // 2
    arr = arr[y0 : y0 + th, x0 : x0 + tw]
    if portrait:
        arr = np.swapaxes(arr, 0, 1)
    return arr, np.asarray((th, tw), np.int32)


class BucketedBatcher:
    """Streaming grouper: arbitrary-size images -> fixed-shape batches.

    ``add()`` assigns each image to its aspect bucket, resizes it into the
    canvas and buffers it; a full batch is yielded as ``(bucket_hw, canvas
    (B, bh, bw, 3) uint8, true_shape (B, 2), meta)``. ``flush()`` drains the
    rest, padded to the batch size by repeating the last row (``meta["n_valid"]``
    counts the real rows; padded rows carry key None).
    """

    def __init__(self, batch_size: int, buckets: Sequence[Tuple[int, int]] = DUST3R_512_BUCKETS):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.batch_size = batch_size
        self.buckets = [tuple(b) for b in buckets]
        self._pending: Dict[int, List[Tuple[np.ndarray, np.ndarray, object]]] = {}

    def add(self, image: np.ndarray, key: object = None) -> Iterator[tuple]:
        "Buffer one HWC image; yields any batch this fill completes."
        idx, portrait = assign_bucket(image.shape[0], image.shape[1], self.buckets)
        canvas, ts = resize_to_bucket(image, self.buckets[idx], portrait)
        self._pending.setdefault(idx, []).append((canvas, ts, key))
        if len(self._pending[idx]) >= self.batch_size:
            yield self._emit(idx, self._pending.pop(idx), n_valid=self.batch_size)

    def flush(self) -> Iterator[tuple]:
        "Drain partial batches, each padded to batch_size (see n_valid)."
        for idx in sorted(self._pending):
            rows = self._pending.pop(idx)
            n_valid = len(rows)
            pad = rows[-1][:-1] + (None,)
            yield self._emit(idx, rows + [pad] * (self.batch_size - n_valid), n_valid=n_valid)

    def _emit(self, idx, rows, n_valid):
        canvases, tss, keys = zip(*rows)
        return self.buckets[idx], np.stack(canvases), np.stack(tss), {"keys": list(keys), "n_valid": n_valid}


class PairBucketedBatcher:
    """Two-view :class:`BucketedBatcher` for pair models.

    Both views of a pair share one batch row and one canvas, chosen from the
    first view's aspect; each view keeps its own orientation flag (ManyAR
    ``true_shape``, ``landscape_only`` models). ``add(img1, img2, key)`` yields
    ``(bucket_hw, canvas1, canvas2, true_shape1, true_shape2, meta)`` per full
    batch; ``flush()`` pads the remainders (``meta["n_valid"]``).

    ``manyar=False`` (``UFMFlow``): no orientation packing; buckets may hold
    portrait canvases (:func:`with_portrait_buckets`), nothing is transposed,
    and ``true_shape`` equals the canvas shape.
    """

    def __init__(self, batch_size: int, buckets: Sequence[Tuple[int, int]] = DUST3R_512_BUCKETS,
                 manyar: bool = True):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.batch_size = batch_size
        self.buckets = [tuple(b) for b in buckets]
        self.manyar = manyar
        self._pending: Dict[int, List[tuple]] = {}

    def add(self, img1: np.ndarray, img2: np.ndarray, key: object = None) -> Iterator[tuple]:
        "Buffer one HWC-image pair; yields any batch this fill completes."
        idx, portrait1 = assign_bucket(img1.shape[0], img1.shape[1], self.buckets, manyar=self.manyar)
        portrait2 = self.manyar and img2.shape[0] > img2.shape[1]
        c1, ts1 = resize_to_bucket(img1, self.buckets[idx], portrait1)
        c2, ts2 = resize_to_bucket(img2, self.buckets[idx], portrait2)
        self._pending.setdefault(idx, []).append((c1, c2, ts1, ts2, key))
        if len(self._pending[idx]) >= self.batch_size:
            yield self._emit(idx, self._pending.pop(idx), n_valid=self.batch_size)

    def flush(self) -> Iterator[tuple]:
        "Drain partial batches, each padded to batch_size (see n_valid)."
        for idx in sorted(self._pending):
            rows = self._pending.pop(idx)
            n_valid = len(rows)
            pad = rows[-1][:-1] + (None,)
            yield self._emit(idx, rows + [pad] * (self.batch_size - n_valid), n_valid=n_valid)

    def _emit(self, idx, rows, n_valid):
        c1s, c2s, ts1s, ts2s, keys = zip(*rows)
        return (self.buckets[idx], np.stack(c1s), np.stack(c2s), np.stack(ts1s), np.stack(ts2s),
                {"keys": list(keys), "n_valid": n_valid})
