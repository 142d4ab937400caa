"""
Host -> device input pipeline (counterpart of uniception_tpu/data/pipeline.py).

    * :func:`prefetch_to_device` keeps ``buffer_size`` batches in flight:
      each batch's arrays are copied into a ring of pinned host buffers and
      sent to the device on a copy stream, with an event that the consuming
      stream waits on. The generator produces batch i + buffer_size only
      after the caller has enqueued its work on batch i, so the host's work
      on the next batches (aspect bucketing and resizing) overlaps the
      device's work on this one.
    * :func:`make_frame_normalizer` / :func:`normalize_batch` — uint8
      (B, H, W, 3) frames to the encoder's normalized (B, 3, H, W) fp32, on
      the device (the JAX package normalizes on the host in numpy or C++).
    * :func:`epoch_batches` — one shuffled pass over a dict of arrays.
    * :class:`DeterministicSampler` — the step-indexed batch stream that
      makes a resumed run see the batches of the uninterrupted one.
"""

import collections
import itertools
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from uniception_tpu_torch.models.encoders.image_normalizations import IMAGE_NORMALIZATION_DICT

__all__ = ["prefetch_to_device", "make_frame_normalizer", "normalize_batch", "epoch_batches", "DeterministicSampler"]


def _is_array(v) -> bool:
    return isinstance(v, np.ndarray) or (isinstance(v, torch.Tensor) and v.device.type == "cpu")


def prefetch_to_device(batches: Iterable[Dict[str, Any]], device, buffer_size: int = 2) -> Iterator[Dict[str, Any]]:
    """Yield each dict of ``batches`` with its top-level array values (numpy
    arrays or CPU tensors) as tensors on ``device``; other values (nested
    tuples, metadata) pass through as they are."""
    if buffer_size < 1:
        raise ValueError("buffer_size must be >= 1")
    device = torch.device(device)
    it = iter(batches)
    if device.type != "cuda":
        for batch in it:
            yield {k: torch.as_tensor(v).to(device) if _is_array(v) else v for k, v in batch.items()}
        return

    copy_stream = torch.cuda.Stream(device)
    ring = [{} for _ in range(buffer_size)]  # slot -> {key: pinned host buffer}
    copied = [None] * buffer_size  # slot -> event after its last copy left the pinned buffer
    slots = itertools.cycle(range(buffer_size))

    def stage(batch):
        s = next(slots)
        if copied[s] is not None:
            copied[s].synchronize()  # the slot's previous batch has left its pinned buffers
        out = {}
        with torch.cuda.stream(copy_stream):
            for k, v in batch.items():
                if not _is_array(v):
                    out[k] = v
                    continue
                host = torch.as_tensor(v)
                buf = ring[s].get(k)
                if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
                    buf = ring[s][k] = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                buf.copy_(host)
                out[k] = buf.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(copy_stream)
        copied[s] = event
        return out, event

    queue = collections.deque(stage(b) for b in itertools.islice(it, buffer_size))
    while queue:
        out, event = queue.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        for v in out.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                v.record_stream(consumer)  # allocated on the copy stream, used on the consumer's
        yield out
        for b in itertools.islice(it, 1):
            queue.append(stage(b))


def make_frame_normalizer(data_norm_type: str, device):
    """Return ``prep(frames_u8) -> (B, 3, H, W) fp32`` on ``device``: uint8
    (B, H, W, 3) frames (arrays, CPU or device tensors) staged through pinned
    memory on CUDA, then ``(x / 255 - mean) / std`` on the device."""
    device = torch.device(device)
    norm = IMAGE_NORMALIZATION_DICT[data_norm_type]
    mean = norm.mean.to(device).view(1, 3, 1, 1)
    std = norm.std.to(device).view(1, 3, 1, 1)

    def prep(frames_u8):
        x = torch.as_tensor(frames_u8)
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"want uint8 (B, H, W, 3) frames, got {x.dtype} {tuple(x.shape)}")
        if device.type == "cuda" and x.device.type == "cpu":
            x = x.pin_memory()
        x = x.to(device, non_blocking=True)
        return (x.permute(0, 3, 1, 2).float() / 255.0 - mean) / std

    return prep


def normalize_batch(images_uint8, data_norm_type: str, device="cpu") -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalized fp32 (B, 3, H, W) on ``device`` for the
    encoder's normalization (one call of :func:`make_frame_normalizer`; a loop
    makes the normalizer once and calls it)."""
    return make_frame_normalizer(data_norm_type, device)(images_uint8)


def epoch_batches(arrays: Dict[str, Any], batch_size: int, *, rng: Optional[np.random.RandomState] = None,
                  drop_last: bool = True) -> Iterator[Dict[str, Any]]:
    "Yield the batches of one pass over a dict of equal-length arrays, shuffled by ``rng`` when given."
    n = len(next(iter(arrays.values())))
    order = np.arange(n)
    if rng is not None:
        rng.shuffle(order)
    end = n - (n % batch_size) if drop_last else n
    for i in range(0, end, batch_size):
        idx = order[i : i + batch_size]
        yield {k: v[idx] for k, v in arrays.items()}


class DeterministicSampler:
    """Step-indexed batch sampler: the k-th batch is a pure function of
    (seed, epoch shuffle, k), with each epoch's permutation drawn from
    ``SeedSequence([seed, epoch])``, so a run resumed at step k sees the
    batches the uninterrupted run would have seen. Persist the train step
    (the batches consumed), not ``sampler.step``: under
    :func:`prefetch_to_device` the sampler runs ``buffer_size`` batches ahead."""

    def __init__(self, arrays: Dict[str, Any], batch_size: int, *, seed: int = 0, start_step: int = 0):
        self.arrays, self.batch_size, self.seed, self.step = arrays, int(batch_size), int(seed), int(start_step)
        self._n = len(next(iter(arrays.values())))
        self.batches_per_epoch = self._n // self.batch_size
        if self.batches_per_epoch == 0:
            raise ValueError(f"dataset ({self._n}) smaller than batch_size ({batch_size})")
        self._epoch, self._order = None, None

    def batch_at(self, step: int) -> Dict[str, Any]:
        "The batch of the given global step."
        epoch, pos = divmod(step, self.batches_per_epoch)
        if self._epoch != epoch:
            self._order = np.random.default_rng(np.random.SeedSequence([self.seed, epoch])).permutation(self._n)
            self._epoch = epoch
        idx = self._order[pos * self.batch_size : (pos + 1) * self.batch_size]
        return {k: v[idx] for k, v in self.arrays.items()}

    def __iter__(self):
        while True:
            yield self.batch_at(self.step)
            self.step += 1
