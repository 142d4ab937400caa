"""
Host -> device input staging (counterpart of uniception_tpu/data/pipeline.py
``prefetch_to_device``).

:func:`prefetch_to_device` keeps ``buffer_size`` batches in flight: each
batch's arrays are copied into a ring of pinned host buffers and sent to the
device on a copy stream, with an event that the consuming stream waits on.
The generator produces batch i + buffer_size only after the caller has
enqueued its work on batch i, so the host's work on the next batches (aspect
bucketing and resizing) overlaps the device's work on this one.
Normalization stays on the device (``serve.make_frame_normalizer``).
"""

import collections
import itertools
from typing import Any, Dict, Iterable, Iterator

import numpy as np
import torch

__all__ = ["prefetch_to_device"]


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
