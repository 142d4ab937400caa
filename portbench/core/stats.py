"""Arithmetic of the benchmark's numbers: tails over all samples, device busy time and rooflines."""

import math
from typing import Iterable, List, Sequence, Tuple

__all__ = ["percentile_all", "union_length", "idle_gaps", "roofline_least_s"]


def percentile_all(values: Sequence[float], q: float) -> float:
    """The q-th percentile of every sample by nearest rank: the smallest value with at least q% of the samples at
    or below it. No sample is dropped and no medians of chunks are taken."""
    if not values:
        raise ValueError("no samples")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def _merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_length(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    "Length of the union of the intervals, clipped to [lo, hi]: the time in which at least one of them ran."
    clipped = [(max(a, lo), min(b, hi)) for a, b in intervals]
    return sum(b - a for a, b in _merged(clipped))


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    "The stretches of [lo, hi] that no interval covers, in time order."
    gaps, t = [], lo
    for a, b in _merged((max(a, lo), min(b, hi)) for a, b in intervals):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def roofline_least_s(flops: float, nbytes: float, peak_flops: float, peak_bytes_per_s: float) -> float:
    "The least time the chip could take: the larger of the operations at the peak rate and the bytes at the peak bandwidth."
    return max(flops / peak_flops, nbytes / peak_bytes_per_s)
