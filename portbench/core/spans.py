"""Spans the benchmark records around its own calls into the program.

Each span is kept in memory as (name, start, end) on the host's ``perf_counter`` clock and, while a profiler runs,
also appears in its trace as a ``record_function`` range of the same name, so that the trace's idle gaps can be
named by what the host was doing.
"""

import contextlib
import time
from typing import List, Tuple

__all__ = ["Spans"]


class Spans:
    "An in-memory list of host spans; ``durations(name)`` gives the seconds of every span of that name."

    def __init__(self, torch):
        self._torch = torch
        self.records: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        with self._torch.profiler.record_function(name):
            yield
        self.records.append((name, t0, time.perf_counter()))

    def durations(self, name: str) -> List[float]:
        return [b - a for n, a, b in self.records if n == name]
