"""What one run hands to the per-layer metric readers and to the result line."""

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from portbench.core.trace import TraceRecord

__all__ = ["RunContext", "Record", "Laps"]


@dataclass
class RunContext:
    "What a traffic runner is given: the cell, the run's arguments and the clock's origin."

    torch: Any
    cell: Any  # core.registry.Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float  # perf_counter at process start: set-up is measured from here
    control: bool = False  # the program's lower-precision path in place of the configured one
    fault: Optional[Any] = None  # a wrapper that breaks the timed path (tests of the comparison only)


@dataclass
class Record:
    "A run's readings. ``units`` are what the cell's rate counts (pairs served or trained)."

    arch: Dict[str, Any]
    family: Any
    device_kind: str
    window_s: float
    units: int
    spans: Any  # core.spans.Spans of the window
    peak_bytes: int
    end_to_end: Dict[str, float]
    values: Dict[str, float]  # the numbers compared with the reference
    attempted: int
    failed: int = 0
    pairs_per_unit: int = 1  # pairs in one batch or step
    trace: Optional[TraceRecord] = None
    traced_units: int = 0  # batches or steps inside the traced window
    notes: Dict[str, Any] = field(default_factory=dict)


class Laps(dict):
    "Seconds of the stages of set-up: ``lap(name)`` records the time since the previous lap (the first: since t0)."

    def __init__(self, t0: float):
        super().__init__()
        self._last = t0

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self[name] = now - self._last
        self._last = now
