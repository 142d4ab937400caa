"""The traced window: ``torch.profiler`` over a stretch of the cell's own work, reduced to device busy time, the
device operations by time, and the idle gaps named by the benchmark's spans.

Every device activity the profiler records (kernels, copies, memsets) counts as busy; the busy time is the length
of the union of their intervals inside the window, so overlapping activities count once.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from portbench.core.stats import idle_gaps, union_length

__all__ = ["TraceRecord", "summarize", "trace_window", "idle_percent", "WINDOW_SPAN"]

WINDOW_SPAN = "portbench.window"
Interval = Tuple[str, float, float]  # (name, start s, end s)


@dataclass
class TraceRecord:
    window_s: float
    busy_s: float
    device: List[Interval]  # every device activity in the window, clipped to it
    host: List[Interval]  # the benchmark's spans in the window
    breakdown: Dict[str, list] = field(default_factory=dict)

    def device_seconds(self, needles: Sequence[str]) -> Tuple[int, float]:
        "(count, seconds) of the device activities whose name holds one of ``needles``."
        hits = [b - a for n, a, b in self.device if any(k in n for k in needles)]
        return len(hits), sum(hits)


def idle_percent(trace) -> "float | None":
    "The share of a traced window in which the device ran nothing, in %; None without a trace."
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def _span_at(host: List[Interval], t: float) -> str:
    "The innermost (latest-starting) benchmark span around time t on the host, or 'no span'."
    around = [(a, n) for n, a, b in host if a <= t <= b and n != WINDOW_SPAN]
    return max(around)[1] if around else "no span"


def summarize(device: List[Interval], host: List[Interval], lo: float, hi: float, top: int = 10) -> TraceRecord:
    "Reduce one window [lo, hi] (seconds on the trace's clock) of device activities and host spans."
    inside = [(n, max(a, lo), min(b, hi)) for n, a, b in device if b > lo and a < hi]  # clipped to the window
    busy = union_length([(a, b) for _, a, b in inside], lo, hi)
    by_name: Dict[str, float] = {}
    for n, a, b in inside:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps([(a, b) for _, a, b in inside], lo, hi), key=lambda g: g[0] - g[1])[:top]
    breakdown = {
        "device_ops": [[n[:160], s] for n, s in ops],
        "idle_gaps": [[_span_at(host, (a + b) / 2), b - a] for a, b in gaps],
    }
    return TraceRecord(window_s=hi - lo, busy_s=busy, device=inside, host=host, breakdown=breakdown)


def trace_window(torch, body) -> TraceRecord:
    """Run ``body()`` under ``torch.profiler`` (CPU and CUDA activities) inside one span, synchronise, and reduce
    the trace. The window is that span, from its start on the host to the synchronise that ends it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            body()
            torch.cuda.synchronize()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    device, host = [], []
    for e in prof.events():
        iv = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        # a record_function range shows on the device's timeline too, as an annotation: it is no device work
        annotation = getattr(e, "is_user_annotation", False) or e.name in _SPAN_NAMES
        if e.device_type == cuda and not annotation:
            device.append(iv)
        elif e.device_type == cpu and e.name in _SPAN_NAMES:
            host.append(iv)
    window = [iv for iv in host if iv[0] == WINDOW_SPAN]
    if not window:
        raise RuntimeError("the profiler recorded no window span")
    _, lo, hi = window[0]
    return summarize(device, host, lo, hi)


# the spans the benchmark's runners record (portbench/traffic/*.py): the names the idle gaps take
_SPAN_NAMES = {WINDOW_SPAN, "serve", "h2d", "step", "sync", "reference"}
